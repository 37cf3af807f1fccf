"""The frozen yardstick: least times, generators, the TF32 rounding."""

import numpy as np
import pytest
import torch

from portbench import cell as cells
from portbench import data, roofline
from portbench.references import kernel_product

# An H100 SXM: 132 SMs at a 1980 MHz maximum clock.
SFU = roofline.special_function_rate(132, 1980.0)


def test_special_function_rate():
    assert SFU == 16 * 132 * 1980e6


@pytest.mark.parametrize("cell,ms,unit", [
    # 2^40 pairs, one transcendental each: 2^40 / SFU.
    ("cube-n2p20.signal-stream", 2**40 / SFU * 1e3,
     "special-function units"),
    # 10^4 x 1,183,514 pairs, D25 in 3 TF32 passes (2 flops a pair and
    # dimension), the signal on the FP32 units beside them.
    ("glove25.signal-stream", 2 * 1e4 * 1183514 * 25 * 3 / 495e12 * 1e3,
     "tensor cores"),
    # Each of four ranks: 2^19 targets against 2^21 sources, 2^40 pairs.
    ("cube-n2p21-ring4.signal-stream", 2**40 / SFU * 1e3,
     "special-function units"),
])
def test_least_time_of_each_cell(cell, ms, unit):
    c = cells.load(cell)
    config, world = c.config, c.chips
    # One launch a query on one card; four chunk launches a rank a query
    # in the ring.
    assert c.task.launch_bound_ms(config, world, SFU) * world == \
        pytest.approx(ms, rel=1e-12)
    n = -(-config["n_targets"] // world)
    _, kind, engine = roofline.bound_ms(
        n, config["n_sources"], config["dimension"], 1,
        roofline.launch_kind(config), config["normalize_rows"], "float32",
        SFU)
    assert (kind, engine) == ("operations", unit)


def test_hand_values():
    # The cube at 2^20: 262.93 ms, the attention D25 at 2^20 x 10^4:
    # 3.1775 ms (the port's smoke script at the same shapes).
    assert roofline.bound_ms(2**20, 2**20, 3, 1, "direct", False, "float32",
                             SFU)[0] == pytest.approx(262.93, abs=0.01)
    assert roofline.bound_ms(10000, 2**20, 25, 1, "flash", True, "float32",
                             SFU)[0] == pytest.approx(3.1775, abs=1e-4)


def test_memory_bound_at_tiny_work():
    ms, kind, engine = roofline.bound_ms(1, 10**8, 3, 1, "direct", False,
                                         "float32", SFU)
    assert (kind, engine) == ("bytes", "memory")
    # (N + M) D coordinates, M + N signal values, 4 bytes each.
    assert ms == pytest.approx((10**8 + 1) * (3 + 1) * 4 / 3.35e12 * 1e3,
                               rel=1e-9)


SMALL = {"n_targets": 300, "n_sources": 700}


@pytest.mark.parametrize("name", ["cube-n2p20.signal-stream",
                                  "glove25.signal-stream"])
def test_generators_repeat_for_a_seed(name):
    c = cells.load(name, SMALL)
    seed = 2**31 + 12345
    a = data.make_inputs(c.config, c.traffic, seed, 64)
    b = data.make_inputs(c.config, c.traffic, seed, 64)
    other = data.make_inputs(c.config, c.traffic, seed + 1, 64)
    for key in ("sources", "targets", "pool", "rows"):
        assert np.array_equal(getattr(a, key), getattr(b, key))
        assert getattr(a, key).shape == getattr(other, key).shape
    assert not np.array_equal(a.sources, other.sources)
    assert not np.array_equal(a.pool, other.pool)
    assert a.sources.dtype == a.pool.dtype == np.float32
    assert a.pool.shape == (16, 700, 1)
    assert a.rows[0] == 0 and a.rows[-1] == 299 and len(set(a.rows)) == 64


def test_generators_distributions():
    rng = np.random.default_rng(0)
    cube = data.uniform_cube(rng, 100000, 3)
    assert cube.min() >= 0 and cube.max() < 1
    assert abs(cube.mean() - 0.5) < 0.01
    cloud = data.normal_cloud(rng, 100000, 25)
    assert abs(np.linalg.norm(cloud, axis=1).mean() - 1.0) < 0.02


def test_tf32_rounding():
    t = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10, 1 + 3 * 2**-12, -1.5,
                      3.0e-3], dtype=torch.float32)
    r = kernel_product.tf32(t)
    assert r[0] == 1.0 and r[2] == 1 + 2**-10 and r[4] == -1.5
    assert r[1] == 1 + 2**-10          # a tie rounds away from zero
    assert r[3] == 1 + 2**-10
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float((r - t).abs().max() / t.abs().max()) <= 2**-11


@pytest.mark.parametrize("kernel,fn", [
    ("gaussian", lambda d2: np.exp(-d2)),
    ("absolute-exponential", lambda d2: np.exp(-np.sqrt(d2))),
])
def test_reference_follows_the_definitions(kernel, fn):
    rng = np.random.default_rng(4)
    x, y = rng.random((7, 3)), rng.random((50, 3))
    b = rng.standard_normal((50, 2))
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    want = fn(d2) @ b
    got = kernel_product.product(x, y, b, kernel=kernel,
                                 normalize_rows=False, device="cpu")
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)
    w = np.exp(x @ y.T)
    got = kernel_product.product(x, y, b, kernel="exponential",
                                 normalize_rows=True, device="cpu")
    assert np.allclose(got, (w @ b) / w.sum(1, keepdims=True), rtol=1e-12)


def test_signals_taken_in_turn():
    c = cells.load("cube-n2p20.signal-stream", SMALL)
    inputs = data.make_inputs(c.config, c.traffic, 2**31 + 9, 16)
    size = c.traffic["signal_pool"]
    for i in (0, 1, size - 1, size, 3 * size + 2):
        s, signal = inputs.signal(i)
        assert s == i % size and np.array_equal(signal, inputs.pool[s])


def test_traffic_keys_the_harness_does_not_read_are_refused(monkeypatch):
    real = cells.load_json

    def load_json(path):
        out = real(path)
        return dict(out, clients=8) if "traffic" in str(path) else out
    monkeypatch.setattr(cells, "load_json", load_json)
    with pytest.raises(ValueError, match="clients"):
        cells.load("cube-n2p20.signal-stream")
