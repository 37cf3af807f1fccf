"""The port's streaming product against kmb_tpu's, on the CPU.

`kernel_matvec_torch` (the plain PyTorch version the CUDA kernels are held
against) is compared with three references on the same numpy-seeded
inputs: `kernel_matvec_xla`, `kernel_matvec_pallas(..., interpret=True)`
and the float64 oracle.  Tolerances are those of tests/test_ops.py:
2e-4/2e-5 for products (:41,50), 1e-4/1e-5 normalised (:65), 1e-3/1e-4 for
large logits (:82).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.algorithms.bruteforce_numpy import kernel_matrix
from kmb_tpu.ops.product import kernel_matvec_pallas, kernel_matvec_xla
from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.ops.product import (
    choose_splits, kernel_matvec, kernel_matvec_cuda, kernel_matvec_torch,
    merge_direct_states, merge_flash_states,
)

ALL_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
               "exponential"]
LOG_KERNELS = ["gaussian", "absolute-exponential", "exponential"]
TOL = {False: dict(rtol=2e-4, atol=2e-5), True: dict(rtol=1e-4, atol=1e-5)}


def _points(rng, n, m, d, e):
    # Scaled by 1/sqrt(D) so every kernel stays O(1) at D = 64, as the
    # normal-cloud datasets do.  N and M are ragged on purpose.
    x = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.standard_normal((m, d)) / np.sqrt(d)).astype(np.float32)
    b = rng.standard_normal((m, e)).astype(np.float32)
    return x, y, b


def _truth(kernel, x, y, b, normalize=False):
    k = kernel_matrix(kernel=kernel, source_points=y.astype(np.float64),
                      target_points=x.astype(np.float64))
    out = k @ b.astype(np.float64)
    if normalize:
        out = out / k.sum(axis=1, keepdims=True)
    return out


def _torch(x, y, b, **kw):
    out = kernel_matvec_torch(
        torch.from_numpy(x), torch.from_numpy(y),
        None if b is None else torch.from_numpy(b), **kw)
    if isinstance(out, tuple):
        return tuple(None if t is None else t.numpy() for t in out)
    return out.numpy()


def _jax(fn, x, y, b, **kw):
    out = fn(jnp.asarray(x), jnp.asarray(y),
             None if b is None else jnp.asarray(b), **kw)
    if isinstance(out, tuple):
        return tuple(None if t is None else np.asarray(t) for t in out)
    return np.asarray(out)


@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 64])
@pytest.mark.parametrize("e", [1, 8])
@pytest.mark.parametrize("normalize", [False, True])
def test_matches_xla_and_oracle(kernel, d, e, normalize, rng):
    x, y, b = _points(rng, 33, 47, d, e)
    got = _torch(x, y, b, kernel_name=kernel, normalize_rows=normalize,
                 block_n=8)
    want_xla = _jax(kernel_matvec_xla, x, y, b, kernel_name=kernel,
                    normalize_rows=normalize, block_n=8)
    assert got.shape == (33, e) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_xla, **TOL[normalize])
    np.testing.assert_allclose(got, _truth(kernel, x, y, b, normalize),
                               **TOL[normalize])


@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 64])
@pytest.mark.parametrize("normalize", [False, True])
def test_matches_pallas_interpret(kernel, d, normalize, rng):
    x, y, b = _points(rng, 33, 47, d, 2)
    got = _torch(x, y, b, kernel_name=kernel, normalize_rows=normalize)
    want = _jax(kernel_matvec_pallas, x, y, b, kernel_name=kernel,
                normalize_rows=normalize, block_n=16, block_m=128,
                interpret=True)
    np.testing.assert_allclose(got, want, **TOL[normalize])


@pytest.mark.parametrize("kernel", ALL_KERNELS)
def test_float64_is_ground_truth(kernel, rng):
    x, y, b = _points(rng, 40, 50, 3, 2)
    got = kernel_matvec_torch(
        torch.from_numpy(x.astype(np.float64)),
        torch.from_numpy(y.astype(np.float64)),
        torch.from_numpy(b.astype(np.float64)), kernel_name=kernel,
        block_n=16)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _truth(kernel, x, y, b),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_signal", [False, True])
def test_density_estimation(with_signal, rng):
    x, y, b = _points(rng, 33, 47, 3, 1)
    b = b if with_signal else None
    kw = dict(kernel_name="gaussian", density_estimation=True)
    want = kernel_matrix(kernel="gaussian", source_points=y.astype(np.float64),
                         target_points=x.astype(np.float64)
                         ).sum(axis=1, keepdims=True)
    got = _torch(x, y, b, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, _jax(kernel_matvec_xla, x, y, b, **kw),
                               rtol=2e-4, atol=2e-5)
    # Normalised density estimation is all ones, computed by nobody.
    ones = _torch(x, y, b, normalize_rows=True, **kw)
    np.testing.assert_array_equal(ones, np.ones((33, 1)))


def test_diagonal_default_from_spec(rng):
    _, y, b = _points(rng, 1, 20, 3, 1)
    want = kernel_matrix(kernel="inverse-distance",
                         source_points=y.astype(np.float64)) @ b
    got = _torch(y, y, b, kernel_name="inverse-distance")
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    unmasked = _torch(y, y, b, kernel_name="inverse-distance",
                      mask_diagonal=False)
    assert np.all(np.isinf(unmasked))


DEFERRED_CASES = [
    # (kernel, normalize_rows, density_estimation, with_signal)
    ("gaussian", False, False, True),            # (num, None)
    ("inverse-distance", True, False, True),     # (num, den)
    ("gaussian", False, True, True),             # (num, den)
    ("gaussian", False, True, False),            # (num, None)
    ("gaussian", True, False, True),             # flash (acc, m, l)
    ("exponential", True, False, True),          # flash (acc, m, l)
    ("absolute-exponential", True, True, False),  # flash, implicit ones
]


@pytest.mark.parametrize("kernel,normalize,density,with_signal",
                         DEFERRED_CASES)
@pytest.mark.parametrize("limits", [False, True])
def test_deferred_states_match_xla(kernel, normalize, density, with_signal,
                                   limits, rng):
    x, y, b = _points(rng, 33, 47, 3, 2)
    b = b if with_signal else None
    kw = dict(kernel_name=kernel, normalize_rows=normalize,
              density_estimation=density, deferred=True)
    if limits:
        # A shard at global rows 5.. and columns 3.. of a problem whose
        # global limits clip its last rows and columns, with the global
        # diagonal masked.
        kw.update(row_offset=5, col_offset=3, col_limit=3 + 40,
                  row_limit=5 + 30, mask_diagonal=True)
    got = _torch(x, y, b, block_n=8, **kw)
    want = _jax(kernel_matvec_xla, x, y, b, block_n=8, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kernel,normalize", [
    ("inverse-distance", True), ("gaussian", False), ("gaussian", True),
    ("exponential", True)])
def test_column_split_states_merge_exactly(kernel, normalize, rng):
    # The CUDA wrapper splits the source range over blocks and merges the
    # partial states; the same merge on the plain version's states of three
    # column ranges (one of them empty for the masked rows) gives the whole.
    x, y, b = (torch.from_numpy(a) for a in _points(rng, 33, 47, 3, 2))
    kw = dict(kernel_name=kernel, normalize_rows=normalize, deferred=True,
              mask_diagonal=True, row_limit=30)
    whole = kernel_matvec_torch(x, y, b, **kw)
    cuts = [0, 5, 31, 47]
    parts = [kernel_matvec_torch(x, y[c0:c1], b[c0:c1], col_offset=c0, **kw)
             for c0, c1 in zip(cuts, cuts[1:])]
    if len(whole) == 3:
        merged = merge_flash_states(*(torch.stack(p) for p in zip(*parts)))
    else:
        num, den = zip(*parts)
        merged = merge_direct_states(
            torch.stack(num), None if den[0] is None else torch.stack(den))
    for got, want in zip(merged, whole):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_flash_stability_large_logits(rng):
    x = (10.0 * rng.standard_normal((16, 4))).astype(np.float32)
    y = (10.0 * rng.standard_normal((24, 4))).astype(np.float32)
    b = rng.standard_normal((24, 1)).astype(np.float32)
    logits = x.astype(np.float64) @ y.astype(np.float64).T
    assert logits.max() > 100.0  # would overflow exp in f32
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    want = (p @ b) / p.sum(axis=1, keepdims=True)
    got = _torch(x, y, b, kernel_name="exponential", normalize_rows=True)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("normalize", [False, True])
def test_bfloat16_tier_matches_xla(kernel, normalize, rng):
    # The reference of the bf16 tier is the kernel the port replaces.  At
    # D <= 8 that is the Pallas kernel's VPU form, which keeps f32 points
    # and rounds the signal and each kernel value
    # (kmb_tpu/ops/product.py:525-538); kernel_matvec_xla rounds the points
    # too, and differs from Pallas by up to 4e-2 of the largest output at
    # D = 3.  At D > 8 the points are rounded in both, and XLA stays the
    # reference.  The frameworks still round at different places (XLA's
    # bf16 matmul also rounds its output, torch accumulates and returns
    # f32), so the tolerance is bf16's: 1e-2 of the largest output.
    for d, fn, extra in ((3, kernel_matvec_pallas,
                          dict(block_n=16, block_m=128, interpret=True)),
                         (9, kernel_matvec_xla, dict(block_n=8))):
        x, y, b = _points(rng, 33, 47, d, 2)
        kw = dict(kernel_name=kernel, normalize_rows=normalize,
                  precision="bfloat16")
        got = _torch(x, y, b, **kw)
        want = _jax(fn, x, y, b, **extra, **kw)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
        # And it is still the kernel product, to bf16 input accuracy.
        truth = _truth(kernel, x, y, b, normalize)
        assert np.abs(got - truth).max() / np.abs(truth).max() < 0.05


def _rms(got, truth):
    return float(np.sqrt(np.mean((got - truth) ** 2))
                 / np.sqrt(np.mean(truth ** 2)))


@pytest.mark.parametrize("cloud, kernel", [("sphere", "inverse-distance"),
                                           ("cube", "gaussian")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfloat16_small_d_keeps_f32_points(cloud, kernel, seed):
    # At D <= 8 the bf16 tier rounds the signal and each kernel value and
    # keeps the points in f32, as the Pallas kernel does.  Held against
    # kernel_matvec_pallas(precision="bfloat16", interpret=True) at 1e-2
    # of the largest output (bf16's tolerance, as above), and against the
    # float64 oracle: its RMS error may not exceed Pallas's (both round
    # the same values; they differ only in summation order, so by 1e-3
    # of it at most).
    rng = np.random.default_rng(seed)
    n = 500
    if cloud == "sphere":
        from kmb_tpu_torch.datasets import fibonacci_sphere
        y = fibonacci_sphere(n).astype(np.float32)
    else:
        y = rng.random((n, 3)).astype(np.float32)
    b = rng.standard_normal((n, 1)).astype(np.float32)
    kw = dict(kernel_name=kernel, precision="bfloat16")
    got = _torch(y, y, b, **kw)
    want = _jax(kernel_matvec_pallas, y, y, b, block_n=128, block_m=128,
                interpret=True, **kw)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    truth = _truth(kernel, y, y, b)
    assert _rms(got, truth) <= (1 + 1e-3) * _rms(want, truth)
    # Rounding the points as well (what the tier did before) is worse on
    # the singular kernel's near pairs.
    if kernel == "inverse-distance":
        rounded = torch.from_numpy(y).to(torch.bfloat16).float().numpy()
        worse = _torch(rounded, rounded, b, **kw)
        assert _rms(got, truth) < _rms(worse, truth)


def test_attention_bf16_keeps_f32_state(rng):
    m = 4096
    x = rng.standard_normal((64, 8)).astype(np.float32) * 0.3
    y = rng.standard_normal((m, 8)).astype(np.float32) * 0.3
    b = rng.standard_normal((m, 1)).astype(np.float32)
    want = _truth("exponential", x, y, b, normalize=True)
    acc, mx, l = _torch(x, y, b, kernel_name="exponential",
                        normalize_rows=True, precision="bfloat16",
                        deferred=True)
    assert acc.dtype == mx.dtype == l.dtype == np.float32
    got = acc / l
    assert np.abs(got - want).max() / np.abs(want).max() < 0.05


def test_float32x3_is_full_f32(rng):
    x, y, b = _points(rng, 33, 47, 64, 2)
    f32 = _torch(x, y, b, kernel_name="gaussian")
    x3 = _torch(x, y, b, kernel_name="gaussian", precision="float32x3")
    np.testing.assert_array_equal(x3, f32)


def test_unknown_precision_raises(rng):
    x, y, b = _points(rng, 4, 5, 3, 1)
    with pytest.raises(ValueError):
        _torch(x, y, b, kernel_name="gaussian", precision="float16")


def test_dispatch_sends_cpu_tensors_to_plain_version(rng):
    x, y, b = _points(rng, 33, 47, 3, 1)
    before = [k.launches for k in _build.KERNELS]
    got = kernel_matvec(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(b), kernel_name="gaussian",
                        interpret=True, block_m=128, rows_aligned=True,
                        cols_aligned=True, block_n=8).numpy()
    np.testing.assert_array_equal(
        got, _torch(x, y, b, kernel_name="gaussian", block_n=8))
    assert [k.launches for k in _build.KERNELS] == before


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    x, y, b = _points(rng, 4, 5, 3, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_matvec_cuda(torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(b), kernel_name="gaussian")


@pytest.mark.parametrize("blocks,slots,m_eff,want", [
    (79, 132, 10000, 5),      # D > 8 at N = 10^4: 395 blocks in 3 full waves
    (1, 132, 10**6, 119),     # one row block: split until 90% of the SMs work
    (256, 1584, 131072, 6),   # D <= 8 at N = 2^17, 12 blocks per SM
    (79, 132, 1000, 1),       # too few source columns to split
    (79, 132, 1500, 1),       # no split fills 90%: the best filled, fewest
])
def test_column_splits_fill_the_card(blocks, slots, m_eff, want):
    assert choose_splits(blocks, slots, m_eff) == want
