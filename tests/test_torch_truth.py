"""The float64 truth in blocks (kmb_tpu_torch.datasets.ground_truth).

The chunked plain product, with its cap on each float64 temporary forced
small (several row blocks, source chunks whose edge does not divide M),
against kmb_tpu's float64 oracle `blocked_kernel_product` at 1e-12
relative: the Gaussian cube at D3, inverse-distance on equal points (the
diagonal across chunk edges), exponential attention at D25 with logits
near 50 (the flash states merged in the max-shifted form), and density
estimation (ones; the row sums alone).  The 2^20-point entries' arrays
against kmb_tpu's generators, and the CLI's stored truth with the cap
forced small against the uncapped one.
"""

import math

import numpy as np
import pytest

import kmb_tpu.datasets as jax_datasets
from kmb_tpu.algorithms.bruteforce_numpy import blocked_kernel_product

import kmb_tpu_torch.datasets as datasets
import kmb_tpu_torch.main as cli
import kmb_tpu_torch.ops.product as product
from kmb_tpu_torch import hdf5

REL = 1e-12
CAP = 10_000   # entries: row blocks of 256 rows, source chunks of 39 columns
LARGE = ["product-cube-D3-E1-M1048576-N1048576-gaussian",
         "attention-normal-D25-E1-M1048576-N10000-exponential",
         "attention-normal-D25-E1-M1048576-N1048576-exponential"]


def _attention_near_50():
    """Exponential attention at D25: 1100 sources of norm sqrt(50), 700
    targets near the first sources, so each target's largest logit
    <x, y> is near 50."""
    rng = np.random.default_rng(25)
    y = rng.standard_normal((1100, 25))
    y *= math.sqrt(50.0) / np.linalg.norm(y, axis=1, keepdims=True)
    x = y[:700] + 0.01 * rng.standard_normal((700, 25))
    return datasets._arrays(
        task="attention", kernel="exponential", short_description="",
        description="", source_points=y, target_points=x,
        source_signal=rng.standard_normal((1100, 2)), normalize_rows=True)


CASES = {
    "cube D3": lambda: datasets.make_arrays(
        "product-cube-D3-E1-M1000-N1000-gaussian"),
    "inverse-distance, same points": lambda: datasets.make_arrays(
        "product-sphere-D3-E1-M1000-N1000-inverse-distance"),
    "attention D25, logits near 50": _attention_near_50,
    "density estimation": datasets.uniform_cube(
        n_points=1000, density_estimation=True),
    "density estimation, row sums alone": datasets.uniform_sphere(
        n_points=1000, kernel="inverse-distance", normalize_rows=True),
}


def _chunked(monkeypatch):
    """Take the path the card takes: no numpy or native oracle."""
    monkeypatch.setattr(datasets, "NUMPY_TRUTH_MAX_PAIRS", 0)
    monkeypatch.setattr(datasets.native, "is_available", lambda: False)


@pytest.mark.parametrize("case", CASES)
def test_chunked_truth_matches_the_jax_oracle(case, monkeypatch):
    arrays = CASES[case]()
    if case.endswith("row sums alone"):   # normalised ones: den only
        arrays["source_signal"] = np.ones((len(arrays["source_points"]), 1))
    _chunked(monkeypatch)
    blocks = []
    plain = product.kernel_matvec_torch

    def spy(x, y, b, **kw):
        blocks.append((len(x), len(y), kw["row_offset"], kw["col_offset"]))
        return plain(x, y, b, **kw)

    monkeypatch.setattr(product, "kernel_matvec_torch", spy)
    got = datasets.ground_truth(arrays, "cpu", max_entries=CAP)
    n, m = len(arrays["target_points"]), len(arrays["source_points"])
    assert all(rows * cols <= CAP for rows, cols, _, _ in blocks)
    assert len({r0 for _, _, r0, _ in blocks}) > 2
    assert m % blocks[0][1] != 0 and len({c0 for *_, c0 in blocks}) > 2
    assert sum(rows * cols for rows, cols, _, _ in blocks) == n * m
    want = blocked_kernel_product(
        kernel=arrays["kernel"], source_points=arrays["source_points"],
        target_points=None if arrays["same_points"]
        else arrays["target_points"],
        source_signal=None if arrays["density_estimation"]
        else arrays["source_signal"],
        normalize_rows=bool(arrays["normalize_rows"]))
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
    if case.startswith("attention"):
        logits = arrays["target_points"] @ arrays["source_points"].T
        assert 45 < logits.max(axis=1).min() < logits.max() < 55
    if case.endswith("row sums alone"):
        np.testing.assert_allclose(got, 1.0, rtol=0, atol=REL)


def test_default_cap_bounds_the_2_20_blocks():
    cols = min(2**20, datasets.TRUTH_BLOCK_ENTRIES // datasets.TRUTH_ROWS)
    rows = datasets.TRUTH_BLOCK_ENTRIES // cols
    assert rows * cols * 8 <= 512 * 2**20   # bytes of a float64 temporary
    assert rows >= datasets.TRUTH_ROWS


@pytest.mark.parametrize("name", LARGE)
def test_the_2_20_entries_arrays_are_kmb_tpus(name, monkeypatch):
    written = {}
    monkeypatch.setattr(jax_datasets, "write_output",
                        lambda **kw: written.update(kw))
    jax_datasets.DATASETS[name](None)
    got = datasets.make_arrays(name)
    want_x = written["target_points"]
    assert got["same_points"] == (want_x is None)
    assert got["density_estimation"] == (written["source_signal"] is None)
    for key, want in (("source_points", written["source_points"]),
                      ("target_points", written["source_points"]
                       if want_x is None else want_x),
                      ("source_signal", written["source_signal"])):
        assert got[key].tobytes() == np.asarray(want, np.float64).tobytes()
    for key in ("task", "kernel", "normalize_rows", "short_description",
                "description"):
        assert got[key] == written[key], key


DATASET = "product-sphere-D3-E1-M1000-N1000-inverse-distance"


def _stored_truth(tmp_path, monkeypatch, name, cap):
    monkeypatch.setenv("KMB_DATA_DIR", str(tmp_path / name / "data"))
    monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / name / "results"))
    monkeypatch.setattr(datasets, "TRUTH_BLOCK_ENTRIES", cap)
    cli.main(["--local", "--hardware", "CPU", "--runs", "1", "--algorithm",
              "torch-product-cpu", "--dataset", DATASET])
    with hdf5.open_read(datasets.get_dataset_fn(DATASET)) as f:
        return f["target_signal"][:]


def test_cli_truth_with_a_small_cap_is_the_uncapped_truth(tmp_path,
                                                         monkeypatch):
    _chunked(monkeypatch)
    capped = _stored_truth(tmp_path, monkeypatch, "capped", CAP)
    uncapped = _stored_truth(tmp_path, monkeypatch, "uncapped", 2**26)
    np.testing.assert_allclose(capped, uncapped, rtol=0,
                               atol=REL * np.abs(uncapped).max())
