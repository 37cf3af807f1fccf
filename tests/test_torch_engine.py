"""The port's harness (datasets, engine, runner, CLI, build) on the CPU."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch

import kmb_tpu.datasets as jax_datasets
from kmb_tpu.algorithms.tpu_engine import TpuProduct
from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.algorithms.torch_engine import TorchProduct
from kmb_tpu_torch.datasets import DATASETS, ground_truth, make_arrays
from kmb_tpu_torch.definitions import Definition
from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.results import get_result_filename, load_all_results
from kmb_tpu_torch.runner import run_on_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [
    "product-sphere-D3-E1-M1000-N1000-inverse-distance",
    "product-cube-D3-E1-M1000-N1000-gaussian",
    "attention-sphere-D3-E1-M1000-N1000-exponential",
    "solver-cube-D3-E1-M2000-N2000-gaussian",
]
# Arrays only: their truth is too large for a CPU test, so it is stubbed
# out on the kmb_tpu side and not computed on ours.
LARGE = [
    "product-cube-kde-D3-E1-M10000-N10000-gaussian",
    "attention-normal-D64-E8-M10000-N10000-exponential",
    "product-normal-D784-E1-M10000-N10000-gaussian",
    "product-cube-D3-E1-M131072-N131072-gaussian",
    "product-sphere-D3-E1-M131072-N131072-inverse-distance",
]
ATTRS = ["task", "kernel", "point_type", "normalize_rows", "same_points",
         "density_estimation", "short_description", "description"]


def _jax_dataset(name, tmp_path, monkeypatch, with_truth):
    import h5py

    if not with_truth:
        monkeypatch.setattr(
            jax_datasets, "blocked_kernel_product",
            lambda *, source_points, target_points=None, source_signal=None,
            **_: np.zeros((len(source_points if target_points is None
                               else target_points),
                           1 if source_signal is None
                           else source_signal.shape[1])))
        monkeypatch.setattr("kmb_tpu.native.is_available", lambda: False)
    fn = str(tmp_path / "jax.hdf5")
    jax_datasets.DATASETS[name](fn)
    with h5py.File(fn, "r") as f:
        return {k: f[k][:] for k in f}, dict(f.attrs)


def test_same_registry():
    assert sorted(DATASETS) == sorted(jax_datasets.DATASETS)


@pytest.mark.parametrize("name", SMALL + LARGE)
def test_make_arrays_byte_identical(name, tmp_path, monkeypatch):
    want, attrs = _jax_dataset(name, tmp_path, monkeypatch,
                               with_truth=name in SMALL)
    got = make_arrays(name)
    assert got["name"] == name
    for key in ("source_points", "target_points", "source_signal"):
        assert got[key].dtype == want[key].dtype == np.float64
        assert got[key].tobytes() == want[key].tobytes(), key
    for key in ATTRS:
        assert got[key] == attrs[key], key
    if name in SMALL:
        truth = ground_truth(got, device="cpu")
        assert truth.tobytes() == want["target_signal"].tobytes()


def test_ground_truth_torch_path_matches_oracle(monkeypatch):
    # Above the pair threshold the CPU truth comes from the native oracle
    # where it is built, else from the float64 torch product; lower the
    # threshold and hide the native oracle to compare the torch product
    # with the numpy oracle.
    arrays = make_arrays(SMALL[0])
    want = ground_truth(arrays, device="cpu")
    monkeypatch.setattr("kmb_tpu_torch.datasets.NUMPY_TRUTH_MAX_PAIRS", 0)
    monkeypatch.setattr("kmb_tpu_torch.native.is_available", lambda: False)
    got = ground_truth(arrays, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("name", SMALL[:3])
def test_torch_product_matches_tpu_product(name):
    arrays = make_arrays(name)
    truth = ground_truth(arrays, device="cpu")
    results = []
    for algo in (
            TorchProduct(kernel=arrays["kernel"], dimension=3,
                         normalize_rows=arrays["normalize_rows"],
                         device="cpu"),
            TpuProduct(kernel=arrays["kernel"], dimension=3,
                       normalize_rows=arrays["normalize_rows"])):
        algo.prepare_data(source_points=arrays["source_points"],
                          target_points=arrays["target_points"],
                          same_points=arrays["same_points"],
                          density_estimation=arrays["density_estimation"])
        algo.fit()
        algo.prepare_query(source_signal=arrays["source_signal"])
        algo.query()
        results.append(algo.get_result())
        algo.done()
    got, want = results
    assert got.dtype == np.float64 and got.shape == truth.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, truth, rtol=2e-4, atol=2e-5)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        TorchProduct(kernel="gaussian", dimension=3)
    with pytest.raises(RuntimeError):
        ground_truth(make_arrays(SMALL[1]))


def test_run_on_arrays_cpu():
    arrays = make_arrays(SMALL[1])
    arrays["target_signal"] = ground_truth(arrays, device="cpu")
    definition = Definition(
        algorithm="torch-product-cpu",
        module="kmb_tpu_torch.algorithms.torch_engine",
        constructor="TorchProduct",
        arguments={"kernel": "gaussian", "dimension": 3, "device": "cpu"},
        query_argument_groups=[{}])
    (row,) = run_on_arrays(definition, arrays, runs=2)
    assert row.attrs["backend"] == "cpu"
    assert row.attrs["torch_device"] == "cpu"
    assert row.attrs["run_count"] == 2 and row.attrs["query_time"] > 0
    assert row.attrs["dataset"] == SMALL[1]
    np.testing.assert_array_equal(row.error,
                                  row.result - arrays["target_signal"])
    assert np.sqrt(np.mean(row.error ** 2)) < 1e-5


def test_cli_stores_rows_like_the_jax_harness(tmp_path):
    # The layout tests/test_harness.py::test_end_to_end_oracle_run reads.
    import h5py

    dataset = "product-sphere-D3-E1-M1000-N1000-inverse-distance"
    env = dict(os.environ, PYTHONPATH=REPO,
               KMB_DATA_DIR=str(tmp_path / "data"))
    proc = subprocess.run(
        [sys.executable, "-m", "kmb_tpu_torch", "--local", "--hardware",
         "CPU", "--dataset", dataset],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # The CPU tier: the plain PyTorch product beside the host baselines
    # (the numpy oracle at six precisions, the native oracle).
    rows = [props for props, _ in load_all_results(dataset)]
    assert sorted(props["algo"] for props in rows) == sorted(
        ["torch-product-cpu", "native-product"]
        + ["bruteforce-product-blas"] * 6)
    (props,) = [p for p in rows if p["algo"] == "torch-product-cpu"]
    assert props["run_count"] == 2
    assert props["build_time"] >= 0 and props["query_time"] > 0
    assert props["backend"] == "cpu"
    definition = Definition(
        algorithm="torch-product-cpu",
        module="kmb_tpu_torch.algorithms.torch_engine",
        constructor="TorchProduct",
        arguments={"kernel": "inverse-distance", "dimension": 3,
                   "normalize_rows": False, "precision": "float32",
                   "device": "cpu"},
        query_argument_groups=[{}])
    with h5py.File(get_result_filename(dataset, definition, {}), "r") as f:
        assert f["result"].shape == (1000, 1)
        assert np.sqrt(np.mean(f["error"][:] ** 2)) < 1e-3


def test_port_imports_no_jax_and_no_kmb_tpu():
    # Every module of the package, imported in a fresh interpreter: none
    # may pull in jax or kmb_tpu, and the card path needs no h5py, yaml or
    # psutil (the card's machine does not have them).
    code = """
import importlib, json, pkgutil, sys
import kmb_tpu_torch
names = ["kmb_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    kmb_tpu_torch.__path__, "kmb_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("kmb_tpu_torch.ops.product", "kmb_tpu_torch.ops.solve",
                   "kmb_tpu_torch.ops.blr", "kmb_tpu_torch.ops.lowrank",
                   "kmb_tpu_torch.algorithms.torch_engine",
                   "kmb_tpu_torch.algorithms.torch_approx",
                   "kmb_tpu_torch.parallel.multihost",
                   "kmb_tpu_torch.parallel.sharded",
                   "kmb_tpu_torch.algorithms.torch_sharded",
                   "kmb_tpu_torch.__main__",
                   "kmb_tpu_torch.algorithms.dummy",
                   "kmb_tpu_torch.algorithms.native_oracle",
                   "kmb_tpu_torch.native", "kmb_tpu_torch.run_algorithm",
                   "kmb_tpu_torch.plotting.metrics",
                   "kmb_tpu_torch.plotting.utils",
                   "kmb_tpu_torch.plotting.plot_variants",
                   "kmb_tpu_torch.plot", "kmb_tpu_torch.report",
                   "kmb_tpu_torch.website", "kmb_tpu_torch.create_dataset",
                   "kmb_tpu_torch.scaling", "kmb_tpu_torch.hdf5",
                   "kmb_tpu_torch.comm", "kmb_tpu_torch.install",
                   "kmb_tpu_torch.smoke", "kmb_tpu_torch.run_all"):
        assert module in report["modules"]
    loaded = report["loaded"]
    # Nor matplotlib or jinja2: the plots and the website import them
    # where they draw or render.
    for banned in ("jax", "jaxlib", "kmb_tpu", "h5py", "yaml", "psutil",
                   "matplotlib", "jinja2"):
        hits = [m for m in loaded
                if m == banned or m.startswith(banned + ".")]
        assert not hits, f"importing kmb_tpu_torch loaded {hits}"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# -- the nvcc + ctypes build, without nvcc -----------------------------------

def test_nvcc_command_line():
    # One compile per source (run together), then one link into the .so.
    cmd = _build.nvcc_command("nvcc", _build.SOURCE, _build.BUILD_DIR / "x.o")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-fPIC", "-c"):
        assert flag in cmd
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"
    assert cmd[-1] == str(_build.SOURCE)
    assert _build.SOURCE.name == "product.cu" and _build.SOURCE.exists()
    assert all(src.exists() for src in (*_build.SOURCES, *_build.HEADERS))
    link = _build.link_command("nvcc", ["a.o", "b.o"], _build.BUILD_DIR / "x.so")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert link[-2:] == ["a.o", "b.o"]


def test_defines_build_a_library_of_their_own(monkeypatch):
    # tools/wide_breakdown.py builds the kernels with measurement switches
    # into a library of its own; none is the package's own build.
    monkeypatch.setattr(_build, "_library", object())
    plain = _build.library_path("nvcc")
    assert not any(f.startswith("-D") for f in _build.nvcc_command(
        "nvcc", _build.SOURCE, _build.BUILD_DIR / "x.o"))
    try:
        _build.use_defines("KMB_NO_SIGNAL_LOADS")
        assert _build._library is None   # loaded again at the next launch
        cmd = _build.nvcc_command("nvcc", _build.SOURCE,
                                  _build.BUILD_DIR / "x.o")
        assert "-DKMB_NO_SIGNAL_LOADS" in cmd
        assert _build.library_path("nvcc") != plain
    finally:
        _build.use_defines()
    assert _build.DEFINES == () and _build.library_path("nvcc") == plain


def test_library_lands_in_the_ignored_build_directory():
    path = _build.library_path("nvcc")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libkmb_product_") and path.suffix == ".so"
    rel = os.path.relpath(_build.BUILD_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert rel + "/" in f.read().split()


def test_build_without_cuda_raises_clearly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.build()
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load_library()


def test_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_cuda_kernel_counts_only_accepted_launches(monkeypatch):
    class FakeLibrary:
        def __init__(self):
            self.code = 0

        def kmb_fake(self, *args):
            return self.code

        def kmb_last_staging(self, stages, resident, staged):
            pass   # zeros: a kernel that stages nothing through TMA

        def kmb_error_string(self, code):
            return b"invalid argument"

    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    kernel = _build.CudaKernel("kmb_fake")
    kernel(1, 2)
    kernel(3)
    assert kernel.launches == 2
    lib.code = 1
    with pytest.raises(RuntimeError, match="CUDA error 1 .invalid argument"):
        kernel()
    assert kernel.launches == 2


def test_cuda_kernel_counts_wide_launches_and_e_blocks(monkeypatch):
    # ... and the bytes the library reports each launch staged through TMA
    # (the large-D wide kernel: stages, x resident, bytes).
    staging = iter([(0, 0, 0), (6, 1, 1000), (4, 0, 24)])

    class FakeLibrary:
        def kmb_fake(self, *args):
            return 0

        def kmb_last_staging(self, stages, resident, staged):
            (stages._obj.value, resident._obj.value,
             staged._obj.value) = next(staging)

    monkeypatch.setattr(_build, "load_library", FakeLibrary)
    kernel = _build.CudaKernel("kmb_fake")
    kernel(1)                 # the narrow mode
    kernel(2, eblocks=1)      # the wide mode, one E block (E <= 256)
    kernel(3, eblocks=2)      # two E blocks (E = 512)
    assert (kernel.launches, kernel.wide_launches,
            kernel.wide_eblocks) == (3, 2, 3)
    assert kernel.staged_bytes == 1024
    assert kernel.last_staging == (4, 0, 24)
    monkeypatch.setattr(_build, "KERNELS", (kernel,))
    _build.reset_launch_counts()
    assert (kernel.launches, kernel.wide_launches,
            kernel.wide_eblocks) == (0, 0, 0)
    assert (kernel.staged_bytes, kernel.last_staging) == (0, (0, 0, 0))
