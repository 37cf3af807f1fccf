"""The port's native float64 oracle (kmb_tpu_torch.native, NativeProduct).

The cases of tests/test_native.py, held at its tolerance (1e-12 relative)
against the port's and kmb_tpu's `blocked_kernel_product` (and against
kmb_tpu.native where its library is built).  The port builds its own
library from native/kmb_native.cpp into the git-ignored
kmb_tpu_torch/_build/ and never writes into native/; a failed build
raises with the compiler's message.
"""

import os
import stat

import numpy as np
import pytest

from kmb_tpu import native as jax_native
from kmb_tpu.algorithms.bruteforce_numpy import (
    blocked_kernel_product as jax_blocked)

from kmb_tpu_torch import native
from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product
from kmb_tpu_torch.algorithms.native_oracle import NativeProduct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-12, atol=1e-12)


def _hold(out, **kw):
    """`out` against both packages' numpy oracles (and kmb_tpu's native
    library when it is built), at tests/test_native.py's tolerance."""
    for reference in (blocked_kernel_product, jax_blocked):
        np.testing.assert_allclose(out, reference(**kw), **TOL)
    if jax_native.is_available():
        kw.pop("block_rows", None)
        np.testing.assert_allclose(
            out, jax_native.native_kernel_product(**kw), **TOL)


def test_build_lands_in_the_ignored_build_directory():
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent == __import__("pathlib").Path(
        REPO, "kmb_tpu_torch", "_build")
    assert path.exists() and native.is_available()
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "kmb_tpu_torch/_build/" in f.read().split()
    cmd = native.compile_command(path)
    for flag in ("-O3", "-march=native", "-ffast-math", "-funroll-loops",
                 "-fopenmp", "-fPIC", "-std=c++17", "-shared", "-lmvec",
                 "-lm"):
        assert flag in cmd
    assert str(native.SOURCE) in cmd
    assert cmd[0] == "g++"
    assert native.num_threads() >= 1


@pytest.mark.parametrize("kernel", sorted(native.KERNEL_IDS))
@pytest.mark.parametrize("normalize", [False, True])
def test_matches_numpy_oracle(rng, kernel, normalize):
    y = rng.standard_normal((257, 5))
    x = rng.standard_normal((123, 5))
    b = rng.standard_normal((257, 3))
    out = native.native_kernel_product(
        kernel=kernel, source_points=y, target_points=x, source_signal=b,
        normalize_rows=normalize)
    _hold(out, kernel=kernel, source_points=y, target_points=x,
          source_signal=b, normalize_rows=normalize, block_rows=64)


def test_same_points_singular_diagonal(rng):
    y = rng.standard_normal((64, 3))
    b = rng.standard_normal((64, 1))
    out = native.native_kernel_product(
        kernel="inverse-distance", source_points=y, source_signal=b)
    assert np.isfinite(out).all()
    _hold(out, kernel="inverse-distance", source_points=y, source_signal=b,
          block_rows=16)


def test_row_offset_slab(rng):
    """A slab of target rows with row_offset masks the same global
    diagonal entries as the full evaluation."""
    y = rng.standard_normal((40, 3))
    b = rng.standard_normal((40, 1))
    full = native.native_kernel_product(
        kernel="inverse-distance", source_points=y, source_signal=b)
    slab = native.native_kernel_product(
        kernel="inverse-distance", source_points=y, target_points=y[10:30],
        source_signal=b, row_offset=10)
    np.testing.assert_allclose(slab, full[10:30], rtol=1e-12)
    _hold(full, kernel="inverse-distance", source_points=y, source_signal=b)


def test_density_rowsums(rng):
    y = rng.standard_normal((50, 4))
    out, rowsums = native.native_kernel_product(
        kernel="gaussian", source_points=y, return_rowsums=True)
    np.testing.assert_allclose(out[:, 0], rowsums, rtol=1e-12)
    _hold(out, kernel="gaussian", source_points=y)


@pytest.mark.parametrize("normalize", [False, True])
def test_native_product_through_the_runner(rng, normalize):
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.runner import run_on_arrays

    y = rng.standard_normal((100, 3))
    x = rng.standard_normal((80, 3))
    b = rng.standard_normal((100, 2))
    truth = native.native_kernel_product(
        kernel="exponential", source_points=y, target_points=x,
        source_signal=b, normalize_rows=normalize)
    arrays = dict(source_points=y, target_points=x, source_signal=b,
                  target_signal=truth, kernel="exponential",
                  point_type="float", same_points=False,
                  normalize_rows=normalize, density_estimation=False)
    definition = Definition(
        algorithm="native-product",
        module="kmb_tpu_torch.algorithms.native_oracle",
        constructor="NativeProduct",
        arguments={"kernel": "exponential", "dimension": 3,
                   "normalize_rows": normalize},
        query_argument_groups=[{}])
    (row,) = run_on_arrays(definition, arrays, runs=2)
    np.testing.assert_array_equal(row.result, truth)
    assert row.attrs["native_threads"] == native.num_threads()
    assert row.attrs["name"] == f"NativeProduct(threads={native.num_threads()})"
    _hold(row.result, kernel="exponential", source_points=y, target_points=x,
          source_signal=b, normalize_rows=normalize)


def test_native_product_in_harness(tmp_path, monkeypatch):
    # The JAX package's test_in_harness on the port's runner and store.
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.results import load_all_results
    from kmb_tpu_torch.runner import run

    monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / "results"))
    definition = Definition(
        algorithm="native-product",
        module="kmb_tpu_torch.algorithms.native_oracle",
        constructor="NativeProduct",
        arguments={"kernel": "inverse-distance", "dimension": 3},
        query_argument_groups=[{}])
    dataset = "product-sphere-D3-E1-M1000-N1000-inverse-distance"
    run(definition=definition, dataset=dataset, runs=1, device="cpu")
    rows = [(props, np.abs(np.asarray(f["error"])).max())
            for props, f in load_all_results(dataset)]
    assert len(rows) == 1
    props, err = rows[0]
    assert props["native_threads"] >= 1
    assert err < 1e-8   # float64 streaming oracle against float64 truth


def test_density_and_attention_lifecycle(rng):
    y = rng.standard_normal((60, 3))
    algo = NativeProduct(kernel="gaussian", dimension=3)
    algo.prepare_data(source_points=y, target_points=y, same_points=True,
                      density_estimation=True)
    algo.fit()
    algo.prepare_query(source_signal=None)
    algo.query()
    _hold(algo.get_result(), kernel="gaussian", source_points=y)
    algo = NativeProduct(kernel="gaussian", dimension=3, normalize_rows=True)
    algo.prepare_data(source_points=y, target_points=y, same_points=True,
                      density_estimation=True)
    algo.prepare_query(source_signal=None)
    algo.query()
    np.testing.assert_array_equal(algo.get_result(), np.ones((60, 1)))


def test_failed_build_raises_with_the_compilers_message(tmp_path,
                                                        monkeypatch):
    compiler = tmp_path / "broken-cxx"
    compiler.write_text("#!/bin/sh\necho 'broken-cxx: cannot compile' >&2\n"
                        "exit 3\n")
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "COMPILER", str(compiler))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.is_available()
    with pytest.raises(RuntimeError, match="broken-cxx: cannot compile"):
        native.build()
    # No quiet switch to the numpy oracle, in the product or the wrapper.
    with pytest.raises(RuntimeError, match="native oracle build failed"):
        native.native_kernel_product(kernel="gaussian",
                                     source_points=np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="native oracle build failed"):
        NativeProduct(kernel="gaussian", dimension=3)
    assert not native.is_available()
    assert os.listdir(tmp_path / "build") == []   # no half-written library


def test_compiler_ignores_cxx(monkeypatch):
    # CXX may name a toolchain that cannot link OpenMP.
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    assert native.compile_command("x.so")[0] == "g++"
    assert native.is_available()


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build()


def test_unknown_kernel_raises():
    with pytest.raises(NotImplementedError):
        native.native_kernel_product(kernel="cauchy",
                                     source_points=np.zeros((2, 3)))
    with pytest.raises(NotImplementedError):
        NativeProduct(kernel="cauchy", dimension=3)
