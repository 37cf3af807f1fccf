"""The port's solver classes against kmb_tpu's, on the CPU.

`TorchSolverDirect` and `TorchSolverCG` run through the port's runner
(`run_on_arrays`, device="cpu", the plain PyTorch product) on the registry's
M = 1000 solver datasets; `TpuSolverDirect` and `TpuSolverCG` run the same
lifecycle on the same arrays.  Results are compared by their float64 true
residual ||K b - a|| / ||a||: within 10x of the JAX package's or below the
stated floor.  The two packages draw the Nystrom sketch's test matrix from
different generators, and on these datasets the iteration count moves
with the draw by a factor of two and more; so the CG comparisons hand the
port the JAX package's test matrix (`jax_omega`) and hold iteration
counts to the 5% band of test_torch_solve.py.  The port's own draw is
tested there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.algorithms.tpu_engine import TpuSolverCG, TpuSolverDirect
import kmb_tpu_torch.algorithms.torch_engine as engine
from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product
from kmb_tpu_torch.algorithms.torch_engine import (
    TorchSolverCG, TorchSolverDirect)
from kmb_tpu_torch.datasets import ground_truth, make_arrays
from kmb_tpu_torch.definitions import Definition, get_definitions
from kmb_tpu_torch.runner import run_on_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE = "solver-cube-D3-E1-M1000-N1000-gaussian"
SPHERE = "solver-sphere-D3-E1-M1000-N1000-inverse-distance"
CG_KEYS = {"cg_iterations", "cg_relative_residual"}


@pytest.fixture(scope="module")
def datasets():
    out = {}
    for name in (CUBE, SPHERE):
        arrays = make_arrays(name)
        arrays["target_signal"] = ground_truth(arrays, device="cpu")
        out[name] = arrays
    return out


def _true_residual(arrays, b):
    a = arrays["target_signal"]
    kb = blocked_kernel_product(kernel=arrays["kernel"],
                                source_points=arrays["source_points"],
                                source_signal=b)
    return float(np.linalg.norm(kb - a) / np.linalg.norm(a))


def _definition(constructor, arrays, args, query):
    return Definition(
        algorithm=f"torch-{constructor}",
        module="kmb_tpu_torch.algorithms.torch_engine",
        constructor=constructor,
        arguments={"kernel": arrays["kernel"], "dimension": 3,
                   "device": "cpu", **args},
        query_argument_groups=[query])


def _tpu(cls, arrays, args, query):
    algo = cls(kernel=arrays["kernel"], dimension=3, **args)
    algo.prepare_data(source_points=arrays["source_points"])
    algo.fit()
    algo.set_query_arguments(**query)
    algo.prepare_query(target_signal=arrays["target_signal"])
    algo.query()
    out = algo.get_result(), algo.get_additional()
    algo.done()
    return out


@pytest.fixture
def jax_omega(monkeypatch):
    """The port's Nystrom factors from the JAX package's test matrix,
    jax.random.normal(PRNGKey(0), (m, rank)), which its sketch draws."""
    from kmb_tpu_torch.ops.solve import nystrom_factors

    def draw(matvec, m, rank, *, device, method="svd"):
        omega = jax.random.normal(jax.random.PRNGKey(0), (m, rank),
                                  jnp.float32)
        return nystrom_factors(matvec, torch.tensor(np.asarray(omega),
                                                    device=device),
                               method=method)

    monkeypatch.setattr(engine, "nystrom_preconditioner", draw)


def _compare(arrays, row, want, floor):
    assert row.result.dtype == np.float64
    assert row.result.shape == arrays["source_signal"].shape
    np.testing.assert_array_equal(row.error,
                                  row.result - arrays["source_signal"])
    # float32 Cholesky breaks down on the same matrices in both (NaN).
    assert np.isnan(row.result).any() == np.isnan(want).any()
    if np.isnan(want).any():
        return None, None
    got_res = _true_residual(arrays, row.result)
    want_res = _true_residual(arrays, want)
    assert got_res <= max(10 * want_res, floor), (got_res, want_res)
    return got_res, want_res


DIRECT = [(CUBE, "lu"), (CUBE, "cholesky"), (CUBE, "svd"), (SPHERE, "lu"),
          (SPHERE, "svd")]


@pytest.mark.parametrize("name, method", DIRECT)
def test_solver_direct_matches_tpu(name, method, datasets):
    arrays = datasets[name]
    args = {"precision": "float32", "method": method}
    (row,) = run_on_arrays(_definition("TorchSolverDirect", arrays, args, {}),
                           arrays, runs=2)
    want, _ = _tpu(TpuSolverDirect, arrays, args, {})
    assert row.attrs["name"] == f"TorchSolverDirect(float32, {method})"
    assert row.attrs["backend"] == "cpu" and row.attrs["run_count"] == 2
    # A float32 factorisation's residual floor at M = 1000.
    _compare(arrays, row, want, floor=1e-4)


def test_solver_direct_bfloat16_matches_tpu(datasets):
    arrays = datasets[SPHERE]
    args = {"precision": "bfloat16", "method": "lu"}
    (row,) = run_on_arrays(_definition("TorchSolverDirect", arrays, args, {}),
                           arrays, runs=1)
    want, _ = _tpu(TpuSolverDirect, arrays, args, {})
    # K from bf16 points: the residual against the exact K is the bf16
    # perturbation's, the same for both (within 2x).
    got_res, want_res = _compare(arrays, row, want, floor=0.0)
    assert 0.5 * want_res <= got_res <= 2.0 * want_res


CG = [
    # (dataset, constructor args, query args, residual floor)
    (CUBE, {"precond_rank": 256}, {"tol": 1e-6, "max_iters": 2000}, 1e-5),
    (SPHERE, {"precond": "jacobi", "leaf": 512},
     {"tol": 1e-5, "max_iters": 2000}, 1e-4),
    (SPHERE, {}, {"tol": 1e-5, "max_iters": 2000}, 1e-4),
    (SPHERE, {"precond_rank": 128}, {"tol": 1e-6, "max_iters": 2000}, 1e-4),
    (CUBE, {"precond_rank": 256, "refine_iters": 4},
     {"tol": 1e-9, "max_iters": 2000, "inner_tol": 1e-5}, 1e-6),
]


@pytest.mark.parametrize("name, args, query, floor", CG)
def test_solver_cg_matches_tpu(name, args, query, floor, datasets,
                               jax_omega):
    arrays = datasets[name]
    args = {"precision": "float32", **args}
    (row,) = run_on_arrays(_definition("TorchSolverCG", arrays, args, query),
                           arrays, runs=1)
    want, want_extra = _tpu(TpuSolverCG, arrays, args, query)
    extra = {k: row.attrs[k] for k in row.attrs if k in want_extra}
    assert set(extra) == set(want_extra)
    assert CG_KEYS <= set(extra)
    assert ("ir_outer_iterations" in extra) == ("refine_iters" in args)
    _compare(arrays, row, want, floor)
    got_it, want_it = extra["cg_iterations"], want_extra["cg_iterations"]
    assert abs(got_it - want_it) <= max(2, 0.05 * want_it), (got_it, want_it)
    if "ir_outer_iterations" in extra:
        assert abs(extra["ir_outer_iterations"]
                   - want_extra["ir_outer_iterations"]) <= 1
        assert extra["cg_relative_residual"] < 1e-6
    else:
        # The reported residual of the iterated operator, against JAX's.
        got_r = extra["cg_relative_residual"]
        want_r = want_extra["cg_relative_residual"]
        assert got_r <= max(10 * want_r, query["tol"])


def test_nystrom_rank_is_capped_at_m(monkeypatch):
    y = np.random.default_rng(0).random((40, 3))
    seen = []
    real = engine.nystrom_preconditioner

    def spy(op, m, rank, **kw):
        seen.append((m, rank))
        return real(op, m, rank, **kw)

    monkeypatch.setattr(engine, "nystrom_preconditioner", spy)
    algo = TorchSolverCG(kernel="gaussian", dimension=3, precond_rank=256,
                         device="cpu")
    algo.prepare_data(source_points=y)
    algo.fit()
    u, lam = algo._precond_fn.args
    assert seen == [(40, 40)] and u.shape == (40, 40) and lam.shape == (40,)
    algo.done()
    assert algo.y is None and algo._precond_fn is None


def test_solver_cg_lifecycle_reports_iterations(datasets):
    arrays = datasets[CUBE]
    algo = TorchSolverCG(kernel="gaussian", dimension=3, precond_rank=64,
                         device="cpu")
    assert algo.name == "TorchSolverCG(float32, tol=1e-06, rank=64)"
    algo.prepare_data(source_points=arrays["source_points"])
    algo.fit()
    algo.set_query_arguments(tol=1e-4, max_iters=500)
    assert algo.name == "TorchSolverCG(float32, tol=0.0001, rank=64)"
    algo.prepare_query(target_signal=arrays["target_signal"])
    algo.query()
    extra = algo.get_additional()
    assert extra["torch_device"] == "cpu"
    assert 0 < extra["cg_iterations"] <= 500
    assert extra["cg_relative_residual"] <= 1e-4
    assert "ir_outer_iterations" not in extra
    assert algo.get_result().dtype == np.float64
    algo.done()


def test_solver_names_match_the_tpu_classes():
    tag = {"precond": "jacobi", "leaf": 256, "refine_iters": 2}
    torch_cg = TorchSolverCG(kernel="gaussian", dimension=3, device="cpu",
                             **tag)
    tpu_cg = TpuSolverCG(kernel="gaussian", dimension=3, **tag)
    assert torch_cg.name == tpu_cg.name.replace("TpuSolverCG",
                                                "TorchSolverCG")
    direct = TorchSolverDirect(kernel="gaussian", dimension=3, method="svd",
                               device="cpu")
    assert direct.name == "TorchSolverDirect(float32, svd)"


@pytest.mark.parametrize("cls", [TorchSolverCG, TorchSolverDirect])
def test_solvers_default_to_the_card(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(kernel="gaussian", dimension=3)


@pytest.mark.parametrize("bad", [{"precond": "ilu"},
                                 {"precision": "float16"}])
def test_solver_cg_refuses_unknown_options(bad):
    with pytest.raises(ValueError):
        TorchSolverCG(kernel="gaussian", dimension=3, device="cpu", **bad)


def test_algos_yaml_mirrors_the_tpu_solver_groups():
    import yaml

    with open(os.path.join(REPO, "algos.yaml")) as f:
        jax_entries = yaml.safe_load(f)
    with open(os.path.join(REPO, "kmb_tpu_torch", "algos.yaml")) as f:
        entries = yaml.safe_load(f)
    for ours, theirs, cls in (("torch-solver-direct", "tpu-solver-direct",
                               "TorchSolverDirect"),
                              ("torch-solver-cg", "tpu-solver-cg",
                               "TorchSolverCG")):
        entry, reference = entries[ours], jax_entries[theirs]
        assert entry["hardware"] == "GPU" and entry["solver"] is True
        assert entry["constructor"] == cls
        assert sorted(entry["run-groups"]) == sorted(reference["run-groups"])
        for group, spec in entry["run-groups"].items():
            want = reference["run-groups"][group]
            assert spec["datasets"] == want["datasets"], group
            assert spec["args"] == want["args"], group
            assert spec.get("query-args") == want.get("query-args"), group
    cpu = entries["torch-solver-cpu"]
    assert cpu["hardware"] == "CPU"
    for spec in cpu["run-groups"].values():
        assert spec["datasets"] == ["solver-*-M1000-*", "solver-*-M2000-*"]
        assert all(args["device"] == "cpu" for args in spec["args"])


def test_definitions_pick_the_solvers_by_tier():
    gpu = get_definitions(dataset=CUBE, task="solver", hardware="GPU")
    cpu = get_definitions(dataset=CUBE, task="solver", hardware="CPU")
    # The host baseline bruteforce-solver-blas rides along in every tier.
    assert {d.algorithm for d in gpu} == {
        "torch-solver-direct", "torch-solver-cg", "torch-solver-cpu",
        "torch-blr-solver", "torch-nystrom-solver",
        "torch-sharded-solver-cg", "bruteforce-solver-blas"}
    assert {d.algorithm for d in cpu} == {"torch-solver-cpu",
                                          "bruteforce-solver-blas"}
    big = get_definitions(dataset="solver-cube-D3-E1-M131072-N131072-"
                          "gaussian", task="solver", hardware="GPU")
    assert {d.algorithm for d in big} == {
        "torch-solver-cg", "torch-blr-solver", "torch-nystrom-solver",
        "torch-sharded-solver-cg", "bruteforce-solver-blas"}
