"""The port's approximate classes against kmb_tpu's, on the CPU.

`NystromProduct`, `RandomFeatureProduct`, `BlrProduct`, `NystromSolver`
and `BlrSolver` of kmb_tpu_torch.algorithms.torch_approx run through the
port's runner (`run_on_arrays`, device="cpu") on the registry's M = 1000
cube and sphere; their kmb_tpu.algorithms.tpu_approx counterparts run the
same lifecycle on the same arrays.  The port is handed the JAX package's
draws (landmarks, frequencies, the BLR test matrix) through its
constructor, so both compute the same approximation.  Tolerances:

- products: within 1e-4 relative Frobenius of JAX's result (float32
  chains of the same matmuls; the BLR product at tests/test_blr.py's
  rtol 2e-4, atol 2e-5);
- the Nystrom solver: its distance from the float64 Woodbury solve on
  the same landmarks within twice JAX's, or 2e-2 (the inner system at
  lam = 1e-2 amplifies float32 roundings by up to ||G|| / lam: both sit
  1-2% from it);
- the BLR solver: MINRES iterations within 5% (at least 2) of JAX's on
  the same operator, true residuals within 2x (or under ten times the
  tolerance: the stop reads a float32 recursive estimate);
  with refinement, outer iterations within one and the float64 residual
  within 10x, as tests/test_torch_solver_engine.py holds the refinement.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmb_tpu.algorithms.tpu_approx as tpu_approx
from kmb_tpu.ops import lowrank as jlr
from kmb_tpu_torch.algorithms import torch_approx
from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product
from kmb_tpu_torch.ops import lowrank as tlr
from kmb_tpu_torch.datasets import ground_truth, make_arrays
from kmb_tpu_torch.definitions import Definition, get_definitions
from kmb_tpu_torch.runner import run_on_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE = "product-cube-D3-E1-M1000-N1000-gaussian"
SPHERE = "product-sphere-D3-E1-M1000-N1000-inverse-distance"
ATTENTION = "attention-sphere-D3-E1-M1000-N1000-exponential"
SOLVER_CUBE = "solver-cube-D3-E1-M1000-N1000-gaussian"
SOLVER_SPHERE = "solver-sphere-D3-E1-M1000-N1000-inverse-distance"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the float32 roundings (and so where a Krylov
    loop stops) do not depend on the host's core count, and parallel test
    workers do not oversubscribe it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def datasets():
    out = {}
    for name in (CUBE, SPHERE, ATTENTION, SOLVER_CUBE, SOLVER_SPHERE):
        arrays = make_arrays(name)
        arrays["target_signal"] = ground_truth(arrays, device="cpu")
        out[name] = arrays
    return out


def jax_draws(constructor, arrays, args):
    """The JAX package's random draw for one configuration, as the port's
    constructor arguments."""
    y = jnp.asarray(np.asarray(arrays["source_points"], np.float32))
    seed = args.get("seed", 0)
    if constructor in ("NystromProduct", "NystromSolver"):
        rank = args.get("rank", 256 if constructor == "NystromProduct"
                        else 512)
        return {"landmarks": np.asarray(jlr.select_landmarks(y, rank,
                                                             seed=seed))}
    if constructor == "RandomFeatureProduct":
        omega, phase = jlr.random_feature_params(
            y.shape[1], arrays["kernel"], args.get("num_features", 1024),
            seed=seed)
        return {"omega": np.asarray(omega),
                "phase": None if phase is None else np.asarray(phase)}
    leaf = args.get("leaf", 256)
    rank = min(args.get("rank", 16 if constructor == "BlrProduct" else 64),
               leaf)
    return {"omega": np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (leaf, rank), dtype=jnp.float32))}


def run_both(constructor, arrays, args, query=None, runs=1):
    """(port row, JAX result, JAX get_additional) on the same arrays."""
    definition = Definition(
        algorithm=f"torch-{constructor}",
        module="kmb_tpu_torch.algorithms.torch_approx",
        constructor=constructor,
        arguments={"kernel": arrays["kernel"], "dimension": 3,
                   "normalize_rows": bool(arrays["normalize_rows"]),
                   "device": "cpu", **args,
                   **jax_draws(constructor, arrays, args)},
        query_argument_groups=[query or {}])
    (row,) = run_on_arrays(definition, arrays, runs=runs)
    algo = getattr(tpu_approx, constructor)(
        kernel=arrays["kernel"], dimension=3,
        normalize_rows=bool(arrays["normalize_rows"]), **args)
    if algo.task == "product":
        algo.prepare_data(source_points=arrays["source_points"],
                          target_points=arrays["target_points"],
                          same_points=bool(arrays["same_points"]),
                          density_estimation=bool(
                              arrays["density_estimation"]))
        algo.fit()
        algo.prepare_query(source_signal=arrays["source_signal"])
    else:
        algo.prepare_data(source_points=arrays["source_points"])
        algo.fit()
        algo.set_query_arguments(**(query or {}))
        algo.prepare_query(target_signal=arrays["target_signal"])
    algo.query()
    out = algo.get_result(), algo.get_additional(), str(algo)
    algo.done()
    return row, *out


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _keys(row, want_extra, name):
    assert set(want_extra) <= set(row.attrs), set(want_extra) - set(
        row.attrs)
    assert row.attrs["name"] == name
    assert row.attrs["backend"] == "cpu"
    assert row.attrs["torch_device"] == "cpu"


PRODUCTS = [
    ("NystromProduct", CUBE, {"rank": 128}, 1e-4),
    ("NystromProduct", ATTENTION, {"rank": 128}, 1e-4),
    ("RandomFeatureProduct", CUBE, {"num_features": 256}, 1e-4),
    ("RandomFeatureProduct", ATTENTION, {"num_features": 256}, 1e-4),
    ("RandomFeatureProduct", ATTENTION,
     {"num_features": 256, "stream_bytes": 0}, 1e-4),
    ("BlrProduct", CUBE, {"leaf": 256, "rank": 16, "eta": 2.0}, None),
    ("BlrProduct", SPHERE, {"leaf": 256, "rank": 64, "eta": 2.0,
                            "epsilon": 1e-3}, None),
]


@pytest.mark.parametrize("constructor, name, args, tol", PRODUCTS)
def test_products_match_tpu_approx(constructor, name, args, tol, datasets):
    arrays = datasets[name]
    row, want, want_extra, want_name = run_both(constructor, arrays, args,
                                                runs=2)
    _keys(row, want_extra, want_name)
    assert row.result.dtype == np.float64
    assert row.result.shape == arrays["target_signal"].shape
    np.testing.assert_array_equal(row.error,
                                  row.result - arrays["target_signal"])
    if tol is None:
        np.testing.assert_allclose(row.result, want, rtol=2e-4, atol=2e-5)
    else:
        assert _rel(row.result, want) < tol
    for key in ("rank", "num_features", "streaming", "near_pairs",
                "near_sym_pairs", "far_pairs", "symmetric"):
        if key in want_extra:
            assert row.attrs[key] == want_extra[key], key
    # Compression: the same formula on the same sizes (the JAX BLR
    # operator also counts its chunk padding, the port stores none).
    if constructor == "BlrProduct":
        assert 0 < row.attrs["compression"] and row.attrs[
            "mean_block_rank"] == pytest.approx(want_extra["mean_block_rank"],
                                                rel=0.02)
    else:
        assert row.attrs["compression"] == pytest.approx(
            want_extra["compression"])


def test_blr_product_density_and_attention(datasets):
    arrays = dict(datasets[CUBE], density_estimation=True)
    args = {"leaf": 256, "rank": 16, "eta": 2.0}
    row, want, _, _ = run_both("BlrProduct", arrays, args)
    np.testing.assert_allclose(row.result, want, rtol=2e-4, atol=2e-5)
    arrays = dict(datasets[CUBE], normalize_rows=True)
    row, want, _, _ = run_both("BlrProduct", arrays, args)
    np.testing.assert_allclose(row.result, want, rtol=2e-4, atol=2e-5)


def _true_residual(arrays, b):
    a = arrays["target_signal"]
    kb = blocked_kernel_product(kernel=arrays["kernel"],
                                source_points=arrays["source_points"],
                                source_signal=b)
    return float(np.linalg.norm(kb - a) / np.linalg.norm(a))


def test_nystrom_solver_matches_tpu_approx(datasets):
    arrays = datasets[SOLVER_CUBE]
    row, want, want_extra, want_name = run_both(
        "NystromSolver", arrays, {"rank": 512}, {"lam": 1e-2}, runs=2)
    _keys(row, want_extra, want_name)
    assert want_name == "NystromSolver(rank=512, lam=0.01)"
    assert row.attrs["compression"] == want_extra["compression"]
    # The float32 Woodbury solve of this ill-conditioned system sits 1-2%
    # from its float64 evaluation on the same landmarks in both packages
    # (the inner system amplifies roundings by up to ||G|| / lam): the
    # port's distance from it is held to twice JAX's, or 2e-2.
    landmarks = torch.tensor(jax_draws("NystromSolver", arrays,
                                       {"rank": 512})["landmarks"],
                             dtype=torch.float64)
    y64 = torch.tensor(np.asarray(arrays["source_points"], np.float32),
                       dtype=torch.float64)
    a64 = torch.tensor(np.asarray(arrays["target_signal"], np.float32),
                       dtype=torch.float64)
    c, gram = tlr.nystrom_solver_build(y64, landmarks, "gaussian")
    inner = 1e-2 * torch.eye(512, dtype=torch.float64) + gram
    exact = ((a64 - c @ torch.linalg.solve(inner, c.T @ a64)) / 1e-2).numpy()
    assert _rel(row.result, exact) <= max(2 * _rel(want, exact), 2e-2)


BLR_SOLVES = [
    # (dataset, query arguments)
    (SOLVER_SPHERE, {"tol": 1e-5, "max_iters": 2000}),
    (SOLVER_CUBE, {"tol": 1e-5, "max_iters": 2000}),
    (SOLVER_SPHERE, {"tol": 1e-8, "max_iters": 2000, "refine_iters": 3,
                     "inner_tol": 1e-4}),
]


@pytest.mark.parametrize("name, query", BLR_SOLVES)
def test_blr_solver_matches_tpu_approx(name, query, datasets):
    arrays = datasets[name]
    args = {"leaf": 256, "rank": 64, "eta": 2.0, "epsilon": 1e-4}
    row, want, want_extra, want_name = run_both("BlrSolver", arrays, args,
                                                query)
    _keys(row, want_extra, want_name)
    got_it, want_it = row.attrs["cg_iterations"], want_extra["cg_iterations"]
    assert abs(got_it - want_it) <= max(2, 0.05 * want_it), (got_it, want_it)
    got_res = _true_residual(arrays, row.result)
    want_res = _true_residual(arrays, want)
    if "refine_iters" in query:
        assert abs(row.attrs["ir_outer_iterations"]
                   - want_extra["ir_outer_iterations"]) <= 1
        assert got_res <= max(10 * want_res, query["tol"])
    else:
        # MINRES stops on its recursive residual estimate, which drifts
        # from the true residual in float32 by the roundings: hence the
        # floor of ten times the tolerance, as test_torch_solver_engine.py
        # holds the sphere's MINRES.
        assert "ir_outer_iterations" not in row.attrs
        assert got_res <= max(2 * want_res, 10 * query["tol"])
    # The reported true residual is the float32 product's, within 2x of
    # the float64 one (or under the tolerance).
    assert row.attrs["true_relative_residual"] <= max(2 * got_res, 1e-6)
    assert row.attrs["compression"] == pytest.approx(
        want_extra["compression"], rel=0.05)


def test_blr_solver_true_residual_uses_the_exact_product(monkeypatch,
                                                         datasets):
    arrays = datasets[SOLVER_SPHERE]
    calls = []
    real = torch_approx.kernel_matvec

    def spy(x, y, b, **kw):
        calls.append((x.dtype, b.dtype, kw))
        return real(x, y, b, **kw)

    monkeypatch.setattr(torch_approx, "kernel_matvec", spy)
    algo = torch_approx.BlrSolver(kernel="inverse-distance", dimension=3,
                                  rank=16, eta=2.0, device="cpu")
    algo.prepare_data(source_points=arrays["source_points"])
    algo.fit()
    algo.set_query_arguments(tol=1e-4, max_iters=300)
    algo.prepare_query(target_signal=arrays["target_signal"])
    algo.query()
    assert calls == [(torch.float32, torch.float32,
                      {"kernel_name": "inverse-distance",
                       "precision": "float32"})]
    extra = algo.get_additional()
    assert extra["true_relative_residual"] == pytest.approx(
        _true_residual(arrays, algo.get_result()), rel=1e-3)
    algo.done()
    assert algo.op is None and algo.y is None


@pytest.mark.parametrize("constructor", ["NystromProduct", "NystromSolver",
                                         "RandomFeatureProduct",
                                         "BlrProduct", "BlrSolver"])
def test_names_match_and_default_to_the_card(constructor):
    args = {"NystromProduct": {"rank": 64},
            "NystromSolver": {"rank": 64, "lam": 1e-3},
            "RandomFeatureProduct": {"num_features": 64},
            "BlrProduct": {"leaf": 128, "epsilon": 1e-3, "eta": 1.5},
            "BlrSolver": {"leaf": 128, "epsilon": 1e-4,
                          "refine_iters": 2}}[constructor]
    kw = dict(kernel="gaussian", dimension=3, **args)
    ours = getattr(torch_approx, constructor)(device="cpu", **kw)
    assert str(ours) == str(getattr(tpu_approx, constructor)(**kw))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(torch_approx, constructor)(**kw)


def test_blr_rejects_the_dot_kernel():
    for cls in (torch_approx.BlrProduct, torch_approx.BlrSolver):
        with pytest.raises(NotImplementedError):
            cls(kernel="exponential", dimension=3, device="cpu")


def test_same_points_share_one_factor(datasets):
    arrays = datasets[SOLVER_CUBE]
    y = arrays["source_points"]
    for cls, attrs in ((torch_approx.NystromProduct, ("zx", "zy")),
                       (torch_approx.RandomFeatureProduct,
                        ("phi_x", "phi_y"))):
        algo = cls(kernel="gaussian", dimension=3, device="cpu")
        algo.prepare_data(source_points=y, target_points=y, same_points=True)
        algo.fit()
        assert getattr(algo, attrs[0]) is getattr(algo, attrs[1])
        algo.done()
        assert getattr(algo, attrs[0]) is None


def test_random_features_stream_past_the_byte_limit(datasets):
    arrays = datasets[CUBE]
    results = {}
    for stream_bytes in (1 << 40, 1):
        algo = torch_approx.RandomFeatureProduct(
            kernel="gaussian", dimension=3, num_features=64,
            stream_bytes=stream_bytes, device="cpu")
        algo.prepare_data(source_points=arrays["source_points"],
                          target_points=arrays["target_points"])
        algo.fit()
        algo.prepare_query(source_signal=arrays["source_signal"])
        algo.query()
        results[stream_bytes] = algo.get_result()
        assert algo.get_additional()["streaming"] == (stream_bytes == 1)
        algo.done()
    # tests/test_lowrank.py:257.
    np.testing.assert_allclose(results[1], results[1 << 40], rtol=2e-5,
                               atol=2e-5)


def test_algos_yaml_mirrors_the_tpu_approx_groups():
    import yaml

    with open(os.path.join(REPO, "algos.yaml")) as f:
        jax_entries = yaml.safe_load(f)
    with open(os.path.join(REPO, "kmb_tpu_torch", "algos.yaml")) as f:
        entries = yaml.safe_load(f)
    pairs = (("torch-nystrom-product", "tpu-nystrom-product"),
             ("torch-blr-product", "tpu-blr-product"),
             ("torch-blr-solver", "blr-solver"),
             ("torch-nystrom-solver", "tpu-nystrom-solver"),
             ("torch-rff-product", "tpu-rff-product"))
    for ours, theirs in pairs:
        entry, reference = entries[ours], jax_entries[theirs]
        assert entry["hardware"] == "GPU"
        assert entry["module"] == "kmb_tpu_torch.algorithms.torch_approx"
        assert entry["constructor"] == reference["constructor"]
        for task in ("product", "attention", "solver"):
            assert entry.get(task, False) == reference.get(task, False)
        assert sorted(entry["run-groups"]) == sorted(reference["run-groups"])
        for group, spec in entry["run-groups"].items():
            want = reference["run-groups"][group]
            assert spec["datasets"] == want["datasets"], group
            assert spec["args"] == want["args"], group
            assert spec.get("query-args") == want.get("query-args"), group
    gpu = get_definitions(dataset=CUBE, task="product", hardware="GPU")
    assert {"torch-nystrom-product", "torch-blr-product",
            "torch-rff-product"} <= {d.algorithm for d in gpu}
    cpu = get_definitions(dataset=CUBE, task="product", hardware="CPU")
    assert {d.algorithm for d in cpu} == {"torch-product-cpu"}


def ridge_residual(c, b, a, lam):
    """||(lam I + C C^T) b - a|| / ||a|| in float64: how well a Nystrom
    solver's answer b solves its own ridge system."""
    c, b, a = (np.asarray(t, dtype=np.float64) for t in (c, b, a))
    return float(np.linalg.norm(lam * b + c @ (c.T @ b) - a)
                 / np.linalg.norm(a))


if __name__ == "__main__":
    # The ridge residual kmb_tpu's NystromSolver(rank=512, lam=1e-2)
    # reaches on the CPU on the registry's 131072-point Gaussian cube
    # (chip_smoke.py holds the port's to ten times it):
    #   KMB_PLATFORM=cpu PYTHONPATH=. python tests/test_torch_approx_engine.py
    # The float64 right-hand side is computed on the CPU (minutes).
    jax.config.update("jax_platforms", "cpu")
    arrays = make_arrays("solver-cube-D3-E1-M131072-N131072-gaussian")
    a = ground_truth(arrays, device="cpu")
    algo = tpu_approx.NystromSolver(kernel="gaussian", dimension=3,
                                    rank=512)
    algo.prepare_data(source_points=arrays["source_points"])
    algo.fit()
    algo.set_query_arguments(lam=1e-2)
    algo.prepare_query(target_signal=a)
    algo.query()
    print(f"{arrays['name']} NystromSolver(rank=512, lam=0.01): ridge "
          f"residual {ridge_residual(algo.c, algo.get_result(), a, 1e-2):.6e}")
