"""The Nystrom-preconditioned CG of `TorchSolverCG` on the CPU against
float64 kernel products, and the spans and counter of its Krylov loop
(`ops/solve.py`).

The right-hand sides are those of the benchmark's solve cell: a = K w for
standard normal w, K w in float64.  An answer is held to its float64 true
residual ||K b - a|| / ||a||, and at a well-conditioned size (512 points
over a cube sixteen times wider, where K is near the identity) to b from
a dense float64 solve.  This file imports neither jax nor kmb_tpu.
"""

import numpy as np
import pytest
import torch

from kmb_tpu_torch import trace
from kmb_tpu_torch.algorithms.torch_engine import TorchSolverCG
from kmb_tpu_torch.ops import solve

N, RANK, TOL = 2048, 64, 1e-5


def _gram64(points):
    """The Gaussian kernel matrix of `points` in float64."""
    x = torch.as_tensor(points, dtype=torch.float64)
    d = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    return torch.exp(-d * d)


def _problem(seed, n=N, scale=1.0, columns=1):
    rng = np.random.default_rng(seed)
    points = (scale * rng.random((n, 3))).astype(np.float32)
    w = torch.as_tensor(rng.standard_normal((n, columns)))
    return points, (_gram64(points) @ w).numpy()


def _fitted(points, tol=TOL, rank=RANK):
    engine = TorchSolverCG(kernel="gaussian", dimension=3, device="cpu",
                           precond="nystrom", precond_rank=rank, tol=tol)
    engine.prepare_data(source_points=points)
    engine.fit()
    return engine


def _solve(engine, a):
    engine.prepare_query(target_signal=a)
    engine.query()
    return engine.get_result()


def _true_residual(points, b, a):
    kb = (_gram64(points) @ torch.as_tensor(b, dtype=torch.float64)).numpy()
    return np.linalg.norm(kb - a, axis=0) / np.linalg.norm(a, axis=0)


# -- against float64 ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12, 13, 2**31 + 5])
def test_nystrom_pcg_meets_its_tolerance_in_float64(seed):
    points, a = _problem(seed)
    engine = _fitted(points)
    b = _solve(engine, a)
    assert engine.residual <= TOL and 0 < engine.iterations < 1000
    assert float(_true_residual(points, b, a)[0]) <= 2 * TOL


@pytest.mark.parametrize("seed", [3, 4])
def test_nystrom_pcg_matches_a_dense_solve_where_well_conditioned(seed):
    # 512 points over a cube 16 times wider: condition number about 80,
    # so a residual of 1e-6 holds b to about 1e-4 of a dense float64 solve.
    tol = 1e-6
    points, a = _problem(seed, n=512, scale=16.0)
    b = _solve(_fitted(points, tol=tol), a)
    assert float(_true_residual(points, b, a)[0]) <= 2 * tol
    want = torch.linalg.solve(_gram64(points), torch.as_tensor(a)).numpy()
    assert np.linalg.norm(b - want) <= 1e-4 * np.linalg.norm(want)


# -- spans and counter ------------------------------------------------------------

def _children(spans, index):
    return [s.name for s in spans if s.parent == index]


def test_a_traced_solve_has_the_loop_spans_once_an_iteration():
    points, a = _problem(8)
    engine = _fitted(points)
    with trace.recording() as rec:
        _solve(engine, a)
    names = [s.name for s in rec.spans]
    top = [s.name for s in rec.spans if s.parent == -1]
    assert top == ["engine.stage_signal", "pcg", "fence.wait", "fence.check",
                   "engine.read"]
    pcg = names.index("pcg")
    inside = _children(rec.spans, pcg)
    iterations = engine.iterations
    # One of each before the loop (the first residual's), then one an
    # iteration; a matvec an iteration.
    assert inside.count("pcg.precond") == iterations + 1
    assert inside.count("pcg.stop") == iterations + 1
    assert inside.count("matvec") == iterations
    assert set(inside) == {"pcg.precond", "pcg.stop", "matvec"}
    assert rec.counts == {"pcg_iterations": iterations}
    assert names.count("pcg") == 1


def test_an_unpreconditioned_solve_counts_its_iterations():
    points, a = _problem(9, n=256, scale=8.0)
    y = torch.as_tensor(points)
    with trace.recording() as rec:
        b, iterations, residual = solve.cg_solve(
            y, torch.as_tensor(a, dtype=torch.float32),
            kernel_name="gaussian", tol=TOL)
    assert residual <= TOL
    assert rec.counts == {"pcg_iterations": iterations}
    assert [s.name for s in rec.spans].count("pcg.stop") == iterations + 1


def test_the_nystrom_build_has_its_sketch_inside_its_factor():
    points, _ = _problem(10, n=512)
    engine = TorchSolverCG(kernel="gaussian", dimension=3, device="cpu",
                           precond="nystrom", precond_rank=32)
    engine.prepare_data(source_points=points)
    with trace.recording() as rec:
        engine.fit()
    # The fit's fence follows the build.
    spans = rec.spans
    assert [s.name for s in spans] == ["nystrom.factor", "nystrom.sketch",
                                       "matvec", "fence.wait", "fence.check"]
    assert [s.parent for s in spans] == [-1, 0, 1, -1, -1]
    assert rec.counts == {}


def test_tracing_changes_no_bit_of_a_solve():
    points, a = _problem(11, columns=2)
    engine = _fitted(points)
    plain = _solve(engine, a)
    plain_iterations = engine.iterations
    with trace.recording() as rec:
        traced = _solve(engine, a)
    assert rec.counts["pcg_iterations"] == engine.iterations
    assert engine.iterations == plain_iterations
    assert np.array_equal(plain, traced)
    again = _solve(engine, a)
    assert np.array_equal(plain, again)
