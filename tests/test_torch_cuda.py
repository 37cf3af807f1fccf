"""Card-only tests of the CUDA kernels and the solvers on them (marked
`cuda`; skip without a card).

This file imports neither jax nor kmb_tpu, so it also runs on a machine
with the card and no JAX, without the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel is held against the plain PyTorch version on the same card and
inputs: 1e-4 of the largest output in the f32 tiers (different summation
orders; the large-D form is 3xTF32), 2e-2 in the bfloat16 tier (the kernel
rounds each flash weight against the running max, the plain version
against the final max), 1e-3 for logits above 100 (tests/test_ops.py:82).
The solvers on the kernel are held against the same solve on the plain
version on the card: iteration counts within 5% (at least 2; the plain
version's own spread over orderings on the ill-conditioned cases named at
SOLVES), residuals within 2x or at the tolerance (the roundings of two
float32 products set where a Krylov loop stops, as in
tests/test_torch_solve.py).  The kernel's float32 sum over 131072 columns
is held to within 2x of the plain version's error against float64.
"""

import numpy as np
import pytest
import torch

from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.ops import solve
from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch

ALL_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
               "exponential"]
TOL = {"float32": 1e-4, "float32x3": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda_points():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def make(n, m, d, e, seed=0):
        rng = np.random.default_rng(seed)
        return tuple(
            torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in (rng.standard_normal((n, d)) / np.sqrt(d),
                      rng.standard_normal((m, d)) / np.sqrt(d),
                      rng.standard_normal((m, e))))

    return make


def _close(got, want, tol=1e-4):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 64, 784])
@pytest.mark.parametrize("normalize", [False, True])
def test_kernels_match_plain_version(kernel, d, normalize, cuda_points):
    # Ragged N and M; M above the split threshold, so partial states merge.
    x, y, b = cuda_points(517, 1203, d, 8)
    kw = dict(kernel_name=kernel, normalize_rows=normalize)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [9, 37, 130])
@pytest.mark.parametrize("normalize", [False, True])
def test_tile_edges_match_plain_version(tier, kernel, d, normalize,
                                        cuda_points):
    # D not a multiple of 8 or 32; N and M not multiples of 16, 64 or 128.
    x, y, b = cuda_points(301, 1203, d, 5)
    kw = dict(kernel_name=kernel, normalize_rows=normalize, precision=tier)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw),
           TOL[tier])


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 2, 4, 8, 13])
@pytest.mark.parametrize("d", [3, 64])
@pytest.mark.parametrize("normalize", [False, True])
def test_signal_widths_match_plain_version(e, d, normalize, cuda_points):
    x, y, b = cuda_points(211, 999, d, e)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 64, 130])
@pytest.mark.parametrize("normalize", [False, True])
def test_limits_ending_inside_a_tile(d, normalize, cuda_points):
    # Row and column limits that end inside a 128-wide tile, the diagonal
    # crossing both tile kinds.
    x, y, b = cuda_points(517, 1203, d, 3)
    kw = dict(kernel_name="gaussian", normalize_rows=normalize, deferred=True,
              row_offset=40, col_offset=3, row_limit=40 + 200,
              col_limit=3 + 700, mask_diagonal=True)
    got = kernel_matvec(x, y, b, **kw)
    want = kernel_matvec_torch(x, y, b, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        masked = w.abs() >= 1e29
        assert torch.equal(g.abs() >= 1e29, masked)
        _close(g[~masked], w[~masked])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
def test_large_logits_on_the_tensor_cores(tier, cuda_points):
    rng = np.random.default_rng(3)
    x, y, b = (torch.tensor(a, dtype=torch.float32, device="cuda")
               for a in (3.0 * rng.standard_normal((161, 64)),
                         3.0 * rng.standard_normal((243, 64)),
                         rng.standard_normal((243, 1))))
    assert float((x @ y.T).max()) > 100.0
    kw = dict(kernel_name="exponential", normalize_rows=True, precision=tier)
    _close(kernel_matvec(x, y, b, **kw), kernel_matvec_torch(x, y, b, **kw),
           max(1e-3, TOL[tier]))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize,which", [(False, "DIRECT"),
                                             (True, "FLASH")])
def test_each_launch_is_counted(normalize, which, cuda_points):
    x, y, b = cuda_points(300, 700, 3, 11)  # 11 columns: two launches
    kernel = getattr(_build, which)
    before = kernel.launches
    kernel_matvec(x, y, b, kernel_name="gaussian", normalize_rows=normalize)
    assert kernel.launches == before + 2


@pytest.mark.cuda
def test_deferred_flash_state_with_limits(cuda_points):
    x, y, b = cuda_points(517, 1203, 64, 1)
    kw = dict(kernel_name="gaussian", normalize_rows=True, deferred=True,
              row_offset=7, col_offset=2, row_limit=7 + 500,
              col_limit=2 + 1100, mask_diagonal=True)
    got = kernel_matvec(x, y, b, **kw)
    want = kernel_matvec_torch(x, y, b, **kw)
    for g, w in zip(got, want):
        masked = w.abs() >= 1e29   # rows past row_limit keep m = -1e30
        assert torch.equal(g.abs() >= 1e29, masked)
        _close(g[~masked], w[~masked])


@pytest.mark.cuda
def test_float64_on_the_card_raises(cuda_points):
    x, y, b = (t.double() for t in cuda_points(8, 9, 3, 1))
    with pytest.raises(TypeError, match="float32"):
        kernel_matvec(x, y, b, kernel_name="gaussian")


# -- the solvers on the direct kernel -----------------------------------------

@pytest.fixture
def solver_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from kmb_tpu_torch.datasets import make_arrays

    def make(name, kernel=None):
        """(kernel, float32 points, float32 rhs = K b in float64) of a
        registry dataset, on the card; `kernel` overrides its kernel."""
        arrays = make_arrays(name)
        kernel = kernel or arrays["kernel"]
        y64 = torch.tensor(arrays["source_points"], device="cuda")
        b64 = torch.tensor(arrays["source_signal"], device="cuda")
        rhs = kernel_matvec_torch(y64, y64, b64, kernel_name=kernel)
        return kernel, y64.float(), rhs.float()

    return make


def _plain_matvec(y, kernel):
    def matvec(v):
        return kernel_matvec_torch(y, y, v, kernel_name=kernel)
    return matvec


# (dataset, preconditioner, indefinite_method, tol, band of iteration
# counts).  The band is how far the plain version's own count moves when
# the same problem is given in another order (other float32 roundings):
# its largest departure from the count in the registry's order, over
# eight orderings (solver_accuracy.py part 3, on an H100): 116 of 284
# for unpreconditioned CG on the Gaussian cube (condition beyond float32);
# 5% where that departure is smaller (at most 3.9%).  CG on the normal
# equations (condition squared, 264 of 489) is held over nine orderings
# below.
SOLVES = [
    ("solver-cube-D3-E1-M2000-N2000-gaussian", None, "auto", 1e-6, 0.41),
    ("solver-cube-D3-E1-M2000-N2000-gaussian", "jacobi", "auto", 1e-6,
     0.05),
    ("solver-sphere-D3-E1-M2000-N2000-inverse-distance", None, "auto", 1e-5,
     0.05),
    ("solver-sphere-D3-E1-M2000-N2000-inverse-distance", "jacobi", "minres",
     1e-5, 0.05),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, precond, method, tol, band", SOLVES)
def test_krylov_on_the_kernel_matches_plain_version(name, precond, method,
                                                    tol, band,
                                                    solver_problem):
    kernel, y, rhs = solver_problem(name)
    pc = (solve.block_jacobi_preconditioner(y, kernel_name=kernel, leaf=512)
          if precond == "jacobi" else None)
    kw = dict(kernel_name=kernel, tol=tol, max_iters=2000, precond=pc,
              indefinite_method=method)
    before = _build.DIRECT.launches
    b, it, res = solve.cg_solve(y, rhs, **kw)
    launched = _build.DIRECT.launches - before
    pb, pit, pres = solve.cg_solve(y, rhs,
                                   matvec=_plain_matvec(y, kernel), **kw)
    assert _build.DIRECT.launches - before == launched   # plain: none
    assert launched >= it > 0
    assert abs(it - pit) <= max(2, band * pit), (it, pit)
    # Both converge alike: within 2x of the plain solve's residual, or to
    # the tolerance.
    assert res <= max(2.0 * pres, tol), (res, pres)
    assert b.is_cuda and bool(torch.isfinite(b).all())


@pytest.mark.cuda
def test_normal_equations_match_plain_version_over_orderings(solver_problem):
    # CG on K^2 (band 0.54: 264 of 489) stops either near 4e-6 after
    # about 500 iterations or near 2e-5 after about 340, by the roundings:
    # one ordering against one is a draw (the plain version fails that
    # comparison against itself in 5 of 7 orderings), so the medians over
    # nine orderings, the registry's and eight permutations, are compared,
    # to the band and factor of a single solve.  Every solve must launch
    # the kernel twice per iteration, the plain one never.
    name = "solver-sphere-D3-E1-M2000-N2000-inverse-distance"
    kernel, y0, rhs0 = solver_problem(name)
    kw = dict(kernel_name=kernel, tol=1e-6, max_iters=2000,
              indefinite_method="normal")
    runs = []
    for seed in [None, *range(8)]:
        y, rhs = y0, rhs0
        if seed is not None:
            perm = torch.randperm(len(y0), device="cuda", generator=(
                torch.Generator(device="cuda").manual_seed(seed)))
            y, rhs = y0[perm].contiguous(), rhs0[perm].contiguous()
        before = _build.DIRECT.launches
        b, it, res = solve.cg_solve(y, rhs, **kw)
        launched = _build.DIRECT.launches - before
        _, pit, pres = solve.cg_solve(y, rhs,
                                      matvec=_plain_matvec(y, kernel), **kw)
        assert _build.DIRECT.launches - before == launched   # plain: none
        assert launched >= 2 * it > 0
        assert b.is_cuda and bool(torch.isfinite(b).all())
        runs.append((it, res, pit, pres))
    it, res, pit, pres = np.median(np.array(runs), axis=0)
    assert abs(it - pit) <= 0.54 * pit, runs
    assert res <= max(2.0 * pres, 1e-6), runs


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "solver-cube-D3-E1-M131072-N131072-gaussian",
    "solver-sphere-D3-E1-M131072-N131072-inverse-distance"])
def test_direct_sum_as_accurate_as_plain_version(name, solver_problem):
    # A single float32 chain per row over a split's columns is off by
    # 1.6e-6 on the cube, 6.7x the plain version's 2.4e-7
    # (solver_accuracy.py): enough to stall the Krylov solves.  Rows
    # 0:1024 of the whole product (so the kernel splits its columns as the
    # solvers' calls do) against float64 from the same float32 inputs.
    kernel, y, _ = solver_problem(name)
    b = torch.randn((len(y), 1), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    rows = slice(0, 1024)
    exact = kernel_matvec_torch(y[rows].double(), y.double(), b.double(),
                                kernel_name=kernel)
    err = [float(torch.linalg.norm(fn(y, y, b, kernel_name=kernel)[rows]
                                   .double() - exact)
                 / torch.linalg.norm(exact))
           for fn in (kernel_matvec, kernel_matvec_torch)]
    assert err[0] <= 2.0 * err[1], err


@pytest.mark.cuda
def test_nystrom_sketch_on_the_kernel_matches_plain_version(solver_problem):
    kernel, y, _ = solver_problem("solver-cube-D3-E1-M2000-N2000-gaussian")
    omega = torch.randn((2000, 256), generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    before = _build.DIRECT.launches
    u, lam = solve.nystrom_factors(
        solve._default_matvec(y, kernel_name=kernel, precision="float32"),
        omega)
    assert _build.DIRECT.launches - before == 256 // 8
    pu, plam = solve.nystrom_factors(_plain_matvec(y, kernel), omega)
    # The factors of two f32 sketches: U diag(lam) U^T within 1e-4 of
    # lam_0 (tests/test_torch_solve.py's bound for two packages).
    _close((u * lam) @ u.T, (pu * plam) @ pu.T)


@pytest.mark.cuda
def test_nystrom_gram_ignores_a_process_wide_tf32(solver_problem):
    kernel, y, _ = solver_problem("solver-cube-D3-E1-M2000-N2000-gaussian")
    omega = torch.randn((2000, 64), generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda")
    op = _plain_matvec(y, kernel)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = solve.nystrom_factors(op, omega)
        a = torch.randn((512, 512), device="cuda")
        exact = a @ a
        torch.set_float32_matmul_precision("high")
        # The setting is live: a bare matmul now runs on TF32 ...
        assert not torch.allclose(a @ a, exact, rtol=1e-5, atol=1e-5)
        # ... and the solver's Gram and factors do not.
        got = solve.nystrom_factors(op, omega)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * float(
            w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["lu", "cholesky", "svd"])
def test_dense_solve_on_the_card_matches_the_cpu(method, solver_problem):
    # Cholesky on an SPD system on which float32 Cholesky does not break.
    kernel, y, rhs = (
        solver_problem("solver-cube-D3-E1-M1000-N1000-gaussian",
                       "absolute-exponential") if method == "cholesky" else
        solver_problem("solver-sphere-D3-E1-M2000-N2000-inverse-distance"))
    kw = dict(kernel_name=kernel, method=method)
    got = solve.dense_solve(y, rhs, **kw)
    want = solve.dense_solve(y.cpu(), rhs.cpu(), **kw)
    res = [float(torch.linalg.norm(kernel_matvec_torch(
        y.cpu().double(), y.cpu().double(), b.cpu().double(),
        kernel_name=kernel) - rhs.cpu().double()) / torch.linalg.norm(
            rhs.cpu().double())) for b in (got, want)]
    # cuSOLVER and LAPACK factor the same f32 matrix: residuals within 10x
    # of each other or at the f32 floor.
    assert res[0] <= max(10 * res[1], 1e-5), res


@pytest.mark.cuda
def test_f64_residual_matvec_on_the_card(solver_problem):
    kernel, y, rhs = solver_problem(
        "solver-sphere-D3-E1-M1000-N1000-inverse-distance")
    from kmb_tpu_torch.algorithms.bruteforce_numpy import (
        blocked_kernel_product)

    v = rhs.double()
    got = solve.f64_residual_matvec(y, kernel_name=kernel)(v)
    want = blocked_kernel_product(kernel=kernel,
                                  source_points=y.double().cpu().numpy(),
                                  source_signal=v.cpu().numpy())
    assert got.is_cuda and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.cuda
def test_solver_cg_lifecycle_on_the_card(solver_problem):
    from kmb_tpu_torch.algorithms.torch_engine import TorchSolverCG

    kernel, y, rhs = solver_problem("solver-cube-D3-E1-M2000-N2000-gaussian")
    algo = TorchSolverCG(kernel=kernel, dimension=3, precond_rank=256,
                         refine_iters=3)
    assert algo.device.type == "cuda"
    algo.prepare_data(source_points=y.cpu().numpy())
    algo.fit()
    algo.set_query_arguments(tol=1e-9, max_iters=2000, inner_tol=1e-5)
    algo.prepare_query(target_signal=rhs.cpu().numpy())
    before = _build.DIRECT.launches
    algo.query()
    extra = algo.get_additional()
    assert _build.DIRECT.launches - before >= extra["cg_iterations"] > 0
    assert extra["ir_outer_iterations"] >= 1
    assert extra["device_name"] == torch.cuda.get_device_name()
    assert algo.get_result().dtype == np.float64
    algo.done()


# The approximate engines on the card (ops/blr.py, ops/lowrank.py,
# algorithms/torch_approx.py): held against the same computation on the
# CPU, with the ranks and matvec tolerances of tests/test_torch_blr.py.
BLR_ARGS = dict(kernel_name="inverse-distance", leaf=64, rank=64, eta=2.0,
                epsilon=1e-4, same_points=True)   # 484 far pairs at M = 2000


@pytest.fixture
def blr_problem(solver_problem):
    _, y, rhs = solver_problem(
        "solver-sphere-D3-E1-M2000-N2000-inverse-distance")
    from kmb_tpu_torch.ops import blr

    omega = blr.draw_test_matrix(64, 64, 0, device="cpu")
    return y.cpu().numpy(), rhs, omega


@pytest.mark.cuda
def test_blr_build_and_matvec_on_the_card_match_the_cpu(blr_problem):
    from kmb_tpu_torch.ops import blr

    y, rhs, omega = blr_problem
    card = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
    host = blr.BlrOperator(y, y, omega=omega, device="cpu", **BLR_ARGS)
    assert card.block_ranks.size > 100
    assert np.mean(card.block_ranks == host.block_ranks) >= 0.99
    assert np.abs(card.block_ranks - host.block_ranks).max() <= 1
    got = card.matvec(rhs)
    assert got.is_cuda
    _close(got.cpu(), host.matvec(rhs.cpu()), 5e-4)


@pytest.mark.cuda
def test_blr_matvec_on_the_card_is_bit_identical(blr_problem):
    from kmb_tpu_torch.ops import blr

    y, rhs, omega = blr_problem
    op = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
    first = op.matvec(rhs)
    assert all(torch.equal(first, op.matvec(rhs)) for _ in range(3))


@pytest.mark.cuda
def test_blr_build_ignores_a_process_wide_tf32(blr_problem):
    from kmb_tpu_torch.ops import blr

    y, rhs, omega = blr_problem
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
        a = torch.randn((512, 512), device="cuda")
        exact = a @ a
        torch.set_float32_matmul_precision("high")
        # The setting is live: a bare matmul now runs on TF32 ...
        assert not torch.allclose(a @ a, exact, rtol=1e-5, atol=1e-5)
        # ... and the build and the matvec do not.
        got = blr.BlrOperator(y, y, omega=omega, device="cuda", **BLR_ARGS)
        np.testing.assert_array_equal(got.block_ranks, want.block_ranks)
        assert torch.equal(got.matvec(rhs), want.matvec(rhs))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.cuda
def test_blr_solver_true_residual_is_one_direct_launch(blr_problem):
    from kmb_tpu_torch.algorithms.torch_approx import BlrSolver

    y, rhs, _ = blr_problem
    algo = BlrSolver(kernel="inverse-distance", dimension=3, rank=64,
                     epsilon=1e-4, tol=1e-5, max_iters=2000)
    assert algo.device.type == "cuda"
    algo.prepare_data(source_points=y)
    algo.fit()
    algo.prepare_query(target_signal=rhs.cpu().numpy())
    before = _build.DIRECT.launches
    algo.query()
    assert _build.DIRECT.launches - before == 1
    extra = algo.get_additional()
    assert extra["cg_iterations"] > 0
    before = _build.DIRECT.launches
    residual = algo._true_residual(algo.res)
    assert _build.DIRECT.launches - before == 1
    assert residual == pytest.approx(extra["true_relative_residual"])
    assert algo.get_result().dtype == np.float64
    algo.done()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "exponential"])
def test_streamed_random_features_match_materialised(kernel, cuda_points):
    from kmb_tpu_torch.ops import lowrank

    x, y, b = cuda_points(5000, 7000, 8, 3)
    omega, phase = lowrank.random_feature_params(8, kernel, 512, seed=0,
                                                 device="cuda")
    normalize = kernel == "exponential"
    want = lowrank.feature_apply(lowrank._feature_block(omega, phase, x),
                                 lowrank._feature_block(omega, phase, y), b,
                                 normalize_rows=normalize)
    got = lowrank.feature_apply_streamed(omega, phase, x, y, b,
                                         normalize_rows=normalize,
                                         block=1024)
    assert got.is_cuda
    # tests/test_lowrank.py:237's 2e-5, of the largest output.
    _close(got, want, 2e-5)
