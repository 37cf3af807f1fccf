"""The port's solvers (kmb_tpu_torch.ops.solve) against kmb_tpu.ops.solve.

Inputs are made with numpy from a seed and go through both packages on
the CPU: the JAX package's matvec there is `kernel_matvec_xla`, the port's
the plain PyTorch product.  Each tolerance is stated where it is used; the
patterns and the absolute tolerances against the truth come from
tests/test_ops.py:183-580.

Iteration counts of two float32 Krylov loops agree exactly only while
their roundings do: the packages sum in different orders, so counts are
held to a band of 5% (at least 2 iterations) and residuals to a factor of
2.  The Nystrom sketch draws its test matrix from jax.random in the JAX
package and from a torch.Generator in the port; the tests that compare the
loops carry the JAX package's fitted state across
(`nystrom_precond_from_arrays`, `block_jacobi_precond_from_arrays`), so
the loops are compared apart from the random sketch.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.algorithms.bruteforce_numpy import kernel_matrix as oracle_matrix
from kmb_tpu.ops import solve as jsolve
from kmb_tpu.ops.blr import _cluster as jax_cluster
from kmb_tpu_torch.datasets import fibonacci_sphere
from kmb_tpu_torch.ops import solve as tsolve
from kmb_tpu_torch.ops.blr import _cluster
from kmb_tpu_torch.ops.product import kernel_matvec_torch

ALL_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
               "exponential"]


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _same_iterations(got, want):
    assert abs(got - want) <= max(2, 0.05 * want), (got, want)


def _same_residual(got, want):
    assert 0.5 * want <= got <= 2.0 * want, (got, want)


def _true_residual(kernel, y, b, rhs):
    k = oracle_matrix(kernel=kernel, source_points=np.asarray(y, np.float64))
    rhs = np.asarray(rhs, np.float64)
    r = k @ np.asarray(b, np.float64) - rhs
    return float(np.linalg.norm(r) / np.linalg.norm(rhs))


def _problem(rng, kernel="gaussian", m=64, e=2, cloud="normal"):
    if cloud == "sphere":
        y = fibonacci_sphere(m).astype(np.float32)
    elif cloud == "cube":
        y = rng.random((m, 3)).astype(np.float32)
    else:
        y = rng.standard_normal((m, 3)).astype(np.float32)
    b = rng.standard_normal((m, e))
    k = oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
    return y, b, (k @ b).astype(np.float32)


# -- kernel_matrix -----------------------------------------------------------

@pytest.mark.parametrize("kernel", ALL_KERNELS)
@pytest.mark.parametrize("d", [3, 9, 64])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_kernel_matrix_matches_xla(kernel, d, precision, rng):
    x = (rng.standard_normal((37, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.standard_normal((53, d)) / np.sqrt(d)).astype(np.float32)
    for a, c in ((x, y), (y, y)):   # (y, y): the diagonal mask
        kw = dict(kernel_name=kernel, precision=precision)
        got = tsolve.kernel_matrix(_t(a), _t(c), **kw).numpy()
        want = np.asarray(jsolve.kernel_matrix_xla(_j(a), _j(c), **kw))
        assert got.shape == want.shape and np.all(np.isfinite(got))
        if kernel == "inverse-distance" and a is c:
            assert np.all(np.diag(got) == 0.0)
        # float32: the same f32 arithmetic in another summation order
        # (2e-5 of the largest entry, test_ops.py:41's product bound),
        # except where absolute-exponential takes the square root of the
        # expanded form at D > 8: on the diagonal the form cancels to its
        # rounding, about 4 eps |y|^2, whose root is about 1e-3.
        # bfloat16: both round the points and the matmul's output to
        # bf16, and one rounding of a cancelling form may land on the
        # neighbouring bf16 value, so bf16's 1e-2 of the largest entry.
        scale = np.abs(want).max()
        tol = 2e-5 if precision == "float32" else 1e-2
        if precision == "float32" and kernel == "absolute-exponential" \
                and d > 8:
            tol = 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_kernel_matrix_is_batched_over_blocks(rng):
    y = rng.standard_normal((3, 20, 3)).astype(np.float32)
    got = tsolve.kernel_matrix(_t(y), _t(y), kernel_name="inverse-distance")
    for i in range(3):
        want = tsolve.kernel_matrix(_t(y[i]), _t(y[i]),
                                    kernel_name="inverse-distance")
        torch.testing.assert_close(got[i], want, rtol=0, atol=0)


# -- dense solves ------------------------------------------------------------

DENSE_CASES = [("lu", "gaussian"), ("lu", "absolute-exponential"),
               ("lu", "inverse-distance"), ("cholesky", "gaussian"),
               ("cholesky", "absolute-exponential"), ("svd", "gaussian"),
               ("svd", "absolute-exponential"), ("svd", "inverse-distance")]


@pytest.mark.parametrize("method, kernel", DENSE_CASES)
@pytest.mark.parametrize("m", [64, 300])
def test_dense_solve_matches_jax(method, kernel, m, rng):
    y, b, rhs = _problem(rng, kernel, m=m)
    kw = dict(kernel_name=kernel, method=method)
    got = tsolve.dense_solve(_t(y), _t(rhs), **kw).numpy()
    want = np.asarray(jsolve.dense_solve(_j(y), _j(rhs), **kw))
    assert got.dtype == np.float32 and got.shape == b.shape
    # float32 Cholesky breaks down on the same matrices in both (NaN).
    assert np.isnan(got).any() == np.isnan(want).any()
    if np.isnan(want).any():
        return
    res_got = _true_residual(kernel, y, got, rhs)
    res_want = _true_residual(kernel, y, want, rhs)
    # Both are float32 factorisations of the same f32 matrix: the port's
    # float64 residual is within 10x of the JAX package's (or at the f32
    # floor, 1e-5), and the solution is the truth to test_ops.py:195's
    # 5e-2 where the problem is well posed enough for the truth to be
    # reached.
    assert res_got <= max(10 * res_want, 1e-5), (res_got, res_want)
    if np.abs(want - b).max() < 5e-2:
        np.testing.assert_allclose(got, b, atol=5e-2)


def test_dense_solve_bfloat16_tier_matches_jax(rng):
    y, b, rhs = _problem(rng, "absolute-exponential", m=200)
    kw = dict(kernel_name="absolute-exponential", precision="bfloat16")
    got = tsolve.dense_solve(_t(y), _t(rhs), **kw).numpy()
    want = np.asarray(jsolve.dense_solve(_j(y), _j(rhs), **kw))
    # K formed from bf16 points: both solve the same perturbed system;
    # residuals against the exact K within 2x of each other.
    _same_residual(_true_residual("absolute-exponential", y, got, rhs),
                   _true_residual("absolute-exponential", y, want, rhs))


def test_dense_svd_beats_lu_when_singular(rng):
    # test_ops.py:204-221: the truncated pseudo-inverse degrades
    # gracefully on the numerically singular Gaussian matrix of the
    # Fibonacci sphere, where exact LU blows up.
    y, b, rhs = _problem(rng, "gaussian", m=500, e=1, cloud="sphere")
    err = {}
    for method in ("lu", "svd"):
        got = tsolve.dense_solve(_t(y), _t(rhs), kernel_name="gaussian",
                                 method=method).numpy()
        err[method] = np.abs(got - b).max()
    assert err["svd"] < err["lu"]


def test_cholesky_breakdown_is_nan_as_in_jax(rng):
    y, _, rhs = _problem(rng, "inverse-distance", m=40)
    got = tsolve.dense_solve(_t(y), _t(rhs), kernel_name="inverse-distance",
                             method="cholesky").numpy()
    want = np.asarray(jsolve.dense_solve(
        _j(y), _j(rhs), kernel_name="inverse-distance", method="cholesky"))
    assert np.isnan(want).all() and np.isnan(got).all()


# -- PCG and MINRES on one explicit operator ---------------------------------

def _operator(rng, m=60, kappa=30.0, indefinite=False, null=0):
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    w = np.logspace(0.0, np.log10(kappa), m)
    w[:null] = 0.0
    if indefinite:
        w = w * np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
    a = (q * w) @ q.T
    return (0.5 * (a + a.T)).astype(np.float32)


def _both(a):
    aj, at = jnp.asarray(a), torch.from_numpy(a)

    def jax_mv(v):
        return jnp.matmul(aj, v, precision=jax.lax.Precision.HIGHEST)

    def torch_mv(v):
        return at @ v

    return jax_mv, torch_mv


def _diag_precond(a):
    # A fixed SPD preconditioner, the same in both packages.
    d = (1.0 / (np.abs(np.diag(a)) + 0.5)).astype(np.float32)
    dj, dt = jnp.asarray(d)[:, None], torch.from_numpy(d)[:, None]
    return (lambda v: dj * v), (lambda v: dt * v)


LOOPS = {"pcg": (jsolve._pcg, tsolve._pcg, False),
         "minres": (jsolve._minres, tsolve._minres, True)}


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("e", [1, 3])
@pytest.mark.parametrize("preconditioned", [False, True])
def test_krylov_loop_matches_jax(loop, e, preconditioned, rng):
    jfn, tfn, indefinite = LOOPS[loop]
    a = _operator(rng, indefinite=indefinite)
    jmv, tmv = _both(a)
    jpc, tpc = _diag_precond(a) if preconditioned else (None, None)
    rhs = rng.standard_normal((a.shape[0], e)).astype(np.float32)
    bj, ij, rj = jfn(jmv, jnp.asarray(rhs), 1e-5, 2000, precond=jpc)
    bt, it, rt = tfn(tmv, torch.from_numpy(rhs), 1e-5, 2000, precond=tpc)
    assert isinstance(it, int) and bt.shape == (a.shape[0], e)
    _same_iterations(it, ij)
    assert rt <= 2e-5 and rj <= 2e-5
    # Converged solutions of a system of condition 30 agree to about
    # kappa * tol.
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(bj)).max())


# Operators on which a loop stalls: CG on a singular matrix with a
# right-hand side outside its range (the residual cannot fall below the
# null-space part), MINRES in float32 on an indefinite matrix of
# condition 1e4 (its residual estimate stops falling at the rounding
# floor).
STALLS = {"pcg": dict(kappa=10 ** 1.5, null=3),
          "minres": dict(kappa=1e4, indefinite=True)}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_stall_window_stops_both(loop, rng):
    # With an unreachable tolerance, the loops stop PCG_STALL_WINDOW
    # iterations after the last new best residual, before max_iters.
    jfn, tfn, _ = LOOPS[loop]
    a = _operator(rng, **STALLS[loop])
    jmv, tmv = _both(a)
    rhs = rng.standard_normal((60, 2)).astype(np.float32)
    _, ij, rj = jfn(jmv, jnp.asarray(rhs), 1e-12, 20000)
    bt, it, rt = tfn(tmv, torch.from_numpy(rhs), 1e-12, 20000)
    assert tsolve.PCG_STALL_WINDOW < it < 20000
    assert ij < 20000
    # Where a loop stalls depends on its roundings: same order of
    # magnitude of iterations and residual.
    assert 0.5 * ij <= it <= 2 * ij, (it, ij)
    assert 0.1 * rj <= rt <= 10 * rj, (rt, rj)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_max_iters_is_honoured(loop, rng):
    jfn, tfn, indefinite = LOOPS[loop]
    a = _operator(rng, indefinite=indefinite)
    jmv, tmv = _both(a)
    rhs = rng.standard_normal((60, 2)).astype(np.float32)
    bj, ij, rj = jfn(jmv, jnp.asarray(rhs), 1e-12, 3)
    bt, it, rt = tfn(tmv, torch.from_numpy(rhs), 1e-12, 3)
    assert it == ij == 3
    # Three iterations from the same start in f32: the same iterate to
    # f32 rounding, and the same residual to 1e-4 of it.
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4,
                               atol=1e-5)
    assert abs(rt - rj) <= 1e-4 * rj


def test_zero_rhs_takes_no_iteration():
    zero = torch.zeros((10, 2))
    for loop in (tsolve._pcg, tsolve._minres):
        b, it, _ = loop(lambda v: 2.0 * v, zero, 1e-6, 100)
        assert it == 0 and torch.count_nonzero(b) == 0


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_best_iterate_is_returned(loop, rng):
    # A loop stopped at k iterations returns the best of its first k
    # iterates, so its residual never grows with k, and the true
    # residual of the returned iterate is the best seen (a later,
    # worse iterate is never returned).
    _, tfn, indefinite = LOOPS[loop]
    a = _operator(rng, m=80, kappa=1e7, indefinite=indefinite)
    _, tmv = _both(a)
    rhs = torch.from_numpy(rng.standard_normal((80, 1)).astype(np.float32))
    a64 = a.astype(np.float64)

    def true_res(b):
        r = a64 @ b.numpy().astype(np.float64) - rhs.numpy()
        return float(np.linalg.norm(r) / np.linalg.norm(rhs.numpy()))

    seen = []
    for k in range(1, 200, 7):
        b, _, reported = tfn(tmv, rhs, 1e-12, k)
        seen.append(true_res(b) if loop == "minres" else reported)
    # PCG's reported residual is the recursive one of the best iterate;
    # MINRES's best is judged by phibar, so its true residual may wobble
    # at the f32 level: 1% slack.
    slack = 1.0 if loop == "pcg" else 1.01
    assert all(b <= slack * a_ for a_, b in zip(seen, seen[1:])), seen


# -- cg_solve routing on the kernel operators --------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Records which loop cg_solve took, and on which operator."""
    taken = []
    for name in ("_pcg", "_minres"):
        real = getattr(tsolve, name)

        def spy(matvec, *args, _real=real, _name=name, **kw):
            taken.append((_name, type(matvec).__name__,
                          kw.get("precond") is not None))
            return _real(matvec, *args, **kw)

        monkeypatch.setattr(tsolve, name, spy)
    return taken


def _cg_both(y, rhs, kernel, tol, max_iters, jax_precond=None,
             torch_precond=None, method="auto"):
    jb, ji, jr = jsolve.cg_solve(_j(y), _j(rhs), kernel_name=kernel, tol=tol,
                                 max_iters=max_iters, precond=jax_precond,
                                 indefinite_method=method)
    tb, ti, tr = tsolve.cg_solve(_t(y), _t(rhs), kernel_name=kernel, tol=tol,
                                 max_iters=max_iters, precond=torch_precond,
                                 indefinite_method=method)
    return (np.asarray(jb), ji, jr), (tb.numpy(), ti, tr)


def test_gaussian_routes_to_pcg(routes, rng):
    y, b, rhs = _problem(rng, "gaussian", m=300, e=1, cloud="sphere")
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, "gaussian", 1e-6, 2000)
    assert routes == [("_pcg", "function", False)]
    _same_iterations(ti, ji)
    _same_residual(tr, jr)
    assert tr <= 1e-6


def test_inverse_distance_auto_routes_to_minres(routes, rng):
    y, b, rhs = _problem(rng, "inverse-distance", m=300, e=1, cloud="sphere")
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, "inverse-distance", 1e-5,
                                          2000)
    assert routes == [("_minres", "function", False)]
    _same_iterations(ti, ji)
    _same_residual(tr, jr)
    np.testing.assert_allclose(tb, b, atol=5e-2)   # test_ops.py:282


def _nystrom_pair(y, kernel, rank):
    """The JAX package's Nystrom factors of K (K^2 for inverse-distance)
    and the same factors as the port's preconditioner."""
    from kmb_tpu.ops.product import kernel_matvec as jax_matvec

    yj = _j(y)

    def op(v):
        out = jax_matvec(yj, yj, v, kernel_name=kernel)
        if kernel not in jsolve.SPD_KERNELS:
            out = jax_matvec(yj, yj, out, kernel_name=kernel)
        return out

    u, lam = jsolve.nystrom_preconditioner(op, y.shape[0], rank)
    return (functools.partial(jsolve.apply_nystrom_precond, u, lam),
            tsolve.nystrom_precond_from_arrays(u, lam, device="cpu"))


def test_inverse_distance_auto_with_precond_routes_to_normal_equations(
        routes, rng):
    y, b, rhs = _problem(rng, "inverse-distance", m=200, e=1, cloud="sphere")
    jp, tp = _nystrom_pair(y, "inverse-distance", 64)
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, "inverse-distance", 1e-6,
                                          3000, jp, tp)
    assert routes == [("_pcg", "NormalEquationsOp", True)]
    _same_iterations(ti, ji)
    _same_residual(tr, jr)


def _jacobi_pair(y, kernel, leaf):
    jp = jsolve.block_jacobi_preconditioner(y, kernel_name=kernel, leaf=leaf)
    tp = tsolve.block_jacobi_precond_from_arrays(
        *(np.asarray(a) for a in jp.args), device="cpu")
    return jp, tp


def test_minres_with_block_abs_jacobi(routes, rng):
    # The clustered geometry of test_ops.py:446-474, at M = 400.
    m, kernel = 400, "inverse-distance"
    centers = 10.0 * rng.standard_normal((8, 3))
    y = (centers[rng.integers(0, 8, m)]
         + 0.05 * rng.standard_normal((m, 3))).astype(np.float32)
    b = rng.standard_normal((m, 1))
    rhs = (oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
           @ b).astype(np.float32)
    jp, tp = _jacobi_pair(y, kernel, 64)
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, kernel, 1e-5, 3000, jp, tp,
                                          method="minres")
    assert routes == [("_minres", "function", True)]
    _same_iterations(ti, ji)
    _same_residual(tr, jr)
    # And the port's own factors do as well as the carried ones.
    own = tsolve.block_jacobi_preconditioner(_t(y), kernel_name=kernel,
                                             leaf=64)
    _, oi, orr = tsolve.cg_solve(_t(y), _t(rhs), kernel_name=kernel, tol=1e-5,
                                 max_iters=3000, precond=own,
                                 indefinite_method="minres")
    _same_iterations(oi, ji)
    assert orr <= 2 * jr


def test_normal_equations_without_precond(routes, rng):
    y, b, rhs = _problem(rng, "inverse-distance", m=40, e=1)
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, "inverse-distance", 1e-7,
                                          4000, method="normal")
    assert routes == [("_pcg", "NormalEquationsOp", False)]
    _same_iterations(ti, ji)
    np.testing.assert_allclose(tb, b, atol=5e-2)   # test_ops.py:240


def test_unknown_indefinite_method_raises(rng):
    y, _, rhs = _problem(rng, "inverse-distance", m=20, e=1)
    with pytest.raises(ValueError, match="indefinite_method"):
        tsolve.cg_solve(_t(y), _t(rhs), kernel_name="inverse-distance",
                        indefinite_method="cholesky")


# -- Nystrom -----------------------------------------------------------------

def _spd_op(y, kernel):
    k = oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
    kj = jnp.asarray(k, jnp.float32)
    kt = torch.as_tensor(k, dtype=torch.float32)
    return ((lambda v: jnp.matmul(kj, v,
                                  precision=jax.lax.Precision.HIGHEST)),
            (lambda v: kt @ v))


@pytest.mark.parametrize("method", ["svd", "gram"])
@pytest.mark.parametrize("kernel", ["gaussian", "absolute-exponential"])
def test_nystrom_factors_match_jax_given_its_omega(method, kernel, rng):
    m, rank = 128, 24
    y = rng.standard_normal((m, 3)).astype(np.float32)
    jop, top = _spd_op(y, kernel)
    u, lam = jsolve.nystrom_preconditioner(jop, m, rank, method=method)
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (m, rank),
                                         jnp.float32))
    tu, tlam = tsolve.nystrom_factors(top, torch.tensor(omega),
                                      method=method)
    assert tu.shape == (m, rank) and tlam.shape == (rank,)
    assert torch.all(tlam[:-1] >= tlam[1:]) and torch.all(tlam >= 0)
    # U diag(lam) U^T is invariant to the factors' signs and bases: within
    # 1e-4 of lam_0 (f32 QR, eigh and SVD in another order).
    want = (np.asarray(u) * np.asarray(lam)) @ np.asarray(u).T
    got = ((tu * tlam) @ tu.T).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.asarray(lam)[0]))
    np.testing.assert_allclose(tlam.numpy(), np.asarray(lam), rtol=0,
                               atol=1e-4 * float(np.asarray(lam)[0]))


@pytest.mark.parametrize("method", ["svd", "gram"])
def test_nystrom_precond_is_spd(method, rng):
    y = rng.standard_normal((64, 3)).astype(np.float32)
    _, top = _spd_op(y, "gaussian")
    u, lam = tsolve.nystrom_preconditioner(top, 64, 16, device="cpu",
                                           method=method)
    minv = tsolve.apply_nystrom_precond(u, lam, torch.eye(64)).numpy()
    np.testing.assert_allclose(minv, minv.T, atol=1e-5)   # test_ops.py:338
    assert np.linalg.eigvalsh(0.5 * (minv + minv.T)).min() > 0


def test_nystrom_draw_is_seeded(rng):
    # The test matrix comes from a torch.Generator seeded with 0.
    y = rng.standard_normal((64, 3)).astype(np.float32)
    _, top = _spd_op(y, "gaussian")
    got = tsolve.nystrom_preconditioner(top, 64, 8, device="cpu")
    omega = torch.randn((64, 8), generator=torch.Generator().manual_seed(0))
    want = tsolve.nystrom_factors(top, omega)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["gaussian", "absolute-exponential"])
def test_nystrom_pcg_matches_jax(kernel, rng):
    y, b, rhs = _problem(rng, kernel, m=400, e=1, cloud="sphere")
    jp, tp = _nystrom_pair(y, kernel, 64)
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, kernel, 1e-6, 3000, jp, tp)
    _same_iterations(ti, ji)
    _same_residual(tr, jr)
    # And the port's own sketch cuts the iterations as the JAX one does.
    _, pi, _ = tsolve.cg_solve(_t(y), _t(rhs), kernel_name=kernel, tol=1e-6,
                               max_iters=3000)
    yt = _t(y)

    def op(v):
        return tsolve._default_matvec(yt, kernel_name=kernel,
                                      precision="float32")(v)

    u, lam = tsolve.nystrom_preconditioner(op, 400, 64, device="cpu")
    _, oi, orr = tsolve.cg_solve(
        yt, _t(rhs), kernel_name=kernel, tol=1e-6, max_iters=3000,
        precond=functools.partial(tsolve.apply_nystrom_precond, u, lam))
    assert oi < pi and orr <= 1e-6


# -- block-abs Jacobi ---------------------------------------------------------

@pytest.mark.parametrize("n, leaf", [(1000, 128), (777, 64), (96, 128),
                                     (513, 256), (2048, 512)])
def test_cluster_matches_jax(n, leaf, rng):
    pts = rng.standard_normal((n, 3))
    gather, gid = _cluster(pts, leaf)
    want_gather, want_gid = jax_cluster(pts, leaf)
    np.testing.assert_array_equal(gather, want_gather)
    np.testing.assert_array_equal(gid, want_gid)
    assert gather.dtype == gid.dtype == np.int32


@pytest.mark.parametrize("kernel", ["gaussian", "absolute-exponential",
                                    "inverse-distance"])
def test_block_jacobi_applies_the_same_inverse(kernel, rng):
    m = 300
    y = rng.standard_normal((m, 3)).astype(np.float32)
    jp, tp = _jacobi_pair(y, kernel, 64)
    x = rng.standard_normal((m, 2)).astype(np.float32)
    want = np.asarray(jp(_j(x)))
    scale = np.abs(want).max()
    # The carried factors: the same f32 matmuls (1e-5 of the largest
    # output).
    np.testing.assert_allclose(tp(_t(x)).numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    # The port's own factors: eigh's bases may differ, V |w|^-1 V^T may
    # not, to 1e-3 of the largest output.  Not for the Gaussian blocks:
    # most of their eigenvalues sit at the 1e-6 floor, where float32 eigh
    # returns any basis of a near-null space, each amplified 1e6 times.
    if kernel == "gaussian":
        return
    own = tsolve.block_jacobi_preconditioner(_t(y), kernel_name=kernel,
                                             leaf=64)
    np.testing.assert_allclose(own(_t(x)).numpy(), want, rtol=0,
                               atol=1e-3 * scale)


@pytest.mark.parametrize("kernel", ["absolute-exponential",
                                    "inverse-distance"])
def test_block_jacobi_is_spd_and_exact_on_one_block(kernel, rng):
    m = 96
    y = rng.standard_normal((m, 3)).astype(np.float32)
    precond = tsolve.block_jacobi_preconditioner(_t(y), kernel_name=kernel,
                                                 leaf=128)
    minv = precond(torch.eye(m)).numpy()
    # test_ops.py:486-488 and :418-420.
    assert np.allclose(minv, minv.T, atol=1e-4 * np.abs(minv).max())
    assert (np.linalg.eigvalsh(0.5 * (minv + minv.T)) > 0).all()
    # One block holds every point: P^-1 = |K|^-1, so P^-1 |K| = I.
    k = oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
    w, v = np.linalg.eigh(k)
    abs_k = (v * np.abs(w)) @ v.T
    np.testing.assert_allclose(minv @ abs_k, np.eye(m), atol=1e-3)


def test_block_jacobi_pcg_matches_jax(rng):
    m, kernel = 600, "absolute-exponential"
    y = rng.random((m, 3)).astype(np.float32)
    b = rng.standard_normal((m, 1))
    rhs = (oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
           @ b).astype(np.float32)
    jp, tp = _jacobi_pair(y, kernel, 128)
    (jb, ji, jr), (tb, ti, tr) = _cg_both(y, rhs, kernel, 1e-5, 3000, jp, tp)
    _same_iterations(ti, ji)
    _same_residual(tr, jr)


# -- iterative refinement -----------------------------------------------------

@pytest.mark.parametrize("kernel, cloud", [("absolute-exponential", "cube"),
                                           ("inverse-distance", "sphere")])
def test_ir_solve_matches_jax(kernel, cloud, rng):
    y, b, _ = _problem(rng, kernel, m=384, e=2, cloud=cloud)
    k = oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
    rhs = k @ b
    kw = dict(kernel_name=kernel, tol=1e-10, inner_tol=1e-5, refine_iters=4,
              max_iters=3000)
    jb, jinfo = jsolve.ir_solve(_j(y), rhs, **kw)
    tb, tinfo = tsolve.ir_solve(_t(y), torch.from_numpy(rhs), **kw)
    assert tb.dtype == torch.float64 and tb.shape == b.shape
    assert tinfo["outer_iterations"] == jinfo["outer_iterations"]
    _same_iterations(tinfo["inner_iterations"], jinfo["inner_iterations"])
    # test_ops.py:531-535: refined below 1e-6; the two float64 residuals
    # within 10x of each other (each pass contracts by kappa * eps_f32,
    # which the roundings set).
    res_t = np.linalg.norm(rhs - k @ tb.numpy()) / np.linalg.norm(rhs)
    res_j = np.linalg.norm(rhs - k @ jb) / np.linalg.norm(rhs)
    assert res_t < 1e-6 and 0.1 * res_j <= res_t <= 10 * res_j
    assert tinfo["relative_residual"] < max(10 * res_t, 1e-12)


def test_ir_solve_with_nystrom_matches_jax(rng):
    kernel = "absolute-exponential"
    y, b, _ = _problem(rng, kernel, m=256, e=1)
    k = oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
    rhs = k @ b
    jp, tp = _nystrom_pair(y, kernel, 64)
    kw = dict(kernel_name=kernel, tol=1e-10, inner_tol=1e-4, refine_iters=4,
              max_iters=3000)
    jb, jinfo = jsolve.ir_solve(_j(y), rhs, precond=jp, **kw)
    tb, tinfo = tsolve.ir_solve(_t(y), torch.from_numpy(rhs), precond=tp,
                                **kw)
    assert tinfo["outer_iterations"] == jinfo["outer_iterations"]
    _same_iterations(tinfo["inner_iterations"], jinfo["inner_iterations"])
    res_t = np.linalg.norm(rhs - k @ tb.numpy()) / np.linalg.norm(rhs)
    res_j = np.linalg.norm(rhs - k @ jb) / np.linalg.norm(rhs)
    assert res_t < 1e-6 and 0.1 * res_j <= res_t <= 10 * res_j


def test_ir_keeps_the_best_iterate(rng):
    # An inner solve that makes things worse never replaces the iterate.
    y, b, _ = _problem(rng, "absolute-exponential", m=64, e=1)
    rhs = torch.from_numpy(
        oracle_matrix(kernel="absolute-exponential",
                      source_points=y.astype(np.float64)) @ b)

    def bad(r):
        return -100.0 * r, 1, 1.0

    got, info = tsolve.ir_solve(_t(y), rhs, kernel_name="absolute-exponential",
                                inner_solve=bad)
    assert torch.count_nonzero(got) == 0
    assert info["outer_iterations"] == 1 and info["history"][0] > 1.0
    assert info["relative_residual"] == 1.0


def test_f64_residual_matvec_is_the_oracle(rng):
    y = rng.standard_normal((50, 3)).astype(np.float32)
    v = rng.standard_normal((50, 2))
    mv = tsolve.f64_residual_matvec(_t(y), kernel_name="inverse-distance")
    got = mv(torch.from_numpy(v))
    want = oracle_matrix(kernel="inverse-distance",
                         source_points=y.astype(np.float64)) @ v
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# -- precision ---------------------------------------------------------------

def test_highest_precision_restores_the_callers_setting():
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        with tsolve.highest_precision():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
        with pytest.raises(ZeroDivisionError):
            with tsolve.highest_precision():
                1 / 0
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_solves_ignore_a_lower_process_precision(rng):
    # Under a process-wide "medium" (bf16 matmuls where the CPU has them)
    # the Nystrom factors and the dense solve are those of "highest".
    y = rng.standard_normal((96, 3)).astype(np.float32)
    _, top = _spd_op(y, "gaussian")
    omega = torch.randn((96, 16), generator=torch.Generator().manual_seed(3))
    _, _, rhs = _problem(rng, "gaussian", m=96, e=1)
    want = (tsolve.nystrom_factors(top, omega),
            tsolve.dense_solve(_t(y), _t(rhs), kernel_name="gaussian"))
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = (tsolve.nystrom_factors(top, omega),
               tsolve.dense_solve(_t(y), _t(rhs), kernel_name="gaussian"))
    finally:
        torch.set_float32_matmul_precision(saved)
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the dense limits of chip_smoke.py's solver phase -------------------------

DENSE_REFERENCE = [
    ("solver-cube-D3-E1-M10000-N10000-gaussian", "lu", "float32"),
    ("solver-cube-D3-E1-M10000-N10000-gaussian", "lu", "bfloat16"),
    ("solver-normal-D784-E1-M5000-N5000-gaussian", "lu", "float32"),
    ("solver-normal-D784-E1-M5000-N5000-gaussian", "lu", "bfloat16"),
    ("solver-normal-D784-E1-M5000-N5000-gaussian", "svd", "float32"),
]


def independent_backward_error(points, b, a, *, kernel_name, block=1000):
    """Normwise backward error ||K b - a|| / (||K||_F ||b|| + ||a||) of a
    solve of K b = a, in float64.  K is the kernel matrix of the float32
    `points`, formed by the plain float64 product (`kernel_matvec_torch`,
    on the points' device), not by the code under test: a solver that
    factors a wrong matrix cannot pass on its own matrix.  Unlike the
    residual ||K b - a|| / ||a||, it does not scale with ||b||, which on a
    numerically singular K is set by the roundings of the factorisation.
    chip_smoke.py computes the same quantity on the card."""
    p = torch.as_tensor(points).float().double()
    b, a = (torch.as_tensor(t, dtype=torch.float64, device=p.device)
            for t in (b, a))
    m = len(p)
    frob_sq = 0.0
    for j in range(0, m, block):       # columns j:j+w of K
        w = min(block, m - j)
        eye = torch.eye(w, dtype=torch.float64, device=p.device)
        frob_sq += float(torch.sum(kernel_matvec_torch(
            p, p[j:j + w], eye, kernel_name=kernel_name, col_offset=j) ** 2))
    kb = kernel_matvec_torch(p, p, b, kernel_name=kernel_name)
    return float(torch.linalg.norm(kb - a) / (
        math.sqrt(frob_sq) * torch.linalg.norm(b) + torch.linalg.norm(a)))


def _tf32(a):
    """float32 values cut to TF32's 10-bit mantissa."""
    a = np.ascontiguousarray(a, np.float32)
    return (a.view(np.int32) & np.int32(~0x1FFF)).view(np.float32)


@pytest.mark.parametrize("kernel, d", [("gaussian", 3),
                                       ("inverse-distance", 3),
                                       ("gaussian", 64)])
def test_independent_backward_error_rejects_a_wrong_matrix(kernel, d, rng):
    y = (rng.standard_normal((300, d)) / math.sqrt(d)).astype(np.float32)
    k64 = oracle_matrix(kernel=kernel, source_points=y.astype(np.float64))
    a = k64 @ rng.standard_normal((300, 1))

    def eta(b):    # blocks of 128 columns: the last block is ragged
        return independent_backward_error(y, b, a, kernel_name=kernel,
                                          block=128)

    right = tsolve.dense_solve(_t(y), _t(a), kernel_name=kernel).numpy()
    b64 = right.astype(np.float64)
    want = np.linalg.norm(k64 @ b64 - a) / (
        np.linalg.norm(k64) * np.linalg.norm(b64) + np.linalg.norm(a))
    assert eta(right) == pytest.approx(want, rel=1e-9)
    # A float32 LU of the right matrix is backward stable ...
    assert eta(right) < 1e-6
    # ... and the solve of a matrix off by 1e-3 (in scale, or formed from
    # points cut to TF32) is caught by two orders of magnitude.
    wrong = [right / 1.001]
    if d > 8:
        wrong.append(tsolve.dense_solve(_t(_tf32(y)), _t(a),
                                        kernel_name=kernel).numpy())
    for b in wrong:
        assert eta(b) > 100 * eta(right), (eta(b), eta(right))


def dense_reference_residuals():
    """What kmb_tpu.ops.solve.dense_solve reaches on the CPU on each
    dataset of chip_smoke.py's dense solver runs: the float64 true
    residual ||K b - a|| / ||a|| (K from the float64 points) and
    `independent_backward_error`.  chip_smoke.py holds the port to ten
    times the latter.  Full size (M = 10000 and 5000): run it as a
    script, not as a test:

        KMB_PLATFORM=cpu PYTHONPATH=. python tests/test_torch_solve.py
    """
    from kmb_tpu_torch.datasets import ground_truth, make_arrays
    from kmb_tpu_torch.algorithms.bruteforce_numpy import (
        blocked_kernel_product)

    out = []
    for name, method, precision in DENSE_REFERENCE:
        arrays = make_arrays(name)
        kernel = arrays["kernel"]
        a = ground_truth(arrays, device="cpu")
        y = _j(arrays["source_points"])
        b = np.asarray(jsolve.dense_solve(y, _j(a), kernel_name=kernel,
                                          precision=precision,
                                          method=method), np.float64)
        kb = blocked_kernel_product(kernel=kernel,
                                    source_points=arrays["source_points"],
                                    source_signal=b)
        res = float(np.linalg.norm(kb - a) / np.linalg.norm(a))
        eta = independent_backward_error(
            arrays["source_points"], b, a, kernel_name=kernel)
        out.append((name, method, precision, res, eta))
        print(f"{name} {method} {precision}: true residual {res:.6e}, "
              f"backward error {eta:.6e}", flush=True)
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    dense_reference_residuals()
