"""The port's Nystrom and random-feature module against kmb_tpu's, on the
CPU.

kmb_tpu_torch.ops.lowrank against kmb_tpu.ops.lowrank on the same inputs:
the same landmarks and frequencies (the JAX package's draws, handed over
as arrays: torch cannot reproduce jax.random).  Tolerances, relative
Frobenius:

- 1e-6 for the cross blocks and feature maps (one float32 matmul and one
  transcendental per entry, summed in another order);
- 1e-5 for the applies and the Woodbury solve on the same fitted state
  (two or three chained float32 matmuls);
- 1e-4 for a Nystrom product whose pseudo-inverse factor each package
  computes itself (float32 eigendecompositions of an ill-conditioned
  W; 1.4e-5 seen), and 2e-3 for the Woodbury solve on each package's own
  build at lam = 1e-2 (the inner system amplifies the build's roundings
  by up to ||G|| / lam; 3.4e-4 seen).

Error against the float64 oracle is held to tests/test_lowrank.py's own
bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.ops import lowrank as jlr
from kmb_tpu_torch.algorithms.bruteforce_numpy import kernel_matrix
from kmb_tpu_torch.algorithms.torch_approx import (
    NystromProduct, NystromSolver, RandomFeatureProduct)
from kmb_tpu_torch.ops import lowrank as tlr

SMOOTH_KERNELS = ["gaussian", "absolute-exponential", "exponential"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the float32 roundings (and so where a Krylov
    loop stops) do not depend on the host's core count, and parallel test
    workers do not oversubscribe it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def clouds():
    # tests/test_lowrank.py's points: small spheres, where the smooth
    # kernels decay fast in rank.
    rng = np.random.default_rng(0)
    x = rng.standard_normal((120, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = rng.standard_normal((150, 3))
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    b = rng.standard_normal((150, 2))
    return (x.astype(np.float32), y.astype(np.float32),
            b.astype(np.float32))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _truth(kernel, x, y, b, normalize=False):
    k = kernel_matrix(kernel=kernel, source_points=y.astype(np.float64),
                      target_points=x.astype(np.float64))
    out = k @ b
    if normalize:
        out = out / k.sum(axis=1, keepdims=True)
    return out


def _jax_landmarks(y, rank, seed=0):
    return np.asarray(jlr.select_landmarks(jnp.array(y), rank, seed=seed))


def _jax_nystrom_state(kernel, x, y, rank):
    landmarks = jnp.array(_jax_landmarks(y, rank))
    u, inv_lam = jlr.nystrom_core(landmarks, kernel)
    zx, zy = jlr.nystrom_factors(jnp.array(x), jnp.array(y), landmarks,
                                 kernel)
    return landmarks, u, inv_lam, zx, zy


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
def test_cross_kernel_matches_jax(kernel, clouds):
    x, y, _ = clouds
    landmarks = _jax_landmarks(y, 64)
    got = tlr._cross_kernel(_t(x), _t(landmarks), kernel)
    want = jlr._cross_kernel(jnp.array(x), jnp.array(landmarks), kernel)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
def test_nystrom_core_matches_jax(kernel, clouds):
    _, y, _ = clouds
    landmarks = _jax_landmarks(y, 64)
    u, inv_lam = tlr.nystrom_core(_t(landmarks), kernel)
    ju, jinv = (np.asarray(a, np.float64)
                for a in jlr.nystrom_core(jnp.array(landmarks), kernel))
    # As many eigenvalues kept (within one at the cutoff), and the kept
    # eigenvalues equal to 1e-4 of the largest: the BLAS form's
    # cancellation puts up to sqrt(eps_f32) |x| into K(L, L)'s entries
    # (its diagonal under absolute-exponential's square root).
    inv_lam = inv_lam.double().numpy()
    kept, jkept = inv_lam > 0, jinv > 0
    assert abs(int(kept.sum()) - int(jkept.sum())) <= 1
    lam, jlam = 1.0 / inv_lam[kept], 1.0 / jinv[jkept]
    top = min(len(lam), len(jlam))
    np.testing.assert_allclose(lam[-top:], jlam[-top:],
                               atol=1e-4 * jlam.max())
    # The same leading eigenspace: the projector on the 8 largest.
    u = u.double().numpy()[:, -8:]
    ju = ju[:, -8:]
    assert np.abs(u @ u.T - ju @ ju.T).max() < 1e-4


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
@pytest.mark.parametrize("mode", ["product", "attention", "density"])
def test_nystrom_apply_matches_jax(kernel, mode, clouds):
    x, y, b = clouds
    state = _jax_nystrom_state(kernel, x, y, 64)
    _, u, inv_lam, zx, zy = tlr.nystrom_from_arrays(*state, device="cpu")
    kw = dict(normalize_rows=mode == "attention",
              density_estimation=mode == "density")
    signal = None if mode == "density" else b
    got = tlr.nystrom_apply(zx, zy, u, inv_lam,
                            None if signal is None else _t(signal), **kw)
    want = jlr.nystrom_apply(*state[3:], state[1], state[2],
                             None if signal is None else jnp.array(signal),
                             **kw)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
def test_nystrom_pipeline_on_jax_landmarks_matches_jax(kernel, clouds):
    x, y, b = clouds
    landmarks = _jax_landmarks(y, 64)
    u, inv_lam = tlr.nystrom_core(_t(landmarks), kernel)
    zx, zy = tlr.nystrom_factors(_t(x), _t(y), _t(landmarks), kernel)
    got = tlr.nystrom_apply(zx, zy, u, inv_lam, _t(b))
    state = _jax_nystrom_state(kernel, x, y, 64)
    want = jlr.nystrom_apply(state[3], state[4], state[1], state[2],
                             jnp.array(b))
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
def test_nystrom_error_bounded_and_monotone(kernel, clouds):
    # tests/test_lowrank.py:60-70 on the port's own landmarks.
    x, y, b = clouds
    want = _truth(kernel, x, y, b)

    def run(rank):
        landmarks = tlr.select_landmarks(_t(y), rank)
        u, inv_lam = tlr.nystrom_core(landmarks, kernel)
        zx, zy = tlr.nystrom_factors(_t(x), _t(y), landmarks, kernel)
        return tlr.nystrom_apply(zx, zy, u, inv_lam, _t(b)).numpy()

    err_lo, err_hi = _rel(run(16), want), _rel(run(128), want)
    assert err_hi < (0.05 if kernel == "absolute-exponential" else 1e-3)
    assert err_hi < err_lo + 1e-6


def test_nystrom_full_rank_and_attention_are_accurate(clouds):
    # tests/test_lowrank.py:73-82.
    x, y, b = clouds
    landmarks = tlr.select_landmarks(_t(y), 150)
    assert landmarks.shape == (150, 3)
    u, inv_lam = tlr.nystrom_core(landmarks, "gaussian")
    zx, zy = tlr.nystrom_factors(_t(x), _t(y), landmarks, "gaussian")
    got = tlr.nystrom_apply(zx, zy, u, inv_lam, _t(b)).numpy()
    assert _rel(got, _truth("gaussian", x, y, b)) < 1e-4
    landmarks = tlr.select_landmarks(_t(y), 128)
    u, inv_lam = tlr.nystrom_core(landmarks, "exponential")
    zx, zy = tlr.nystrom_factors(_t(x), _t(y), landmarks, "exponential")
    got = tlr.nystrom_apply(zx, zy, u, inv_lam, _t(b),
                            normalize_rows=True).numpy()
    assert _rel(got, _truth("exponential", x, y, b, normalize=True)) < 1e-3


def test_select_landmarks_draws_distinct_rows_in_order():
    y = torch.arange(40, dtype=torch.float32)[:, None].repeat(1, 3)
    got = tlr.select_landmarks(y, 10, seed=5)[:, 0]
    assert torch.equal(got, torch.sort(got).values)
    assert len(set(got.tolist())) == 10
    assert torch.equal(got, tlr.select_landmarks(y, 10, seed=5)[:, 0])
    assert not torch.equal(got, tlr.select_landmarks(y, 10, seed=6)[:, 0])
    assert tlr.select_landmarks(y, 99).shape == (40, 3)


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
def test_feature_map_matches_jax(kernel, clouds):
    x, _, _ = clouds
    omega, phase = jlr.random_feature_params(3, kernel, 256, seed=3)
    assert (phase is None) == (kernel == "exponential")
    params = tlr.random_features_from_arrays(omega, phase, device="cpu")
    got = tlr._feature_block(*params, _t(x))
    want = jlr.random_feature_map(jnp.array(x), kernel, 256, seed=3)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
@pytest.mark.parametrize("mode", ["product", "attention", "density"])
def test_feature_apply_and_streamed_match_jax(kernel, mode, clouds):
    x, y, b = clouds
    omega, phase = jlr.random_feature_params(3, kernel, 64, seed=3)
    params = tlr.random_features_from_arrays(omega, phase, device="cpu")
    kw = dict(normalize_rows=mode == "attention",
              density_estimation=mode == "density")
    jb = None if mode == "density" else jnp.array(b)
    tb = None if mode == "density" else _t(b)
    want = np.asarray(jlr.feature_apply(
        jlr.random_feature_map(jnp.array(x), kernel, 64, seed=3),
        jlr.random_feature_map(jnp.array(y), kernel, 64, seed=3), jb, **kw))
    got = tlr.feature_apply(tlr._feature_block(*params, _t(x)),
                            tlr._feature_block(*params, _t(y)), tb, **kw)
    assert _rel(got, want) < 1e-5
    # block=32: several blocks on both clouds, the last one short.
    streamed = tlr.feature_apply_streamed(*params, _t(x), _t(y), tb,
                                          block=32, **kw)
    jax_streamed = np.asarray(jlr.feature_apply_streamed(
        omega, phase, jnp.array(x), jnp.array(y), jb, block=32, **kw))
    assert _rel(streamed, jax_streamed) < 1e-5
    # tests/test_lowrank.py:237: streamed within 2e-5 of materialised.
    np.testing.assert_allclose(streamed.numpy(), got.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("kernel", SMOOTH_KERNELS)
def test_random_features_converge(kernel, clouds):
    # tests/test_lowrank.py:85-98 on the port's own draws.
    x, y, b = clouds
    want = _truth(kernel, x, y, b)

    def run(f, seed):
        phi_x = tlr.random_feature_map(_t(x), kernel, f, seed=seed)
        phi_y = tlr.random_feature_map(_t(y), kernel, f, seed=seed)
        return tlr.feature_apply(phi_x, phi_y, _t(b)).numpy()

    # The bounds of one JAX draw, held by the median of eight of the
    # port's: one draw's error moves by a factor of two between seeds for
    # the Performer features at F = 4096 (as test_random_feature_draws_
    # spread_like_jax shows for the cube), and the estimator is JAX's on
    # the same draw (test_feature_apply_and_streamed_match_jax).
    small, large = zip(*((_rel(run(64, seed), want), _rel(run(4096, seed),
                                                          want))
                         for seed in range(8)))
    assert np.median(large) < 0.1
    assert np.median(large) < np.median(small)


def test_random_feature_params_follow_the_spectral_measures():
    gen = {k: tlr.random_feature_params(3, k, 20000, seed=1, device="cpu")
           for k in SMOOTH_KERNELS}
    omega, phase = gen["gaussian"]
    # N(0, 2 I): variance 2 (20000 x 3 draws: standard error 0.012).
    assert abs(float(omega.var()) - 2.0) < 0.06
    assert float(phase.min()) >= 0.0 and float(phase.max()) <= 2 * np.pi
    omega, _ = gen["absolute-exponential"]
    # Cauchy columns: heavy tails, median |omega_d| near 1 / median |g|.
    assert float(omega.abs().max()) > 100.0
    omega, phase = gen["exponential"]
    assert phase is None and abs(float(omega.var()) - 1.0) < 0.03


def test_performer_features_are_positive(clouds):
    x, _, _ = clouds
    phi = tlr.random_feature_map(_t(x), "exponential", 128)
    assert bool((phi > 0).all())


@pytest.mark.parametrize("kernel", ["gaussian", "absolute-exponential"])
def test_woodbury_solve_matches_jax(kernel, clouds):
    _, y, b = clouds
    landmarks = _jax_landmarks(y, 64)
    c, gram = jlr.nystrom_solver_build(jnp.array(y), jnp.array(landmarks),
                                       kernel)
    state = tlr.nystrom_solver_from_arrays(c, gram, device="cpu")
    own = tlr.nystrom_solver_build(_t(y), _t(landmarks), kernel)
    assert _rel(own[0] @ own[0].T,
                np.asarray(c) @ np.asarray(c).T) < 1e-4
    for lam in (1e-2, 1e-4):
        want = jlr.nystrom_solver_apply(c, gram, jnp.array(b), lam)
        assert _rel(tlr.nystrom_solver_apply(*state, _t(b), lam),
                    want) < 1e-5
    want = jlr.nystrom_solver_apply(c, gram, jnp.array(b), 1e-2)
    assert _rel(tlr.nystrom_solver_apply(*own, _t(b), 1e-2), want) < 2e-3


def test_nystrom_solver_full_rank_is_ridge_solve(clouds):
    # tests/test_lowrank.py:112-138: every source a landmark.
    _, y, _ = clouds
    rng = np.random.default_rng(7)
    k = kernel_matrix(kernel="gaussian", source_points=y.astype(np.float64))
    a = (k @ rng.standard_normal((150, 2))).astype(np.float32)
    c, gram = tlr.nystrom_solver_build(_t(y), tlr.select_landmarks(_t(y),
                                                                   150),
                                       "gaussian")
    b_hat = tlr.nystrom_solver_apply(c, gram, _t(a), 1e-2).double().numpy()
    res = np.linalg.norm(k @ b_hat - a) / np.linalg.norm(a)
    assert res < 1e-2


def test_woodbury_cholesky_breakdown_gives_nan():
    c = torch.ones((5, 2))
    gram = -torch.eye(2) * 10.0    # lam I + G not positive definite
    out = tlr.nystrom_solver_apply(c, gram, torch.ones((5, 1)), 1e-2)
    assert bool(torch.isnan(out).all())


@pytest.mark.parametrize("cls", [NystromProduct, RandomFeatureProduct,
                                 NystromSolver])
def test_inverse_distance_rejected(cls):
    with pytest.raises(NotImplementedError):
        cls(kernel="inverse-distance", dimension=3, device="cpu")
    with pytest.raises(NotImplementedError):
        tlr.random_feature_params(3, "inverse-distance", 8, device="cpu")


def _rff_cube_errors(rows, seeds):
    """RMS errors of 1024 random Gaussian features on the first `rows`
    points of the registry's 131072-point cube (signal and float64 truth
    from the same rows), one per draw: (port's generator, JAX's)."""
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.ops.product import kernel_matvec_torch

    arrays = make_arrays("product-cube-D3-E1-M131072-N131072-gaussian")
    y = torch.tensor(arrays["source_points"][:rows])
    b = torch.tensor(arrays["source_signal"][:rows])
    truth = kernel_matvec_torch(y, y, b, kernel_name="gaussian").numpy()

    def error(params):
        phi = tlr._feature_block(*params, y.float())
        got = tlr.feature_apply(phi, phi, b.float()).double().numpy()
        return float(np.sqrt(np.mean((got - truth) ** 2))
                     / np.sqrt(np.mean(truth ** 2)))

    port = [error(tlr.random_feature_params(3, "gaussian", 1024, seed=s,
                                            device="cpu")) for s in seeds]
    ref = [error(tlr.random_features_from_arrays(
        *jlr.random_feature_params(3, "gaussian", 1024, seed=s),
        device="cpu")) for s in seeds]
    return port, ref


def test_random_feature_draws_spread_like_jax():
    # One draw's error is a sample; over ten draws the two generators give
    # the same estimator's spread: medians within 1.5x of each other.
    port, ref = _rff_cube_errors(4096, range(10))
    assert 1 / 1.5 < np.median(port) / np.median(ref) < 1.5, (port, ref)


if __name__ == "__main__":
    # The spread of one draw's error at F = 1024 on the cube's first 8192
    # points, ten draws of each generator:
    #   KMB_PLATFORM=cpu PYTHONPATH=. python tests/test_torch_lowrank.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    for label, errors in zip(("port", "jax"),
                             _rff_cube_errors(8192, range(10))):
        print(f"{label}: median {np.median(errors):.4f}, "
              f"{min(errors):.4f}-{max(errors):.4f}: "
              + " ".join(f"{e:.4f}" for e in errors))
