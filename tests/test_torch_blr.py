"""The port's block-low-rank engine against kmb_tpu's, on the CPU.

kmb_tpu_torch.ops.blr against kmb_tpu.ops.blr on the same points and the
same Gaussian test matrix (the JAX package's draw, handed over as an
array: torch cannot reproduce jax.random).  Tolerances:

- the host plan, rank selection and rank tiers: equal (copied NumPy);
- kernel tiles: 1e-6 relative Frobenius (one float32 form and map per
  entry);
- each far block's U V: 1e-4 relative Frobenius of JAX's (both project
  the same tile on the range of the same sketch; the two QRs differ only
  in directions where the tile has no energy);
- selected ranks: equal on at least 99% of the blocks, within one
  elsewhere (a block whose spectral tail sits at epsilon can tip);
- the matvec against JAX's at tests/test_blr.py's tolerances: rtol 2e-4,
  atol 2e-5, and 5e-4 for the symmetric and inverse-distance operators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmb_tpu.ops import blr as jblr
from kmb_tpu.ops.kernels import get_kernel as jax_get_kernel
from kmb_tpu_torch.algorithms.bruteforce_numpy import kernel_matrix
from kmb_tpu_torch.ops import blr as tblr
from kmb_tpu_torch.ops.kernels import get_kernel

SQDIST_KERNELS = ["gaussian", "absolute-exponential", "inverse-distance"]


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
    # tests/test_blr.py's clouds.
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (201, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (167, 3)).astype(np.float32)
    b = rng.standard_normal((167, 2)).astype(np.float32)
    return x, y, b


@pytest.fixture
def cloud():
    rng = np.random.default_rng(1)
    y = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    b = rng.standard_normal((300, 2)).astype(np.float32)
    return y, b


def jax_omega(leaf, rank, seed=0):
    """The test matrix kmb_tpu.ops.blr.compress_far_blocks draws."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (leaf, rank), dtype=jnp.float32))


def _truth(kernel, x, y, b):
    k = kernel_matrix(kernel=kernel, source_points=y.astype(np.float64),
                      target_points=x.astype(np.float64))
    return k @ b


def _ops(x, y, same_points, **kw):
    """(port, JAX) operators on the same points and test matrix."""
    rank = min(kw["rank"], kw["leaf"])
    port = tblr.BlrOperator(x, y, same_points=same_points,
                            omega=jax_omega(kw["leaf"], rank), device="cpu",
                            **kw)
    return port, jblr.BlrOperator(x, y, same_points=same_points, **kw)


@pytest.mark.parametrize("same_points, leaf, eta", [
    (False, 32, 2.0), (False, 16, 1.0), (True, 32, 2.0), (True, 64, 1.0)])
def test_build_plan_matches_jax(same_points, leaf, eta, clouds):
    x, y, _ = clouds
    if same_points:
        y = x
    got = tblr.build_plan(x, y, leaf=leaf, eta=eta, same_points=same_points)
    want = jblr.build_plan(x, y, leaf=leaf, eta=eta, same_points=same_points)
    for field in ("gather_x", "gid_x", "out_pos", "gather_y", "gid_y",
                  "near_pairs", "near_sym_pairs", "far_pairs"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.leaf, got.eta, got.same_points) == (
        want.leaf, want.eta, want.same_points)


@pytest.mark.parametrize("kernel", SQDIST_KERNELS)
@pytest.mark.parametrize("d", [3, 40])
def test_kernel_tile_matches_jax(kernel, d):
    # Coordinates scaled by 1/sqrt(D), so |x - y|^2 stays O(1) and the
    # Gaussian's values stay well above float32's underflow at D = 40.
    rng = np.random.default_rng(2)
    xb = (rng.uniform(-1, 1, (3, 16, d)) / np.sqrt(d)).astype(np.float32)
    yb = (rng.uniform(-1, 1, (3, 16, d)) / np.sqrt(d)).astype(np.float32)
    got = tblr._kernel_tile(get_kernel(kernel), torch.tensor(xb),
                            torch.tensor(yb)).numpy()
    want = np.stack([np.asarray(jblr._kernel_tile(
        jax_get_kernel(kernel), jnp.array(xb[p]), jnp.array(yb[p])))
        for p in range(3)])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_kernel_tile_keeps_close_pairs_finite():
    # Points 1e-4 apart at |x| ~ 1: the difference form keeps 1/|x - y|
    # finite where the BLAS form cancels to <= 0.
    x = torch.tensor([[[0.7, -0.3, 0.5]]])
    y = x + torch.tensor([[[1e-4, 0.0, 0.0]]])
    tile = tblr._kernel_tile(get_kernel("inverse-distance"), x, y)
    assert bool(torch.isfinite(tile).all())
    np.testing.assert_allclose(float(tile), 1e4, rtol=1e-2)


def test_thin_q_is_the_householder_q():
    a = torch.randn((6, 50, 12), generator=torch.Generator().manual_seed(0))
    a[:, :, 8:] = a[:, :, :4] * 1e-7     # numerically rank-deficient
    q = tblr._thin_q(a)
    want, _ = torch.linalg.qr(a)
    torch.testing.assert_close(q, want, rtol=1e-5, atol=1e-5)
    eye = torch.eye(12).expand(6, 12, 12)
    torch.testing.assert_close(q.mT @ q, eye, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", SQDIST_KERNELS)
def test_far_factors_match_jax(kernel, clouds):
    x, y, _ = clouds
    plan = tblr.build_plan(x, y, leaf=32, eta=2.0)
    xpts = x[plan.gather_x]
    ypts = y[plan.gather_y]
    fi, fj = plan.far_pairs[:, 0], plan.far_pairs[:, 1]
    u, v = tblr.compress_far_blocks(
        torch.tensor(xpts), torch.tensor(ypts), torch.tensor(fi).long(),
        torch.tensor(fj).long(), kernel_name=kernel, rank=12,
        omega=tblr.omega_from_array(jax_omega(32, 12), device="cpu"))
    ji, jj, _, _ = jblr._pad_pairs(plan.far_pairs, plan.num_x_blocks)
    ju, jv = jblr.compress_far_blocks(jnp.array(xpts), jnp.array(ypts), ji,
                                      jj, kernel_name=kernel, rank=12)
    pf = len(fi)
    got = (u @ v).numpy()
    want = np.asarray(ju)[:pf] @ np.asarray(jv)[:pf]
    err = (np.linalg.norm(got - want, axis=(1, 2))
           / np.linalg.norm(want, axis=(1, 2)))
    assert pf > 10 and err.max() < 1e-4, err.max()


def test_svd_factors_and_ranks_match_jax():
    rng = np.random.default_rng(3)
    y = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    port, ref = _ops(y, y, True, kernel_name="gaussian", leaf=64, rank=32,
                     eta=2.0, epsilon=1e-4)
    got, want = port.block_ranks, ref.block_ranks
    assert got.shape == want.shape and got.size > 100
    assert np.mean(got == want) >= 0.99, np.mean(got == want)
    assert np.abs(got - want).max() <= 1
    assert port.compression == pytest.approx(
        2048 * 2048 / (sum(2 * 64 * u.shape[2] * u.shape[0]
                           for u, _, _, _ in port.far_groups)
                       + (port.plan.near_pairs.shape[0]
                          + port.plan.near_sym_pairs.shape[0]) * 64 * 64))


def test_select_block_ranks_and_tiers_match_jax():
    rng = np.random.default_rng(4)
    sv2 = np.sort(rng.exponential(size=(200, 16)) ** 6, axis=1)[:, ::-1]
    sv2[:3] = 0.0
    for eps in (1e-1, 1e-3, 1e-6):
        got = tblr.select_block_ranks(sv2, eps)
        np.testing.assert_array_equal(got, jblr.select_block_ranks(sv2, eps))
        for (rt, it), (rj, ij) in zip(tblr._rank_tiers(got, 16),
                                      jblr._rank_tiers(got, 16),
                                      strict=True):
            assert rt == rj
            np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("kernel", ["gaussian", "absolute-exponential"])
@pytest.mark.parametrize("epsilon", [None, 1e-3])
def test_matvec_matches_jax(kernel, epsilon, clouds):
    x, y, b = clouds
    port, ref = _ops(x, y, False, kernel_name=kernel, leaf=32, rank=12,
                     eta=2.0, epsilon=epsilon)
    got = port.matvec(b).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.matvec(b)), rtol=2e-4,
                               atol=2e-5)
    assert port.mirror_groups == ()


@pytest.mark.parametrize("kernel", SQDIST_KERNELS)
@pytest.mark.parametrize("epsilon", [None, 1e-3])
def test_symmetric_matvec_matches_jax(kernel, epsilon, cloud):
    y, b = cloud
    port, ref = _ops(y, y, True, kernel_name=kernel, leaf=32, rank=32,
                     eta=1.0, epsilon=epsilon)
    got = port.matvec(b).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.matvec(b)), rtol=5e-4,
                               atol=5e-4)
    assert len(port.mirror_groups) == len(port.far_groups) >= 1
    assert port.plan.near_sym_pairs.shape[0] > 0


def test_inverse_distance_diagonal_is_masked(cloud):
    # rank == leaf: the range finder is exact, so the operator is K with
    # the oracle's zero diagonal (tests/test_blr.py:60-68).
    y, b = cloud
    op = tblr.BlrOperator(y, y, kernel_name="inverse-distance", leaf=32,
                          rank=32, eta=1.0, same_points=True, device="cpu")
    np.testing.assert_allclose(op.matvec(b[:, :1]).numpy(),
                               _truth("inverse-distance", y, y, b[:, :1]),
                               rtol=5e-4, atol=5e-4)


def test_symmetric_operator_matches_the_two_cloud_one(cloud):
    y, b = cloud
    kw = dict(kernel_name="gaussian", leaf=32, rank=32, eta=2.0,
              device="cpu")
    sym = tblr.BlrOperator(y, y, same_points=True, **kw)
    full = tblr.BlrOperator(y, y.copy(), same_points=False, **kw)
    assert 2 * sym.plan.far_pairs.shape[0] == full.plan.far_pairs.shape[0]
    assert sym.compression > full.compression
    want = _truth("gaussian", y, y, b)
    for op in (sym, full):
        np.testing.assert_allclose(op.matvec(b).numpy(), want, rtol=5e-4,
                                   atol=5e-4)
    np.testing.assert_allclose(sym.matvec(b).numpy(),
                               full.matvec(b).numpy(), rtol=5e-4, atol=5e-4)


def test_adaptive_epsilon_error_tracks_knob(clouds):
    # tests/test_blr.py:116-131 on the port's own draw.
    x, y, b = clouds
    want = _truth("gaussian", x, y, b)
    errs, mean_ranks = [], []
    for eps in (3e-1, 1e-2, 1e-5):
        op = tblr.BlrOperator(x, y, kernel_name="gaussian", leaf=32,
                              rank=32, eta=2.0, epsilon=eps, device="cpu")
        got = op.matvec(b).numpy()
        errs.append(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert op.block_ranks.shape == (op.plan.far_pairs.shape[0],)
        mean_ranks.append(op.block_ranks.mean())
    assert errs[0] > errs[1] > errs[2]
    assert mean_ranks[0] < mean_ranks[2]
    assert errs[2] < 1e-3


def test_mismatched_mirror_groups_are_refused(cloud):
    y, b = cloud
    op = tblr.BlrOperator(y, y, kernel_name="gaussian", leaf=32, rank=32,
                          eta=2.0, epsilon=1e-2, same_points=True,
                          device="cpu")
    assert len(op.far_groups) >= 2
    with pytest.raises(ValueError, match="mirror groups"):
        tblr.blr_matvec_blocks(
            op.xpts, op.ypts, op.gid_x, op.gid_y, op.far_groups,
            op.mirror_groups[:1], op.block_signal(b), op._near,
            op._near_sym, kernel_name="gaussian",
            num_x_blocks=op.plan.num_x_blocks, mask_diagonal=False)


def test_matvec_is_deterministic(cloud):
    y, b = cloud
    op = tblr.BlrOperator(y, y, kernel_name="inverse-distance", leaf=32,
                          rank=16, eta=2.0, epsilon=1e-3, same_points=True,
                          device="cpu")
    assert torch.equal(op.matvec(b), op.matvec(b))


def test_operator_defaults_to_the_card(cloud):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    y, _ = cloud
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tblr.BlrOperator(y, y, kernel_name="gaussian", leaf=32)
    with pytest.raises(NotImplementedError):
        tblr.BlrOperator(y, y, kernel_name="exponential", leaf=32,
                         device="cpu")
