"""The port's sharded engines (kmb_tpu_torch.parallel.sharded) in four gloo
processes on the CPU, against kmb_tpu.parallel.sharded on four of the
conftest's eight CPU devices.

One spawn per module runs tests/torch_sharded_worker.py as ranks 0-3 (a
FileStore in the module's temporary directory, so parallel test workers
never race for a port; one torch thread per rank).  The ring schedule runs
on a (4,) mesh and the all-pairs schedule on a (2, 2) mesh in both
packages, on the same numpy inputs, whose sizes are not multiples of the
meshes (padding, and masks at global offsets).

Tolerances, those of tests/test_parallel.py: products rtol = atol = 2e-4,
normalised rows rtol 1e-4 and atol 1e-5 (the packages sum in other orders,
and the JAX engine on the CPU is the blocked XLA product); solves: the
same iteration count within max(3, 10%) (two float32 Krylov loops agree
exactly only while their roundings do; the band of
tests/test_parallel.py:135-160), solutions within 5e-2 of the truth for
the SPD systems, and within rtol = atol = 1e-2 of JAX's for the normal
equations and MINRES, whose accuracy is conditioning-limited.  Every rank
must end with the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmb_tpu.algorithms.bruteforce_numpy import kernel_matrix
from kmb_tpu.ops import solve as jsolve
from kmb_tpu.parallel import sharded as jsharded

from torch_sharded_worker import spawn_ranks

KERNELS = ["gaussian", "absolute-exponential", "inverse-distance",
           "exponential"]
WORLD = 4
PRODUCT_TOL = dict(rtol=2e-4, atol=2e-4)
NORMALIZED_TOL = dict(rtol=1e-4, atol=1e-5)
# (kernel, points, signal columns, tol, max_iters, Nystrom rank or 0)
SOLVES = {
    "cg": ("gaussian", 64, 2, 1e-5, 2000, 0),
    "cg_padded": ("gaussian", 70, 1, 1e-5, 2000, 0),   # m_pad = 96
    "pcg": ("absolute-exponential", 128, 1, 1e-5, 2000, 32),
    "normal": ("inverse-distance", 64, 1, 1e-6, 3000, 32),
    "minres": ("inverse-distance", 64, 1, 1e-5, 2000, 0),
}


def _truth(kernel, x, y, b):
    k = kernel_matrix(kernel=kernel, source_points=np.float64(y),
                      target_points=np.float64(x))
    return k @ np.float64(b)


def _m_pad(m):
    return -(-m // (WORLD * 8)) * (WORLD * 8)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)

    def points(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    data = dict(x=points(101, 3), y=points(83, 3), b=points(83, 2),
                x_wide=points(37, 3), y_wide=points(129, 3),
                b_wide=points(129, 2), y_same=points(90, 3),
                b_same=points(90, 1))
    for case, (kernel, m, e, tol, max_iters, rank) in SOLVES.items():
        y = points(m, 3)
        b = points(m, e)
        data[f"{case}/kernel"] = np.array(kernel)
        data[f"{case}/y"] = y
        data[f"{case}/b"] = b
        data[f"{case}/rhs"] = _truth(kernel, y, y, b).astype(np.float32)
        data[f"{case}/tol"] = np.float64(tol)
        data[f"{case}/max_iters"] = np.int64(max_iters)
        if rank:
            # JAX's own draw (kmb_tpu/ops/solve.py nystrom_preconditioner
            # under build_sharded_precond): the port takes it as `omega`.
            data[f"{case}/omega"] = np.asarray(jax.random.normal(
                jax.random.PRNGKey(0), (_m_pad(m), rank), jnp.float32))
    # JAX's factors of the PCG case, built on one device from the same draw
    # (m = m_pad there): the port takes them through the converter.
    kernel, m, _, _, _, rank = SOLVES["pcg"]
    k = jnp.asarray(kernel_matrix(kernel=kernel, source_points=np.float64(
        data["pcg/y"])), jnp.float32)
    u, lam = jsolve.nystrom_preconditioner(
        lambda v: jnp.matmul(k, v, precision=jax.lax.Precision.HIGHEST), m,
        rank, method="gram")
    data["pcg/jax_u"], data["pcg/jax_lam"] = np.asarray(u), np.asarray(lam)
    return data


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks("sharded", WORLD, inputs,
                       str(tmp_path_factory.mktemp("sharded")))


@pytest.fixture(scope="module")
def jax_meshes():
    devices = jax.devices()[:WORLD]
    return {"ring": jsharded.make_mesh((WORLD,), devices=devices),
            "allpairs": jsharded.make_mesh((2, 2), ("tgt", "src"),
                                           devices=devices)}


def _jax_product(jax_meshes, schedule, x, y, b, **kw):
    return np.asarray(jsharded.sharded_kernel_matvec(
        jnp.asarray(x), jnp.asarray(y), None if b is None else jnp.asarray(b),
        mesh=jax_meshes[schedule], schedule=schedule, **kw))


@pytest.mark.parametrize("variant", ["plain", "normalized", "ragged"])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("schedule", ["ring", "allpairs"])
def test_products_match_jax(schedule, kernel, variant, inputs, ranks,
                            jax_meshes):
    if variant == "ragged":   # N < M; attention rows for the exponential
        x, y, b = inputs["x_wide"], inputs["y_wide"], inputs["b_wide"]
        normalize = kernel == "exponential"
    else:
        x, y, b = inputs["x"], inputs["y"], inputs["b"]
        normalize = variant == "normalized"
    want = _jax_product(jax_meshes, schedule, x, y, b, kernel_name=kernel,
                        normalize_rows=normalize)
    got = ranks[0][f"{schedule}/{kernel}/{variant}"]
    assert got.shape == (len(x), b.shape[1])
    np.testing.assert_allclose(got, want, **(NORMALIZED_TOL if normalize
                                             else PRODUCT_TOL))


@pytest.mark.parametrize("schedule", ["ring", "allpairs"])
def test_same_points_diagonal_matches_jax(schedule, inputs, ranks,
                                          jax_meshes):
    # The singular kernel's diagonal is masked at global positions, across
    # shards and (ring) after every rotation.
    y, b = inputs["y_same"], inputs["b_same"]
    want = _jax_product(jax_meshes, schedule, y, y, b,
                        kernel_name="inverse-distance")
    got = ranks[0][f"{schedule}/diagonal"]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **PRODUCT_TOL)
    k = kernel_matrix(kernel="inverse-distance", source_points=np.float64(y))
    np.testing.assert_allclose(got, k @ np.float64(b), **PRODUCT_TOL)


@pytest.mark.parametrize("schedule", ["ring", "allpairs"])
def test_density_estimation_matches_jax(schedule, inputs, ranks,
                                        jax_meshes):
    x, y = inputs["x"], inputs["y"]
    want = _jax_product(jax_meshes, schedule, x, y, None,
                        kernel_name="gaussian", density_estimation=True)
    got = ranks[0][f"{schedule}/density"]
    assert got.shape == (len(x), 1)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("rank", range(1, WORLD))
def test_every_rank_ends_with_the_same_bits(rank, ranks):
    # The gathered products, and each solve's iterate, count and residual:
    # every rank took the same branch at every Krylov iteration.
    assert sorted(ranks[rank]) == sorted(ranks[0])
    for key, value in ranks[0].items():
        np.testing.assert_array_equal(ranks[rank][key], value, err_msg=key)


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solves_match_jax(case, inputs, ranks, jax_meshes):
    kernel, m, _, tol, max_iters, rank = SOLVES[case]
    y, rhs = inputs[f"{case}/y"], inputs[f"{case}/rhs"]
    want, want_iters, want_res = jsharded.sharded_cg_solve(
        y, rhs, mesh=jax_meshes["ring"], kernel_name=kernel, tol=tol,
        max_iters=max_iters, precond_rank=rank)
    want, want_iters = np.asarray(want), int(want_iters)
    got = ranks[0][f"{case}/solution"]
    got_iters = int(ranks[0][f"{case}/iterations"])
    assert got.shape == (m, rhs.shape[1])
    assert abs(got_iters - want_iters) <= max(3, 0.1 * want_iters), (
        got_iters, want_iters)
    if case in ("normal", "minres"):
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        assert ranks[0][f"{case}/residual"] < 10 * tol
        np.testing.assert_allclose(got, inputs[f"{case}/b"], atol=5e-2)
        np.testing.assert_allclose(got, want, atol=5e-2)


def test_pcg_on_jax_factors_matches_jax(inputs, ranks, jax_meshes):
    # The factors of JAX's sharded build, handed over as arrays
    # (`sharded_precond_from_arrays`): each rank keeps its rows of U.
    kernel, m, _, tol, max_iters, rank = SOLVES["pcg"]
    _, want_iters, _ = jsharded.sharded_cg_solve(
        inputs["pcg/y"], inputs["pcg/rhs"], mesh=jax_meshes["ring"],
        kernel_name=kernel, tol=tol, max_iters=max_iters, precond_rank=rank)
    got_iters = int(ranks[0]["pcg_jax_factors/iterations"])
    assert abs(got_iters - int(want_iters)) <= max(3, 0.1 * int(want_iters))
    np.testing.assert_allclose(ranks[0]["pcg_jax_factors/solution"],
                               inputs["pcg/b"], atol=5e-2)


# The sharded Nystrom build's sketch K @ Q at E = rank, as the ring's ranks
# compute it (PERF.md, the split of the four-card PCG's count).  On the
# CPU, in this process.
SKETCH_M, SKETCH_RANK = 300, 40


@pytest.fixture(scope="module")
def sketch_inputs():
    rng = np.random.default_rng(7)
    return (rng.random((SKETCH_M, 3)).astype(np.float32),
            rng.standard_normal((SKETCH_M, SKETCH_RANK)).astype(np.float32))


def test_ring_chunked_sketch_matches_jax(sketch_inputs, jax_meshes):
    # Four virtual ranks, each chunk's points and signal the strided halves
    # of the packed (y | b) buffer the ranks rotate (a chunk on them equals
    # the chunk on contiguous shards), folded in ring order.
    import torch

    from kmb_tpu_torch.parallel import sharded

    y, q = sketch_inputs
    want = _jax_product(jax_meshes, "ring", y, y, q, kernel_name="gaussian")
    ty, tq = torch.from_numpy(y), torch.from_numpy(q)
    got = sharded.virtual_ring_product(ty, ty, tq, p=WORLD,
                                       kernel_name="gaussian")
    assert got.shape == (SKETCH_M, SKETCH_RANK)
    np.testing.assert_allclose(got.numpy(), want, **PRODUCT_TOL)
    ys, qs = (sharded.shard_rows(t, WORLD, 1, "cpu") for t in (ty, tq))
    packed = torch.cat([ys, qs], dim=1)
    chunk = dict(me=2, step=1, p=WORLD, n=SKETCH_M, m=SKETCH_M,
                 kernel_name="gaussian")
    np.testing.assert_array_equal(
        sharded.ring_chunk(ys, packed[:, :3], packed[:, 3:], **chunk)[0],
        sharded.ring_chunk(ys, ys, qs, **chunk)[0])


def test_sharded_gram_build_sums_in_float64(sketch_inputs, jax_meshes):
    # Every Gram of the sharded "gram" build is summed over the ranks in
    # float64 (the sketch's squared norm in float32), and a mesh of one
    # gives the single card's factors.  Their leading eigenvalues are K's
    # (float64) within 5e-3 and JAX's "gram" build's within 5e-2 (JAX
    # draws its own test matrix and shifts by more).
    import torch

    from kmb_tpu_torch.ops import solve
    from kmb_tpu_torch.parallel import sharded

    y, _ = sketch_inputs
    mesh = sharded.make_mesh(device="cpu")
    reduced = []

    def allreduce(t, *args):
        reduced.append(t.dtype)
        return t

    mesh.allreduce = allreduce
    omega = sharded.draw_test_matrix(SKETCH_M, SKETCH_RANK, "cpu")
    prepared = sharded.prepare_sharded_cg(
        y, mesh=mesh, kernel_name="gaussian", precond_rank=SKETCH_RANK,
        omega=omega)
    assert reduced == [torch.float64, torch.float32, torch.float64,
                       torch.float64]
    ty = torch.from_numpy(y)
    u, lam = solve.nystrom_factors(
        lambda v: solve.kernel_matvec(ty, ty, v, kernel_name="gaussian"),
        omega, method="gram")
    np.testing.assert_allclose(prepared.precond.lam.numpy(), lam.numpy(),
                               rtol=1e-5, atol=1e-6 * float(lam[0]))
    k = jnp.asarray(kernel_matrix(kernel="gaussian",
                                  source_points=np.float64(y)), jnp.float32)
    _, want_lam = jsolve.nystrom_preconditioner(
        lambda v: jnp.matmul(k, v, precision=jax.lax.Precision.HIGHEST),
        SKETCH_M, SKETCH_RANK, method="gram")
    top = SKETCH_RANK // 4
    exact = np.linalg.eigvalsh(np.float64(k))[::-1][:top]
    np.testing.assert_allclose(lam.numpy()[:top], exact, rtol=5e-3)
    np.testing.assert_allclose(lam.numpy()[:top], np.asarray(want_lam)[:top],
                               rtol=5e-2)
