"""The port's multi-process runtime (kmb_tpu_torch.parallel.multihost), the
runner's rank-0 result ownership and the sharded algorithms' lifecycle.

Single-process identities as tests/test_multihost.py checks them for the
JAX package; a two-process gloo run (tests/torch_sharded_worker.py, mode
"multihost", brought up from the KMB_* variables) of the helpers,
`ShardedProduct` and `ShardedSolverCG`, `runner.run` and the CLI, as
tests/test_multihost_integration.py runs the JAX package's; and the
lifecycle in a world of one, as tests/test_sharded_algorithms.py.

Tolerances, those of tests/test_sharded_algorithms.py: products rtol 1e-4
and atol 1e-5 of the float64 oracle, solutions atol 5e-2 of the truth.
"""

import os

import numpy as np
import pytest
import torch

from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product
from kmb_tpu_torch.algorithms.torch_sharded import (
    ShardedProduct, ShardedSolverCG)
from kmb_tpu_torch.parallel import multihost

from torch_sharded_worker import spawn_ranks

DATASET = "product-sphere-D3-E1-M1000-N1000-inverse-distance"
PRODUCT_TOL = dict(rtol=1e-4, atol=1e-5)
LAUNCH_VARIABLES = ("KMB_COORDINATOR_ADDRESS", "KMB_NUM_PROCESSES",
                    "KMB_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                    "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCH_VARIABLES:
        monkeypatch.delenv(name, raising=False)


def test_initialize_noop_without_config(no_launcher):
    assert multihost.initialize() is False
    assert multihost.initialize(device="cpu") is False


def test_initialize_needs_a_process_id(no_launcher):
    with pytest.raises(ValueError, match="process"):
        multihost.initialize("localhost:1234", num_processes=2)


def test_initialize_on_the_card_raises_without_one(no_launcher, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize(f"file://{tmp_path}/store", num_processes=1,
                             process_id=0)


def test_coordinator_is_rank_zero():
    assert multihost.is_coordinator() is True
    assert multihost.num_hosts() == 1


def test_barrier_runs():
    multihost.barrier()


def test_max_across_hosts_identity_single_process():
    assert multihost.max_across_hosts(1.25) == 1.25


def test_broadcast_identity_single_process():
    plan = ["a", "b"]
    assert multihost.broadcast_from_coordinator(plan) is plan


# -- two gloo processes ---------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from kmb_tpu_torch.datasets import get_dataset

    tmp = str(tmp_path_factory.mktemp("multihost"))
    dirs = dict(KMB_DATA_DIR=os.path.join(tmp, "data"),
                KMB_RESULTS_DIR=os.path.join(tmp, "results"))
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dirs.items():
            mp.setenv(name, value)
        get_dataset(DATASET, device="cpu")[0].close()   # pre-generated
    rng = np.random.default_rng(0)
    inputs = dict(y=rng.standard_normal((53, 3)),
                  x=rng.standard_normal((37, 3)),
                  b=rng.standard_normal((53, 2)),
                  y_solve=rng.standard_normal((64, 3)),
                  b_solve=rng.standard_normal((64, 1)),
                  dataset=np.array(DATASET))
    outputs = spawn_ranks("multihost", 2, inputs, tmp, env=dirs)
    return inputs, outputs, dirs["KMB_RESULTS_DIR"]


def test_two_processes_write_one_result_per_experiment(two_ranks):
    import h5py

    _, _, results = two_ranks
    files = sorted(os.path.join(root, name)
                   for root, _, names in os.walk(results)
                   for name in names if name.endswith(".hdf5"))
    # runner.run of ShardedProduct and the CLI's torch-product-cpu, each
    # written by rank 0 alone.
    assert len(files) == 2, files
    algos = set()
    for fn in files:
        with h5py.File(fn, "r") as f:
            algos.add(f.attrs["algo"])
            assert f.attrs["query_time"] > 0
            if f.attrs["algo"] == "torch-sharded-product":
                assert f.attrs["n_chips"] == 2
                err = np.sqrt(np.mean(f["error"][:] ** 2))
                assert err < 1e-4 * np.sqrt(np.mean(f["result"][:] ** 2))
    assert algos == {"torch-sharded-product", "torch-product-cpu"}


def test_fleet_max_across_two_processes(two_ranks):
    _, outputs, _ = two_ranks
    assert [float(out["max"]) for out in outputs] == [2.0, 2.0]


@pytest.mark.parametrize("key", ["product/ring", "product/allpairs",
                                 "product/subset"])
def test_two_process_product_matches_oracle(key, two_ranks):
    inputs, outputs, _ = two_ranks
    want = blocked_kernel_product(
        kernel="gaussian", source_points=inputs["y"],
        target_points=inputs["x"], source_signal=inputs["b"])
    for out in outputs:
        np.testing.assert_allclose(out[key], want, **PRODUCT_TOL)
    np.testing.assert_array_equal(outputs[1][key], outputs[0][key])
    if key != "product/subset":
        assert all(int(out[f"{key}/n_chips"]) == 2 for out in outputs)


@pytest.mark.parametrize("precond_rank, n_chips", [(0, 2), (16, 2),
                                                   (16, 1)])
def test_two_process_solver_matches_truth(precond_rank, n_chips, two_ranks):
    # n_chips = 1: a mesh of rank 0 alone; rank 1 takes its answer.
    inputs, outputs, _ = two_ranks
    key = f"solver/{precond_rank}/{n_chips}"
    for out in outputs:
        np.testing.assert_allclose(out[key], inputs["b_solve"], atol=5e-2)
        assert int(out[f"{key}/n_chips"]) == n_chips
    assert (int(outputs[0][f"{key}/iterations"])
            == int(outputs[1][f"{key}/iterations"]) > 0)
    np.testing.assert_array_equal(outputs[1][key], outputs[0][key])


# -- the lifecycle in a world of one ---------------------------------------------

def _product(rng, **kw):
    y = rng.standard_normal((53, 3))
    x = rng.standard_normal((37, 3))
    b = rng.standard_normal((53, 2))
    algo = ShardedProduct(kernel="gaussian", dimension=3, device="cpu", **kw)
    algo.prepare_data(source_points=y, target_points=x, same_points=False)
    algo.fit()
    algo.prepare_query(source_signal=b)
    algo.query()
    want = blocked_kernel_product(kernel="gaussian", source_points=y,
                                  target_points=x, source_signal=b)
    return algo, want


@pytest.mark.parametrize("schedule", ["ring", "allpairs"])
def test_sharded_product_lifecycle(rng, schedule):
    algo, want = _product(rng, schedule=schedule)
    np.testing.assert_allclose(algo.get_result(), want, **PRODUCT_TOL)
    extra = algo.get_additional()
    assert extra["n_chips"] == 1 and extra["schedule"] == schedule
    # All-pairs degrades to the ring on a 1-D world.
    assert algo.mesh.shape == (1,)


def test_sharded_attention_lifecycle(rng):
    y = rng.standard_normal((40, 4))
    b = rng.standard_normal((40, 1))
    algo = ShardedProduct(kernel="exponential", dimension=4,
                          normalize_rows=True, device="cpu")
    algo.prepare_data(source_points=y, target_points=y, same_points=True)
    algo.fit()
    algo.prepare_query(source_signal=b)
    algo.query()
    want = blocked_kernel_product(kernel="exponential", source_points=y,
                                  source_signal=b, normalize_rows=True)
    np.testing.assert_allclose(algo.get_result(), want, **PRODUCT_TOL)


def test_sharded_density_lifecycle(rng):
    y = rng.standard_normal((45, 3))
    algo = ShardedProduct(kernel="gaussian", dimension=3, device="cpu")
    algo.prepare_data(source_points=y, target_points=y, same_points=True,
                      density_estimation=True)
    algo.prepare_query(source_signal=None)
    algo.query()
    want = blocked_kernel_product(kernel="gaussian", source_points=y,
                                  source_signal=np.ones((45, 1)))
    np.testing.assert_allclose(algo.get_result(), want, **PRODUCT_TOL)


@pytest.mark.parametrize("precond_rank", [0, 16])
def test_sharded_solver_cg_lifecycle(rng, precond_rank):
    m = 64
    y = rng.standard_normal((m, 3))
    b = rng.standard_normal((m, 1))
    rhs = blocked_kernel_product(kernel="gaussian", source_points=y,
                                 source_signal=b)
    algo = ShardedSolverCG(kernel="gaussian", dimension=3, tol=1e-6,
                           max_iters=2000, precond_rank=precond_rank,
                           device="cpu")
    algo.prepare_data(source_points=y)
    algo.fit()
    algo.set_query_arguments(tol=1e-7)
    assert algo.name == ("ShardedSolverCG(float32, tol=1e-07"
                         + (", rank=16)" if precond_rank else ")"))
    algo.prepare_query(target_signal=rhs)
    algo.query()
    extra = algo.get_additional()
    assert extra["n_chips"] == 1
    assert extra["cg_iterations"] > 0
    assert extra["cg_relative_residual"] < 1e-5
    np.testing.assert_allclose(algo.get_result(), b, atol=5e-2)


def test_more_devices_than_ranks_raise(rng):
    algo = ShardedProduct(kernel="gaussian", dimension=3, n_devices=8,
                          device="cpu")
    with pytest.raises(RuntimeError, match="requested 8 devices, have 1"):
        algo.prepare_data(source_points=np.zeros((4, 3)),
                          target_points=np.zeros((4, 3)))
    solver = ShardedSolverCG(kernel="gaussian", dimension=3, n_devices=2,
                             device="cpu")
    with pytest.raises(RuntimeError, match="requested 2 devices, have 1"):
        solver.prepare_data(source_points=np.zeros((4, 3)))


def test_mesh_shape_needs_as_many_ranks(rng):
    algo = ShardedProduct(kernel="gaussian", dimension=3,
                          schedule="allpairs", mesh_shape=[2, 2],
                          device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        algo.prepare_data(source_points=np.zeros((4, 3)),
                          target_points=np.zeros((4, 3)))
