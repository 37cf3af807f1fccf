"""Worker run by tests/test_torch_sharded.py and
tests/test_torch_multihost.py in several processes, one rank each, over a
gloo process group on the CPU.

Usage:
    python torch_sharded_worker.py <mode> <rank> <world> <store> <inputs.npz> <out_dir>

`store` is the path of the FileStore all ranks rendezvous on; every rank
writes its outputs to <out_dir>/rank<rank>.npz and prints WORKER_OK.  The
tests start the ranks with `spawn_ranks`.

Modes:
- "sharded" (4 ranks): the ring schedule on a (4,) mesh and the all-pairs
  schedule on a (2, 2) mesh for every case the parent compares with
  kmb_tpu.parallel.sharded, and the sharded CG, PCG, normal-equations and
  MINRES solves.
- "multihost" (2 ranks): brought up from the KMB_* environment variables;
  the runtime helpers, the lifecycle of ShardedProduct and
  ShardedSolverCG, one `runner.run` of ShardedProduct and one CLI run of
  torch-product-cpu on a dataset the parent generated.
- "scaling" (2 ranks, from the KMB_* variables): kmb_tpu_torch.scaling's
  sweep over meshes of 1 and 2 ranks (rank 1 outside the first), its rows
  and rank 0's answers.
- "subprocess-cli" (2 ranks, from the KMB_* variables): the CLI without
  --local, which must refuse to run; the message it exits with.
- "trace" (2 or 4 ranks): two ring queries of ShardedProduct, each inside
  a `kmb_tpu_torch.trace` recording; the second's span names, parents and
  points staged, and both answers.
"""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("gaussian", "absolute-exponential", "inverse-distance",
           "exponential")


def spawn_ranks(mode, world, inputs, tmp, env=None, timeout=180):
    """Run the worker as `world` gloo ranks; returns each rank's outputs."""
    store = os.path.join(tmp, "store")
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                **(env or {}))
    base.pop("XLA_FLAGS", None)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(world), store, os.path.join(tmp, "inputs.npz"), tmp],
        cwd=tmp, env=base, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0 and f"WORKER_OK rank={rank}" in log, (
            f"rank {rank} failed:\n{log}")
    outputs = []
    for rank in range(world):
        with np.load(os.path.join(tmp, f"rank{rank}.npz")) as f:
            outputs.append(dict(f))
    return outputs


def sharded(rank, inputs, out):
    from kmb_tpu_torch.parallel import sharded as sh

    meshes = {"ring": sh.make_mesh((4,), device="cpu"),
              "allpairs": sh.make_mesh((2, 2), device="cpu")}
    assert meshes["allpairs"].coords == divmod(rank, 2)
    x, y, b = inputs["x"], inputs["y"], inputs["b"]
    for schedule, mesh in meshes.items():
        def product(key, xx, yy, bb, **kw):
            out[f"{schedule}/{key}"] = sh.sharded_kernel_matvec(
                xx, yy, bb, mesh=mesh, schedule=schedule, **kw).numpy()

        for kernel in KERNELS:
            product(f"{kernel}/plain", x, y, b, kernel_name=kernel)
            product(f"{kernel}/normalized", x, y, b, kernel_name=kernel,
                    normalize_rows=True)
            product(f"{kernel}/ragged", inputs["x_wide"], inputs["y_wide"],
                    inputs["b_wide"], kernel_name=kernel,
                    normalize_rows=kernel == "exponential")
        product("diagonal", inputs["y_same"], inputs["y_same"],
                inputs["b_same"], kernel_name="inverse-distance")
        product("density", x, y, None, kernel_name="gaussian",
                density_estimation=True)

    for case in ("cg", "cg_padded", "pcg", "normal", "minres"):
        kernel = str(inputs[f"{case}/kernel"])
        omega = inputs.get(f"{case}/omega")
        solution, iters, residual = sh.sharded_cg_solve(
            inputs[f"{case}/y"], inputs[f"{case}/rhs"], mesh=meshes["ring"],
            kernel_name=kernel, tol=float(inputs[f"{case}/tol"]),
            max_iters=int(inputs[f"{case}/max_iters"]),
            precond_rank=0 if omega is None else omega.shape[1],
            omega=omega)
        out[f"{case}/solution"] = solution.numpy()
        out[f"{case}/iterations"] = np.int64(iters)
        out[f"{case}/residual"] = np.float64(residual)

    # PCG on the JAX package's own factors, each rank keeping its rows.
    mesh = meshes["ring"]
    prepared = sh.prepare_sharded_cg(inputs["pcg/y"], mesh=mesh,
                                     kernel_name="absolute-exponential")
    prepared = prepared._replace(precond=sh.sharded_precond_from_arrays(
        inputs["pcg/jax_u"], inputs["pcg/jax_lam"], mesh=mesh))
    solution, iters, _ = sh.cg_solve_shard(
        prepared, sh.shard_rows(inputs["pcg/rhs"], 4, mesh.index, "cpu"),
        kernel_name="absolute-exponential", tol=float(inputs["pcg/tol"]),
        max_iters=int(inputs["pcg/max_iters"]))
    out["pcg_jax_factors/solution"] = mesh.gather_rows(
        solution, len(inputs["pcg/y"])).numpy()
    out["pcg_jax_factors/iterations"] = np.int64(iters)


def trace_mode(rank, world, inputs, out):
    from kmb_tpu_torch import trace
    from kmb_tpu_torch.algorithms.torch_sharded import ShardedProduct

    engine = ShardedProduct(kernel="gaussian", dimension=3, schedule="ring",
                            device="cpu")
    engine.prepare_data(source_points=inputs["y"],
                        target_points=inputs["x"])
    engine.fit()
    for i in range(2):
        with trace.recording() as rec:
            engine.prepare_query(source_signal=inputs["b"])
            engine.query()
            out[f"answer{i}"] = engine.get_result()
    out["names"] = np.array([s.name for s in rec.spans])
    out["parents"] = np.array([s.parent for s in rec.spans])
    out["queries"] = np.array([s.query for s in rec.spans])
    out["points_staged"] = np.int64(rec.counts.get("points_staged", 0))
    engine.done()


def multihost_mode(rank, world, inputs, out):
    from kmb_tpu_torch.algorithms.bruteforce_numpy import (
        blocked_kernel_product)
    from kmb_tpu_torch.algorithms.torch_sharded import (
        ShardedProduct, ShardedSolverCG)
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.main import main as cli_main
    from kmb_tpu_torch.parallel import multihost
    from kmb_tpu_torch.runner import run

    assert multihost.is_coordinator() == (rank == 0)
    assert multihost.num_hosts() == world
    multihost.barrier()
    out["max"] = np.float64(multihost.max_across_hosts(1.0 + rank))

    y, x, b = inputs["y"], inputs["x"], inputs["b"]
    for schedule in ("ring", "allpairs"):
        algo = ShardedProduct(kernel="gaussian", dimension=3,
                              schedule=schedule, device="cpu")
        algo.prepare_data(source_points=y, target_points=x)
        algo.fit()
        algo.prepare_query(source_signal=b)
        algo.query()
        out[f"product/{schedule}"] = algo.get_result()
        out[f"product/{schedule}/n_chips"] = algo.get_additional()["n_chips"]
        algo.done()
    # A mesh of one of the two ranks: rank 1 takes rank 0's answer.
    algo = ShardedProduct(kernel="gaussian", dimension=3, n_devices=1,
                          device="cpu")
    algo.prepare_data(source_points=y, target_points=x)
    algo.prepare_query(source_signal=b)
    algo.query()
    out["product/subset"] = algo.get_result()

    ys = inputs["y_solve"]
    rhs = blocked_kernel_product(kernel="gaussian", source_points=ys,
                                 source_signal=inputs["b_solve"])
    for precond_rank, n_devices in ((0, None), (16, None), (16, 1)):
        algo = ShardedSolverCG(kernel="gaussian", dimension=3, tol=1e-6,
                               max_iters=2000, precond_rank=precond_rank,
                               n_devices=n_devices, device="cpu")
        algo.prepare_data(source_points=ys)
        algo.fit()
        algo.set_query_arguments(tol=1e-7)
        algo.prepare_query(target_signal=rhs)
        algo.query()
        extra = algo.get_additional()
        key = f"solver/{precond_rank}/{n_devices or world}"
        out[key] = algo.get_result()
        out[f"{key}/iterations"] = extra["cg_iterations"]
        out[f"{key}/n_chips"] = extra["n_chips"]

    definition = Definition(
        algorithm="torch-sharded-product",
        module="kmb_tpu_torch.algorithms.torch_sharded",
        constructor="ShardedProduct",
        arguments={"kernel": "inverse-distance", "dimension": 3,
                   "precision": "float32", "schedule": "ring",
                   "device": "cpu"},
        query_argument_groups=[{}])
    run(definition=definition, dataset=str(inputs["dataset"]), runs=1,
        device="cpu")
    cli_main(["--local", "--hardware", "CPU", "--dataset",
              str(inputs["dataset"]),
              "--algorithm", "torch-product-cpu", "--runs", "1"])
    multihost.barrier()


def scaling_mode(rank, world, inputs, out):
    from kmb_tpu_torch import scaling

    answers = []
    rows = scaling.measure(int(inputs["n"]), 3, 1, "gaussian", [1, 2],
                           runs=2, device="cpu", outputs=answers)
    for row in rows:
        for key, value in row.items():
            out[f"row{row['devices']}/{key}"] = np.float64(value)
    for p, answer in zip((1, 2), answers):
        out[f"answer{p}/member"] = np.bool_(answer is not None)
        if answer is not None:
            out[f"answer{p}"] = answer.numpy()


def subprocess_cli_mode(rank, world, inputs, out):
    from kmb_tpu_torch.main import main as cli_main

    try:
        cli_main(["--hardware", "CPU", "--dataset", str(inputs["dataset"])])
    except SystemExit as exc:
        out["exit"] = np.array(str(exc.code))
    else:
        out["exit"] = np.array("")


def main():
    mode, rank, world, store, inputs_path, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from kmb_tpu_torch.parallel import multihost

    if mode in ("sharded", "trace"):
        assert multihost.initialize(coordinator_address=f"file://{store}",
                                    num_processes=world, process_id=rank,
                                    device="cpu")
    else:   # the launcher's variables, as a multi-process CLI run reads them
        os.environ.update(KMB_COORDINATOR_ADDRESS=f"file://{store}",
                          KMB_NUM_PROCESSES=str(world),
                          KMB_PROCESS_ID=str(rank))
        assert multihost.initialize(device="cpu")
        assert multihost.initialize(device="cpu")   # a second call: no-op
    with np.load(inputs_path) as f:
        inputs = dict(f)
    out = {}
    if mode == "sharded":
        sharded(rank, inputs, out)
    elif mode == "scaling":
        scaling_mode(rank, world, inputs, out)
    elif mode == "subprocess-cli":
        subprocess_cli_mode(rank, world, inputs, out)
    elif mode == "trace":
        trace_mode(rank, world, inputs, out)
    else:
        multihost_mode(rank, world, inputs, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK rank={rank}")


if __name__ == "__main__":
    main()
