"""Scaling-efficiency report: the ring-scheduled product on 1..P cards.

The port's twin of the repository's scaling.py.  Times the ring-scheduled
streaming product (`parallel.sharded.ring_kernel_matvec`) over meshes of
increasing size and reports throughput, per-card throughput and the
efficiency relative to perfect linear scaling from the smallest mesh:

    efficiency(p) = pairs_per_second(p) / (p * pairs_per_second(1))

One process per card, so a sweep over p cards runs under torchrun (or the
KMB_COORDINATOR_ADDRESS, KMB_NUM_PROCESSES and KMB_PROCESS_ID variables):

    torchrun --nproc-per-node 4 -m kmb_tpu_torch.scaling -n 1048576

Without a process group it runs in a world of one.  The mesh of size p
holds ranks 0..p-1; the other ranks wait at each timing's barrier and
never call the mesh's collectives.  Rank 0 prints a table plus one JSON
line per mesh size, with the JAX sweep's keys.  `--hardware CPU` runs the
plain PyTorch product in gloo processes (the tests).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def measure(n, d, e, kernel, device_counts, runs, *, device="cuda",
            outputs=None):
    """One row per mesh size: devices, seconds, pairs_per_second,
    efficiency.

    The points and the signal are the JAX sweep's: standard normal draws
    of np.random.default_rng(0), x (n, d) then b (n, e), in float32.  Each
    mesh's product is run once untimed (the kernels' first-use build),
    then `runs` times, each from a barrier of every rank to `hard_fence`
    on every rank of the mesh; `seconds` is the best run's slowest rank.
    If `outputs` is a list, each mesh's (n, e) answer is appended to it
    (None on a rank outside that mesh).
    """
    import torch

    from kmb_tpu_torch import resolve_device
    from kmb_tpu_torch.parallel import multihost
    from kmb_tpu_torch.parallel.sharded import make_mesh, ring_kernel_matvec
    from kmb_tpu_torch.utils import hard_fence

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal((n, e)), dtype=torch.float32,
                     device=dev)

    world = multihost.num_hosts()
    rows = []
    for p in device_counts:
        if not 1 <= p <= world:
            raise ValueError(f"a mesh of {p} cards needs {p} ranks; the "
                             f"process group has {world}")
        # Every rank makes every mesh, in the same order: the process
        # groups under them are made collectively.
        mesh = make_mesh(ranks=range(p), device=device)

        def step():
            return hard_fence(ring_kernel_matvec(
                x, x, b, mesh=mesh, kernel_name=kernel))

        out = step() if mesh.member else None   # first use: build
        best = float("inf")
        for _ in range(runs):
            multihost.barrier()
            t0 = time.perf_counter()
            if mesh.member:
                step()
            elapsed = time.perf_counter() - t0 if mesh.member else 0.0
            best = min(best, multihost.max_across_hosts(elapsed))
        rows.append({"devices": p, "seconds": best,
                     "pairs_per_second": n * n / best})
        if outputs is not None:
            outputs.append(out)
    base = rows[0]["pairs_per_second"] / rows[0]["devices"]
    for row in rows:
        row["efficiency"] = (
            row["pairs_per_second"] / (row["devices"] * base))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.scaling")
    parser.add_argument("-n", type=int, default=2**15,
                        help="N = M problem size")
    parser.add_argument("-d", type=int, default=3)
    parser.add_argument("-e", type=int, default=1)
    parser.add_argument("--kernel", default="gaussian")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--devices", type=int, nargs="*",
                        help="card counts to test (default 1,2,4,..,P)")
    parser.add_argument(
        "--hardware", default="GPU", choices=["CPU", "GPU"],
        help="GPU: one card per rank (NCCL); CPU: the plain PyTorch "
             "product in gloo processes")
    args = parser.parse_args(argv)

    from kmb_tpu_torch.parallel import multihost

    device = "cuda" if args.hardware == "GPU" else "cpu"
    multihost.initialize(device=device)
    available = multihost.num_hosts()
    counts = args.devices or [
        p for p in [1, 2, 4, 8, 16, 32, 64] if p <= available]

    rows = measure(args.n, args.d, args.e, args.kernel, counts, args.runs,
                   device=device)
    if multihost.is_coordinator():
        print(f"{'devices':>8} {'seconds':>10} {'pairs/s':>12} "
              f"{'per-device':>12} {'efficiency':>11}")
        for row in rows:
            print(f"{row['devices']:>8} {row['seconds']:>10.4f} "
                  f"{row['pairs_per_second']:>12.3e} "
                  f"{row['pairs_per_second'] / row['devices']:>12.3e} "
                  f"{row['efficiency']:>10.1%}")
        for row in rows:
            print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
