"""Collective inventory and communication model of the port's sharded
schedules (the twin of comm.py):

    python -m kmb_tpu_torch.comm [-n 1048576] [-d 3] [-e 1]
                                 [--devices 2 4 8] [--rate PAIRS_PER_S]
                                 [--markdown FILE] [--report FILE]

comm.py compiles the JAX package's ring and all-pairs programs at full
size and reads their collectives out of XLA's HLO.  The port has no HLO:
each collective is a torch.distributed call made by one of five methods of
`parallel.sharded.Mesh`, which `record_collectives` tallies.  So the port
measures at small sizes and scales by a verified formula: for each p of
`--devices` it spawns a gloo world of p CPU ranks (this module with
`--rank`), which run the ring and the all-pairs `ShardedProduct` (the
Gaussian product, as comm.py's programs) at the two sizes of SIZES,
record one query's collectives, and check that recording leaves the
answer bit-identical.  The parent holds every rank's recorded counts and
bytes equal to `analytic`'s per-query formula at both sizes; only then does
it evaluate the formula at -n.  Every collective the port issues is
reported, the final all_gather included (comm.py's HLO shows none there).

Per device, N = M = n points, D coordinates, E signal columns, float32,
on the port's meshes (ring: (p,); all-pairs: (2, p / 2), the target axis
first, as ShardedProduct lays them out), with shards of
L = ceil(n, 8 parts) / parts rows:

  ring:      p - 1 rotations of the visiting (y | b) chunk, L (D + E) 4
             bytes sent to the next rank, each posted before the chunk's
             kernel, so t_step = max(t_comm, t_comp); then the all_gather
             of the (L, E) rows, (p - 1) L E 4 bytes received.
  allpairs:  one all_reduce of the (Lt, E) state over the source axis
             (2 (ps - 1) / ps of its bytes on a ring), after the compute;
             then the all_gather of the (Lt, E) rows over the mesh.

The link rate is NVLink's on the H100 SXM, 450 GB/s per direction (NVIDIA
data sheet: 900 GB/s bidirectional).  The compute rate is `--rate` (pairs
per second); without it, on a card, it is measured: one float32
TorchProduct query at min(n, 131072)^2 (named in the rows); without a card
`--rate` is required.  No TPU number is used.

Prints one JSON line per (schedule, p) and a table on stderr; `--markdown`
writes the table, `--report` the JSON of the rows and the recorded
inventories.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# H100 SXM NVLink, one direction (NVIDIA data sheet).
NVLINK_BYTES_PER_S = 450e9
SIZES = (1000, 3000)          # the sizes each world records at
RATE_MAX_N = 131072           # the measured rate's largest size
SCHEDULES = ("ring", "allpairs")
WORLD_TIMEOUT = 600           # seconds for one gloo world
FLOAT32 = 4


def _ceil_to(n, k):
    return -(-n // k) * k


def mesh_shape(schedule, p):
    """The mesh ShardedProduct lays p ranks out on."""
    if schedule == "allpairs" and p % 2 == 0:
        return (2, p // 2)
    return (p,)


def analytic(schedule, p, n, d, e):
    """The collectives of one query of the Gaussian ShardedProduct on p
    ranks, per rank: [(op, group, shape, count)]."""
    shape = mesh_shape(schedule, p)
    if len(shape) == 1:
        rows = _ceil_to(n, p * 8) // p
        out = [("batch_isend_irecv", "mesh", [rows, d + e], p - 1)] if (
            p > 1) else []
        return out + [("all_gather", "mesh", [rows, e], 1)]
    pt, ps = shape
    rows = _ceil_to(n, pt * 8) // pt
    out = [("all_reduce", "source axis", [rows, e], 1)] if ps > 1 else []
    return out + [("all_gather", "mesh", [rows, e], 1)]


def inventory(calls):
    """Recorded calls of one query as analytic's [(op, group, shape,
    count)], with their bytes checked against float32 shapes."""
    out = {}
    for call in calls:
        if call["bytes"] != FLOAT32 * int(np.prod(call["shape"])):
            raise RuntimeError(f"recorded bytes of a non-float32 call: {call}")
        key = (call["op"], call["group"], tuple(call["shape"]))
        out[key] = out.get(key, 0) + 1
    return sorted((op, group, list(shape), count)
                  for (op, group, shape), count in out.items())


def predict(schedule, p, n, d, e, rate):
    """The model's row at -n (see the module docstring)."""
    collectives = analytic(schedule, p, n, d, e)
    shape = mesh_shape(schedule, p)
    transport = 0.0
    rows = []
    for op, group, dims, count in collectives:
        size = FLOAT32 * int(np.prod(dims))
        k = p if group == "mesh" else shape[1]
        moved = {"batch_isend_irecv": size, "all_reduce":
                 2.0 * (k - 1) / k * size, "all_gather": (k - 1) * size}[op]
        rows.append(dict(op=op, group=group, shape=dims, count=count,
                         bytes=size, transport_bytes=moved))
        transport += count * moved
    t_linear = n * n / p / rate
    if len(shape) == 1:
        t_comp_step = (n / p) ** 2 / rate
        step = sum(r["transport_bytes"] for r in rows
                   if r["op"] == "batch_isend_irecv")
        gather = sum(r["transport_bytes"] for r in rows
                     if r["op"] == "all_gather")
        t_comm_step = step / NVLINK_BYTES_PER_S
        t_call = ((p - 1) * max(t_comm_step, t_comp_step) + t_comp_step
                  + gather / NVLINK_BYTES_PER_S)
        extra = dict(per_step_bytes_per_device=step,
                     t_comm_step_s=t_comm_step, t_comp_step_s=t_comp_step,
                     comm_compute_ratio=t_comm_step / t_comp_step)
    else:
        pt, ps = shape
        t_comp = (n / pt) * (n / ps) / rate
        t_comm = transport / NVLINK_BYTES_PER_S
        t_call = t_comp + t_comm   # the reduction follows the compute
        extra = dict(mesh=list(shape), t_comm_s=t_comm, t_comp_s=t_comp,
                     comm_compute_ratio=t_comm / t_comp)
    return dict(schedule=schedule, devices=p, collectives=rows,
                total_bytes_per_device=transport, predicted_query_s=t_call,
                predicted_efficiency=t_linear / t_call, **extra)


# -- the ranks ---------------------------------------------------------------

def rank_main(args):
    """One rank of a gloo world: both schedules at both sizes, one
    recorded query each; writes its report."""
    import torch

    from kmb_tpu_torch.algorithms.torch_sharded import ShardedProduct
    from kmb_tpu_torch.parallel import multihost
    from kmb_tpu_torch.parallel.sharded import record_collectives

    torch.set_num_threads(1)
    multihost.initialize(f"file://{args.store}", num_processes=args.world,
                         process_id=args.rank, device="cpu")
    report = {}
    for schedule in SCHEDULES:
        for n in SIZES:
            rng = np.random.default_rng(n)
            algo = ShardedProduct(kernel="gaussian", dimension=args.d,
                                  schedule=schedule, device="cpu")
            algo.prepare_data(source_points=rng.random((n, args.d)),
                              target_points=None, same_points=True)
            algo.fit()
            algo.prepare_query(
                source_signal=rng.standard_normal((n, args.e)))
            algo.query()
            plain = algo.get_result()
            with record_collectives(algo.mesh) as recorder:
                algo.query()
            report[f"{schedule}/{n}"] = dict(
                calls=recorder.calls, queries=recorder.queries,
                mesh=list(algo.mesh.shape),
                bit_identical=bool(np.array_equal(plain, algo.get_result())))
            algo.done()
    with open(args.report, "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()
    return 0


def record_world(p, d, e, tmp):
    """Spawn a gloo world of p ranks; returns each rank's report."""
    store = os.path.join(tmp, f"store{p}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (root, os.environ.get("PYTHONPATH")) if x)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmb_tpu_torch.comm", "-d", str(d), "-e",
         str(e), "--rank", str(r), "--world", str(p), "--store", store,
         "--report", os.path.join(tmp, f"p{p}_rank{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(p)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=WORLD_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    reports = []
    for r, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {r} of {p} exited with "
                               f"{proc.returncode}:\n{log[-4000:]}")
        with open(os.path.join(tmp, f"p{p}_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def verify(p, d, e, reports):
    """Hold every rank's recorded query to `analytic` at both sizes;
    returns rank 0's records.  Raises on any difference."""
    out = {}
    for schedule in SCHEDULES:
        for n in SIZES:
            key = f"{schedule}/{n}"
            want = [list(c) for c in analytic(schedule, p, n, d, e)]
            for r, report in enumerate(reports):
                rec = report[key]
                got = [list(c) for c in inventory(rec["calls"])]
                if rec["queries"] != 1 or got != sorted(want):
                    raise RuntimeError(
                        f"{key} on {p} ranks, rank {r}: recorded {got} in "
                        f"{rec['queries']} queries, the formula {want}")
                if rec["mesh"] != list(mesh_shape(schedule, p)):
                    raise RuntimeError(f"{key}: mesh {rec['mesh']}")
                if not rec["bit_identical"]:
                    raise RuntimeError(f"{key}, rank {r}: recording changed "
                                       "the answer")
            out[key] = reports[0][key]
    return out


def measured_rate(n, d, e):
    """Pairs per second of one float32 TorchProduct query on the card at
    min(n, RATE_MAX_N)^2 (best of three after a warm-up), and its name."""
    import time

    import torch

    from kmb_tpu_torch.algorithms.torch_engine import TorchProduct

    size = min(n, RATE_MAX_N)
    rng = np.random.default_rng(0)
    algo = TorchProduct(kernel="gaussian", dimension=d, device="cuda")
    algo.prepare_data(source_points=rng.random((size, d)),
                      target_points=None, same_points=True)
    algo.fit()
    algo.prepare_query(source_signal=rng.standard_normal((size, e)))
    algo.query()
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        algo.query()
        best = min(best, time.perf_counter() - start)
    algo.done()
    name = (f"measured: TorchProduct float32 query at {size}^2 on "
            f"{torch.cuda.get_device_name(0)}")
    return size * size / best, name


def parse_args(argv):
    parser = argparse.ArgumentParser(prog="python -m kmb_tpu_torch.comm")
    parser.add_argument("-n", type=int, default=2**20)
    parser.add_argument("-d", type=int, default=3)
    parser.add_argument("-e", type=int, default=1)
    parser.add_argument("--devices", type=int, nargs="*", default=[2, 4, 8])
    parser.add_argument("--rate", type=float, default=None,
                        help="single-card pairs/s (default: measured on "
                             "the card; required without one)")
    parser.add_argument("--markdown", help="write the table here")
    parser.add_argument("--report", help="write the rows and inventories "
                        "here as JSON")
    # A rank of a gloo world (record_world starts them).
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    import torch

    if args.rate is not None:
        rate, rate_source = args.rate, "--rate"
    elif torch.cuda.is_available():
        rate, rate_source = measured_rate(args.n, args.d, args.e)
    else:
        raise SystemExit("no CUDA device to measure the compute rate on: "
                         "pass --rate PAIRS_PER_S")
    rows, recorded = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for p in args.devices:
            recorded[p] = verify(p, args.d, args.e,
                                 record_world(p, args.d, args.e, tmp))
    for schedule in SCHEDULES:
        for p in args.devices:
            row = predict(schedule, p, args.n, args.d, args.e, rate)
            row.update(rate_pairs_per_s=rate, rate_source=rate_source,
                       link_bytes_per_s=NVLINK_BYTES_PER_S,
                       verified_at=list(SIZES))
            rows.append(row)
            print(json.dumps(row), flush=True)
    table = format_table(rows)
    print(table, file=sys.stderr)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(f"# Collectives of the port's sharded schedules\n\n"
                    f"`python -m kmb_tpu_torch.comm -n {args.n} -d {args.d}"
                    f" -e {args.e}`; rate {rate:.4e} pairs/s "
                    f"({rate_source}); link {NVLINK_BYTES_PER_S:.3e} B/s "
                    "(H100 SXM NVLink, one direction, data sheet).\n\n"
                    + table + "\n")
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"rows": rows, "recorded": {
                str(p): records for p, records in recorded.items()}}, f)
    return 0


def format_table(rows):
    lines = ["| schedule | p | collectives per query | bytes/device | "
             "comm/compute | predicted query (s) | predicted efficiency |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        ops = ", ".join(f"{c['count']} x {c['op']} ({c['group']}, "
                        f"{c['shape']})" for c in r["collectives"])
        lines.append(
            f"| {r['schedule']} | {r['devices']} | {ops or 'none'} | "
            f"{r['total_bytes_per_device']:.4e} | "
            f"{r['comm_compute_ratio']:.4e} | "
            f"{r['predicted_query_s']:.6f} | "
            f"{r['predicted_efficiency']:.4f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(main())
