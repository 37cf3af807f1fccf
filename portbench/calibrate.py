"""The readings that the limits of a cell's numbers are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --queries 32

In one process (one per card on several cards), for each seed: the cell's
inputs and engine from that seed, `--queries` queries of the window's
shape (two passes over the signal pool by default), and the numbers
check.py compares, for the program's answers and for the control's: the
plain reference computed one precision below the configuration's (its
`control`), put in the program's place.  Prints one JSON line per seed:
{"seed", "program": {number: value}, "control": {number: value},
"queries"}.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import cell as cells
from portbench import run


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   type=lambda s: [int(x) for x in s.split(",")])
    p.add_argument("--queries", type=int, default=32)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--address", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--override", type=json.loads, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def calibrate(args):
    import torch.distributed as dist

    from portbench import check
    from portbench.session import Session

    cell = cells.load(args.workload, args.override)
    world = cell.chips
    procs, address = [], args.address
    if args.rank == 0 and world > 1:
        command = [sys.executable, "-m", "portbench.calibrate",
                   "--workload", args.workload, "--seeds",
                   ",".join(map(str, args.seeds)), "--queries",
                   str(args.queries), "--device", args.device]
        if args.override:
            command += ["--override", json.dumps(args.override)]
        address, procs = run.start_ranks(command, world, args.device)
    try:
        control = (run.join_ranks(address, world, args.rank, args.device)
                   if world > 1 else None)
        for seed in args.seeds:
            session = Session(cell, seed, device=args.device,
                              rank=args.rank, world=world, control=control)
            session.set_up()
            session.window(1e9, queries=args.queries)
            session.free()
            if world > 1:
                dist.barrier(group=control)
            if args.rank != 0:
                continue
            reference, magnitude = session.reference()
            ids = [q.signal for q in session.report.queries]
            _, _, program = check.judge(session.answers, ids, reference,
                                        magnitude, cell.limits)
            lowered, _ = session.reference("control")
            _, _, control_numbers = check.judge(
                list(lowered), range(len(lowered)), reference, magnitude,
                cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "queries": len(ids), "program": program,
                              "control": control_numbers}), flush=True)
        if world > 1:
            dist.destroy_process_group()
        if any(run.stop_ranks(procs)):
            raise RuntimeError("a rank failed")
        procs = []
    finally:
        for proc in procs:
            proc.kill()
        run.stop_ranks(procs)


def main(argv=None):
    args = parse(argv)
    run.fixed_caches()
    os.environ["OMP_NUM_THREADS"] = "1"
    calibrate(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
