"""Measure a cell's spread: sets of runs of `portbench.run`, each run a
fresh process, and a summary of them.

    python3 -m portbench.proof --workload <cell> --seeds 1,2,3,4,5,6 \
        --sets 2 --trace-seeds 7,8,9 --out <summary.json>

Each set runs every seed once at BENCHMARK.json's `run_seconds`, the
sets with the same seeds; then one traced run per trace seed.  The
summary holds every run's result line and, per metric and set, the
median and the spread: the distance between the first and third
quartiles (`statistics.quantiles(values, n=4)`) over the median, and the
card's name and power limit.  `--warm` runs first one untimed run that
builds the kernel library in a fresh checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from portbench import cell as cells


def one_run(workload, seed, seconds, trace):
    started = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", repr(seconds), "--trace",
         str(trace)], capture_output=True, text=True, timeout=1500)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - started, "result": result,
            "stderr_tail": proc.stderr[-1500:]}


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    median = statistics.median(values)
    # A count that reads 0 in every run (points staged in the cube) has
    # no spread relative to its median.
    return (q3 - q1) / median if median else None


def summarize(runs):
    out = {}
    for run in runs:
        if run["result"] is None:
            continue
        for name, metric in run["result"]["metrics"].items():
            out.setdefault(name, {}).setdefault(run["set"], []).append(
                metric["value"])
    return {name: {str(s): {"median": statistics.median(v),
                            "spread": spread(v), "n": len(v),
                            "values": v}
                   for s, v in sets.items()}
            for name, sets in out.items()}


def card():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return proc.stdout.strip().splitlines()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   type=lambda s: [int(x) for x in s.split(",") if x])
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace-seeds", default="",
                   type=lambda s: [int(x) for x in s.split(",") if x])
    p.add_argument("--seconds", type=float)
    p.add_argument("--warm", action="store_true")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seconds = args.seconds or cells.load_json(cells.BENCHMARK)["run_seconds"]
    runs = []
    if args.warm:
        run = one_run(args.workload, args.seeds[0], 2, 0)
        run["set"] = "warm"
        runs.append(run)
    for s in range(args.sets):
        for seed in args.seeds:
            run = one_run(args.workload, seed, seconds, 0)
            run["set"] = s
            runs.append(run)
            print(json.dumps({k: run[k] for k in ("set", "seed", "rc",
                                                   "wall_s")}
                             | {"result": run["result"]}), flush=True)
    for seed in args.trace_seeds:
        run = one_run(args.workload, seed, seconds, 1)
        run["set"] = "trace"
        runs.append(run)
        print(json.dumps({k: run[k] for k in ("set", "seed", "rc",
                                               "wall_s")}
                         | {"result": run["result"]}), flush=True)
    summary = {"workload": args.workload, "run_seconds": seconds,
               "card": card(), "metrics": summarize(runs),
               "correct": [r["result"]["correct"] if r["result"] else None
                           for r in runs],
               "runs": runs}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
