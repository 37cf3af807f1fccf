#!/usr/bin/env python3
"""Where the Nystrom PCG of the benchmark's solve cell stops, seed by
seed: what ends each solve and how far its answer is from solving the
system in float64.

Run from the repository root (on a CUDA card; `--device cpu` with a
small `--override` for a rehearsal):

    python3 tools/pcg_tolerance.py --seeds 1,2,3 \
        [--workload cube-n2p17-pcg.krige-stream] [--tol 1e-5] \
        [--bf16 4] [--out pcg_tolerance.jsonl]

For each seed, the cell's inputs (points and the pool of right-hand sides
a = K w, w standard normal, K w in float64) and its solver, fitted once;
then every right-hand side of the pool solved in turn.  For each solve:
the iterations, what ended it ("tolerance": the loop's float32 residual
met the tolerance; "stall": PCG_STALL_WINDOW iterations without a new
best; "max_iters"), the loop's own relative residual, the float64 true
relative residual ||K b - a|| / ||a|| over every row and at the cell's
checked rows alone (what the cell's `err_rms` reads), the growth
rms(|K| |b|) / rms(a), and the solve's wall ms.  The first solve of a
seed runs again inside the port's trace recording: its answer and count
must be the untraced ones to the bit, and its `pcg_iterations` counter
equal to its kernel launches.  `--bf16 k` solves the first k right-hand
sides again with the same solver at precision "bfloat16", the port's
lower tier.  Prints one JSON line per seed, and the card's name and power
limit first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError:
        return None
    return out.stdout.strip().splitlines()


def solves(engine, pool, count, tol, max_iters, sync):
    """(answers, per-solve records) of the pool's first `count`
    right-hand sides."""
    answers, records = [], []
    for s in range(count):
        start = time.perf_counter()
        engine.prepare_query(target_signal=pool[s])
        engine.query()
        b = engine.get_result()
        sync()
        ms = (time.perf_counter() - start) * 1e3
        if engine.residual <= tol:
            ended = "tolerance"
        elif engine.iterations >= max_iters:
            ended = "max_iters"
        else:
            ended = "stall"
        answers.append(b)
        records.append({"iterations": engine.iterations, "ended": ended,
                        "loop_residual": engine.residual, "ms": ms})
    return answers, records


def true_residuals(reference, inputs, answers, device):
    """(relative residual, the same at the checked rows, growth) of each
    answer, over every row unless said, in float64."""
    import numpy as np

    n = len(inputs.sources)
    b = np.concatenate(answers, axis=1)
    kb = reference.residual_terms(inputs.sources,
                                  np.concatenate([b, np.abs(b)], axis=1),
                                  np.arange(n), device=device)
    a = inputs.pool[:len(answers), :, 0].T
    k = len(answers)
    rel = np.linalg.norm(kb[:, :k] - a, axis=0) / np.linalg.norm(a, axis=0)
    rows = inputs.rows
    checked = (np.linalg.norm(kb[rows, :k] - a[rows], axis=0)
               / np.linalg.norm(a[rows], axis=0))
    growth = (np.sqrt(np.mean(kb[:, k:] ** 2, axis=0))
              / np.sqrt(np.mean(a ** 2, axis=0)))
    return rel.tolist(), checked.tolist(), growth.tolist()


def traced_first(engine, pool, kernels):
    """The first right-hand side solved inside the port's recording:
    (b, iterations, pcg_iterations counted, kernel launches, span names)."""
    from kmb_tpu_torch import trace

    before = sum(k.launches for k in kernels)
    with trace.recording() as rec:
        engine.prepare_query(target_signal=pool[0])
        engine.query()
        b = engine.get_result()
    launches = sum(k.launches for k in kernels) - before
    return (b, engine.iterations, rec.counts.get("pcg_iterations"),
            launches, sorted({s.name for s in rec.spans}))


def main(argv=None):
    import numpy as np
    import torch

    from kmb_tpu_torch.ops import _build
    from portbench import cell as cells

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="cube-n2p17-pcg.krige-stream")
    p.add_argument("--seeds", required=True,
                   type=lambda s: [int(x) for x in s.split(",") if x])
    p.add_argument("--tol", type=float)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", type=json.loads)
    p.add_argument("--out")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    c = cells.load(args.workload, args.override)
    config = c.config
    engine_args = dict(config["engine"].get("args", {}))
    if args.tol is not None:
        engine_args["tol"] = args.tol
    tol = engine_args["tol"]
    max_iters = engine_args.get("max_iters", 1000)
    task = c.task
    reference = importlib.import_module(
        f"portbench.references.{config['reference']}")
    device = torch.device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = open(args.out, "a") if args.out else None
    head = {"card": card() if cuda else "cpu", "workload": args.workload,
            "tol": tol, "engine_args": engine_args}
    print(json.dumps(head), flush=True)
    if out:
        out.write(json.dumps(head) + "\n")
    for seed in args.seeds:
        started = time.perf_counter()
        inputs = task.make_inputs(config, c.traffic, seed, c.check_rows)
        made = time.perf_counter()
        engine = task.build(dict(config, engine=dict(
            config["engine"], args=engine_args)), device)
        task.prepare(engine, inputs)
        sync()
        fitted = time.perf_counter()
        pool = inputs.pool
        answers, records = solves(engine, pool, len(pool), tol, max_iters,
                                  sync)
        b0, it0, counted, launches, names = traced_first(
            engine, pool, _build.KERNELS)
        bitwise = bool(np.array_equal(b0, answers[0])
                       and it0 == records[0]["iterations"])
        rel, checked, growth = true_residuals(reference, inputs, answers,
                                              args.device)
        for r, x, c_, g in zip(records, rel, checked, growth):
            r["true_residual"], r["checked_residual"] = x, c_
            r["growth"] = g
        line = {"seed": seed, "inputs_s": made - started,
                "fit_s": fitted - made, "solves": records,
                "traced_equal_to_the_bit": bitwise,
                "pcg_iterations_counted": counted,
                "kernel_launches": launches, "spans": names}
        if args.bf16:
            engine.done()
            low = task.build(dict(config, precision="bfloat16", engine=dict(
                config["engine"], args=engine_args)), device)
            task.prepare(low, inputs)
            low_answers, low_records = solves(low, pool, args.bf16, tol,
                                              max_iters, sync)
            rel, checked, growth = true_residuals(reference, inputs,
                                                  low_answers, args.device)
            for r, x, c_, g in zip(low_records, rel, checked, growth):
                r["true_residual"], r["checked_residual"] = x, c_
                r["growth"] = g
            line["bf16"] = low_records
            low.done()
        else:
            engine.done()
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
