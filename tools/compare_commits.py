#!/usr/bin/env python3
"""Time the large-D kernels of two source trees in turns, on one CUDA card.

Run from the repository root, with an older tree unpacked beside it
(`git archive <commit> | tar -x -C _archive/parent`):

    python3 tools/compare_commits.py _archive/parent . . _archive/parent

Each tree in the list runs in a fresh process of its own (its kernels
built from its sources into its own `kmb_tpu_torch/_build/`), one after
the other, so two trees are compared in turns on one card.  Each process
times, in each precision tier, the wrapper's call (CUDA events around
`reps` calls) and the kernel alone (torch.profiler's device time of the
launches named `*_d_kernel` or `*_d_wide_kernel`, averaged), on the
shapes below.  The kernel alone is read by the profiler in both trees
because older trees have no `_build.launch_timer`: one method on both
sides of the comparison (each process is fresh, where the profiler has
kept its records).  The shapes:

- the D256 dataset's 20000^2 points (abs-exp) with its 16-column signal,
  and with a 64-column signal drawn from a seed;
- the attention dataset's 10^4 points (exponential, normalised) with a
  64-column signal drawn from a seed, and with its own 8 columns;
- the D784 dataset's 10^4 points with its one column.

Where the tree's wrapper can keep y's staging (`fixed_source`), the call
is also timed as an engine makes it (`ms_fixed_source`); on a dataset's
own signal, the query through `TorchProduct` as the runner times it
(`query_ms`, best of `reps` on the host clock), and one call (as the
engine makes it) with the card idle before it: the host's time until it
returns (`host_ms`) and until the card has finished (`isolated_ms`).
`--only LABEL` (repeatable) times only those shapes.  Prints the
card's name and power limit, then one JSON line per tree and shape.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys
import time

import torch

SHAPES = (
    ("D256 E16", "product-normal-D256-E16-M20000-N20000-absolute-exponential",
     None),
    ("D256 E64", "product-normal-D256-E16-M20000-N20000-absolute-exponential",
     64),
    ("attention D64 E64", "attention-normal-D64-E8-M10000-N10000-exponential",
     64),
    ("attention D64 E8", "attention-normal-D64-E8-M10000-N10000-exponential",
     None),
    ("D784 E1", "product-normal-D784-E1-M10000-N10000-gaussian", None),
)
TIERS = ("float32", "float32x3", "bfloat16")
REPS = 10


def kernel_alone_ms(fn, reps):
    """Device time of one launch, from torch.profiler (a fresh process)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if re.search(r"_d_(wide_)?kernel", e.key)]
    count = sum(e.count for e in found)
    us = sum(e.self_device_time_total for e in found)
    return us / count / 1e3 if count else None


def call_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def isolated_ms(fn, reps):
    """(host ms until `fn` returns, host ms until the card has finished
    it), each the best of `reps` calls made with the card idle: the first
    is the wrapper's host work and launches, the second a lone call as a
    query makes it (back-to-back calls hide the host work behind the
    card's)."""
    returned = finished = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        returned = min(returned, time.perf_counter() - start)
        torch.cuda.synchronize()
        finished = min(finished, time.perf_counter() - start)
    return returned * 1e3, finished * 1e3


def engine_query_ms(arrays, tier, reps):
    """Best of `reps` host-clock times of `TorchProduct.query()` on a
    dataset, as the runner times a query (`prepare_query` untimed before
    each; one query first, untimed)."""
    from kmb_tpu_torch.algorithms.torch_engine import TorchProduct

    algo = TorchProduct(kernel=arrays["kernel"],
                        dimension=arrays["source_points"].shape[1],
                        normalize_rows=bool(arrays["normalize_rows"]),
                        precision=tier)
    algo.prepare_data(source_points=arrays["source_points"],
                      target_points=arrays["target_points"],
                      same_points=bool(arrays["same_points"]))
    algo.fit()
    best = float("inf")
    for i in range(reps + 1):
        algo.prepare_query(source_signal=arrays["source_signal"])
        torch.cuda.synchronize()
        start = time.perf_counter()
        algo.query()
        if i:
            best = min(best, time.perf_counter() - start)
    return best * 1e3


def measure(tree, card, only):
    """Time every shape (or those labelled in `only`) and tier with the
    kernels of the tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.ops.product import (
        kernel_matvec, kernel_matvec_cuda, kernel_matvec_torch)

    fixed = "fixed_source" in inspect.signature(kernel_matvec_cuda).parameters

    for label, name, e in SHAPES:
        if only and label not in only:
            continue
        arrays = make_arrays(name)
        y = torch.tensor(arrays["source_points"], dtype=torch.float32,
                         device="cuda")
        x = y if arrays["same_points"] else torch.tensor(
            arrays["target_points"], dtype=torch.float32, device="cuda")
        if e is None:
            b = torch.tensor(arrays["source_signal"], dtype=torch.float32,
                             device="cuda")
        else:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(e)
            b = torch.randn((len(y), e), generator=gen, device="cuda")
        for tier in TIERS:
            kw = dict(kernel_name=arrays["kernel"], precision=tier,
                      normalize_rows=bool(arrays["normalize_rows"]))
            got = kernel_matvec(x, y, b, **kw)
            want = kernel_matvec_torch(x, y, b, **kw)
            rel = float((got - want).abs().max() / want.abs().max())
            fn = lambda: kernel_matvec(x, y, b, **kw)  # noqa: E731
            row = {"tree": tree, "shape": label, "precision": tier,
                   "ms": call_ms(fn, REPS),
                   "kernel_ms": kernel_alone_ms(fn, REPS),
                   "rel_vs_plain": rel, "card": card}
            if fixed:   # the call as an engine makes it: y staged once
                fn = lambda: kernel_matvec(  # noqa: E731
                    x, y, b, fixed_source=True, **kw)
                row["ms_fixed_source"] = call_ms(fn, REPS)
            if e is None:   # the dataset's own query through the engine
                row["query_ms"] = engine_query_ms(arrays, tier, REPS)
                row["host_ms"], row["isolated_ms"] = isolated_ms(fn, REPS)
            print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("compare_commits: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--measure", help=argparse.SUPPRESS)
    parser.add_argument("--only", action="append", default=[],
                        help="a shape's label to time (repeatable; all "
                        "shapes without it)")
    options = parser.parse_args()
    if options.measure is not None:
        measure(options.measure, card, options.only)
        return 0
    print(card, flush=True)
    rc = 0
    only = [arg for label in options.only for arg in ("--only", label)]
    for tree in options.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", tree,
             *only], cwd=os.path.abspath(tree))
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
