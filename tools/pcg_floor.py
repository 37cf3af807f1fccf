#!/usr/bin/env python3
"""Where the Nystrom PCG on the 131072-point solver cube stops, by the
matvec it iterates on, on one CUDA card (sm_90a).

Run from the repository root:

    python3 tools/pcg_floor.py

The PCG of `chip_smoke.py` phases 5, 7 and 8 (precond_rank 256, tol 1e-6,
max_iters 2000) on `solver-cube-D3-E1-M131072-N131072-gaussian` ends at
the tolerance or when PCG_STALL_WINDOW (60) iterations bring no new best
residual; then its best residual is its float32 floor, reached 60
iterations before the end.  For each of ORDERINGS orderings of the points
(the test matrix's rows permuted with them; ordering 0 is the
registry's), the single card's "gram" factors from the one-launch
sketch, under these matvecs:

- "kernel": one launch of the direct kernel (the single card's);
- "virtual ring": the ring schedule of four virtual ranks in this process
  (`sharded.virtual_ring_product`: 16 chunk launches, folded), the
  arithmetic of four cards' matvec without their collectives; also on
  the factors built from its own sketch (ordering 0), as four cards build
  them;
- "kernel, S splits" for each S of SPLITS: one launch with S column
  splits (each split's row sums over M / S columns, merged in float32),
  instead of the splits the wrapper picks for occupancy;
- ordering 0 only: the plain PyTorch product in float32, and in float64
  rounded to float32 (an exact matvec up to its output's rounding).

Prints the card's name and power limit, then one JSON line per run:
iterations, best relative residual, whether the tolerance was met, and
the matvec's milliseconds (CUDA events, mean over the solve).  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys

DATASET = "solver-cube-D3-E1-M131072-N131072-gaussian"
RANK, TOL, MAX_ITERS = 256, 1e-6, 2000
ORDERINGS, SPLITS = 4, (16, 64)


@contextlib.contextmanager
def column_splits(count):
    """The wrapper's kernel launches take `count` column splits."""
    from kmb_tpu_torch.ops import product

    choose = product.choose_splits
    product.choose_splits = lambda *args: count
    try:
        yield
    finally:
        product.choose_splits = choose


def timed(matvec, times):
    """`matvec`, appending each call's milliseconds (CUDA events)."""
    import torch

    def call(v):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = matvec(v)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        return out
    return call


def solve(y, rhs, u, lam, matvec, splits=None):
    """(iterations, best relative residual, matvec ms) of the PCG."""
    from kmb_tpu_torch.ops import solve as ksolve

    times = []
    with column_splits(splits) if splits else contextlib.nullcontext():
        _, iterations, residual = ksolve.cg_solve(
            y, rhs, kernel_name="gaussian", tol=TOL, max_iters=MAX_ITERS,
            matvec=timed(matvec, times),
            precond=functools.partial(ksolve.apply_nystrom_precond, u, lam))
    return iterations, residual, sum(times) / len(times)


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pcg_floor: needs a CUDA card", file=sys.stderr)
        return 1
    from kmb_tpu_torch.datasets import ground_truth, make_arrays
    from kmb_tpu_torch.ops import solve as ksolve
    from kmb_tpu_torch.ops.product import kernel_matvec_torch
    from kmb_tpu_torch.parallel import sharded

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    arrays = make_arrays(DATASET)
    y0 = torch.tensor(arrays["source_points"], dtype=torch.float32,
                      device="cuda")
    rhs0 = torch.tensor(ground_truth(arrays), dtype=torch.float32,
                        device="cuda")
    omega0 = sharded.draw_test_matrix(len(y0), RANK, y0.device)
    orders = np.random.default_rng(0)

    def report(ordering, matvec, factors, result):
        iterations, residual, ms = result
        print(json.dumps({"ordering": ordering, "matvec": matvec,
                          "factors": factors, "iterations": iterations,
                          "best_residual": residual,
                          "converged": residual <= TOL, "matvec_ms": ms,
                          "card": card}), flush=True)

    for ordering in range(ORDERINGS):
        perm = torch.as_tensor(
            np.arange(len(y0)) if ordering == 0
            else orders.permutation(len(y0)), device=y0.device)
        y, rhs = y0[perm], rhs0[perm]
        kernel = functools.partial(ksolve.kernel_matvec, y, y,
                                   kernel_name="gaussian")
        ring = functools.partial(sharded.virtual_ring_product, y, y,
                                 p=4, kernel_name="gaussian")
        u, lam = ksolve.nystrom_factors(kernel, omega0[perm], method="gram")
        report(ordering, "kernel", "one launch",
               solve(y, rhs, u, lam, kernel))
        report(ordering, "virtual ring", "one launch",
               solve(y, rhs, u, lam, ring))
        for count in SPLITS:
            report(ordering, f"kernel, {count} splits", "one launch",
                   solve(y, rhs, u, lam, kernel, splits=count))
        if ordering:
            continue
        ur, lamr = ksolve.nystrom_factors(ring, omega0, method="gram")
        report(0, "virtual ring", "virtual ring",
               solve(y, rhs, ur, lamr, ring))
        report(0, "plain float32", "one launch", solve(
            y, rhs, u, lam, functools.partial(
                kernel_matvec_torch, y, y, kernel_name="gaussian")))
        y64 = y.double()
        report(0, "float64, rounded to float32", "one launch", solve(
            y, rhs, u, lam, lambda v: kernel_matvec_torch(
                y64, y64, v.double(), kernel_name="gaussian").float()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
