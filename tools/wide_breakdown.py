#!/usr/bin/env python3
"""Where the wide kernels' time goes, on one CUDA card (sm_90a).

Run from the repository root:

    python3 tools/wide_breakdown.py [--only small|large]

Times each wide kernel alone (CUDA events around each launch on its
stream, recorded by the kernel library: `_build.launch_timer`, as
chip_smoke.py's `kernel_device_ms`; a
process that loads a second kernel library has seen torch.profiler keep
no record of its kernels) in the float32 and bfloat16 tiers, in
four builds of the kernels (each into a library of its own,
`_build.use_defines`):

- as the package builds them;
- no loads: the small-D kernel (csrc/small_d_wide.cuh) stages its signal
  for the first two tiles only (KMB_NO_SIGNAL_LOADS); the large-D kernel
  (csrc/large_d_wide.cuh) issues no TMA load after its ring's first round
  of stages (KMB_NO_STAGE_LOADS): no bytes from L2 after that;
- no elementwise work: the small-D kernel forms the kernel values of tile
  0 only (KMB_NO_KERNEL_VALUES); the large-D kernel runs no epilogue
  (KMB_NO_EPILOGUE: no form completion, map, masks or signal product);
- both switches: the loops with their tensor-core products and waits.

Shapes: the small-D kernel on the Nystrom sketch's, 131072^2 points of
the solver cube at D = 3 with E = 256, 64 and 16; the large-D kernel on
the D256 dataset's 20000^2 points (abs-exp) with E = 16 and 64.  Signals
are drawn from a seed.

The switched builds compute wrong answers; only their times are kept.
Prints the card's name and power limit, then one JSON object per build.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

BUILDS = (("as built", ()),
          ("no loads", ("KMB_NO_SIGNAL_LOADS", "KMB_NO_STAGE_LOADS")),
          ("no elementwise work", ("KMB_NO_KERNEL_VALUES",
                                   "KMB_NO_EPILOGUE")),
          ("neither", ("KMB_NO_SIGNAL_LOADS", "KMB_NO_STAGE_LOADS",
                       "KMB_NO_KERNEL_VALUES", "KMB_NO_EPILOGUE")))
TIERS = ("float32", "bfloat16")
# (kind, dataset, kernel map, signal widths)
SHAPES = (("small", "solver-cube-D3-E1-M131072-N131072-gaussian", "gaussian",
           (256, 64, 16)),
          ("large", "product-normal-D256-E16-M20000-N20000-absolute-exponential",
           "absolute-exponential", (16, 64)))


def kernel_ms(fn, reps=2):
    """Device time of one launch of the kernel: CUDA events around each
    launch, averaged over `reps` calls after one warm-up call."""
    from kmb_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    with _build.launch_timer() as times:
        for _ in range(reps):
            fn()
    return sum(times) / len(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=("small", "large"))
    options = parser.parse_args()
    if not torch.cuda.is_available():
        print("wide_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.ops import _build, product

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    shapes = [s for s in SHAPES if options.only in (None, s[0])]
    inputs = {}
    gen = torch.Generator(device="cuda")
    for kind, dataset, _, widths in shapes:
        y = torch.tensor(make_arrays(dataset)["source_points"],
                         dtype=torch.float32, device="cuda")
        gen.manual_seed(0)
        inputs[kind] = (y, {e: torch.randn((len(y), e), generator=gen,
                                           device="cuda") for e in widths})
    try:
        for label, defines in BUILDS:
            _build.use_defines(*defines)
            product._plan.cache_clear()
            times = {}
            for kind, _, kernel, widths in shapes:
                y, signals = inputs[kind]
                for e in widths:
                    for tier in TIERS:
                        times[f"{kind} E={e} {tier}"] = kernel_ms(
                            lambda: product.kernel_matvec(
                                y, y, signals[e], kernel_name=kernel,
                                precision=tier))
            print(json.dumps({"build": label, "defines": list(defines),
                              "kernel_ms": times, "card": card}),
                  flush=True)
    finally:
        _build.use_defines()
        product._plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
