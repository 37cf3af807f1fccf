#!/usr/bin/env python3
"""Where the small-D wide kernel's time goes, on one CUDA card (sm_90a).

Run from the repository root:

    python3 tools/wide_breakdown.py

Times the kernel alone (torch.profiler's device time, as chip_smoke.py's
`kernel_device_ms`) on the Nystrom sketch's shape, 131072^2 points of the
solver cube at D = 3, for E = 256, 64 and 16 in the float32 and bfloat16
tiers, in four builds of csrc/small_d_wide.cuh (each into a library of its
own, `_build.use_defines`):

- as the package builds it;
- KMB_NO_SIGNAL_LOADS: the signal staged for the first two tiles only,
  the others reuse them (no signal bytes from L2 after that);
- KMB_NO_KERNEL_VALUES: the kernel values of tile 0 only (no elementwise
  work of the producer side after that);
- both switches: the loop, its source records, its tensor-core products
  and its barriers.

The switched builds compute wrong answers; only their times are kept.
Prints the card's name and power limit, then one JSON object per build.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch

BUILDS = (("as built", ()),
          ("no signal loads", ("KMB_NO_SIGNAL_LOADS",)),
          ("no kernel values", ("KMB_NO_KERNEL_VALUES",)),
          ("neither", ("KMB_NO_SIGNAL_LOADS", "KMB_NO_KERNEL_VALUES")))
WIDTHS = (256, 64, 16)
TIERS = ("float32", "bfloat16")
DATASET = "solver-cube-D3-E1-M131072-N131072-gaussian"


def kernel_ms(fn, reps=2):
    """Device time of one launch of the kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if re.search(r"small_d_wide_kernel", e.key)]
    count = sum(e.count for e in found)
    if not count:
        raise RuntimeError("the profiler saw no small_d_wide_kernel")
    return sum(e.self_device_time_total for e in found) / count / 1e3


def main():
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
    y = torch.tensor(make_arrays(DATASET)["source_points"],
                     dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    signals = {e: torch.randn((len(y), e), generator=gen, device="cuda")
               for e in WIDTHS}
    try:
        for label, defines in BUILDS:
            _build.use_defines(*defines)
            product._plan.cache_clear()
            times = {}
            for e in WIDTHS:
                for tier in TIERS:
                    times[f"E={e} {tier}"] = kernel_ms(
                        lambda: product.kernel_matvec(
                            y, y, signals[e], kernel_name="gaussian",
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
