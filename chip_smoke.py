#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (kmb_tpu_torch).

Run from the repository root on a machine with one CUDA card (sm_90a):

    python3 chip_smoke.py

Phases, each of which must pass:

1. Environment: the card's name and power limit, torch and CUDA versions,
   the nvcc build of kmb_tpu_torch/ops/csrc/ (one process per source, the
   seconds of each), and ptxas's registers and spills (`-Xptxas -v`).
2. Both kernels (direct and flash) against the plain PyTorch version on the
   card, in all three precision tiers and for all four kernel maps, at
   ragged shapes (D in {3, 9, 37, 64, 130, 784}, E in {1, 2, 4, 8, 13}, N
   and M not multiples of 16, 64 or 128), with the diagonal mask,
   normalize_rows, density estimation, the deferred states, offsets and
   limits (also ending inside a tile), and large logits at D = 4 (small-D
   loop) and D = 64 (tensor cores).
3. The main path, through the port's runner (`run_on_arrays`, runs=2), on
   four datasets in three tiers, each held against its float64 truth
   computed on the card; every kernel launch is counted.
4. Each kernel timed at the main path's shapes, in each tier, beside its
   plain version, its bound and (for the flash kernel) the library's
   attention call, and held against the plain version there too.  `ms` is
   the wrapper's call (staging, launches, merge) with CUDA events;
   `kernel_device_ms` is the kernel alone, from torch.profiler.

The last line is {"ok": true, "device": {...}} and is printed only when
every phase passed; the line before it holds the kernels' numbers, one
entry per kernel, dataset and tier.  Nothing
is written outside the git-ignored kernel build directory.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Relative error bounds, |kernel - reference| / max|reference|, for phases 2
# and 4 (kernel against plain version, same inputs, same device).  float32
# tiers: both sides are f32 with different summation orders (~1e-6 seen at
# these sizes; bound with margin).  bfloat16: the kernel rounds each flash
# weight against the running max, the plain version against the final max,
# so single weights can land on neighbouring bf16 values (2^-8 relative).
KERNEL_TOL = {"float32": 1e-4, "float32x3": 1e-4, "bfloat16": 2e-2}
LARGE_LOGIT_TOL = 1e-3   # logits > 100 (tests/test_ops.py:82 uses 1e-3)
LIBRARY_TOL = 1e-2       # the library's attention may run reduced precision

# Main-path error bounds: RMS(result - truth) / RMS(truth) against the
# float64 truth.  f32 tiers: f32 rounding of points and sums; bfloat16:
# bf16 points, signal and kernel values (test_ops.py holds the JAX bf16
# tier to 5e-2 max-relative).
MAIN_PATH_BOUND = {"float32": 1e-4, "float32x3": 1e-4, "bfloat16": 5e-2}

TIERS = ("float32", "float32x3", "bfloat16")
KERNEL_NAMES = ("gaussian", "absolute-exponential", "inverse-distance",
                "exponential")
LOG_KERNELS = ("gaussian", "absolute-exponential", "exponential")

# (dataset, kernel of csrc/product.cu it drives, what it exercises)
MAIN_PATH = (
    ("product-cube-D3-E1-M131072-N131072-gaussian", "direct",
     "difference form"),
    ("product-sphere-D3-E1-M131072-N131072-inverse-distance", "direct",
     "diagonal mask"),
    ("product-normal-D784-E1-M10000-N10000-gaussian", "direct",
     "expanded form, D > 8"),
    ("attention-normal-D64-E8-M10000-N10000-exponential", "flash",
     "online softmax"),
)
REPLACES = {
    "direct": "kmb_tpu/ops/product.py:230 (_direct_kernel_body, "
              "pallas_call at :638)",
    "flash": "kmb_tpu/ops/product.py:260 (_flash_kernel_body, "
             "pallas_call at :608)",
}
SOURCE = "kmb_tpu_torch/ops/csrc/product.cu"

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# TF32 and bf16 on the tensor cores, device memory bandwidth, and
# special-function throughput per SM per clock.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16

# The large-D form product on the tensor cores: (passes, peak) per tier.
# The f32 tiers run 3xTF32 (lo.hi + hi.lo + hi.hi), bf16 one pass.
TENSOR_CORE_FORM = {"float32": (3, PEAK_TF32_FLOPS),
                    "float32x3": (3, PEAK_TF32_FLOPS),
                    "bfloat16": (1, PEAK_BF16_FLOPS)}

# The instantiations the main path launches, by (template, arguments as
# ptxas's mangled names list them), for phase 1's register report:
# small_d<map, D, E, flash, den, rnd>, large_d<map, E, flash, den, bf16>.
MAIN_PATH_KERNELS = {
    ("small_d_kernel", "0,3,1,0,0,0"): "cube, float32",
    ("small_d_kernel", "0,3,1,0,0,1"): "cube, bfloat16",
    ("small_d_kernel", "2,3,1,0,0,0"): "sphere, float32",
    ("large_d_kernel", "0,1,0,0,0"): "D784, float32 (3xTF32)",
    ("large_d_kernel", "0,1,0,0,1"): "D784, bfloat16",
    ("large_d_kernel", "3,8,1,0,0"): "attention, float32 (3xTF32)",
    ("large_d_kernel", "3,8,1,0,1"): "attention, bfloat16",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, message):
    if not cond:
        raise SmokeFailure(message)


def nvidia_smi(query):
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def compare(got, ref):
    """Max abs and relative error; NaN and -1e30 sentinels must match."""
    check(tuple(got.shape) == tuple(ref.shape),
          f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
    got, ref = got.double(), ref.double()
    nan = torch.isnan(ref)
    check(torch.equal(torch.isnan(got), nan), "NaN positions differ")
    sentinel = ref.abs() >= 1e29
    check(torch.equal(got.abs() >= 1e29, sentinel),
          "masked-row sentinels differ")
    ok = ~(nan | sentinel)
    check(bool(torch.isfinite(got[ok]).all()), "non-finite values")
    if not bool(ok.any()):
        return 0.0, 0.0
    err = float((got[ok] - ref[ok]).abs().max())
    scale = max(float(ref[ok].abs().max()), 1e-30)
    return err, err / scale


def as_tuple(out):
    return tuple(t for t in out if t is not None) if isinstance(
        out, tuple) else (out,)


def ptxas_kernels(report):
    """(template, arguments, registers, spill bytes) of each kernel in a
    ptxas -v report."""
    out = []
    for entry in re.split(r"Compiling entry function '", report)[1:]:
        name = entry.split("'")[0]
        kind = re.search(r"(small_d_kernel|large_d_kernel)", name)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        check(kind and regs and spill, f"unreadable ptxas entry {name}")
        args = ",".join(re.findall(r"L[ib](\d+)E", name))
        out.append((kind.group(1), args, int(regs.group(1)),
                    int(spill.group(1)) + int(spill.group(2))))
    return out


def bound_ms(n, m, d, e, which, normalize, tier, sfu_rate):
    """The least time the card could take for one call, and what bounds it.

    The larger of: the form (2 D flops per pair) and the signal columns
    (2 flops per pair and column) on the f32 units at D <= 8; at D > 8 the
    form on the tensor cores (3 passes of TF32 in the f32 tiers, one of
    bf16) plus the signal columns on the f32 units; one transcendental per
    pair on the special-function units; each input read once and each
    output written once from device memory.
    """
    cols = e + (1 if normalize and which == "direct" else 0)
    if d <= 8:
        terms = {"f32 FMA": 2.0 * n * m * (d + cols) / PEAK_F32_FLOPS}
    else:
        passes, peak = TENSOR_CORE_FORM[tier]
        terms = {"tensor cores": 2.0 * n * m * d * passes / peak,
                 "f32 FMA": 2.0 * n * m * cols / PEAK_F32_FLOPS}
    terms["special-function units"] = n * m / sfu_rate
    terms["memory"] = ((n + m) * d + m * e + n * e) * 4 / PEAK_BYTES
    engine = max(terms, key=terms.get)
    return (terms[engine] * 1e3, "bytes" if engine == "memory"
            else "operations", engine)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kmb_tpu_torch.datasets import ground_truth, make_arrays
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.ops.product import (
        kernel_matvec, kernel_matvec_torch)
    from kmb_tpu_torch.runner import run_on_arrays

    dev = torch.device("cuda")
    # ---- 1. environment ---------------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(dev)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {props.multi_processor_count} SMs, "
          f"max SM clock {max_clock_mhz:.0f} MHz")
    t0 = time.perf_counter()
    library = _build.build()
    _build.load_library()
    print(f"built {library.name} in {time.perf_counter() - t0:.2f} s [{card}]")
    report = _build.report_path(library).read_text()
    for line in report.splitlines():
        if line.startswith("== "):
            print(f"phase 1: nvcc {line[3:]}")
    kernels = ptxas_kernels(report)
    for kind in ("small_d_kernel", "large_d_kernel"):
        regs = [r for k, _, r, _ in kernels if k == kind]
        check(regs, f"no {kind} in the build")
        print(f"phase 1: {len(regs)} {kind} instantiations, {min(regs)}-"
              f"{max(regs)} registers")
    spilled = [(k, a, s) for k, a, _, s in kernels if s > 0]
    print(f"phase 1: {len(spilled)} kernels spill: {spilled}")
    for (kind, args), what in MAIN_PATH_KERNELS.items():
        found = [(r, s) for k, a, r, s in kernels if (k, a) == (kind, args)]
        check(len(found) == 1, f"{kind}<{args}> not in the build")
        print(f"phase 1: {kind}<{args}> ({what}): {found[0][0]} registers, "
              f"{found[0][1]} bytes spilled")
    sfu_rate = (SFU_PER_CLOCK_PER_SM * props.multi_processor_count
                * max_clock_mhz * 1e6)

    # ---- 2. kernels against their plain versions, on the card -------------
    rng = np.random.default_rng(0)

    def cuda(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    worst = {"direct": (0.0, ""), "flash": (0.0, "")}  # relative, case
    n_cases = 0

    def hold(label, which, tol, x, y, b, **kw):
        nonlocal n_cases
        got = as_tuple(kernel_matvec(x, y, b, **kw))
        ref = as_tuple(kernel_matvec_torch(x, y, b, **kw))
        torch.cuda.synchronize()
        check(len(got) == len(ref), f"{label}: state arity differs")
        for g, r in zip(got, ref):
            _, rel = compare(g, r)
            check(rel <= tol, f"{label}: relative error {rel:.3e} > {tol}")
            worst[which] = max(worst[which], (rel, label))
        n_cases += 1

    # N and M not multiples of 16, 64 or 128; D not multiples of 8 or 32.
    shapes = ((1037, 1511, 3, 1), (517, 1203, 64, 8), (300, 411, 784, 1),
              (301, 1203, 9, 13), (211, 999, 37, 2), (257, 1031, 130, 4))
    for tier in TIERS:
        tol = KERNEL_TOL[tier]
        for n, m, d, e in shapes:
            x = cuda(rng.standard_normal((n, d)) / np.sqrt(d))
            y = cuda(rng.standard_normal((m, d)) / np.sqrt(d))
            b = cuda(rng.standard_normal((m, e)))
            for name in KERNEL_NAMES:
                common = dict(kernel_name=name, precision=tier)
                tag = f"{tier} {name} N={n} M={m} D={d} E={e}"
                hold(f"{tag} product", "direct", tol, x, y, b, **common)
                hold(f"{tag} normalized",
                     "flash" if name in LOG_KERNELS else "direct", tol,
                     x, y, b, normalize_rows=True, **common)
                hold(f"{tag} deferred product", "direct", tol, x, y, b,
                     deferred=True, **common)
                hold(f"{tag} deferred normalized",
                     "flash" if name in LOG_KERNELS else "direct", tol,
                     x, y, b, normalize_rows=True, deferred=True, **common)
                hold(f"{tag} density", "direct", tol, x, y, b,
                     density_estimation=True, **common)
                hold(f"{tag} density, implicit ones", "direct", tol, x, y,
                     None, density_estimation=True, **common)
                limits = dict(row_offset=5, col_offset=3,
                              col_limit=3 + m - 7, row_limit=5 + n - 4,
                              mask_diagonal=True)
                # Limits ending inside a 128-wide tile.
                inside = dict(row_offset=40, col_offset=3,
                              col_limit=3 + min(m, 700) - 5,
                              row_limit=40 + min(n, 200) - 3,
                              mask_diagonal=True)
                for lname, lim in (("offsets and limits", limits),
                                   ("limits inside a tile", inside)):
                    hold(f"{tag} {lname}", "direct", tol, x, y, b, **lim,
                         **common)
                    if name in LOG_KERNELS:
                        hold(f"{tag} {lname}, flash", "flash", tol, x, y, b,
                             normalize_rows=True, deferred=True, **lim,
                             **common)
            # Same points: the diagonal of the singular kernel is masked.
            hold(f"{tier} inverse-distance same points D={d}", "direct", tol,
                 y, y, b, kernel_name="inverse-distance", precision=tier)
        # Large logits: exp(<x, y>) with logits above 100, in the small-D
        # loop (D = 4) and on the tensor cores (D = 64).
        for d, scale in ((4, 10.0), (64, 3.0)):
            xl = cuda(scale * rng.standard_normal((161, d)))
            yl = cuda(scale * rng.standard_normal((243, d)))
            bl = cuda(rng.standard_normal((243, 1)))
            check(float((xl @ yl.T).max()) > 100.0,
                  "large-logit case too small")
            hold(f"{tier} large logits D={d}", "flash",
                 max(LARGE_LOGIT_TOL, KERNEL_TOL[tier]), xl, yl, bl,
                 kernel_name="exponential", normalize_rows=True,
                 precision=tier)
    print(f"phase 2: {n_cases} cases, kernels match the plain version")
    for which, (rel, label) in worst.items():
        print(f"phase 2: worst {which} kernel relative error {rel:.3e} "
              f"({label})")

    # ---- 3. the main path through the port's runner -----------------------
    datasets = {}
    for name, _, _ in MAIN_PATH:
        arrays = make_arrays(name)
        t0 = time.perf_counter()
        arrays["target_signal"] = ground_truth(arrays, device="cuda")
        torch.cuda.synchronize()
        print(f"{name}: float64 truth on the card in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        datasets[name] = arrays

    _build.reset_launch_counts()
    per_run = {}   # (dataset, tier) -> launches of its kernel
    for name, which, what in MAIN_PATH:
        arrays = datasets[name]
        n, m = len(arrays["target_points"]), len(arrays["source_points"])
        for tier in TIERS:
            definition = Definition(
                algorithm="torch-product",
                module="kmb_tpu_torch.algorithms.torch_engine",
                constructor="TorchProduct",
                arguments={"kernel": arrays["kernel"],
                           "dimension": arrays["source_points"].shape[1],
                           "normalize_rows": bool(arrays["normalize_rows"]),
                           "precision": tier},
                query_argument_groups=[{}])
            before = {k.symbol: k.launches for k in _build.KERNELS}
            (row,) = run_on_arrays(definition, arrays, runs=2)
            launched = {k.symbol: k.launches - before[k.symbol]
                        for k in _build.KERNELS}
            symbol = getattr(_build, which.upper()).symbol
            check(launched[symbol] >= 2,
                  f"{name} {tier}: {symbol} launched {launched[symbol]} "
                  "times in 2 queries")
            truth = arrays["target_signal"]
            rel = float(np.sqrt(np.mean(row.error ** 2))
                        / np.sqrt(np.mean(truth ** 2)))
            check(np.all(np.isfinite(row.result))
                  and row.result.shape == truth.shape,
                  f"{name} {tier}: result not finite or misshapen")
            check(rel <= MAIN_PATH_BOUND[tier],
                  f"{name} {tier}: RMS error {rel:.3e} > "
                  f"{MAIN_PATH_BOUND[tier]}")
            qt = row.attrs["query_time"]
            per_run[name, tier] = launched[symbol]
            print(f"{name} [{tier}, {which} kernel, {what}]: query "
                  f"{qt * 1e3:.3f} ms, {n * m / qt:.4e} pairs/s, RMS rel "
                  f"error {rel:.3e}, launches {launched} [{card}]")
    launches = {k.symbol: k.launches for k in _build.KERNELS}
    for kernel in _build.KERNELS:
        check(kernel.launches > 0,
              f"{kernel.symbol} never launched on the main path")
    print(f"phase 3: main path launches {launches}")

    # ---- 4. kernels at the main path's shapes: time, bound, library -------
    def time_ms(fn, reps):
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

    def kernel_device_ms(fn, reps=3):
        """Device time of one launch of the hand-written kernel (the
        profiler's records whose name holds "_d_kernel", averaged over the
        records it kept), so `ms` splits into kernel and wrapper: the main
        path launches one kernel per call (E <= 8).  None if the profiler
        saw no such record."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if "_d_kernel" in e.key]
        count = sum(e.count for e in found)
        us = sum(getattr(e, "self_device_time_total", 0) for e in found)
        return us / count / 1e3 if count and us > 0 else None

    entries = []
    for name, which, _ in MAIN_PATH:
        arrays = datasets[name]
        y = cuda(arrays["source_points"])
        x = y if arrays["same_points"] else cuda(arrays["target_points"])
        b = cuda(arrays["source_signal"])
        n, d = x.shape
        m, e = b.shape
        normalize = bool(arrays["normalize_rows"])
        kw = dict(kernel_name=arrays["kernel"], normalize_rows=normalize)
        library_ms = None
        if which == "flash":
            q, k, v = (t[None, None] for t in (x, y, b))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_out = sdpa(q, k, v, scale=1.0)[0, 0]
            _, lib_rel = compare(lib_out, kernel_matvec_torch(x, y, b, **kw))
            # A yardstick only: it must compute the same function, at
            # whatever precision the library picks.
            check(lib_rel <= LIBRARY_TOL,
                  f"library attention disagrees ({lib_rel:.3e})")
            print(f"library attention vs plain: relative {lib_rel:.3e}")
            library_ms = time_ms(lambda: sdpa(q, k, v, scale=1.0), 20)
        for tier in TIERS:
            kwt = dict(kw, precision=tier)
            got = kernel_matvec(x, y, b, **kwt)
            ref = kernel_matvec_torch(x, y, b, **kwt)
            err, rel = compare(got, ref)
            check(rel <= KERNEL_TOL[tier],
                  f"{name} {tier}: kernel vs plain {rel:.3e}")
            del got, ref
            reps = 3 if n * m > 10**9 else 10
            ms = time_ms(lambda: kernel_matvec(x, y, b, **kwt), reps)
            plain_ms = time_ms(lambda: kernel_matvec_torch(x, y, b, **kwt),
                               2)
            device_ms = kernel_device_ms(lambda: kernel_matvec(x, y, b,
                                                               **kwt))
            kernel_alone = (None if device_ms is None
                            else round(device_ms, 4))
            bound, bound_by, engine = bound_ms(n, m, d, e, which, normalize,
                                               tier, sfu_rate)
            lib = None if library_ms is None else round(library_ms, 4)
            print(f"{which} kernel, {name} [{tier}]: {ms:.4f} ms (kernel "
                  f"alone {kernel_alone} ms), plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({engine}), "
                  f"library {lib} ms, {n * m / (ms * 1e-3):.4e} pairs/s, "
                  f"max_abs_err vs plain {err:.3e} [{card}]")
            entries.append(dict(
                name=which, route="cuda", source=SOURCE,
                replaces=REPLACES[which], launches=per_run[name, tier],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms, at=name,
                precision=tier, bound_engine=engine,
                kernel_device_ms=device_ms))
        del x, y, b
        torch.cuda.empty_cache()

    check({entry["name"] for entry in entries} == {"direct", "flash"},
          "a kernel was not timed")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
