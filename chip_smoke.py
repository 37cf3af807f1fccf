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
5. The solver path, through the port's runner (runs=2): Nystrom PCG,
   block-abs Jacobi MINRES and iterative refinement on the direct kernel,
   and the dense solvers, on the registry's solver datasets at full size.
   Each answer's float64 true residual ||K b - a|| / ||a|| is computed on
   the card and held under its limit (a dense answer: its backward error
   against the float64 matrix of the plain product); every iteration must
   have launched the direct kernel, and the plain version may run only in
   float64 (truth, residuals and that matrix).  The solver path's kernel
   shapes (the Nystrom sketch at E = 256, the E = 1 matvec at M = 10^4)
   are held against the plain version and timed.
6. The approximate path, through the port's runner (runs=2): the
   block-low-rank product (fixed rank and epsilon), Nystrom and random
   features (product and attention, materialised and streamed), the
   Nystrom ridge solver and the BLR MINRES solver with and without
   iterative refinement, at registry size.  Each is held against its
   float64 truth computed on the card (a product's RMS error, a solver's
   true residual, the Nystrom solver's residual of its own ridge system)
   under a limit fixed before the first run; BlrSolver must launch the
   direct kernel in every query (its true residual), and that shape is
   held against the plain version and timed.  One BLR build segment is
   timed step by step beside the alternatives the build does not take
   (torch.linalg.qr, eigh on the card), and one BlrSolver matvec beside
   its far-field products alone.

The last line is {"ok": true, "device": {...}} and is printed only when
every phase passed; the line before it holds the kernels' numbers, one
entry per kernel, dataset and tier, and the lines before that the solver
runs' and the approximate runs'.  Nothing is written outside the
git-ignored kernel build directory.
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
# bf16 signal and kernel values, bf16 points at D > 8 (test_ops.py holds
# the JAX bf16 tier to 5e-2 max-relative).
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
# The JAX package's bf16 tier on the same datasets: RMS(result - truth) /
# RMS(truth) of its TPU records
# results/product-{sphere,cube}-D3-E1-M131072-N131072-*/tpu-product/
# *bfloat16.hdf5 (`result` and `error`), for comparison only.
JAX_BF16_RECORD = {
    "product-sphere-D3-E1-M131072-N131072-inverse-distance": 2.35e-3,
    "product-cube-D3-E1-M131072-N131072-gaussian": 3.73e-3,
}

# Phase 5, the solver path: (label, dataset, constructor, constructor args,
# query args, the JAX package's TPU record as (iterations, reported
# residual) or None, limit on the float64 true residual ||K b - a|| / ||a||).
# The TPU records are results/<dataset>/tpu-solver-cg/*.hdf5 of the same
# configurations (iterations and residuals only, never times).  Limits,
# fixed before the first timed run: 1e-5 for the Gaussian PCG (tol 1e-6
# on the f32 recursive residual, 10x for its drift from the true one),
# 1e-2 for the sphere MINRES (its TPU record runs to max_iters at 3.9e-3),
# 1e-6 for the refinement (float64 outer residuals, TPU record 2.2e-7).
# The dense runs (limit None here) are held to ten times the backward
# error ||K b - a|| / (||K||_F ||b|| + ||a||) that
# kmb_tpu.ops.solve.dense_solve reaches on the CPU on the same dataset,
# with K the float64 kernel matrix of the float32 points formed by the
# plain float64 product, independent of the matrix the solver factors
# (`independent_backward_error`, here and in tests/test_torch_solve.py).
# Their true residual is printed beside it: on the numerically singular
# Gaussian cube it scales with ||b||, which the factorisation's roundings
# set (XLA's CPU LU reaches about 6e-5 there, cuSOLVER's about 7e-4, at
# backward errors of one order).
CUBE_131072 = "solver-cube-D3-E1-M131072-N131072-gaussian"
SPHERE_131072 = "solver-sphere-D3-E1-M131072-N131072-inverse-distance"
CUBE_10000 = "solver-cube-D3-E1-M10000-N10000-gaussian"
NORMAL_5000 = "solver-normal-D784-E1-M5000-N5000-gaussian"
SOLVER_PATH = (
    ("Nystrom PCG", CUBE_131072, "TorchSolverCG",
     {"precision": "float32", "precond_rank": 256},
     {"tol": 1e-6, "max_iters": 2000}, (141, 3.5e-6), 1e-5),
    ("block-abs Jacobi MINRES", SPHERE_131072, "TorchSolverCG",
     {"precision": "float32", "precond": "jacobi", "leaf": 512},
     {"tol": 1e-5, "max_iters": 2000}, (2000, 3.9e-3), 1e-2),
    ("Nystrom iterative refinement", CUBE_10000, "TorchSolverCG",
     {"precision": "float32", "precond_rank": 256, "refine_iters": 4},
     {"tol": 1e-9, "max_iters": 2000, "inner_tol": 1e-5}, (276, 2.2e-7),
     1e-6),
    ("dense LU", CUBE_10000, "TorchSolverDirect",
     {"precision": "float32", "method": "lu"}, {}, None, None),
    ("dense LU", CUBE_10000, "TorchSolverDirect",
     {"precision": "bfloat16", "method": "lu"}, {}, None, None),
    ("dense LU", NORMAL_5000, "TorchSolverDirect",
     {"precision": "float32", "method": "lu"}, {}, None, None),
    ("dense LU", NORMAL_5000, "TorchSolverDirect",
     {"precision": "bfloat16", "method": "lu"}, {}, None, None),
    ("dense eigh pseudo-inverse", NORMAL_5000, "TorchSolverDirect",
     {"precision": "float32", "method": "svd"}, {}, None, None),
)
# The backward error kmb_tpu.ops.solve.dense_solve reaches on the CPU
# (`KMB_PLATFORM=cpu PYTHONPATH=. python tests/test_torch_solve.py`, jax
# and torch on a CPU host): (dataset, method, precision) -> backward error.
DENSE_JAX_CPU_BACKWARD_ERROR = {
    (CUBE_10000, "lu", "float32"): 2.067883e-09,
    (CUBE_10000, "lu", "bfloat16"): 9.686364e-06,
    (NORMAL_5000, "lu", "float32"): 8.089086e-09,
    (NORMAL_5000, "lu", "bfloat16"): 2.562492e-06,
    (NORMAL_5000, "svd", "float32"): 3.009504e-07,
}

# Phase 6, the approximate path: (label, dataset, constructor, constructor
# args, query args, what is held, limit, the JAX package's TPU record of
# the same configuration).  Records: results/<dataset>/tpu-*-product/ and
# .../blr-solver/ (`error` datasets and attributes; accuracy and counts
# only, never times).  Limits, fixed before the first chip run: twice the
# record (the port computes in true float32 where the TPU's default
# matmuls were bf16 passes; the random draws differ between the packages),
# and for the Nystrom ridge solver ten times the residual of its own
# ridge system that kmb_tpu reaches on the CPU (NYSTROM_JAX_CPU_RIDGE).
PRODUCT_CUBE = "product-cube-D3-E1-M131072-N131072-gaussian"
PRODUCT_SPHERE = "product-sphere-D3-E1-M131072-N131072-inverse-distance"
ATTENTION = "attention-normal-D64-E8-M10000-N10000-exponential"
BLR_SOLVER_ARGS = {"leaf": 256, "rank": 64, "eta": 2.0, "epsilon": 1e-4}
APPROX_PATH = (
    ("BLR product, fixed rank", PRODUCT_CUBE, "BlrProduct",
     {"leaf": 256, "rank": 16, "eta": 2.0}, {}, "rms", 5.1e-3,
     {"rms": 2.556e-3, "compression": 15.5446}),
    ("BLR product, epsilon", PRODUCT_SPHERE, "BlrProduct",
     {"leaf": 256, "rank": 64, "eta": 2.0, "epsilon": 1e-3}, {}, "rms",
     1.3e-3, {"rms": 6.613e-4, "compression": 74.228}),
    ("Nystrom product", PRODUCT_CUBE, "NystromProduct", {"rank": 512}, {},
     "rms", 1.13e-2, {"rms": 5.642e-3, "compression": 127.75}),
    ("Nystrom attention", ATTENTION, "NystromProduct", {"rank": 512}, {},
     "rms", 2.97e-2, {"rms": 1.485e-2, "compression": 9.52}),
    ("random features", PRODUCT_CUBE, "RandomFeatureProduct",
     {"num_features": 1024}, {}, "rms", 1.31e-1,
     {"rms": 6.573e-2, "compression": 64.0}),
    ("random features attention", ATTENTION, "RandomFeatureProduct",
     {"num_features": 1024}, {}, "rms", 1.28e-1,
     {"rms": 6.381e-2, "compression": 4.88}),
    ("random features attention, streamed", ATTENTION,
     "RandomFeatureProduct", {"num_features": 1024, "stream_bytes": 0}, {},
     "rms", 1.28e-1, {"rms": 6.381e-2, "compression": 4.88}),
    ("Nystrom ridge solver", CUBE_131072, "NystromSolver", {"rank": 512},
     {"lam": 1e-2}, "ridge residual", None, None),
    ("BLR MINRES", SPHERE_131072, "BlrSolver", BLR_SOLVER_ARGS,
     {"tol": 1e-5, "max_iters": 2000}, "true residual", 2e-3,
     {"iterations": 2000, "true residual": 5.838e-4, "compression": 49.87}),
    ("BLR MINRES, iterative refinement", SPHERE_131072, "BlrSolver",
     BLR_SOLVER_ARGS, {"tol": 1e-8, "max_iters": 2000, "refine_iters": 3,
                       "inner_tol": 1e-4}, "true residual", 2e-4,
     {"iterations": 6000, "outer": 3, "true residual": 5.210e-5,
      "compression": 49.87}),
)
# ||(lam I + C C^T) b - a|| / ||a|| of kmb_tpu's NystromSolver(rank=512,
# lam=1e-2) on CUBE_131072, on the CPU
# (`KMB_PLATFORM=cpu PYTHONPATH=. python tests/test_torch_approx_engine.py`).
NYSTROM_JAX_CPU_RIDGE = 1.072553e+00
# The streamed random features against the materialised ones, relative to
# the largest output (tests/test_lowrank.py:237).
STREAM_TOL = 2e-5

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
            if tier == "bfloat16" and name in JAX_BF16_RECORD:
                print(f"{name} [bfloat16]: RMS rel error {rel:.3e}, JAX "
                      f"TPU record {JAX_BF16_RECORD[name]:.2e}")
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

    solvers, solver_datasets = solver_path(dev, card, sfu_rate, entries,
                                           time_ms)
    approx = approx_path(dev, card, sfu_rate, entries, time_ms,
                         {**datasets, **solver_datasets})

    check({entry["name"] for entry in entries} == {"direct", "flash"},
          "a kernel was not timed")
    print(json.dumps({"approx": approx}))
    print(json.dumps({"solvers": solvers}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def solver_path(dev, card, sfu_rate, entries, time_ms):
    """Phase 5: the solver path on the card (see the module docstring).

    Appends the solver path's kernel shapes to `entries` and returns one
    record per run of SOLVER_PATH."""
    from kmb_tpu_torch.algorithms import torch_engine
    from kmb_tpu_torch.datasets import ground_truth, make_arrays
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.ops import _build, product, solve
    from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch
    from kmb_tpu_torch.runner import run_on_arrays

    datasets = {}
    for name in dict.fromkeys(entry[1] for entry in SOLVER_PATH):
        arrays = make_arrays(name)
        t0 = time.perf_counter()
        arrays["target_signal"] = ground_truth(arrays, device="cuda")
        torch.cuda.synchronize()
        print(f"{name}: float64 truth on the card in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        datasets[name] = arrays

    def true_residual(arrays, b):
        """||K b - a|| / ||a|| in float64 on the card, from the float64
        points: independent of the solver's own report."""
        y64 = torch.tensor(arrays["source_points"], device=dev)
        a64 = torch.tensor(arrays["target_signal"], device=dev)
        kb = kernel_matvec_torch(y64, y64, torch.tensor(b, device=dev),
                                 kernel_name=arrays["kernel"])
        return float(torch.linalg.norm(kb - a64) / torch.linalg.norm(a64))

    frobenius = {}

    def independent_backward_error(arrays, b, block=1000):
        """||K b - a|| / (||K||_F ||b|| + ||a||) in float64 on the card, K
        the kernel matrix of the float32 points from the plain float64
        product: not the matrix the dense solver factored."""
        p = torch.tensor(arrays["source_points"], dtype=torch.float32,
                         device=dev).double()
        kernel = arrays["kernel"]
        m = len(p)
        if id(arrays) not in frobenius:
            frob_sq = 0.0
            for j in range(0, m, block):   # columns j:j+w of K
                w = min(block, m - j)
                eye = torch.eye(w, dtype=torch.float64, device=dev)
                frob_sq += float(torch.sum(kernel_matvec_torch(
                    p, p[j:j + w], eye, kernel_name=kernel,
                    col_offset=j) ** 2))
            frobenius[id(arrays)] = frob_sq ** 0.5
        b64 = torch.tensor(b, device=dev)
        a64 = torch.tensor(arrays["target_signal"], device=dev)
        kb = kernel_matvec_torch(p, p, b64, kernel_name=kernel)
        return float(torch.linalg.norm(kb - a64) / (
            frobenius[id(arrays)] * torch.linalg.norm(b64)
            + torch.linalg.norm(a64)))

    # Launches of the direct kernel inside each fit and query, and every
    # call of the plain version during the solves with its dtype.
    phase_launches = {"fit": 0, "query": 0}
    plain_dtypes = []
    real_plain = kernel_matvec_torch

    def spy_plain(x, *args, **kwargs):
        plain_dtypes.append(x.dtype)
        return real_plain(x, *args, **kwargs)

    def counted(method, key):
        def wrapper(self, *args, **kwargs):
            before = _build.DIRECT.launches
            try:
                return method(self, *args, **kwargs)
            finally:
                phase_launches[key] += _build.DIRECT.launches - before
        return wrapper

    classes = (torch_engine.TorchSolverCG, torch_engine.TorchSolverDirect)
    saved = [(cls, name, getattr(cls, name)) for cls in classes
             for name in ("fit", "query")]
    records = []
    _build.reset_launch_counts()
    for label, name, constructor, args, query, record, limit in SOLVER_PATH:
        arrays = datasets[name]
        definition = Definition(
            algorithm=f"torch-{constructor}",
            module="kmb_tpu_torch.algorithms.torch_engine",
            constructor=constructor,
            arguments={"kernel": arrays["kernel"],
                       "dimension": arrays["source_points"].shape[1],
                       **args},
            query_argument_groups=[query])
        phase_launches.update(fit=0, query=0)
        plain_dtypes.clear()
        for cls, method, fn in saved:
            setattr(cls, method, counted(fn, method))
        product.kernel_matvec_torch = spy_plain
        solve.kernel_matvec_torch = spy_plain
        try:
            (row,) = run_on_arrays(definition, arrays, runs=2)
        finally:
            for cls, method, fn in saved:
                setattr(cls, method, fn)
            product.kernel_matvec_torch = real_plain
            solve.kernel_matvec_torch = real_plain
        check(torch.float32 not in plain_dtypes,
              f"{label} on {name}: the plain version ran in float32")
        check(np.all(np.isfinite(row.result))
              and row.result.shape == arrays["source_signal"].shape,
              f"{label} on {name}: result not finite or misshapen")
        res = true_residual(arrays, row.result)
        attrs = row.attrs
        iterations = attrs.get("cg_iterations")
        fit_per_run = phase_launches["fit"] // 2
        query_per_run = phase_launches["query"] // 2
        if iterations is not None:
            check(query_per_run >= iterations,
                  f"{label}: {query_per_run} direct-kernel launches for "
                  f"{iterations} iterations in one query")
        held, eta = "true residual", None
        if limit is None:   # a dense run: its backward error is held
            held = "backward error"
            key = name, args["method"], args["precision"]
            eta = independent_backward_error(arrays, row.result)
            limit = 10 * DENSE_JAX_CPU_BACKWARD_ERROR[key]
        measured = res if eta is None else eta
        check(measured <= limit, f"{label} on {name} {args}: {held} "
              f"{measured:.3e} > {limit:.3e}")
        entry = dict(label=label, dataset=name, args=args, query=query,
                     build_s=attrs["build_time"],
                     query_s=attrs["query_time"], iterations=iterations,
                     jax_tpu_record=record,
                     reported_residual=attrs.get("cg_relative_residual"),
                     ir_outer_iterations=attrs.get("ir_outer_iterations"),
                     true_residual=res, backward_error=eta, held=held,
                     limit=limit,
                     fit_launches=fit_per_run, query_launches=query_per_run,
                     plain_dtypes=sorted({str(t) for t in plain_dtypes}))
        records.append(entry)
        print(f"phase 5: {label} on {name} {args} {query}: build "
              f"{attrs['build_time']:.4f} s, query {attrs['query_time']:.4f}"
              f" s, iterations {iterations} (JAX TPU record {record}), "
              f"reported residual {entry['reported_residual']}, float64 "
              f"true residual {res:.3e}, backward error {eta}, "
              f"{held} held to {limit:.3e}, direct "
              f"launches per fit {fit_per_run}, per query {query_per_run} "
              f"[{card}]")
    launches = {k.symbol: k.launches for k in _build.KERNELS}
    check(_build.DIRECT.launches > 0, "the solver path launched no kernel")
    print(f"phase 5: solver path launches {launches}")

    # The solver path's kernel shapes against the plain version, timed:
    # the Nystrom sketch (E = 256) and the E = 1 matvec of each dataset.
    def cuda(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, e in ((CUBE_131072, 256), (CUBE_131072, 1),
                    (SPHERE_131072, 1), (CUBE_10000, 1)):
        arrays = datasets[name]
        y = cuda(arrays["source_points"])
        b = torch.randn((len(y), e), generator=gen, device=dev)
        kw = dict(kernel_name=arrays["kernel"])
        before = _build.DIRECT.launches
        got = kernel_matvec(y, y, b, **kw)
        per_call = _build.DIRECT.launches - before
        ref = kernel_matvec_torch(y, y, b, **kw)
        err, rel = compare(got, ref)
        check(rel <= KERNEL_TOL["float32"],
              f"solver path {name} E={e}: kernel vs plain {rel:.3e}")
        del got, ref
        ms = time_ms(lambda: kernel_matvec(y, y, b, **kw), 3)
        plain_ms = time_ms(lambda: kernel_matvec_torch(y, y, b, **kw), 1)
        n, d = y.shape
        bound, bound_by, engine = bound_ms(n, n, d, e, "direct", False,
                                           "float32", sfu_rate)
        what = "Nystrom sketch" if e > 1 else "Krylov matvec"
        print(f"phase 5: direct kernel, {what} on {name} E={e} [float32]: "
              f"{ms:.4f} ms in {per_call} launches, plain {plain_ms:.4f} ms,"
              f" bound {bound:.4f} ms ({engine}), max_abs_err vs plain "
              f"{err:.3e} [{card}]")
        entries.append(dict(
            name="direct", route="cuda", source=SOURCE,
            replaces=REPLACES["direct"], launches=launches[
                _build.DIRECT.symbol],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=None,
            at=f"{name}, solver path, E={e}", precision="float32",
            bound_engine=engine, kernel_device_ms=None,
            launches_per_call=per_call))
        del y, b
        torch.cuda.empty_cache()
    return records, datasets


def rms_error(row, truth):
    """RMS(result - truth) / RMS(truth), the main path's product error."""
    return float(np.sqrt(np.mean(row.error ** 2))
                 / np.sqrt(np.mean(truth ** 2)))


def approx_path(dev, card, sfu_rate, entries, time_ms, datasets):
    """Phase 6: the approximate path on the card (see the module
    docstring).

    `datasets` holds the arrays, with their float64 truth, of phases 3 and
    5.  Appends the BlrSolver's direct-kernel shape to `entries` and
    returns one record per run of APPROX_PATH."""
    from kmb_tpu_torch.algorithms import torch_approx
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch
    from kmb_tpu_torch.runner import run_on_arrays

    def true_residual(arrays, b):
        y64 = torch.tensor(arrays["source_points"], device=dev)
        a64 = torch.tensor(arrays["target_signal"], device=dev)
        kb = kernel_matvec_torch(y64, y64, torch.tensor(b, device=dev),
                                 kernel_name=arrays["kernel"])
        return float(torch.linalg.norm(kb - a64) / torch.linalg.norm(a64))

    # The Nystrom solver's factor C of its last build (the runner keeps the
    # last candidate), for the residual of its own ridge system.
    built = []
    real_build = torch_approx.nystrom_solver_build

    def spy_build(*args, **kwargs):
        out = real_build(*args, **kwargs)
        built.append(out[0])
        return out

    # The last BLR operator built, for the matvec breakdown.
    operators = []
    real_operator = torch_approx.BlrOperator

    def spy_operator(*args, **kwargs):
        operators[:] = [real_operator(*args, **kwargs)]
        return operators[0]

    query_launches = []
    real_query = torch_approx.BlrSolver.query

    def counted_query(self):
        before = _build.DIRECT.launches
        try:
            return real_query(self)
        finally:
            query_launches.append(_build.DIRECT.launches - before)

    records = []
    materialised = None
    started = time.perf_counter()
    _build.reset_launch_counts()
    torch_approx.nystrom_solver_build = spy_build
    torch_approx.BlrOperator = spy_operator
    torch_approx.BlrSolver.query = counted_query
    try:
        for (label, name, constructor, args, query, held, limit,
             record) in APPROX_PATH:
            arrays = datasets[name]
            definition = Definition(
                algorithm=f"torch-{constructor}",
                module="kmb_tpu_torch.algorithms.torch_approx",
                constructor=constructor,
                arguments={"kernel": arrays["kernel"],
                           "dimension": arrays["source_points"].shape[1],
                           "normalize_rows": bool(arrays["normalize_rows"]),
                           **args},
                query_argument_groups=[query])
            built.clear()
            query_launches.clear()
            (row,) = run_on_arrays(definition, arrays, runs=2)
            attrs = row.attrs
            solver = constructor in ("NystromSolver", "BlrSolver")
            truth = arrays["source_signal" if solver else "target_signal"]
            check(np.all(np.isfinite(row.result))
                  and row.result.shape == truth.shape,
                  f"{label}: result not finite or misshapen")
            entry = dict(label=label, dataset=name, args=args, query=query,
                         build_s=attrs["build_time"],
                         query_s=attrs["query_time"], held=held,
                         jax_tpu_record=record, card=card)
            for key in ("compression", "rank", "num_features", "streaming",
                        "near_pairs", "near_sym_pairs", "far_pairs",
                        "mean_block_rank", "build_qr_seconds",
                        "build_eigh_seconds", "cg_iterations",
                        "ir_outer_iterations", "cg_relative_residual",
                        "true_relative_residual"):
                if key in attrs:
                    entry[key] = attrs[key]
            if held == "rms":
                measured = rms_error(row, arrays["target_signal"])
            elif held == "ridge residual":
                check(len(built) == 2, f"{label}: {len(built)} builds")
                c = built[-1].double()
                b = torch.tensor(row.result, device=dev)
                a = torch.tensor(arrays["target_signal"], device=dev)
                lam = query["lam"]
                measured = float(torch.linalg.norm(lam * b + c @ (c.T @ b)
                                                   - a)
                                 / torch.linalg.norm(a))
                limit = 10 * NYSTROM_JAX_CPU_RIDGE
                entry["jax_cpu_ridge_residual"] = NYSTROM_JAX_CPU_RIDGE
                entry["true_residual"] = true_residual(arrays, row.result)
            else:
                measured = true_residual(arrays, row.result)
                check(len(query_launches) == 2
                      and min(query_launches) >= 1,
                      f"{label}: direct-kernel launches per query "
                      f"{query_launches}")
                entry["direct_launches_per_query"] = query_launches[:]
                if "refine_iters" not in query:
                    entry.update(blr_matvec_breakdown(
                        operators[0], attrs, time_ms, dev))
            check(measured <= limit,
                  f"{label} on {name}: {held} {measured:.3e} > {limit:.3e}")
            entry.update(measured=measured, limit=limit)
            if constructor == "BlrProduct" and "epsilon" not in args:
                # A fixed rank: the compression follows from the plan.
                check(round(attrs["compression"], 4) == record["compression"],
                      f"{label}: compression {attrs['compression']:.6f}, "
                      f"record {record['compression']}")
            if args.get("stream_bytes") == 0:
                check(attrs["streaming"], f"{label}: did not stream")
                ref = torch.tensor(materialised)
                diff = float((torch.tensor(row.result) - ref).abs().max()
                             / ref.abs().max())
                check(diff <= STREAM_TOL, f"{label}: streamed differs from "
                      f"materialised by {diff:.3e} > {STREAM_TOL}")
                entry["streamed_vs_materialised"] = diff
            elif constructor == "RandomFeatureProduct":
                materialised = row.result
            records.append(entry)
            shown = {k: v for k, v in entry.items()
                     if k not in ("label", "dataset", "args", "query",
                                  "card", "held", "measured", "limit")}
            print(f"phase 6: {label} on {name} {args} {query}: {held} "
                  f"{measured:.4e} (limit {limit:.3e}), {shown} [{card}]")
    finally:
        torch_approx.nystrom_solver_build = real_build
        torch_approx.BlrOperator = real_operator
        torch_approx.BlrSolver.query = real_query
        operators.clear()
    launches = {k.symbol: k.launches for k in _build.KERNELS}
    check(_build.DIRECT.launches > 0,
          "the approximate path launched no direct kernel")
    print(f"phase 6: approximate path launches {launches}")

    blr_build_segment(datasets[SPHERE_131072], card, dev)

    # BlrSolver's true residual: the direct kernel at E = 1 on the sphere,
    # against the plain version, timed.
    arrays = datasets[SPHERE_131072]
    y = torch.tensor(np.asarray(arrays["source_points"], np.float32),
                     device=dev)
    b = torch.randn((len(y), 1), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    kw = dict(kernel_name=arrays["kernel"], precision="float32")
    got = kernel_matvec(y, y, b, **kw)
    ref = kernel_matvec_torch(y, y, b, **kw)
    err, rel = compare(got, ref)
    check(rel <= KERNEL_TOL["float32"],
          f"approximate path {SPHERE_131072}: kernel vs plain {rel:.3e}")
    del got, ref
    ms = time_ms(lambda: kernel_matvec(y, y, b, **kw), 3)
    plain_ms = time_ms(lambda: kernel_matvec_torch(y, y, b, **kw), 1)
    n, d = y.shape
    bound, bound_by, engine = bound_ms(n, n, d, 1, "direct", False,
                                       "float32", sfu_rate)
    print(f"phase 6: direct kernel, BlrSolver true residual on "
          f"{SPHERE_131072} E=1 [float32]: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({engine}), "
          f"launches {launches[_build.DIRECT.symbol]}, max_abs_err vs plain "
          f"{err:.3e} [{card}]")
    entries.append(dict(
        name="direct", route="cuda", source=SOURCE,
        replaces=REPLACES["direct"], launches=launches[_build.DIRECT.symbol],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=None,
        at=f"{SPHERE_131072}, approximate path (BlrSolver true residual), "
           "E=1", precision="float32", bound_engine=engine,
        kernel_device_ms=None))
    print(f"phase 6: {time.perf_counter() - started:.1f} s [{card}]")
    return records


def blr_matvec_breakdown(op, attrs, time_ms, dev):
    """One E = 1 matvec of a built BLR operator against its far-field
    products alone (U (V b_j) and the mirrored V^T (U^T b_i), as the
    matvec forms them), CUDA events; and that share of the solver's query.
    """
    b = torch.randn((op.m, 1), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    blocks = op.block_signal(b)
    out = blocks.new_zeros((op.plan.num_x_blocks, op.plan.num_y_blocks,
                            op.plan.leaf, 1))

    def far_field():
        for u, v, far_j, far_i in op.far_groups:
            out[far_i, far_j] = u @ (v @ blocks[far_j])
        for (u, v, _, _), (far_i, far_j) in zip(op.far_groups,
                                                op.mirror_groups):
            out[far_j, far_i] = v.mT @ (u.mT @ blocks[far_i])

    matvec_ms = time_ms(lambda: op.matvec(b), 10)
    far_ms = time_ms(far_field, 10)
    iterations = attrs["cg_iterations"]
    return {"matvec_ms": matvec_ms, "far_field_ms": far_ms,
            "far_field_share_of_matvec": far_ms / matvec_ms,
            "far_field_share_of_query": far_ms * 1e-3 * iterations
            / attrs["query_time"]}


def blr_build_segment(arrays, card, dev):
    """One build segment (BUILD_SEGMENT far pairs of the sphere, leaf 256,
    rank 64) step by step, beside the alternatives the build does not
    take: torch.linalg.qr (Q one matrix at a time) for the WY thin QR, and
    torch.linalg.eigh in float64 on the card for the host LAPACK eigh.
    Second of two passes (the first warms up)."""
    from kmb_tpu_torch.ops import blr
    from kmb_tpu_torch.utils import highest_precision

    y = np.asarray(arrays["source_points"], np.float32)
    plan = blr.build_plan(y, y, leaf=256, eta=2.0, same_points=True)
    pts = torch.tensor(y[plan.gather_x], device=dev)
    pairs = torch.tensor(plan.far_pairs[:blr.BUILD_SEGMENT], dtype=torch.long,
                         device=dev)
    spec = blr.get_kernel(arrays["kernel"])
    omega = blr.draw_test_matrix(256, 64, 0, device=dev)
    for _ in range(2):
        seconds = {}

        def step(key, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds[key] = time.perf_counter() - t0
            return out

        with highest_precision():
            k_tile = step("tile", blr._kernel_tile, spec, pts[pairs[:, 0]],
                          pts[pairs[:, 1]])
            sketch = step("sketch", torch.matmul, k_tile, omega)
            q = step("wy_qr", blr._thin_q, sketch)
            q_lib, _ = step("linalg_qr", torch.linalg.qr, sketch)
            v = step("projection", torch.matmul, q.mT, k_tile)
            gram = step("gram", blr._batched_gram, v)
        w_host, _ = step("host_eigh", blr._host_eigh, gram)
        w_card, _ = step("card_eigh", torch.linalg.eigh, gram.double())
    check(float((q @ q.mT - q_lib @ q_lib.mT).abs().max()) < 1e-4,
          "the WY Q spans another range than torch.linalg.qr's")
    diff = float(np.abs(w_host - w_card.cpu().numpy()).max()
                 / np.abs(w_host).max())
    check(diff < 1e-12, f"host and card eigenvalues differ by {diff:.3e}")
    print(f"phase 6: BLR build segment of {len(pairs)} pairs (sphere, leaf "
          f"256, rank 64), seconds: "
          + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
          + f"; kept WY QR and host eigh [{card}]")


if __name__ == "__main__":
    sys.exit(main())
