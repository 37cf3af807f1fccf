#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (kmb_tpu_torch).

Run from the repository root on a machine with one CUDA card (sm_90a):

    python3 chip_smoke.py

`--phases 7,8` (any comma-separated subset; default all) runs only those
phases: phase 1 always runs, phase 8 brings phase 7 (its single-card
baselines), phase 10 brings phase 8 (its processes), and a phase makes
the datasets and truths it needs when the phase that makes them is not
run.

Phases, each of which must pass:

1. Environment: the card's name and power limit, torch and CUDA versions,
   the nvcc build of kmb_tpu_torch/ops/csrc/ (one process per source, the
   seconds of each), and ptxas's registers and spills (`-Xptxas -v`) of
   each family, the wide mode's included, and its wgmma serialisation
   warnings.
2. Both kernels (direct and flash) against the plain PyTorch version on the
   card, in all three precision tiers and for all four kernel maps, at
   ragged shapes (D in {3, 5, 9, 37, 64, 130, 784}, E in {1, 2, 4, 8, 13}
   and, in the wide mode, {9, 16, 32, 64, 100, 256, 512} with D up to 784,
   N and M not
   multiples of 16, 64 or 128), with the diagonal mask, normalize_rows,
   density estimation, the deferred states, offsets and limits (also
   ending inside a tile), and large logits at D = 4 (small-D loop) and
   D = 64 (tensor cores).  One long case, M = 131072 and E = 256, is held
   against float64: the wide mode no less accurate than the same signal
   in the narrow mode.  The large-D form at the diagonal of equal points
   (D = 256, 20000 points, abs-exp) is held to the plain version in both
   modes, and every bf16 flash kernel over eight draws at N = 300,
   M = 411 (the narrow and wide large-D kernels at D = 784 and 64, the
   small-D kernels at D = 3 and 8; each draw's distance to float64
   printed).  The E = 512 shape is timed in each tier, the library's
   attention beside its normalised (flash) rows.
3. The main path, through the port's runner (`run_on_arrays`, runs=2), on
   five datasets in three tiers, each held against its float64 truth
   computed on the card; every kernel launch is counted, and the D256 E16
   product must take one launch of the wide mode per query.
4. Each kernel timed at the main path's shapes, in each tier, beside its
   plain version, its bound and (for the flash kernel) the library's
   attention call, and held against the plain version there too; then
   two shapes of the large-D wide kernel beyond the main path's datasets:
   the D256 dataset's points with a 64-column signal, and the attention
   dataset's points with a 64-column signal (beside the library's
   attention); these two shapes' `launches` count their own checked call
   (counts set to 0 just before it; `main_path` false in their entries).
   `ms` is the wrapper's call (staging, launches, merge) with CUDA events;
   `kernel_device_ms` is the kernel alone, CUDA events that the kernel
   library records just before and after each launch on its stream (None
   if that read more than the call took); the large-D wide rows also give
   the bytes the kernel staged from L2 in the checked call, as the
   library reports them from the launch's own plan, and their rate.
5. The solver path, through the port's runner (runs=2): Nystrom PCG,
   block-abs Jacobi MINRES and iterative refinement on the direct kernel,
   and the dense solvers, on the registry's solver datasets at full size.
   Each answer's float64 true residual ||K b - a|| / ||a|| is computed on
   the card and held under its limit (a dense answer: its backward error
   against the float64 matrix of the plain product); every iteration must
   have launched the direct kernel, each Nystrom build exactly once (the
   sketch, one launch of the wide mode with one E block: each kernel
   value computed once), and the plain version may run
   only in float64 (truth, residuals and that matrix); the Nystrom PCG
   takes no more than max(3, 10%) beyond the 142 iterations recorded
   before the wide mode (its best residual came at 82, the stall window
   ended it).  The solver path's kernel
   shapes (the Nystrom sketch at E = 256 in each tier, one launch of one E
   block; the same size at E = 64 and 16; the E = 1 matvec at M = 10^4)
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
7. The sharded path on one card, in an NCCL world of one
   (parallel/multihost.initialize): ShardedProduct (ring and all-pairs) on
   the cube, the sphere and attention, and ShardedSolverCG (Nystrom PCG on
   the solver cube, MINRES on the solver sphere), through the port's
   runner (runs=2), each held against its float64 truth under phase 3's
   and phase 5's limits, the products also against the single-card
   TorchProduct answer, the PCG iterations within max(3, 10%) of the
   single-card TorchSolverCG's, its sketch one launch per ring chunk.
   Before them, the single card's Nystrom PCG over four orderings of the
   points on "gram" factors from two sketches of the same test matrix
   (one launch; the ring's 16 chunk launches for four virtual ranks on
   the packed (y | b) signal the ranks rotate, folded); each sketch's
   per-column error against the float64 sketch on the card and each
   route's factors against the one launch's are printed, the virtual
   ring's errors (max and median) held within 1.5x of the one launch's,
   and its ordering-0 count held to the band phase 8 uses.
   Then the per-shard arithmetic of four cards on this one: the ring's
   chunks and fold for four virtual ranks, the all-pairs blocks on a
   virtual 2 x 2 grid, against the single-card product and the float64
   truth; and the ring chunk's kernel shapes at p = 4 against the plain
   version, timed.  Last, the communication model of kmb_tpu_torch.comm:
   the ring's and all-pairs' collectives recorded in a gloo world of four
   CPU ranks and held to its formula, which is scaled to the cube and to
   2^20 at this card's rate (the single-card TorchProduct float32 query on
   the cube) and NVLink's data-sheet rate, its rows printed.
8. Four cards (when the machine has them; otherwise a line says it was not
   run): four NCCL ranks, one process per card, run the ring and the 2 x 2
   all-pairs product on the cube, the sphere and attention and
   ShardedSolverCG(precond_rank=256) on the solver cube through the
   runner (runs=2; times are the slowest rank's).  Rank 0's answers are
   held against the same truths and limits; each query's time is printed
   beside the single-card time of phase 7, the scaling efficiency
   (single-card time / (4 x sharded time)) and, for the ring, the sum of
   its chunk kernels' times (CUDA events, the slowest rank's).  Each rank
   also runs the sharded PCG loop on the single card's "gram" factors of
   the same test matrix and records the dtypes its sharded build sums
   over the ranks; rank 0 holds the four-card sketch, gathered, against
   the float64 sketch on the card (its errors within 1.5x of the one
   launch's, as in phase 7); these are printed before the checks, and
   the launch counts are read before this split runs.  One ring
   and one all-pairs query on the cube run with the mesh's collectives
   recorded (parallel.sharded.record_collectives): every rank's counts
   and bytes must equal kmb_tpu_torch.comm's formula, and the model's
   efficiency is printed beside the measured one.
9. The harness around the engines on one card, in a process of its own
   (torch.profiler's CUDA records went missing in this process after
   phase 5 in earlier runs; here the hook is first tried once in it, and
   either writes a trace with kernel events or refuses), after 10^5
   launches there: the runner's torch.profiler hook (KMB_PROFILE_DIR)
   on TorchProduct float32 through `run_on_arrays` (runs=2) on the cube
   and attention, after the same run without it: one Chrome trace per
   query group,
   from the last repetition, whose kernel events name the instantiations
   of phase 1's ptxas report and number the launches of that repetition;
   the native float64 oracle (built from native/kmb_native.cpp) through
   `run_on_arrays` on three 10^4-point datasets against the float64 plain
   product on the card; and `kmb_tpu_torch.scaling.measure` at p = 1 on
   2^20 points (1.1e12 pairs) against a float64 plain product on a subset
   of the target rows (phase 11 times that kernel shape).
10. The device-count sweep on four cards (with phase 8's per-card
   processes; otherwise a line says it was not run): `scaling.measure`
   over meshes of 1, 2 and 4 cards at 131072^2 and 2^20, each answer held
   against the single card's, printed beside phase 8's ring efficiency.
11. The 2^20-point datasets through the CLI, in a temporary data and
   results directory: `python -m kmb_tpu_torch --dataset NAME --algorithm
   torch-product --runs 2` in a subprocess for the Gaussian cube at
   2^20 x 2^20 (D3) and exponential attention at D25 (2^20 sources, 10^4
   targets), each computing its float64 truth over every row on the card
   (its seconds and peak allocated memory, under 16 GiB, from the CLI's
   log), then each tier's query in a child process.  Each stored result's
   error over all rows is held under phase 3's bounds; each tier's
   launches come from the children's log.  Then each kernel at those
   shapes in this process: the call held to the plain version on its
   first 4096 rows, timed with its kernel alone, one plain call (float32x3
   shares float32's: the plain version's code is the same), the bound and
   (attention) the library's memory-efficient attention.  Last, `python
   -m kmb_tpu_torch.smoke --hardware GPU` with its test step skipped
   (JAX and minutes), and its plot and website steps where matplotlib is
   missing.

The last line is {"ok": true, "device": {...}} and is printed only when
every phase passed; the line before it holds the kernels' numbers, one
entry per kernel, dataset and tier, and the lines before that the sharded
runs', the solver runs' and the approximate runs'.  Nothing is written
outside the git-ignored kernel build directories and the system's
temporary directory (phase 8's rank reports, phase 9's traces, phase 11's
datasets and results, removed at the end).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
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
# (D, E) of phase 2's bf16 flash draws (tests/test_torch_cuda.py's too):
# the narrow large-D kernel, the large-D wide kernel, the small-D kernels.
FLASH_DRAWS = ((784, 1), (784, 16), (784, 64), (64, 16), (64, 64), (3, 1),
               (8, 1), (3, 16), (8, 64))
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
    ("product-normal-D256-E16-M20000-N20000-absolute-exponential", "direct",
     "wide signal, D > 8"),
)
# Datasets whose queries must run the wide mode (E > 8), one launch each.
WIDE_MAIN_PATH = ("product-normal-D256-E16-M20000-N20000-absolute-exponential",)
# Phase 5's single-card Nystrom PCG: its iterations with the sketch in
# launches of 8 columns (PERF.md section 5).  Its best residual there,
# 1.569e-6, above the tolerance 1e-6, came at iteration 82, and the stall
# window (60 iterations without a new best) ended the solve: a
# preconditioner no worse takes no more than max(3, 10%) beyond it, and
# one whose float32 floor lies below the tolerance stops near iteration 82
# instead.
NYSTROM_PCG_ITERATIONS = 142
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

# Phases 7 and 8, the sharded path (ShardedProduct, ShardedSolverCG).
APPROX_DATASETS = (PRODUCT_CUBE, PRODUCT_SPHERE, ATTENTION, CUBE_131072,
                   SPHERE_131072)
SHARDED_PRODUCTS = (PRODUCT_CUBE, PRODUCT_SPHERE, ATTENTION)
SCHEDULES = ("ring", "allpairs")
# (label, dataset, constructor args, query args, limit on the float64 true
# residual: phase 5's on the same dataset).  The MINRES entry has no
# preconditioner: its TPU record (tpu-solver-cg, tol 1e-6) runs 2000
# iterations to a reported 2.0e-4.
SHARDED_SOLVERS = (
    ("sharded Nystrom PCG", CUBE_131072,
     {"precision": "float32", "precond_rank": 256},
     {"tol": 1e-6, "max_iters": 2000}, 1e-5),
    ("sharded MINRES", SPHERE_131072, {"precision": "float32"},
     {"tol": 1e-6, "max_iters": 2000}, 1e-2),
)
SHARDED_DATASETS = SHARDED_PRODUCTS + (CUBE_131072, SPHERE_131072)
FOUR_CARDS = 4
PCG_ORDERINGS = 4   # orderings of the points for the single-card PCG spread
# A ring-chunked sketch K @ Q's per-column errors against float64 (max and
# median) within this factor of the one launch's.
SKETCH_ERROR_RATIO = 1.5
FOUR_CARD_TIMEOUT = 600   # seconds for phase 8's ranks, start to report

# Phase 9: the runner's profiler hook on TorchProduct float32, by dataset:
# the instantiation its kernel events must name (as MAIN_PATH_KERNELS).
PROFILED = ((PRODUCT_CUBE, ("small_d_kernel", "0,3,1,0,0,0")),
            (ATTENTION, ("large_d_kernel", "3,8,1,0,0")))
# The native oracle against the float64 plain product on the card,
# relative to the largest output: two float64 summation orders over 10^4
# sources and -ffast-math's vector exp (about 4 ulp) differ by more than
# tests/test_native.py's 1e-12 at 257 sources.
NATIVE_DATASETS = ("product-cube-D3-E1-M10000-N10000-gaussian",
                   "product-sphere-D3-E1-M10000-N10000-inverse-distance",
                   ATTENTION)
NATIVE_TOL = 1e-10
# The sweep (phases 9-10): the JAX package's north-star size, and the
# phase-8 size; answers held at 1e-4 RMS relative (float32 sums), at p = 1
# against float64 on the first SWEEP_CHECK_ROWS target rows.
SWEEP_N = 2**20
SWEEP_SIZES = (131072, SWEEP_N)
SWEEP_COUNTS = (1, 2, 4)
SWEEP_RUNS = 3
SWEEP_TOL = 1e-4
SWEEP_CHECK_ROWS = 4096
# Phase 11: the 2^20-point datasets through `python -m kmb_tpu_torch`
# (the algos.yaml entry `torch-product`: three tiers), each with its
# float64 truth over every row, computed by the CLI on the card.
CLI_DATASETS = ("product-cube-D3-E1-M1048576-N1048576-gaussian",
                "attention-normal-D25-E1-M1048576-N10000-exponential")
CLI_ALGORITHM = "torch-product"
CLI_TIMEOUT = 900           # seconds for one CLI run, truth included
TRUTH_PEAK_BYTES = 16 * 2**30   # device memory the truth may hold
SMOKE_TIMEOUT = 600         # seconds for `python -m kmb_tpu_torch.smoke`
PHASE9_TIMEOUT = 900   # seconds for phase 9's process, start to report
HOOK_PRIOR_LAUNCHES = 100_000   # launches before phase 9's hook, its process
HOOK_DATASET = "product-cube-D3-E1-M1000-N1000-gaussian"

REPLACES = {
    "direct": "kmb_tpu/ops/product.py:230 (_direct_kernel_body, "
              "pallas_call at :638)",
    "flash": "kmb_tpu/ops/product.py:260 (_flash_kernel_body, "
             "pallas_call at :608)",
}
SOURCE = "kmb_tpu_torch/ops/csrc/product.cu"
# The wide mode (E > 8, acc_mode="mxu" of the Pallas kernels) behind the
# entry points of product.cu: at D <= 8 its own kernel, at D > 8 the
# large-D tile with its signal product from wide.cuh.
WIDE_SOURCE = {False: "kmb_tpu_torch/ops/csrc/small_d_wide.cuh",
               True: "kmb_tpu_torch/ops/csrc/large_d_wide.cuh"}


def kernel_source(d, e):
    """The source of the kernel a call of D coordinates and E signal
    columns launches (the narrow mode's entry points for E <= 8)."""
    return WIDE_SOURCE[d > 8] if e > 8 else SOURCE


# Phase 4's shapes of the large-D wide kernel beyond the main path's
# datasets: (label, dataset whose points are used, columns of a signal
# drawn from a seed).  The D256 dataset's kernel is abs-exp (direct); the
# attention dataset's is exponential, normalised (flash).
WIDE_TIMING = (
    ("D256 E64", "product-normal-D256-E16-M20000-N20000-absolute-exponential",
     64),
    ("attention D64 E64", "attention-normal-D64-E8-M10000-N10000-exponential",
     64),
)
def library_attention(x, y, b, kernel_name):
    """One PyTorch call that computes the normalised product of
    `kernel_name` (scaled_dot_product_attention), or None: exponential
    attention softmax(x y^T) b; the Gaussian's softmax(-|x - y|^2) as
    softmax(2 x y^T - |y|^2) b, the row's |x|^2 cancelling.  A yardstick
    only: the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    v = b[None, None]
    if kernel_name == "exponential":
        q, k = x[None, None], y[None, None]
        return lambda: sdpa(q, k, v, scale=1.0)[0, 0]
    if kernel_name == "gaussian":
        q, k = (2.0 * x)[None, None], y[None, None]
        bias = -(y * y).sum(1)[None, None, None, :].expand(
            1, 1, x.shape[0], y.shape[0])
        return lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0)[0, 0]
    return None

# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# TF32 and bf16 on the tensor cores, device memory bandwidth, and
# special-function throughput per SM per clock.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SFU_PER_CLOCK_PER_SM = 16

# The large-D form product and the wide mode's signal product on the
# tensor cores: (passes, peak) per tier.  The f32 tiers run 3xTF32
# (lo.hi + hi.lo + hi.hi), bf16 one pass.
TENSOR_CORE_FORM = {"float32": (3, PEAK_TF32_FLOPS),
                    "float32x3": (3, PEAK_TF32_FLOPS),
                    "bfloat16": (1, PEAK_BF16_FLOPS)}

# The instantiations the main and solver paths launch, by (template, or
# the wide mode's source, and arguments as ptxas's mangled names list
# them), for phase 1's register report: small_d<map, D, E, flash, den,
# rnd>, large_d<map, E, flash, den, bf16>, one_chunk_large_d<map, E, flash,
# den>, small_d_wide_<D>_<tier><map, E block, flash>,
# large_d_wide_<tier><map, flash, E block>.
MAIN_PATH_KERNELS = {
    ("small_d_kernel", "0,3,1,0,0,0"): "cube, float32",
    ("small_d_kernel", "0,3,1,0,0,1"): "cube, bfloat16",
    ("small_d_kernel", "2,3,1,0,0,0"): "sphere, float32",
    ("large_d_kernel", "0,1,0,0,0"): "D784, float32 (3xTF32)",
    ("large_d_kernel", "0,1,0,0,1"): "D784, bfloat16",
    ("large_d_kernel", "3,8,1,0,0"): "attention, float32 (3xTF32)",
    ("large_d_kernel", "3,8,1,0,1"): "attention, bfloat16",
    ("one_chunk_large_d_kernel", "3,1,1,0"): "attention D25 E1, float32 "
                                             "(3xTF32, one chunk)",
    ("large_d_wide_tf32", "1,0,16"): "D256 E16, float32 (3xTF32)",
    ("large_d_wide_bf16", "1,0,16"): "D256 E16, bfloat16",
    ("large_d_wide_tf32", "1,0,32"): "D256 E64, float32 (two E blocks)",
    ("large_d_wide_bf16", "1,0,64"): "D256 E64, bfloat16 (one E block)",
    ("large_d_wide_tf32", "3,1,32"): "attention D64 E64, float32",
    ("large_d_wide_bf16", "3,1,64"): "attention D64 E64, bfloat16",
    ("small_d_wide_3_tf32", "0,256,0"): "Nystrom sketch E=256, float32",
    ("small_d_wide_3_bf16", "0,256,0"): "Nystrom sketch E=256, bfloat16",
}
# Kernel families of phase 1's report (a wide family: one source each).
KERNEL_FAMILY = re.compile(
    r"(small_d_wide_[38]_(?:tf32|bf16)|large_d_wide_(?:tf32|bf16)"
    r"|one_chunk_large_d_kernel|small_d_kernel|large_d_kernel)")


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


def kernel_name(line):
    """(template, arguments) of the kernel a ptxas line names, as
    ptxas_kernels gives them, or None."""
    name = re.search(r"'(_Z[^']*)'", line)
    kind = name and KERNEL_FAMILY.search(name.group(1))
    if not kind:
        return None
    return kind.group(1), ",".join(re.findall(r"L[ib](\d+)E", name.group(1)))


def ptxas_kernels(report):
    """(template, arguments, registers, spill bytes) of each kernel in a
    ptxas -v report."""
    out = []
    for entry in re.split(r"Compiling entry function '", report)[1:]:
        name = entry.split("'")[0]
        kind = KERNEL_FAMILY.search(name)
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

    The larger of each unit's share: the form (2 D flops per pair) on the
    f32 units at D <= 8, on the tensor cores at D > 8 (3 passes of TF32 in
    the f32 tiers, one of bf16); one transcendental per pair on the
    special-function units; each input read once and each output written
    once from device memory; and the signal columns (2 flops per pair and
    column) on whichever unit gives the least such time, whatever unit the
    kernel uses: in the f32 tiers the f32 units or 3 TF32 passes on the
    tensor cores (f32-accurate), in bfloat16 one bf16 pass.
    """
    cols = e + (1 if normalize and which == "direct" else 0)
    pairs = float(n) * m
    passes, peak = TENSOR_CORE_FORM[tier]
    shares = {"f32 FMA": 0.0, "tensor cores": 0.0,
              "special-function units": pairs / sfu_rate,
              "memory": ((n + m) * d + m * e + n * e) * 4 / PEAK_BYTES}
    if d <= 8:
        shares["f32 FMA"] += 2.0 * pairs * d / PEAK_F32_FLOPS
    else:
        shares["tensor cores"] += 2.0 * pairs * d * passes / peak
    signal = {"tensor cores": 2.0 * pairs * cols * passes / peak}
    if tier != "bfloat16":
        signal["f32 FMA"] = 2.0 * pairs * cols / PEAK_F32_FLOPS
    options = []
    for unit, seconds in signal.items():
        terms = dict(shares)
        terms[unit] += seconds
        engine = max(terms, key=terms.get)
        options.append((terms[engine], engine))
    least, engine = min(options)
    return (least * 1e3, "bytes" if engine == "memory" else "operations",
            engine)


def special_function_rate(props, max_clock_mhz):
    """Special-function ops per second of the card at its maximum clock."""
    return (SFU_PER_CLOCK_PER_SM * props.multi_processor_count
            * max_clock_mhz * 1e6)


def cuda(a):
    """A float32 copy of `a` on the card."""
    return torch.tensor(np.asarray(a, np.float32), device="cuda")


def time_ms(fn, reps):
    """Milliseconds per call of `fn`, CUDA events around `reps` calls after
    one warm-up call."""
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


def kernel_device_ms(fn, reps=3, call_ms=None):
    """Device time of one launch of the hand-written kernel, so `ms`
    splits into kernel and wrapper (the kernels take one launch per call):
    CUDA events that the kernel library records just before and just
    after each launch on its stream (`_build.launch_timer`), averaged over
    `reps` calls after one warm-up call.  torch.profiler served before,
    and in long processes lost its kernel records or read more than the
    call took (ROADMAP Queue 3).  None if no launch was timed, or if the
    reading exceeds `call_ms`, the call's own time: a kernel alone cannot
    take longer than the call."""
    from kmb_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    with _build.launch_timer() as times:
        for _ in range(reps):
            fn()
    if not times:
        return None
    ms = sum(times) / len(times)
    return None if call_ms is not None and ms > call_ms else ms


def load_datasets(names, datasets, card):
    """Add each registry dataset of `names` missing from `datasets`, with
    its float64 truth computed on the card; returns `datasets`."""
    from kmb_tpu_torch.datasets import ground_truth, make_arrays

    for name in names:
        if name in datasets:
            continue
        arrays = make_arrays(name)
        t0 = time.perf_counter()
        arrays["target_signal"] = ground_truth(arrays, device="cuda")
        torch.cuda.synchronize()
        print(f"{name}: float64 truth on the card in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
        datasets[name] = arrays
    return datasets


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="On-card smoke run of kmb_tpu_torch (see the module "
                    "docstring).")
    parser.add_argument(
        "--phases", default="all",
        help="comma-separated phases to run, e.g. 7,8 (default: all)")
    # Phase 8 starts this script once per card with these (and --sweep
    # for phase 10).
    parser.add_argument("--phase8-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--sweep", action="store_true",
                        help=argparse.SUPPRESS)
    # Phase 9 runs in a process of its own, started with this.
    parser.add_argument("--phase9-report", help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--report", help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def selected_phases(spec):
    """The phases to run: phase 1 always; 4 brings 3 (its launch counts),
    10 brings 8 (its processes), 8 brings 7 (its single-card baselines)."""
    if spec == "all":
        return set(range(1, 12))
    phases = {int(p) for p in spec.split(",")} | {1}
    check(phases <= set(range(1, 12)), f"no such phase in {spec!r}")
    if 4 in phases:
        phases.add(3)
    if 10 in phases:
        phases.add(8)
    if 8 in phases:
        phases.add(7)
    return phases


def main(argv=None):
    options = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if options.phase8_rank is not None:
        return four_card_rank(options)
    if options.phase9_report is not None:
        return harness_process(options.phase9_report)
    phases = selected_phases(options.phases)
    from kmb_tpu_torch.ops import _build

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
    for kind in ("small_d_kernel", "large_d_kernel",
                 "one_chunk_large_d_kernel", "small_d_wide_3_tf32",
                 "small_d_wide_3_bf16", "small_d_wide_8_tf32",
                 "small_d_wide_8_bf16", "large_d_wide_tf32",
                 "large_d_wide_bf16"):
        regs = [r for k, _, r, _ in kernels if k == kind]
        check(regs, f"no {kind} in the build")
        print(f"phase 1: {len(regs)} {kind} instantiations, {min(regs)}-"
              f"{max(regs)} registers")
    spilled = [(k, a, s) for k, a, _, s in kernels if s > 0]
    print(f"phase 1: {len(spilled)} kernels spill: {spilled}")
    # ptxas serialises a wgmma pipeline it cannot prove safe, and says so.
    serialized = [line for line in report.splitlines()
                  if "wgmma" in line and "erializ" in line]
    print(f"phase 1: {len(serialized)} wgmma serialisation warnings"
          + "".join(f"\n  {line}" for line in serialized[:4]))
    serialized_kernels = {kernel_name(line) for line in serialized}
    for (kind, args), what in MAIN_PATH_KERNELS.items():
        found = [(r, s) for k, a, r, s in kernels if (k, a) == (kind, args)]
        check(len(found) == 1, f"{kind}<{args}> not in the build")
        print(f"phase 1: {kind}<{args}> ({what}): {found[0][0]} registers, "
              f"{found[0][1]} bytes spilled, wgmma serialised: "
              f"{(kind, args) in serialized_kernels}")
        if kind.startswith(("large_d_wide", "one_chunk")):   # for this card
            check(found[0][1] == 0, f"{kind}<{args}> spills")
    # The one-chunk kernel's overlap needs its wgmma groups unserialised.
    one_chunk = {(k, a) for k, a, _, _ in kernels
                 if k == "one_chunk_large_d_kernel"}
    print(f"phase 1: {len(serialized_kernels & one_chunk)} of "
          f"{len(one_chunk)} one_chunk_large_d_kernel instantiations have "
          "their wgmma groups serialised by ptxas")
    check(not serialized_kernels & one_chunk,
          "ptxas serialises the one-chunk kernel's wgmma groups")
    wide_main = [key for key in MAIN_PATH_KERNELS
                 if key[0].startswith("large_d_wide")]
    print(f"phase 1: {len(serialized_kernels & set(wide_main))} of "
          f"{len(wide_main)} main-path large_d_wide instantiations have "
          "their wgmma groups serialised by ptxas (an open fault: ROADMAP "
          "Queue 2, item 2b)")
    sfu_rate = special_function_rate(props, max_clock_mhz)
    print(f"phases {sorted(phases)} [{card}]")

    entries, datasets, per_run = [], {}, {}
    solvers = approx = sharded = four = harness = wide_shapes = cli = None
    if 2 in phases:
        wide_shapes = kernels_vs_plain(dev, card, sfu_rate)
    if 3 in phases:
        per_run = main_path(card, datasets)
    if 4 in phases:
        main_path_kernels(card, sfu_rate, entries, datasets, per_run)
    if 5 in phases:
        solvers, solver_datasets = solver_path(dev, card, sfu_rate, entries,
                                               time_ms)
        datasets.update(solver_datasets)
    if 6 in phases:
        approx = approx_path(dev, card, sfu_rate, entries, time_ms,
                             load_datasets(APPROX_DATASETS, datasets, card))
    if 7 in phases:
        sharded, single_card = sharded_path(
            dev, card, sfu_rate, entries,
            load_datasets(SHARDED_DATASETS, datasets, card), solvers)
    if 8 in phases:
        four = four_cards(card, single_card, sweep=10 in phases)
    if 9 in phases:
        harness = harness_phase(card)
    if 11 in phases:
        torch.cuda.empty_cache()   # the card's memory, for the CLI's
        cli = cli_path(card, sfu_rate, entries)

    if phases & {4, 7, 11}:
        check({entry["name"] for entry in entries} == {"direct", "flash"},
              "a kernel was not timed")
    for key, records in (("wide_e512", wide_shapes), ("approx", approx),
                         ("solvers", solvers),
                         ("sharded", sharded), ("four_cards", four),
                         ("harness", harness), ("cli", cli)):
        if records is not None:
            print(json.dumps({key: records}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_vs_plain(dev, card, sfu_rate):
    """Phase 2: both kernels against the plain version on the card (see
    the module docstring).  Returns the timed E = 512 shape's records."""
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch

    rng = np.random.default_rng(0)
    worst = {}   # kernel and mode -> (relative error, case)
    n_cases = 0

    def hold(label, which, tol, x, y, b, **kw):
        nonlocal n_cases
        got = as_tuple(kernel_matvec(x, y, b, **kw))
        ref = as_tuple(kernel_matvec_torch(x, y, b, **kw))
        torch.cuda.synchronize()
        check(len(got) == len(ref), f"{label}: state arity differs")
        key = which + (" (wide)" if b is not None and b.shape[1] > 8 else "")
        for g, r in zip(got, ref):
            _, rel = compare(g, r)
            check(rel <= tol, f"{label}: relative error {rel:.3e} > {tol}")
            worst[key] = max(worst.get(key, (0.0, "")), (rel, label))
        n_cases += 1

    # N and M not multiples of 16, 64 or 128; D not multiples of 8 or 32.
    shapes = ((1037, 1511, 3, 1), (517, 1203, 64, 8), (300, 411, 784, 1),
              (301, 1203, 9, 13), (211, 999, 37, 2), (257, 1031, 130, 4))
    # E above 8, the wide mode, both forms (E blocks of 16 at D > 8), drawn
    # from a generator of their own: the shapes above keep their draws.
    wide_rng = np.random.default_rng(1)
    wide_shapes = ((1037, 1511, 3, 9), (517, 1203, 64, 16), (301, 1203, 5, 64),
                   (211, 999, 130, 100), (257, 1031, 3, 256),
                   (300, 411, 37, 512), (257, 1031, 256, 64),
                   (301, 411, 784, 17), (211, 999, 9, 32))
    for tier in TIERS:
        tol = KERNEL_TOL[tier]
        for (n, m, d, e), draw in ([(sh, rng) for sh in shapes]
                                   + [(sh, wide_rng) for sh in wide_shapes]):
            x = cuda(draw.standard_normal((n, d)) / np.sqrt(d))
            y = cuda(draw.standard_normal((m, d)) / np.sqrt(d))
            b = cuda(draw.standard_normal((m, e)))
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
    for which, (rel, label) in sorted(worst.items()):
        print(f"phase 2: worst {which} kernel relative error {rel:.3e} "
              f"({label})")

    # One long case: the wide mode's sums over 131072 source columns at
    # E = 256 (the Nystrom sketch's shape) against float64 on 2048 rows,
    # no less accurate than the same signal through the narrow mode (32
    # launches of 8 columns, FP32 products, a fresh partial per tile).
    y = cuda(make_arrays(CUBE_131072)["source_points"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b = torch.randn((len(y), 256), generator=gen, device=dev)
    rows = slice(0, 2048)
    exact = kernel_matvec_torch(y[rows].double(), y.double(), b.double(),
                                kernel_name="gaussian")
    wide = kernel_matvec(y, y, b, kernel_name="gaussian")[rows]
    narrow = torch.cat([kernel_matvec(y, y, b[:, c:c + 8].contiguous(),
                                      kernel_name="gaussian")[rows]
                        for c in range(0, 256, 8)], dim=1)
    plain = kernel_matvec_torch(y[rows], y, b, kernel_name="gaussian")

    def rel64(v):
        return float(torch.linalg.norm(v.double() - exact)
                     / torch.linalg.norm(exact))

    errors = {k: rel64(v) for k, v in (("wide", wide), ("narrow", narrow),
                                       ("plain", plain))}
    print(f"phase 2: M = 131072, E = 256 against float64 (2048 rows): wide "
          f"mode {errors['wide']:.3e}, narrow mode {errors['narrow']:.3e}, "
          f"plain float32 {errors['plain']:.3e} [{card}]")
    check(errors["wide"] <= errors["narrow"],
          f"the wide mode at M = 131072 is less accurate than the narrow "
          f"mode: {errors}")
    del y, b, exact, wide, narrow, plain

    # The large-D form at the diagonal of equal points (abs-exp, D = 256):
    # the kernel within 1e-4 of the plain version in both modes.
    arrays = make_arrays(WIDE_MAIN_PATH[0])
    y = cuda(arrays["source_points"])
    b = cuda(arrays["source_signal"])
    kw = dict(kernel_name=arrays["kernel"])
    plain = kernel_matvec_torch(y, y, b, **kw)
    for mode, got in (
            ("wide", kernel_matvec(y, y, b, **kw)),
            ("narrow", torch.cat([kernel_matvec(y, y, b[:, c:c + 8]
                                                .contiguous(), **kw)
                                  for c in range(0, b.shape[1], 8)], 1))):
        _, rel = compare(got, plain)
        print(f"phase 2: D = 256 equal points, {mode} mode vs plain "
              f"{rel:.3e} [{card}]")
        check(rel <= KERNEL_TOL["float32"],
              f"D = 256 equal points, {mode} mode: {rel:.3e}")
    del y, b, plain, got

    # Every bf16 flash kernel over eight draws (N = 300, M = 411; at
    # D = 784 the outputs cancel): the narrow and wide large-D kernels, the
    # small-D kernels narrow and wide; held to the plain version at the
    # bf16 limit, each draw's distance to float64 printed.
    for (d, e), name in ((de, k) for de in FLASH_DRAWS for k in LOG_KERNELS):
        dists = []
        for seed in range(8):
            draw = np.random.default_rng(100 + seed)
            x = cuda(draw.standard_normal((300, d)) / np.sqrt(d))
            y = cuda(draw.standard_normal((411, d)) / np.sqrt(d))
            b = cuda(draw.standard_normal((411, e)))
            kw = dict(kernel_name=name, normalize_rows=True)
            got = kernel_matvec(x, y, b, precision="bfloat16", **kw)
            want = kernel_matvec_torch(x, y, b, precision="bfloat16", **kw)
            exact = kernel_matvec_torch(x.double(), y.double(), b.double(),
                                        **kw)
            _, rel = compare(got, want)
            check(rel <= KERNEL_TOL["bfloat16"],
                  f"bf16 D = {d} E = {e} flash {name} draw {seed}: "
                  f"{rel:.3e}")
            dists.append((rel, compare(got, exact)[1],
                          compare(want, exact)[1]))
        print(f"phase 2: bf16 D = {d} E = {e} flash {name}, 8 draws "
              f"(kernel vs "
              f"plain, kernel vs float64, plain vs float64): "
              + ", ".join(f"({a:.2e}, {k:.2e}, {p:.2e})"
                          for a, k, p in dists) + f" [{card}]")

    # The E = 512 shape, timed: the most E blocks of a launch.
    records = []
    n, m, d, e = 300, 411, 37, 512
    x = cuda(wide_rng.standard_normal((n, d)) / np.sqrt(d))
    y = cuda(wide_rng.standard_normal((m, d)) / np.sqrt(d))
    b = cuda(wide_rng.standard_normal((m, e)))
    for which, normalize in (("direct", False), ("flash", True)):
        kernel = getattr(_build, which.upper())
        library_ms = None
        if normalize:
            library = library_attention(x, y, b, "gaussian")
            _, lib_rel = compare(library(), kernel_matvec_torch(
                x, y, b, kernel_name="gaussian", normalize_rows=True))
            check(lib_rel <= LIBRARY_TOL,
                  f"library attention disagrees at E = 512 ({lib_rel:.3e})")
            library_ms = time_ms(library, 20)
        for tier in TIERS:
            kw = dict(kernel_name="gaussian", normalize_rows=normalize,
                      precision=tier)
            before = (kernel.launches, kernel.wide_launches)
            got = kernel_matvec(x, y, b, **kw)
            per_call = (kernel.launches - before[0],
                        kernel.wide_launches - before[1])
            check(per_call == (1, 1), f"E = 512 {which} {tier}: launches "
                  f"(all, wide) {per_call}, not one wide launch")
            err, rel = compare(got, kernel_matvec_torch(x, y, b, **kw))
            check(rel <= KERNEL_TOL[tier], f"E = 512 {which} {tier}: {rel}")
            ms = time_ms(lambda: kernel_matvec(x, y, b, **kw), 20)
            plain_ms = time_ms(lambda: kernel_matvec_torch(x, y, b, **kw), 5)
            bound, bound_by, engine = bound_ms(n, m, d, e, which, normalize,
                                               tier, sfu_rate)
            print(f"phase 2: {which} kernel, N={n} M={m} D={d} E={e} "
                  f"[{tier}]: {ms:.4f} ms in 1 launch, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({engine}), "
                  f"library {library_ms} ms, max_abs_err vs plain "
                  f"{err:.3e} [{card}]")
            records.append(dict(name=which, shape=[n, m, d, e],
                                precision=tier, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=bound_by,
                                bound_engine=engine, max_abs_err=err,
                                library_ms=library_ms))
    return records


def main_path(card, datasets):
    """Phase 3: the main path through the port's runner.  Adds its
    datasets to `datasets`; returns the launches of each (dataset, tier)."""
    from kmb_tpu_torch.definitions import Definition
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.runner import run_on_arrays

    load_datasets([name for name, _, _ in MAIN_PATH], datasets, card)
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
            kernel = getattr(_build, which.upper())
            before = {k.symbol: k.launches for k in _build.KERNELS}
            wide_before = kernel.wide_launches
            (row,) = run_on_arrays(definition, arrays, runs=2)
            launched = {k.symbol: k.launches - before[k.symbol]
                        for k in _build.KERNELS}
            symbol = kernel.symbol
            check(launched[symbol] >= 2,
                  f"{name} {tier}: {symbol} launched {launched[symbol]} "
                  "times in 2 queries")
            if name in WIDE_MAIN_PATH:   # one wide launch per query
                wide = kernel.wide_launches - wide_before
                check(launched[symbol] == wide == 2,
                      f"{name} {tier}: {launched[symbol]} launches, {wide} "
                      "of the wide mode, in 2 queries")
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
    check(_build.DIRECT.wide_launches > 0,
          "the wide mode never launched on the main path")
    print(f"phase 3: main path launches {launches}, of them wide "
          f"{ {k.symbol: k.wide_launches for k in _build.KERNELS} }")
    return per_run


def main_path_kernels(card, sfu_rate, entries, datasets, per_run):
    """Phase 4: each kernel at the main path's shapes, and the large-D
    wide kernel at WIDE_TIMING's, timed beside its plain version, its
    bound and the library; appends to `entries`."""
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.ops.product import (
        kernel_matvec, kernel_matvec_torch, signal_plan)

    shapes = [(name, name, which, None) for name, which, _ in MAIN_PATH]
    shapes += [(label, name, "flash" if datasets[name]["normalize_rows"]
                else "direct", e) for label, name, e in WIDE_TIMING]
    for label, name, which, e in shapes:
        on_main_path = e is None
        arrays = datasets[name]
        y = cuda(arrays["source_points"])
        x = y if arrays["same_points"] else cuda(arrays["target_points"])
        if on_main_path:
            b = cuda(arrays["source_signal"])
        else:   # a signal of e columns from a seed
            gen = torch.Generator(device="cuda")
            gen.manual_seed(e)
            b = torch.randn((len(y), e), generator=gen, device="cuda")
        n, d = x.shape
        m, e = b.shape
        normalize = bool(arrays["normalize_rows"])
        kw = dict(kernel_name=arrays["kernel"], normalize_rows=normalize)
        library_ms = None
        library = library_attention(x, y, b, arrays["kernel"]) if (
            which == "flash") else None
        if library is not None:
            _, lib_rel = compare(library(), kernel_matvec_torch(x, y, b, **kw))
            # A yardstick only: it must compute the same function, at
            # whatever precision the library picks.
            check(lib_rel <= LIBRARY_TOL,
                  f"library attention disagrees ({lib_rel:.3e})")
            print(f"library attention vs plain: relative {lib_rel:.3e}")
            library_ms = time_ms(library, 20)
        kernel = getattr(_build, which.upper())
        for tier in TIERS:
            kwt = dict(kw, precision=tier)
            # As the main path's engine calls it: y fixed, staged once.
            kwk = dict(kwt, fixed_source=True)
            if on_main_path:   # its launches are phase 3's
                launches = per_run[name, tier]
                staged_before = kernel.staged_bytes
                got = kernel_matvec(x, y, b, **kwk)
                staged = kernel.staged_bytes - staged_before
            else:   # off the main path: the launches of its checked call
                _build.reset_launch_counts()
                got = kernel_matvec(x, y, b, **kwk)
                launches, staged = kernel.launches, kernel.staged_bytes
                eblocks = signal_plan(e, d > 8, tier == "bfloat16")[1]
                check((launches, kernel.wide_launches, kernel.wide_eblocks)
                      == (1, 1, eblocks),
                      f"{label} {tier}: launches (all, wide, E blocks) "
                      f"{(launches, kernel.wide_launches, kernel.wide_eblocks)}"
                      f", not one wide launch of {eblocks} E blocks")
            stages, resident, _ = kernel.last_staging
            ref = kernel_matvec_torch(x, y, b, **kwt)
            err, rel = compare(got, ref)
            check(rel <= KERNEL_TOL[tier],
                  f"{label} {tier}: kernel vs plain {rel:.3e}")
            del got, ref
            reps = 3 if n * m > 10**9 else 10
            ms = time_ms(lambda: kernel_matvec(x, y, b, **kwk), reps)
            plain_ms = time_ms(lambda: kernel_matvec_torch(x, y, b, **kwt),
                               2)
            device_ms = kernel_device_ms(
                lambda: kernel_matvec(x, y, b, **kwk), call_ms=ms)
            kernel_alone = (None if device_ms is None
                            else round(device_ms, 4))
            bound, bound_by, engine = bound_ms(n, m, d, e, which, normalize,
                                               tier, sfu_rate)
            lib = None if library_ms is None else round(library_ms, 4)
            staged_rate = None
            if staged:   # the large-D wide kernel's L2 stream
                staged_rate = staged / ((device_ms or ms) * 1e-3)
            else:
                staged = None
            print(f"{which} kernel, {label} [{tier}]: {ms:.4f} ms (kernel "
                  f"alone {kernel_alone} ms), plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({engine}), "
                  f"library {lib} ms, {n * m / (ms * 1e-3):.4e} pairs/s, "
                  + ("" if staged is None else
                     f"staged {staged / 1e9:.3f} GB at "
                     f"{staged_rate / 1e12:.3f} TB/s ({stages} stages, x "
                     f"{'resident' if resident else 'streamed'}), ")
                  + f"max_abs_err vs plain {err:.3e} [{card}]")
            entries.append(dict(
                name=which, route="cuda",
                source=kernel_source(d, e),
                replaces=REPLACES[which], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms, at=label,
                precision=tier, bound_engine=engine,
                kernel_device_ms=device_ms, wide_mode=e > 8,
                main_path=on_main_path, staged_bytes=staged,
                staged_bytes_per_s=staged_rate))
        del x, y, b
        torch.cuda.empty_cache()


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

    # Launches of the direct kernel inside each fit and query (and the E
    # blocks of its wide launches in each fit), and every call of the plain
    # version during the solves with its dtype.
    phase_launches = {"fit": 0, "query": 0, "fit E blocks": 0}
    plain_dtypes = []
    real_plain = kernel_matvec_torch

    def spy_plain(x, *args, **kwargs):
        plain_dtypes.append(x.dtype)
        return real_plain(x, *args, **kwargs)

    def counted(method, key):
        def wrapper(self, *args, **kwargs):
            before = _build.DIRECT.launches, _build.DIRECT.wide_eblocks
            try:
                return method(self, *args, **kwargs)
            finally:
                phase_launches[key] += _build.DIRECT.launches - before[0]
                if key == "fit":
                    phase_launches["fit E blocks"] += (
                        _build.DIRECT.wide_eblocks - before[1])
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
        phase_launches.update({"fit": 0, "query": 0, "fit E blocks": 0})
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
        res = float64_residual(arrays, row.result)
        attrs = row.attrs
        iterations = attrs.get("cg_iterations")
        fit_per_run = phase_launches["fit"] // 2
        query_per_run = phase_launches["query"] // 2
        if iterations is not None:
            check(query_per_run >= iterations,
                  f"{label}: {query_per_run} direct-kernel launches for "
                  f"{iterations} iterations in one query")
        if args.get("precond_rank"):   # the sketch: one wide launch
            eblocks = phase_launches["fit E blocks"] // 2
            check((fit_per_run, eblocks) == (1, 1), f"{label}: "
                  f"{fit_per_run} direct-kernel launches of {eblocks} E "
                  "blocks per fit, not one of one (the Nystrom sketch)")
        if label == "Nystrom PCG" and name == CUBE_131072:
            most = NYSTROM_PCG_ITERATIONS + max(3, 0.1 * NYSTROM_PCG_ITERATIONS)
            check(iterations <= most, f"{label}: {iterations} iterations, "
                  f"more than {most} (before: {NYSTROM_PCG_ITERATIONS})")
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
    # the Nystrom sketch (E = 256, one launch of the wide mode with one E
    # block, in each tier; and the narrower blocks' widths E = 16 and 64 at
    # the same size) and the E = 1 matvec of each dataset.
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, e, tier in ((CUBE_131072, 256, "float32"),
                          (CUBE_131072, 256, "float32x3"),
                          (CUBE_131072, 256, "bfloat16"),
                          (CUBE_131072, 64, "float32"),
                          (CUBE_131072, 64, "bfloat16"),
                          (CUBE_131072, 16, "float32"),
                          (CUBE_131072, 16, "bfloat16"),
                          (CUBE_131072, 1, "float32"),
                          (SPHERE_131072, 1, "float32"),
                          (CUBE_10000, 1, "float32")):
        arrays = datasets[name]
        y = cuda(arrays["source_points"])
        gen.manual_seed(e)
        b = torch.randn((len(y), e), generator=gen, device=dev)
        kw = dict(kernel_name=arrays["kernel"], precision=tier)
        before = _build.DIRECT.launches, _build.DIRECT.wide_eblocks
        got = kernel_matvec(y, y, b, **kw)
        per_call = _build.DIRECT.launches - before[0]
        eblocks = _build.DIRECT.wide_eblocks - before[1]
        check((per_call, eblocks) == (1, int(e > 8)),
              f"solver path {name} E={e} {tier}: {per_call} launches of "
              f"{eblocks} E blocks, not one of {int(e > 8)}")
        ref = kernel_matvec_torch(y, y, b, **kw)
        err, rel = compare(got, ref)
        check(rel <= KERNEL_TOL[tier],
              f"solver path {name} E={e} {tier}: kernel vs plain {rel:.3e}")
        del got, ref
        ms = time_ms(lambda: kernel_matvec(y, y, b, **kw), 3)
        device_ms = kernel_device_ms(lambda: kernel_matvec(y, y, b, **kw), 2,
                                     call_ms=ms)
        plain_ms = time_ms(lambda: kernel_matvec_torch(y, y, b, **kw), 1)
        n, d = y.shape
        bound, bound_by, engine = bound_ms(n, n, d, e, "direct", False,
                                           tier, sfu_rate)
        what = ("Nystrom sketch" if e == 256 else "wide signal" if e > 8
                else "Krylov matvec")
        print(f"phase 5: direct kernel, {what} on {name} E={e} [{tier}]: "
              f"{ms:.4f} ms (kernel alone {device_ms} ms) in {per_call} "
              f"launches of {eblocks} E blocks, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({engine}), max_abs_err vs plain "
              f"{err:.3e} [{card}]")
        entries.append(dict(
            name="direct", route="cuda",
            source=kernel_source(d, e),
            replaces=REPLACES["direct"], launches=launches[
                _build.DIRECT.symbol],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=None,
            at=f"{name}, solver path, E={e}", precision=tier,
            bound_engine=engine, kernel_device_ms=device_ms,
            launches_per_call=per_call, e_blocks_per_call=eblocks,
            wide_mode=e > 8))
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
        for members in shared_builds(APPROX_PATH):
            _, name, constructor, args = members[0][:4]
            arrays = datasets[name]
            definition = Definition(
                algorithm=f"torch-{constructor}",
                module="kmb_tpu_torch.algorithms.torch_approx",
                constructor=constructor,
                arguments={"kernel": arrays["kernel"],
                           "dimension": arrays["source_points"].shape[1],
                           "normalize_rows": bool(arrays["normalize_rows"]),
                           **args},
                query_argument_groups=[member[4] for member in members])
            built.clear()
            query_launches.clear()
            rows = run_on_arrays(definition, arrays, runs=2)
            check(not query_launches
                  or len(query_launches) == 2 * len(members),
                  f"{members[0][0]}: {len(query_launches)} queries counted "
                  f"for {len(members)} query groups of two runs")
            for pos, (member, row) in enumerate(zip(members, rows)):
                (label, name, constructor, args, query, held, limit,
                 record) = member
                # This query group's two repetitions (groups run in turn).
                launched = query_launches[2 * pos:2 * pos + 2]
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
                if len(members) > 1:
                    # One build served these query groups: build_s is its.
                    entry["build_shared_with"] = [
                        other[0] for other in members if other is not member]
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
                    entry["true_residual"] = float64_residual(arrays, row.result)
                else:
                    measured = float64_residual(arrays, row.result)
                    check(len(launched) == 2 and min(launched) >= 1,
                          f"{label}: direct-kernel launches per query "
                          f"{launched}")
                    entry["direct_launches_per_query"] = launched
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


def shared_builds(entries):
    """APPROX_PATH's entries in runs of consecutive ones on the same
    dataset, constructor and arguments: one definition (one build per
    repetition) with their queries as its query groups."""
    runs = []
    for entry in entries:
        if runs and runs[-1][0][1:4] == entry[1:4]:
            runs[-1].append(entry)
        else:
            runs.append([entry])
    return runs


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


def free_port():
    """A free TCP port on this machine, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def definition(module, constructor, arrays, args, query=None):
    from kmb_tpu_torch.definitions import Definition

    return Definition(
        algorithm=f"torch-{constructor}",
        module=f"kmb_tpu_torch.algorithms.{module}",
        constructor=constructor,
        arguments={"kernel": arrays["kernel"],
                   "dimension": arrays["source_points"].shape[1],
                   "normalize_rows": bool(arrays["normalize_rows"]),
                   **args},
        query_argument_groups=[query or {}])


def float64_residual(arrays, b):
    """||K b - a|| / ||a|| in float64 on the card from the float64 points:
    independent of the solver's own report."""
    from kmb_tpu_torch.ops.product import kernel_matvec_torch

    y64 = torch.tensor(arrays["source_points"], device="cuda")
    a64 = torch.tensor(arrays["target_signal"], device="cuda")
    kb = kernel_matvec_torch(y64, y64, torch.tensor(b, device="cuda"),
                             kernel_name=arrays["kernel"])
    return float(torch.linalg.norm(kb - a64) / torch.linalg.norm(a64))


def recording(matvec, seen):
    """`matvec`, appending each call's (input, output) to `seen`."""
    def call(v):
        out = matvec(v)
        seen.append((v, out))
        return out
    return call


def column_errors(sketch, exact):
    """Each column's ||sketch - exact|| / ||exact||: (max, median, min)."""
    col = (torch.linalg.vector_norm(sketch.double() - exact, dim=0)
           / torch.linalg.vector_norm(exact, dim=0))
    return [float(col.max()), float(col.median()), float(col.min())]


def factor_distance(factors, reference, top=64):
    """How far Nystrom factors (U, lam) lie from `reference`'s: the
    largest relative difference of the `top` largest eigenvalues (each
    relative to the reference's, floored at float32's epsilon times the
    largest), and the largest principal angle (radians) between the spans
    of their columns of U."""
    (u, lam), (u0, lam0) = factors, reference
    lam, lam0 = lam[:top].double(), lam0[:top].double()
    floor = torch.finfo(torch.float32).eps * lam0[0]
    cosines = torch.linalg.svdvals(u0[:, :top].double().T
                                   @ u[:, :top].double())
    return {"lam_rel": float(((lam - lam0).abs()
                              / lam0.clamp_min(floor)).max()),
            "max_angle": float(torch.arccos(cosines.min().clamp(max=1.0)))}


def sketch_routes(dev, card, arrays, precond_rank, query):
    """Phase 7's Nystrom PCG over PCG_ORDERINGS orderings of the points
    (the test matrix's rows permuted with them), its "gram" factors built
    from two sketches K @ Q of the same Q (one launch; the p = 4 virtual
    ring's 16 chunk launches, as four cards compute it), each solved by
    the single-card PCG.  On ordering 0, each sketch's per-column error
    against the float64 sketch on the card and each route's factors
    against the one launch's.  Returns the iterations by route (a list
    over the orderings) and the record printed."""
    import functools

    from kmb_tpu_torch.ops import solve
    from kmb_tpu_torch.ops.product import kernel_matvec_torch
    from kmb_tpu_torch.parallel import sharded

    kernel = arrays["kernel"]
    sketches = {
        "one launch": lambda y: functools.partial(
            solve.kernel_matvec, y, y, kernel_name=kernel),
        "virtual ring": lambda y: functools.partial(
            sharded.virtual_ring_product, y, y, p=FOUR_CARDS,
            kernel_name=kernel),
    }
    y0 = cuda(arrays["source_points"])
    rhs0 = cuda(arrays["target_signal"])
    omega0 = sharded.draw_test_matrix(len(y0), precond_rank, dev)
    orders = np.random.default_rng(0)
    counts = {route: [] for route in sketches}
    residuals = {route: [] for route in sketches}
    seen, factors = {}, {}
    for ordering in range(PCG_ORDERINGS):
        perm = torch.as_tensor(
            np.arange(len(y0)) if ordering == 0
            else orders.permutation(len(y0)), device=dev)
        y, rhs = y0[perm], rhs0[perm]
        solve_kw = dict(kernel_name=kernel, tol=query["tol"],
                        max_iters=query["max_iters"])
        for route, make in sketches.items():
            calls = []
            u, lam = solve.nystrom_factors(recording(make(y), calls),
                                           omega0[perm], method="gram")
            _, iterations, residual = solve.cg_solve(
                y, rhs, precond=functools.partial(
                    solve.apply_nystrom_precond, u, lam), **solve_kw)
            counts[route].append(iterations)
            residuals[route].append(residual)
            if ordering == 0:
                (seen[route],) = calls
                factors[route] = (u, lam)
    q = seen["one launch"][0]
    check(all(torch.equal(v, q) for v, _ in seen.values()),
          "the sketch routes sketched different test matrices")
    y64 = y0.double()
    exact = kernel_matvec_torch(y64, y64, q.double(), kernel_name=kernel)
    record = {"iterations": counts, "best_residuals": residuals,
              "column_errors": {route: column_errors(s, exact)
                                for route, (_, s) in seen.items()},
              "vs_one_launch": {route: factor_distance(
                  factors[route], factors["one launch"])
                  for route in sketches if route != "one launch"}}
    del y0, rhs0, omega0, y, rhs, y64, exact, seen, factors
    torch.cuda.empty_cache()
    print(f"phase 7: Nystrom PCG iterations over {PCG_ORDERINGS} orderings "
          f"by the sketch of its 'gram' factors: {counts['one launch']} one "
          f"launch, {counts['virtual ring']} the p = {FOUR_CARDS} virtual "
          f"ring ({FOUR_CARDS ** 2} chunk launches on the packed (y | b) "
          f"signal, folded); best relative residuals (tol {query['tol']}) "
          + "; ".join(f"{route} " + ", ".join(f"{r:.3e}" for r in values)
                      for route, values in residuals.items())
          + f" [{card}]")
    for route, errors in record["column_errors"].items():
        print(f"phase 7: sketch K @ Q ({route}) against the float64 sketch "
              f"on the card, per-column relative error max / median / min "
              + " / ".join(f"{e:.3e}" for e in errors)
              + (f"; its factors against the one launch's: top-64 "
                 f"eigenvalues {record['vs_one_launch'][route]['lam_rel']:.3e}"
                 f" apart, largest principal angle of the top-64 columns of "
                 f"U {record['vs_one_launch'][route]['max_angle']:.3e} rad"
                 if route in record["vs_one_launch"] else "")
              + f" [{card}]")
    return counts, record


def sharded_path(dev, card, sfu_rate, entries, datasets, solver_records):
    """Phase 7: the sharded path on one card (see the module docstring).

    Appends the ring chunk's kernel shapes at p = 4 to `entries`; returns
    one record per sharded run and the single-card baselines phase 8
    compares with."""
    import torch.distributed as dist

    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.ops.product import kernel_matvec_torch
    from kmb_tpu_torch.parallel import multihost, sharded
    from kmb_tpu_torch.runner import run_on_arrays

    started = time.perf_counter()
    # Single-card baselines, not counted as the sharded path's launches:
    # TorchProduct in float32; phase 5's Nystrom PCG (run here when phase 5
    # was not), whose factors take the "svd" route; and the same PCG on
    # the sharded build's route ("gram", the same test matrix).
    single = {}
    for name in SHARDED_PRODUCTS:
        arrays = datasets[name]
        (row,) = run_on_arrays(definition("torch_engine", "TorchProduct",
                                          arrays, {"precision": "float32"}),
                               arrays, runs=2)
        single[name] = (row.result, row.attrs["query_time"])
    pcg = next((r for r in solver_records or ()
                if r["label"] == "Nystrom PCG" and r["dataset"] == CUBE_131072),
               None)
    if pcg is None:
        _, name, constructor, args, query, _, _ = SOLVER_PATH[0]
        (row,) = run_on_arrays(definition("torch_engine", constructor,
                                          datasets[name], args, query),
                               datasets[name], runs=2)
        pcg = {"iterations": row.attrs["cg_iterations"],
               "query_s": row.attrs["query_time"]}
    # The "gram" PCG over orderings of the points (the test matrix's rows
    # permuted with them): the same system and factors, other roundings,
    # as sharding brings.  Ordering 0 is the registry's.  Beside it, the
    # factors from the sketch of four virtual ranks' ring chunks.
    _, name, _, args, query, _, _ = SOLVER_PATH[0]
    counts, routes = sketch_routes(dev, card, datasets[name],
                                   args["precond_rank"], query)
    single_counts = counts["one launch"]
    pcg.update(gram_iterations=single_counts[0],
               gram_spread=[min(single_counts), max(single_counts)],
               sketch_routes=routes)
    print(f"phase 7: single-card baselines: TorchProduct float32 query "
          + ", ".join(f"{name} {qt:.6f} s" for name, (_, qt) in single.items())
          + f"; TorchSolverCG Nystrom PCG ('svd' factors) "
          f"{pcg['iterations']} iterations, query {pcg['query_s']:.4f} s; "
          f"the same PCG on 'gram' factors {pcg['gram_iterations']} "
          f"iterations, {single_counts} over {PCG_ORDERINGS} orderings of "
          f"the points [{card}]")
    # The chunked sketch is held by its error; its PCG count, a stall
    # position (see check_pcg_iterations), to the band phase 8 holds the
    # four cards' count to.
    errors = routes["column_errors"]
    check_sketch_errors("phase 7 virtual ring", errors["virtual ring"],
                        errors["one launch"])
    check_pcg_iterations("phase 7 PCG on the 'gram' factors of the p = 4 "
                         "virtual ring's sketch (a stall position, held to "
                         "phase 8's band)", counts["virtual ring"][0], pcg)

    records = []
    check(multihost.initialize(f"localhost:{free_port()}", num_processes=1,
                               process_id=0), "no process group was made")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "phase 7 needs an NCCL world of one")
        _build.reset_launch_counts()
        for name in SHARDED_PRODUCTS:
            arrays = datasets[name]
            truth = arrays["target_signal"]
            for schedule in SCHEDULES:
                (row,) = run_on_arrays(
                    definition("torch_sharded", "ShardedProduct", arrays,
                               {"precision": "float32",
                                "schedule": schedule}), arrays, runs=2)
                check(np.all(np.isfinite(row.result))
                      and row.result.shape == truth.shape,
                      f"sharded {schedule} {name}: not finite or misshapen")
                rel = rms_error(row, truth)
                check(rel <= MAIN_PATH_BOUND["float32"],
                      f"sharded {schedule} {name}: RMS error {rel:.3e}")
                base, base_s = single[name]
                record = dict(
                    dataset=name, schedule=schedule,
                    ranks=row.attrs["n_chips"],
                    query_s=row.attrs["query_time"],
                    single_card_query_s=base_s, rms=rel,
                    bit_identical_to_single_card=bool(
                        np.array_equal(row.result, base)),
                    max_abs_diff_to_single_card=float(
                        np.abs(row.result - base).max()))
                records.append(record)
                print(f"phase 7: ShardedProduct {schedule} on {name}: "
                      f"query {record['query_s']:.6f} s (single card "
                      f"{base_s:.6f} s), RMS rel error {rel:.3e}, "
                      f"bit-identical to TorchProduct: "
                      f"{record['bit_identical_to_single_card']} (max abs "
                      f"diff {record['max_abs_diff_to_single_card']:.3e}) "
                      f"[{card}]")
        # The sharded Nystrom build: one ring product with E = rank, one
        # launch of the wide mode per ring chunk.
        from kmb_tpu_torch.algorithms import torch_sharded

        real_fit = torch_sharded.ShardedSolverCG.fit
        fit_launches = []

        def counted_fit(self):
            before = (_build.DIRECT.launches, _build.DIRECT.wide_launches)
            try:
                return real_fit(self)
            finally:
                fit_launches.append(
                    (_build.DIRECT.launches - before[0],
                     _build.DIRECT.wide_launches - before[1]))

        for label, name, args, query, limit in SHARDED_SOLVERS:
            arrays = datasets[name]
            fit_launches.clear()
            torch_sharded.ShardedSolverCG.fit = counted_fit
            try:
                (row,) = run_on_arrays(definition("torch_sharded",
                                                  "ShardedSolverCG", arrays,
                                                  args, query), arrays,
                                       runs=2)
            finally:
                torch_sharded.ShardedSolverCG.fit = real_fit
            if args.get("precond_rank"):
                chunks = row.attrs["n_chips"]   # ring chunks per rank
                check(fit_launches == [(chunks, chunks)] * 2,
                      f"{label}: sketch launches (all, wide) per fit "
                      f"{fit_launches}, not one per ring chunk ({chunks})")
                print(f"phase 7: {label}: sketch launches per fit "
                      f"{fit_launches[0][0]}, all of the wide mode, "
                      f"{chunks} ring chunk(s)")
            check(np.all(np.isfinite(row.result))
                  and row.result.shape == arrays["source_signal"].shape,
                  f"{label}: result not finite or misshapen")
            res = float64_residual(arrays, row.result)
            check(res <= limit, f"{label}: true residual {res:.3e} > {limit}")
            iterations = row.attrs["cg_iterations"]
            if args.get("precond_rank"):
                check_pcg_iterations(label, iterations, pcg)
            record = dict(label=label, dataset=name, args=args, query=query,
                          ranks=row.attrs["n_chips"],
                          build_s=row.attrs["build_time"],
                          query_s=row.attrs["query_time"],
                          iterations=iterations,
                          reported_residual=row.attrs["cg_relative_residual"],
                          true_residual=res, limit=limit)
            if args.get("precond_rank"):
                record.update(single_card_svd_iterations=pcg["iterations"],
                              single_card_gram_iterations=pcg[
                                  "gram_iterations"],
                              single_card_gram_spread=pcg["gram_spread"])
            records.append(record)
            print(f"phase 7: {label} on {name}: build "
                  f"{record['build_s']:.4f} s, query {record['query_s']:.4f}"
                  f" s, {iterations} iterations (single card, 'svd' / "
                  f"'gram' factors: {record.get('single_card_svd_iterations')}"
                  f" / {record.get('single_card_gram_iterations')}), "
                  f"reported residual "
                  f"{record['reported_residual']:.3e}, float64 true "
                  f"residual {res:.3e} (limit {limit}) [{card}]")
        launches = {k.symbol: k.launches for k in _build.KERNELS}
        for kernel in _build.KERNELS:
            check(kernel.launches > 0,
                  f"{kernel.symbol} never launched on the sharded path")
        print(f"phase 7: sharded path launches {launches}")
    finally:
        dist.destroy_process_group()

    # The per-shard arithmetic of four cards on this one.
    before = {k.symbol: k.launches for k in _build.KERNELS}
    for name in SHARDED_PRODUCTS:
        arrays = datasets[name]
        y = cuda(arrays["source_points"])
        x = y if arrays["same_points"] else cuda(arrays["target_points"])
        b = cuda(arrays["source_signal"])
        kw = dict(kernel_name=arrays["kernel"],
                  normalize_rows=bool(arrays["normalize_rows"]))
        base = torch.tensor(single[name][0], device=dev)
        truth = arrays["target_signal"]
        for label, out in (
                ("ring, 4 virtual ranks",
                 sharded.virtual_ring_product(x, y, b, p=FOUR_CARDS, **kw)),
                ("all-pairs, 2 x 2 virtual grid",
                 sharded.virtual_allpairs_product(x, y, b, pt=2, ps=2,
                                                  **kw))):
            got = out.double().cpu().numpy()
            rel = float(np.sqrt(np.mean((got - truth) ** 2))
                        / np.sqrt(np.mean(truth ** 2)))
            check(rel <= MAIN_PATH_BOUND["float32"],
                  f"{label} on {name}: RMS error {rel:.3e}")
            _, vs_single = compare(out, base)
            check(vs_single <= KERNEL_TOL["float32"],
                  f"{label} on {name}: {vs_single:.3e} from the single card")
            print(f"phase 7: {label} on {name}: RMS rel error {rel:.3e}, "
                  f"max rel diff to the single card {vs_single:.3e}")
        del x, y, b, base
    virtual = {k.symbol: k.launches - before[k.symbol] for k in _build.KERNELS}
    check(all(virtual.values()), f"virtual ranks launched {virtual}")
    print(f"phase 7: virtual-rank launches {virtual}")

    # The ring chunk's kernel shapes at p = 4 (rank 1, step 0: its own
    # source shard, so the sphere's diagonal lies in the chunk).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, which in ((PRODUCT_CUBE, "direct"), (PRODUCT_SPHERE, "direct"),
                        (ATTENTION, "flash")):
        arrays = datasets[name]
        y = cuda(arrays["source_points"])
        x = y if arrays["same_points"] else cuda(arrays["target_points"])
        b = cuda(arrays["source_signal"])
        n, m = len(x), len(y)
        normalize = bool(arrays["normalize_rows"])
        kw = dict(kernel_name=arrays["kernel"], normalize_rows=normalize)
        me, step, owner = 1, 0, 1
        xs = sharded.shard_rows(x, FOUR_CARDS, me, dev)
        ys = sharded.shard_rows(y, FOUR_CARDS, owner, dev)
        bs = sharded.shard_rows(b, FOUR_CARDS, owner, dev)
        chunk = dict(me=me, step=step, p=FOUR_CARDS, n=n, m=m, **kw)
        plain = dict(deferred=True, row_offset=me * len(xs),
                     col_offset=owner * len(ys), col_limit=m, row_limit=n,
                     **kw)
        got = as_tuple(sharded.ring_chunk(xs, ys, bs, **chunk))
        ref = as_tuple(kernel_matvec_torch(xs, ys, bs, **plain))
        check(len(got) == len(ref), f"{name} chunk: state arity differs")
        err = rel = 0.0
        for g, r in zip(got, ref):
            e_abs, e_rel = compare(g, r)
            err, rel = max(err, e_abs), max(rel, e_rel)
        check(rel <= KERNEL_TOL["float32"],
              f"{name} ring chunk: kernel vs plain {rel:.3e}")
        del got, ref
        ms = time_ms(lambda: sharded.ring_chunk(xs, ys, bs, **chunk), 5)
        device_ms = kernel_device_ms(
            lambda: sharded.ring_chunk(xs, ys, bs, **chunk), call_ms=ms)
        plain_ms = time_ms(lambda: kernel_matvec_torch(xs, ys, bs, **plain),
                           1)
        library_ms = None
        if which == "flash":
            q, k, v = (t[None, None] for t in (xs, ys, bs))
            library_ms = time_ms(lambda: sdpa(q, k, v, scale=1.0), 20)
        nc, d = xs.shape
        mc, e = bs.shape
        bound, bound_by, engine = bound_ms(nc, mc, d, e, which, normalize,
                                           "float32", sfu_rate)
        print(f"phase 7: {which} kernel, ring chunk at p = 4 of {name} "
              f"({nc} x {mc}): {ms:.4f} ms (kernel alone {device_ms} ms), "
              f"plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({engine}), library {library_ms} ms, "
              f"max_abs_err vs plain {err:.3e} [{card}]")
        entries.append(dict(
            name=which, route="cuda", source=SOURCE,
            replaces=REPLACES[which],
            launches=launches[getattr(_build, which.upper()).symbol],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=library_ms,
            at=f"{name}, sharded path, ring chunk at p = 4 (rank 1, step 0)",
            precision="float32", bound_engine=engine,
            kernel_device_ms=device_ms))
        del x, y, b, xs, ys, bs
        torch.cuda.empty_cache()
    records.append({"comm_model": comm_model(
        card, len(datasets[PRODUCT_CUBE]["source_points"]),
        single[PRODUCT_CUBE][1])})
    print(f"phase 7: {time.perf_counter() - started:.1f} s [{card}]")
    single_card = {name: qt for name, (_, qt) in single.items()}
    single_card["pcg"] = pcg
    return records, single_card


def comm_model(card, n, query_s):
    """Phase 7's communication model (kmb_tpu_torch.comm): the collectives
    of the ring and the all-pairs ShardedProduct recorded in a gloo world
    of FOUR_CARDS CPU ranks and held to the formula, which is then scaled
    to N = M = n (the cube) and 2^20 at this card's rate: the single-card
    TorchProduct float32 query on the n-point cube, `query_s` seconds."""
    from kmb_tpu_torch import comm

    rate = n * n / query_s
    with tempfile.TemporaryDirectory() as tmp:
        comm.verify(FOUR_CARDS, 3, 1,
                    comm.record_world(FOUR_CARDS, 3, 1, tmp))
    rows = []
    for size in (n, SWEEP_N):
        for schedule in SCHEDULES:
            row = comm.predict(schedule, FOUR_CARDS, size, 3, 1, rate)
            rows.append(dict(row, n=size))
            ops = ", ".join(f"{c['count']} x {c['op']} {c['shape']}"
                            for c in row["collectives"])
            print(f"phase 7: comm model, {schedule} on {FOUR_CARDS} ranks at "
                  f"N = M = {size} (recorded on gloo at {comm.SIZES}, held "
                  f"to the formula): {ops}; {row['total_bytes_per_device']:.4e}"
                  f" bytes a card over NVLink at "
                  f"{comm.NVLINK_BYTES_PER_S:.3e} B/s (data sheet), "
                  f"comm/compute {row['comm_compute_ratio']:.4e}, predicted "
                  f"query {row['predicted_query_s']:.6f} s, efficiency "
                  f"{row['predicted_efficiency']:.4f}, at {rate:.4e} pairs/s "
                  f"(this card's TorchProduct float32 query at {n}^2) "
                  f"[{card}]")
    return dict(rate_pairs_per_s=rate, rows=rows)


def check_sketch_errors(label, errors, one_launch):
    """A ring-chunked sketch K @ Q is as accurate as the one launch: its
    per-column relative errors against the float64 sketch, (max, median,
    min) as `column_errors` gives them, within SKETCH_ERROR_RATIO of the
    one launch's in max and median."""
    for i, what in enumerate(("max", "median")):
        check(errors[i] <= SKETCH_ERROR_RATIO * one_launch[i],
              f"{label} sketch: {what} per-column error {errors[i]:.3e}, "
              f"one launch {one_launch[i]:.3e} (within "
              f"{SKETCH_ERROR_RATIO}x)")


def check_pcg_iterations(label, iterations, pcg):
    """The sharded Nystrom PCG iterates as the single card does on the
    same factor route ("gram"): its count lies within the single-card
    counts over PCG_ORDERINGS orderings of the points, widened by max(3,
    10%) (the band of tests/test_parallel.py:135-160).  One count is not
    the reference.  At 131072 points and tol 1e-6 no route meets the
    tolerance: each solve stalls at a best residual of 1.0e-6 to 1.7e-6,
    on a float64 matvec too, and ends PCG_STALL_WINDOW iterations after
    it, so its count is where that residual fell on a plateau, and moves
    with any change of rounding: 106 to 203 on one NVIDIA H100 over the
    orderings, the ring's chunking, column splits and the plain product
    (tools/pcg_floor.py)."""
    lo, hi = pcg["gram_spread"]
    check(lo - max(3, 0.1 * lo) <= iterations <= hi + max(3, 0.1 * hi),
          f"{label}: {iterations} iterations, single card on the same "
          f"factors {lo}-{hi} over {PCG_ORDERINGS} orderings")


def four_cards(card, single_card, sweep=False):
    """Phase 8, and with `sweep` phase 10: four NCCL ranks on four cards
    (see the module docstring); returns rank 0's records with the scaling
    efficiencies (and the sweep's rows), or None on a machine with fewer
    cards."""
    count = torch.cuda.device_count()
    if count < FOUR_CARDS:
        print(f"phase 8: needs four cards; this machine has {count}, so "
              f"phase 8 was not run [{card}]")
        if sweep:
            print(f"phase 10: needs four cards; this machine has {count}, "
                  f"so phase 10 was not run [{card}]")
        return None
    started = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kmb_phase8_")
    port = free_port()
    procs = []
    try:
        for rank in range(FOUR_CARDS):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase8-rank",
                 str(rank), "--port", str(port), "--report",
                 os.path.join(tmp, f"rank{rank}.json")]
                + (["--sweep"] if sweep else []),
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + FOUR_CARD_TIMEOUT
        for proc, _ in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    try:
        for rank, (proc, _) in enumerate(procs):
            if proc.returncode != 0:
                with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                    tail = f.read()[-6000:]
                raise SmokeFailure(f"phase 8 rank {rank} exited with "
                                   f"{proc.returncode}:\n{tail}")
        reports = []
        for rank in range(FOUR_CARDS):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                reports.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for report in reports:
        check(all(report["launches"].values()),
              f"phase 8 rank {report['rank']} launches {report['launches']}")
        print(f"phase 8: rank {report['rank']} on {report['device']} "
              f"({report['name']}): launches {report['launches']}")
    for name, prof in reports[0]["ring_profiles"].items():
        print(f"phase 8: rank 0, one profiled ring query of {name}: wall "
              f"{prof['wall_ms']:.3f} ms; device ms by operation [count, "
              f"ms]: {prof['device_ms']} [{card}, {FOUR_CARDS} cards]")
    records = reports[0]["records"]
    # Before the records' checks, so that a failing one leaves these shown.
    collectives = four_card_collectives(card, reports, records,
                                        single_card[PRODUCT_CUBE])
    for record in records:
        if "sketch" in record:
            sketch = record["sketch"]
            print(f"phase 8: rank 0, {record['label']}: "
                  f"{sketch['sharded_iterations']} iterations (best "
                  f"residual {sketch['sharded_residual']:.3e}) on the "
                  f"sharded build's factors, "
                  f"{sketch['single_factor_iterations']} (best "
                  f"{sketch['single_factor_residual']:.3e}) on the single "
                  f"card's 'gram' factors of the same test matrix "
                  f"(single card on them "
                  f"{single_card['pcg']['gram_iterations']}); the "
                  f"build's sums over the ranks in "
                  f"{sketch['reduced_dtypes']}; its test matrix "
                  f"{sketch['q_max_abs_diff']:.3e} from the single "
                  f"card's; sketch per-column relative error against "
                  f"float64 max / median / min "
                  + " / ".join(f"{e:.3e}" for e in sketch["column_errors"])
                  + " (one launch "
                  + " / ".join(f"{e:.3e}" for e in
                               sketch["one_launch_column_errors"])
                  + f"); factors against the one launch's: top-64 "
                  f"eigenvalues {sketch['vs_one_launch']['lam_rel']:.3e} "
                  f"apart, largest principal angle "
                  f"{sketch['vs_one_launch']['max_angle']:.3e} rad "
                  f"[{card}, {FOUR_CARDS} cards]")
    for record in records:
        if "schedule" in record:
            check(record["finite"], f"phase 8 {record}: not finite")
            check(record["rms"] <= MAIN_PATH_BOUND["float32"],
                  f"phase 8 {record['schedule']} {record['dataset']}: RMS "
                  f"error {record['rms']:.3e}")
            single = single_card[record["dataset"]]
            what = f"ShardedProduct {record['schedule']}"
        else:
            check(record["true_residual"] <= record["limit"],
                  f"phase 8 {record['label']}: true residual "
                  f"{record['true_residual']:.3e}")
            check_sketch_errors(f"phase 8 {FOUR_CARDS}-card ring",
                                record["sketch"]["column_errors"],
                                record["sketch"]["one_launch_column_errors"])
            pcg = single_card["pcg"]
            check_pcg_iterations(f"phase 8 {record['label']}",
                                 record["iterations"], pcg)
            single = pcg["query_s"]
            what = (f"{record['label']} ({record['iterations']} iterations, "
                    f"single card 'svd' / 'gram' factors "
                    f"{pcg['iterations']} / {pcg['gram_iterations']}, 'gram' "
                    f"over orderings {pcg['gram_spread']}; true residual "
                    f"{record['true_residual']:.3e})")
        check(record["ranks"] == FOUR_CARDS, f"phase 8 {record}: ranks")
        record["single_card_query_s"] = single
        record["efficiency"] = single / (FOUR_CARDS * record["query_s"])
        chunks = record.get("chunk_kernels_ms")
        print(f"phase 8: {what} on {record['dataset']}, {FOUR_CARDS} cards: "
              f"query {record['query_s']:.6f} s, single card {single:.6f} s,"
              f" scaling efficiency {record['efficiency']:.3f}"
              + ("" if chunks is None else
                 f", ring chunk kernels {chunks:.4f} ms of "
                 f"{record['query_s'] * 1e3:.4f} ms")
              + f" [{card}, {FOUR_CARDS} cards]")
    records.append({"collectives": collectives})
    print(f"phase 8: {time.perf_counter() - started:.1f} s [{card}]")
    if sweep:
        ring = next(r for r in records if r.get("schedule") == "ring"
                    and r["dataset"] == PRODUCT_CUBE)
        records.append({"sweep": four_card_sweep(card, reports, ring)})
    return records


def four_card_collectives(card, reports, records, single_s):
    """Phase 8's recorded collectives of one ring and one all-pairs query
    on the cube, every rank's held to kmb_tpu_torch.comm's formula, and the
    model's efficiency (at the single card's rate) beside the measured."""
    from kmb_tpu_torch import comm

    d, e, n = (int(v) for v in re.search(r"-D(\d+)-E(\d+)-M\d+-N(\d+)-",
                                         PRODUCT_CUBE).groups())
    out = {}
    for schedule in SCHEDULES:
        want = sorted(list(c) for c in comm.analytic(
            schedule, FOUR_CARDS, n, d, e))
        for report in reports:
            rec = report["collectives"][schedule]
            got = [list(c) for c in comm.inventory(rec["calls"])]
            check(rec["queries"] == 1 and got == want,
                  f"phase 8 rank {report['rank']} {schedule}: recorded "
                  f"{got}, the formula {want}")
        model = comm.predict(schedule, FOUR_CARDS, n, d, e,
                             n * n / single_s)
        measured = single_s / (FOUR_CARDS * next(
            r["query_s"] for r in records if r.get("schedule") == schedule
            and r["dataset"] == PRODUCT_CUBE))
        out[schedule] = dict(collectives=want, model=model,
                             measured_efficiency=measured)
        print(f"phase 8: {schedule} on {PRODUCT_CUBE}, {FOUR_CARDS} cards: "
              f"recorded collectives per query {want} on every rank, as the "
              f"formula; predicted efficiency "
              f"{model['predicted_efficiency']:.4f} (NVLink data-sheet rate,"
              f" the single card's {n * n / single_s:.4e} pairs/s), measured"
              f" {measured:.3f} [{card}, {FOUR_CARDS} cards]")
    return out


def four_card_sweep(card, reports, ring):
    """Phase 10's checks and lines from the ranks' reports."""
    from kmb_tpu_torch.ops import _build

    sweeps = reports[0]["sweep"]
    for report in reports:
        # Every rank holds the slowest rank's rows, and every rank is in
        # the four-card mesh.
        check([s["rows"] for s in report["sweep"]]
              == [s["rows"] for s in sweeps], "phase 10: ranks' rows differ")
        launches = report["sweep_launches"]
        check(launches[_build.DIRECT.symbol] > 0,
              f"phase 10 rank {report['rank']}: launches {launches}")
        print(f"phase 10: rank {report['rank']} launches {launches} "
              f"[{card}, {FOUR_CARDS} cards]")
    for sweep in sweeps:
        n = sweep["n"]
        check([row["devices"] for row in sweep["rows"]]
              == list(SWEEP_COUNTS), f"phase 10 at {n}: rows {sweep}")
        check(sweep["rows"][0]["efficiency"] == 1.0,
              f"phase 10 at {n}: p = 1 efficiency "
              f"{sweep['rows'][0]['efficiency']}")
        for row, rel in zip(sweep["rows"], sweep["rms_vs_one_card"]):
            check(rel <= SWEEP_TOL, f"phase 10 at {n}, p = "
                  f"{row['devices']}: {rel:.3e} from the single card")
            print(f"phase 10: N = M = {n}: {json.dumps(row)}, RMS rel "
                  f"diff to p = 1 {rel:.3e} [{card}, {FOUR_CARDS} cards]")
        print(f"phase 10: N = M = {n}: efficiency at p = 2, 4 "
              + ", ".join(f"{row['efficiency']:.3f}"
                          for row in sweep["rows"][1:])
              + f"; phase 8's ring (runner, {PRODUCT_CUBE}) "
              f"{ring['efficiency']:.3f} [{card}, {FOUR_CARDS} cards]")
    return sweeps


def ring_profile(arrays, top=6):
    """One ring query of ShardedProduct under torch.profiler on this rank
    (every rank runs it, after a warm-up query and a barrier): its wall
    time and this rank's largest device times by operation."""
    from torch.profiler import ProfilerActivity, profile

    from kmb_tpu_torch.algorithms.torch_sharded import ShardedProduct
    from kmb_tpu_torch.parallel import multihost

    algo = ShardedProduct(kernel=arrays["kernel"],
                          dimension=arrays["source_points"].shape[1],
                          normalize_rows=bool(arrays["normalize_rows"]))
    algo.prepare_data(source_points=arrays["source_points"],
                      target_points=arrays["target_points"],
                      same_points=bool(arrays["same_points"]))
    algo.prepare_query(source_signal=arrays["source_signal"])
    algo.query()
    multihost.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        algo.query()
        wall_ms = (time.perf_counter() - t0) * 1e3
    algo.done()
    events = sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "self_device_time_total", 0))
    return {"wall_ms": wall_ms, "device_ms": {
        e.key[:60]: [e.count, e.self_device_time_total / 1e3]
        for e in events[:top]}}


def recorded_collectives(arrays):
    """One query of each schedule of ShardedProduct on this rank, after a
    warm-up query, with the mesh's collectives recorded
    (parallel.sharded.record_collectives)."""
    from kmb_tpu_torch.algorithms.torch_sharded import ShardedProduct
    from kmb_tpu_torch.parallel.sharded import record_collectives

    out = {}
    for schedule in SCHEDULES:
        algo = ShardedProduct(kernel=arrays["kernel"],
                              dimension=arrays["source_points"].shape[1],
                              schedule=schedule)
        algo.prepare_data(source_points=arrays["source_points"],
                          target_points=arrays["target_points"],
                          same_points=bool(arrays["same_points"]))
        algo.prepare_query(source_signal=arrays["source_signal"])
        algo.query()
        with record_collectives(algo.mesh) as recorder:
            algo.query()
        out[schedule] = dict(calls=recorder.calls, queries=recorder.queries,
                             mesh=list(algo.mesh.shape))
        algo.done()
    return out


def four_card_rank(args):
    """One rank of phase 8, on card `args.phase8_rank`: the sharded runs
    through the runner, then this rank's ring chunks timed alone; writes a
    JSON report to `args.report`."""
    import torch.distributed as dist

    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.parallel import multihost, sharded
    from kmb_tpu_torch.runner import run_on_arrays

    rank = args.phase8_rank
    multihost.initialize(f"localhost:{args.port}", num_processes=FOUR_CARDS,
                         process_id=rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        datasets = load_datasets(SHARDED_PRODUCTS + (CUBE_131072,), {},
                                 f"rank {rank}")
        _build.reset_launch_counts()
        records = []
        for name in SHARDED_PRODUCTS:
            arrays = datasets[name]
            for schedule in SCHEDULES:
                (row,) = run_on_arrays(
                    definition("torch_sharded", "ShardedProduct", arrays,
                               {"precision": "float32",
                                "schedule": schedule}), arrays, runs=2)
                records.append(dict(
                    dataset=name, schedule=schedule,
                    ranks=row.attrs["n_chips"],
                    query_s=row.attrs["query_time"],
                    rms=rms_error(row, arrays["target_signal"]),
                    finite=bool(np.all(np.isfinite(row.result)))))
        label, name, solver_args, query, limit = SHARDED_SOLVERS[0]
        arrays = datasets[name]
        (row,) = run_on_arrays(definition("torch_sharded", "ShardedSolverCG",
                                          arrays, solver_args, query),
                               arrays, runs=2)
        # The main path's launches, before the split's own.
        launches = {k.symbol: k.launches for k in _build.KERNELS}
        records.append(dict(
            label=label, dataset=name, ranks=row.attrs["n_chips"],
            build_s=row.attrs["build_time"], query_s=row.attrs["query_time"],
            iterations=row.attrs["cg_iterations"],
            reported_residual=row.attrs["cg_relative_residual"],
            true_residual=(float64_residual(arrays, row.result)
                           if rank == 0 else None), limit=limit,
            sketch=four_card_sketch(arrays, solver_args["precond_rank"],
                                    query, dev)))

        # This rank's ring chunks, each kernel call timed alone; the
        # slowest rank's sum beside the ring query's time.
        for record in records:
            if record.get("schedule") != "ring":
                continue
            arrays = datasets[record["dataset"]]
            y = cuda(arrays["source_points"])
            x = y if arrays["same_points"] else cuda(arrays["target_points"])
            b = cuda(arrays["source_signal"])
            kw = dict(n=len(x), m=len(y), kernel_name=arrays["kernel"],
                      normalize_rows=bool(arrays["normalize_rows"]))
            xs = sharded.shard_rows(x, FOUR_CARDS, rank, dev)
            total = 0.0
            for step in range(FOUR_CARDS):
                owner = (rank - step) % FOUR_CARDS
                ys = sharded.shard_rows(y, FOUR_CARDS, owner, dev)
                bs = sharded.shard_rows(b, FOUR_CARDS, owner, dev)
                total += time_ms(lambda: sharded.ring_chunk(
                    xs, ys, bs, me=rank, step=step, p=FOUR_CARDS, **kw), 5)
            record["chunk_kernels_ms"] = multihost.max_across_hosts(total)
        # The profiler's first start on each rank comes at another time
        # (its set-up), which the first profiled collective would wait out.
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            multihost.barrier()
        profiles = {name: ring_profile(datasets[name])
                    for name in SHARDED_PRODUCTS}
        multihost.barrier()
        report = {"rank": rank, "device": str(dev),
                  "name": torch.cuda.get_device_name(dev),
                  "launches": launches, "records": records,
                  "ring_profiles": profiles,
                  "collectives": recorded_collectives(
                      datasets[PRODUCT_CUBE])}
        if args.sweep:   # phase 10
            del datasets
            torch.cuda.empty_cache()
            report["sweep"], report["sweep_launches"] = sweep_on_ranks(
                rank)
        with open(args.report, "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def four_card_sketch(arrays, precond_rank, query, dev):
    """Phase 8's split of the sharded Nystrom PCG on this rank of the
    NCCL world: the sharded build (`build_sharded_precond`, its sketch and
    the dtypes of the tensors it sums over the ranks recorded) under the
    sharded PCG loop (`cg_solve_shard`), and the single card's "gram"
    factors of the same test matrix (one launch on this card) handed to
    the same loop.  On rank 0 only, the four-card sketch, gathered,
    against the float64 sketch on the card, and the sharded factors
    against the single card's."""
    import functools

    from kmb_tpu_torch.ops import solve
    from kmb_tpu_torch.ops.product import kernel_matvec_torch
    from kmb_tpu_torch.parallel import sharded

    kernel = arrays["kernel"]
    y = cuda(arrays["source_points"])
    m = len(y)
    mesh = sharded.make_mesh(device=dev)
    prepared = sharded.prepare_sharded_cg(y, mesh=mesh, kernel_name=kernel)
    rhs = sharded.shard_rows(arrays["target_signal"], mesh.size, mesh.index,
                             dev)
    real = sharded.nystrom_factors
    calls, dtypes = [], []

    def spy(matvec, omega, **kw):
        reduce = kw.pop("allreduce")

        def allreduce(t, *args):
            dtypes.append(str(t.dtype).replace("torch.", ""))
            return reduce(t, *args)
        return real(recording(matvec, calls), omega, allreduce=allreduce,
                    **kw)

    sharded.nystrom_factors = spy
    try:
        prepared = sharded.build_sharded_precond(
            prepared, kernel_name=kernel, precond_rank=precond_rank)
    finally:
        sharded.nystrom_factors = real
    solve_kw = dict(kernel_name=kernel, tol=query["tol"],
                    max_iters=query["max_iters"])
    _, sharded_iterations, sharded_residual = sharded.cg_solve_shard(
        prepared, rhs, **solve_kw)
    single_calls = []
    u1, lam1 = solve.nystrom_factors(
        recording(functools.partial(solve.kernel_matvec, y, y,
                                    kernel_name=kernel), single_calls),
        sharded.draw_test_matrix(m, precond_rank, dev), method="gram")
    single_factors = prepared._replace(
        precond=sharded.sharded_precond_from_arrays(
            u1, lam1.cpu().numpy(), mesh=mesh))
    _, e1_iterations, e1_residual = sharded.cg_solve_shard(
        single_factors, rhs, **solve_kw)
    ((q_local, sketch_local),) = calls
    # Collectives: every rank gathers.
    q = mesh.gather_rows(q_local, m)
    sketch = mesh.gather_rows(sketch_local, m)
    u = mesh.gather_rows(prepared.precond.u, m)
    record = {"sharded_iterations": sharded_iterations,
              "sharded_residual": sharded_residual,
              "single_factor_iterations": e1_iterations,
              "single_factor_residual": e1_residual,
              "reduced_dtypes": dtypes}
    if mesh.index == 0:
        ((q1, sketch1),) = single_calls
        y64 = y.double()
        exact = kernel_matvec_torch(y64, y64, q.double(), kernel_name=kernel)
        record.update(
            q_max_abs_diff=float((q - q1).abs().max()),
            column_errors=column_errors(sketch, exact),
            one_launch_column_errors=column_errors(sketch1, exact),
            vs_one_launch=factor_distance((u, prepared.precond.lam),
                                          (u1, lam1)))
    return record


def instantiation(name):
    """(template, arguments as phase 1's ptxas report lists them) of a
    kernel event's name, demangled ("small_d_kernel<0, 3, 1, false, ...>")
    or mangled; None for another kernel."""
    kind = re.search(r"(one_chunk_large_d_kernel|small_d_kernel"
                     r"|large_d_kernel)", name)
    if kind is None:
        return None
    demangled = re.search(kind.group(1) + r"<([^>]*)>", name)
    if demangled:
        tokens = re.findall(r"\b(\d+|true|false)\b", demangled.group(1))
        args = [{"true": "1", "false": "0"}.get(t, t) for t in tokens]
    else:
        args = re.findall(r"L[ib](\d+)E", name)
    return kind.group(1), ",".join(args)


def profiled_runs(card, built, datasets):
    """Phase 9's profiler hook: TorchProduct float32 through the runner
    with KMB_PROFILE_DIR set, then the same run without it; returns one
    record per dataset."""
    from kmb_tpu_torch.algorithms.torch_engine import TorchProduct
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.runner import TRACE_FILE, run_on_arrays

    # Each query's launches and time (the last repetition is the traced
    # one); the runner's own rows give the best times.
    queries = []
    query = TorchProduct.query

    def counted(self):
        before = sum(k.launches for k in _build.KERNELS)
        t0 = time.perf_counter()
        query(self)
        queries.append((sum(k.launches for k in _build.KERNELS) - before,
                        time.perf_counter() - t0))

    root = tempfile.mkdtemp(prefix="kmb_phase9_")
    records = []
    TorchProduct.query = counted
    try:
        for name, expected in PROFILED:
            arrays = datasets[name]
            run = definition("torch_engine", "TorchProduct", arrays,
                             {"precision": "float32"})
            # The run without the hook first: both runs then start warm.
            queries.clear()
            (plain_row,) = run_on_arrays(run, arrays, runs=2)
            untraced = [q for _, q in queries]
            os.environ["KMB_PROFILE_DIR"] = root
            queries.clear()
            try:
                (row,) = run_on_arrays(run, arrays, runs=2)
            finally:
                del os.environ["KMB_PROFILE_DIR"]
            traced_launches, traced_s = queries[-1]
            traced = [q for _, q in queries]
            truth = arrays["target_signal"]
            for label, r in (("with the hook", row), ("without", plain_row)):
                rel = rms_error(r, truth)
                check(np.all(np.isfinite(r.result))
                      and rel <= MAIN_PATH_BOUND["float32"],
                      f"phase 9 {name} {label}: RMS error {rel:.3e}")
            check("profile_trace" not in plain_row.attrs,
                  f"phase 9 {name}: a trace without KMB_PROFILE_DIR")
            trace_dir = row.attrs.get("profile_trace")
            check(trace_dir is not None and trace_dir.startswith(root),
                  f"phase 9 {name}: profile_trace {trace_dir!r}")
            files = sorted(os.path.join(d, f) for d, _, names in
                           os.walk(root) for f in names)
            check(files == [os.path.join(trace_dir, TRACE_FILE)],
                  f"phase 9 {name}: trace files {files}")
            with open(files[0]) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            ours = [e["name"] for e in kernels
                    if instantiation(e.get("name", "")) is not None]
            check(ours, f"phase 9 {name}: no CUDA kernel of ours in the "
                  f"trace ({len(kernels)} kernel events, "
                  f"{len(events)} events)")
            found = {instantiation(k) for k in ours}
            check(found == {expected} and found <= built,
                  f"phase 9 {name}: traced {sorted(found)}, expected "
                  f"{expected}; names {sorted(set(ours))[:4]}")
            check(len(ours) == traced_launches,
                  f"phase 9 {name}: {len(ours)} kernel events, "
                  f"{traced_launches} launches in the traced repetition")
            shutil.rmtree(trace_dir)
            record = dict(
                dataset=name, instantiation=f"{expected[0]}<{expected[1]}>",
                traced_kernel_events=len(ours),
                traced_launches=traced_launches,
                kernel_event_names=sorted(set(ours)),
                repetitions_s_with_hook=traced,
                repetitions_s_without=untraced,
                query_s_with_hook=row.attrs["query_time"],
                query_s_without=plain_row.attrs["query_time"])
            records.append(record)
            print(f"phase 9: profiled TorchProduct float32 on {name}: one "
                  f"trace, {len(ours)} {expected[0]}<{expected[1]}> events "
                  f"= {traced_launches} launches of the traced repetition; "
                  f"best query {row.attrs['query_time'] * 1e3:.4f} ms with "
                  f"the hook, {plain_row.attrs['query_time'] * 1e3:.4f} ms "
                  f"without; repetitions (ms) with the hook "
                  f"{[round(t * 1e3, 4) for t in traced]} (the last under "
                  f"the profiler), without "
                  f"{[round(t * 1e3, 4) for t in untraced]} [{card}]")
    finally:
        TorchProduct.query = query
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), "phase 9: trace directory left behind")
    return records


def native_runs(card, datasets):
    """Phase 9's native oracle: its build, then NativeProduct through the
    runner against the float64 plain product on the card."""
    from kmb_tpu_torch import native
    from kmb_tpu_torch.ops.product import kernel_matvec_torch
    from kmb_tpu_torch.runner import run_on_arrays

    t0 = time.perf_counter()
    library = native.build()
    build_s = time.perf_counter() - t0
    threads = native.num_threads()
    print(f"phase 9: native oracle {library.name} built in {build_s:.2f} s "
          f"({threads} OpenMP threads) [{card}]")
    records = []
    for name in NATIVE_DATASETS:
        arrays = datasets[name]
        (row,) = run_on_arrays(definition("native_oracle", "NativeProduct",
                                          arrays, {}), arrays, runs=2)
        truth = arrays["target_signal"]
        check(np.all(np.isfinite(row.result))
              and row.result.shape == truth.shape,
              f"phase 9 native {name}: not finite or misshapen")
        diff = float(np.abs(row.result - truth).max())
        rel = diff / float(np.abs(truth).max())
        check(rel <= NATIVE_TOL,
              f"phase 9 native {name}: {rel:.3e} of the largest output")
        y = torch.tensor(arrays["source_points"], device="cuda")
        x = y if arrays["same_points"] else torch.tensor(
            arrays["target_points"], device="cuda")
        b = torch.tensor(arrays["source_signal"], device="cuda")
        plain_ms = time_ms(lambda: kernel_matvec_torch(
            x, y, b, kernel_name=arrays["kernel"],
            normalize_rows=bool(arrays["normalize_rows"])), 2)
        del x, y, b
        records.append(dict(dataset=name, threads=threads,
                            build_s=build_s,
                            query_s=row.attrs["query_time"],
                            card_float64_plain_ms=plain_ms,
                            max_abs_diff=diff, rel_to_largest=rel))
        print(f"phase 9: NativeProduct on {name}: query "
              f"{row.attrs['query_time']:.4f} s on {threads} threads, card "
              f"float64 plain {plain_ms:.3f} ms; largest difference "
              f"{diff:.3e} ({rel:.3e} of the largest output, limit "
              f"{NATIVE_TOL}) [{card}]")
    return records


def sweep_truth_rel(answer, n, rows):
    """RMS relative error of a sweep answer's first `rows` rows against
    the float64 plain product of the sweep's float32 inputs, on the card."""
    from kmb_tpu_torch.ops.product import kernel_matvec_torch

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                     device="cuda").double()
    b = torch.tensor(rng.standard_normal((n, 1)), dtype=torch.float32,
                     device="cuda").double()
    ref = kernel_matvec_torch(x[:rows], x, b, kernel_name="gaussian",
                              block_n=256)
    got = answer[:rows].double()
    return float(torch.sqrt(torch.mean((got - ref) ** 2))
                 / torch.sqrt(torch.mean(ref ** 2)))


def harness_path(card, kernels, datasets):
    """Phase 9: the harness around the engines on one card (see the
    module docstring); returns the phase's records.  It adds no kernel
    row: phase 11 times the sweep's kernel shape, 2^20 x 2^20 at D3."""
    from kmb_tpu_torch import scaling
    from kmb_tpu_torch.ops import _build
    from kmb_tpu_torch.ops.product import kernel_matvec

    started = time.perf_counter()
    built = {(kind, args) for kind, args, _, _ in kernels}
    # The hook after 10^5 launches in this process.
    x = torch.randn((64, 3), device="cuda")
    for _ in range(HOOK_PRIOR_LAUNCHES):
        kernel_matvec(x, x, x[:, :1].contiguous(), kernel_name="gaussian")
    torch.cuda.synchronize()
    print(f"phase 9: {_build.DIRECT.launches} launches before the hook "
          f"[{card}]")
    _build.reset_launch_counts()
    profiled = profiled_runs(card, built, datasets)
    before = _build.DIRECT.launches
    answers = []
    rows = scaling.measure(SWEEP_N, 3, 1, "gaussian", [1], SWEEP_RUNS,
                           device="cuda", outputs=answers)
    sweep_launches = _build.DIRECT.launches - before
    launches = {k.symbol: k.launches for k in _build.KERNELS}
    for kernel in _build.KERNELS:
        check(kernel.launches > 0,
              f"{kernel.symbol} never launched on phase 9's path")
    print(f"phase 9: harness path launches {launches} (the sweep "
          f"{sweep_launches})")
    (row,) = rows
    check(row["efficiency"] == 1.0, f"phase 9 sweep row {row}")
    rel = sweep_truth_rel(answers[0], SWEEP_N, SWEEP_CHECK_ROWS)
    check(rel <= SWEEP_TOL, f"phase 9 sweep at 2^20: RMS error {rel:.3e} "
          f"on {SWEEP_CHECK_ROWS} rows")
    print(f"phase 9: scaling.measure at p = 1, N = M = {SWEEP_N}: "
          f"{json.dumps(row)}; RMS rel error {rel:.3e} against float64 on "
          f"{SWEEP_CHECK_ROWS} target rows [{card}]")
    del answers

    natives = native_runs(card, datasets)
    print(f"phase 9: {time.perf_counter() - started:.1f} s [{card}]")
    return {"profiled": profiled, "native": natives, "sweep": rows,
            "sweep_rel_error": rel}


def hook_in_this_process(card):
    """The profiler hook once in this process, after phases 2-8: a trace
    with kernel events, or the hook's refusal (CUPTI dropped the
    records); returns which."""
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.runner import FAILED_TRACE_FILE, TRACE_FILE
    from kmb_tpu_torch.runner import run_on_arrays

    arrays = make_arrays(HOOK_DATASET)
    arrays["target_signal"] = arrays["source_signal"]   # any truth
    run = definition("torch_engine", "TorchProduct", arrays,
                     {"precision": "float32"})
    root = tempfile.mkdtemp(prefix="kmb_hook_")
    os.environ["KMB_PROFILE_DIR"] = root
    try:
        (row,) = run_on_arrays(run, arrays, runs=1)
        with open(os.path.join(row.attrs["profile_trace"], TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        check(kernels > 0, "the hook wrote a trace without kernel events")
        outcome = f"a trace with {kernels} kernel events"
    except RuntimeError as exc:
        failed = [os.path.join(d, FAILED_TRACE_FILE)
                  for d, _, names in os.walk(root)
                  if FAILED_TRACE_FILE in names]
        check(failed and "no CUDA kernel" in str(exc),
              f"the hook failed otherwise: {exc}")
        outcome = f"refused: {exc}"
    finally:
        del os.environ["KMB_PROFILE_DIR"]
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 9: the profiler hook in the main process after phases "
          f"2-8: {outcome} [{card}]")
    return outcome


def harness_phase(card):
    """Phase 9 in a process of its own (this script with --phase9-report),
    its output relayed: torch.profiler's CUDA records go missing in a
    process that has paused for about a minute since a profiling session
    (ROADMAP Queue 3), and the phase holds a trace's kernel events.
    Returns the child's records."""
    here = hook_in_this_process(card)
    torch.cuda.empty_cache()   # the card's memory, for the other process
    tmp = tempfile.mkdtemp(prefix="kmb_phase9_")
    report = os.path.join(tmp, "report.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase9-report",
         report], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(PHASE9_TIMEOUT, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
        proc.wait()
        check(proc.returncode == 0,
              f"phase 9's process exited with {proc.returncode} [{card}]")
        with open(report) as f:
            out = json.load(f)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(out["records"], hook_in_main_process=here)


def harness_process(report):
    """The process of phase 9: builds (or finds) the kernels, runs
    `harness_path` and writes its records to `report`."""
    from kmb_tpu_torch.ops import _build

    card = nvidia_smi("name,power.limit")
    library = _build.build()
    _build.load_library()
    kernels = ptxas_kernels(_build.report_path(library).read_text())
    datasets = load_datasets([name for name, _ in PROFILED]
                             + list(NATIVE_DATASETS), {}, card)
    records = harness_path(card, kernels, datasets)
    with open(report, "w") as f:
        json.dump({"records": records}, f)
    return 0


def library_attention_fused(x, y, b):
    """One PyTorch call for exponential attention softmax(x y^T) b at a
    size whose logits would not fit the card (10^4 x 2^20): SDPA held to
    its memory-efficient kernel (no fallback to the math path, which
    forms the logits), q, k and v padded with zero columns to 32.  A
    yardstick only: the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    width = 32

    def padded(t):
        return torch.nn.functional.pad(t, (0, width - t.shape[1]))[None, None]

    q, k, v = padded(x), padded(y), padded(b)
    e = b.shape[1]

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return sdpa(q, k, v, scale=1.0)[0, 0, :, :e]
    return call


def run_cli(name, tmp, env):
    """`python -m kmb_tpu_torch` on one dataset in a subprocess; returns
    its output (stdout and stderr), failing the phase on a non-zero exit."""
    cmd = [sys.executable, "-m", "kmb_tpu_torch", "--dataset", name,
           "--algorithm", CLI_ALGORITHM, "--runs", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    out = proc.stdout + proc.stderr
    check(proc.returncode == 0,
          f"phase 11: {' '.join(cmd[1:])} exited with {proc.returncode}:\n"
          f"{out[-6000:]}")
    print(f"phase 11: {' '.join(cmd[2:])}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def cli_path(card, sfu_rate, entries):
    """Phase 11: the 2^20-point datasets through the CLI, in a temporary
    data and results directory: the float64 truth over every row (its
    seconds and the device memory it held), every tier's stored error
    against it, the kernels at those shapes beside their plain version,
    bound and (attention) the library; then the smoke twin.  Appends the
    kernel rows to `entries`; returns the phase's records."""
    import importlib.util

    from kmb_tpu_torch import hdf5
    from kmb_tpu_torch.datasets import TRUTH_LOG
    from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch

    started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="kmb_phase11_")
    env = dict(os.environ, KMB_DATA_DIR=os.path.join(tmp, "data"),
               KMB_RESULTS_DIR=os.path.join(tmp, "results"),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    truth_line = re.compile(
        re.escape(TRUTH_LOG).replace("%s", r"(\S+)")
        .replace(r"%\.3f", r"([\d.]+)").replace("%d", r"(\d+)"))
    launch_line = re.compile(r"TorchProduct\((\w+)\): kernel launches in "
                             r"(\d+) queries: (\{.*\})")
    records = []
    try:
        for name in CLI_DATASETS:
            out = run_cli(name, tmp, env)
            found = truth_line.search(out)
            check(found and found.group(1) == name,
                  f"phase 11 {name}: no truth line in the CLI's output")
            truth_s, peak = float(found.group(3)), int(found.group(4))
            check(peak < TRUTH_PEAK_BYTES,
                  f"phase 11 {name}: the truth held {peak} bytes")
            launches = {}
            for tier, queries, counts in launch_line.findall(out):
                check(int(queries) == 2, f"phase 11 {name}: {queries}")
                launches[tier] = json.loads(counts)
            with hdf5.open_read(os.path.join(tmp, "data",
                                             f"{name}.hdf5")) as f:
                arrays = {key: f[key][:] for key in (
                    "source_points", "target_points", "source_signal",
                    "target_signal")}
                kernel = str(f.attrs["kernel"])
                normalize = bool(f.attrs["normalize_rows"])
            truth = arrays["target_signal"]
            rms_truth = float(np.sqrt(np.mean(truth ** 2)))
            which = "flash" if normalize and kernel in LOG_KERNELS else (
                "direct")
            symbol = f"kmb_{which}_matvec"
            stored = {}
            folder = os.path.join(tmp, "results", name, CLI_ALGORITHM)
            for fn in sorted(os.listdir(folder)):
                with hdf5.open_read(os.path.join(folder, fn)) as f:
                    tier = re.search(r"\((\w+)\)", str(f.attrs["name"]))[1]
                    result, error = f["result"][:], f["error"][:]
                    query_s = float(f.attrs["query_time"])
                check(np.all(np.isfinite(result))
                      and result.shape == truth.shape,
                      f"phase 11 {name} {tier}: not finite or misshapen")
                rel = float(np.sqrt(np.mean(error ** 2))) / rms_truth
                check(rel <= MAIN_PATH_BOUND[tier],
                      f"phase 11 {name} {tier}: RMS error {rel:.3e} over "
                      f"all {len(truth)} rows > {MAIN_PATH_BOUND[tier]}")
                check(launches.get(tier, {}).get(symbol, 0) >= 2,
                      f"phase 11 {name} {tier}: launches "
                      f"{launches.get(tier)}")
                stored[tier] = (query_s, rel)
            check(sorted(stored) == sorted(TIERS),
                  f"phase 11 {name}: results for {sorted(stored)}")
            n, m = len(truth), len(arrays["source_points"])
            print(f"phase 11: {name}: float64 truth in {truth_s:.3f} s on "
                  f"the card, peak {peak / 2**30:.3f} GiB allocated; "
                  f"{n * m:.4e} pairs [{card}]")
            record = dict(dataset=name, truth_s=truth_s, truth_peak_bytes=peak,
                          tiers={})
            records.append(record)

            y = cuda(arrays["source_points"])
            x = cuda(arrays["target_points"])
            b = cuda(arrays["source_signal"])
            d, e = x.shape[1], b.shape[1]
            # One plain call per code path, kept for the check on every
            # row: the plain version runs the same code in float32 and
            # float32x3 (it rounds only in bfloat16), and at 2^20 x 2^20 a
            # call takes 40-50 s.
            plain = {}   # by bfloat16 or not: (output, ms of the call)
            for code, tier in ((False, "float32"), (True, "bfloat16")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = kernel_matvec_torch(x, y, b, kernel_name=kernel,
                                           normalize_rows=normalize,
                                           precision=tier)
                torch.cuda.synchronize()
                plain[code] = (want, (time.perf_counter() - t0) * 1e3)
                torch.cuda.empty_cache()
            library_ms = None
            if which == "flash":
                library = library_attention_fused(x, y, b)
                _, lib_rel = compare(library(), plain[False][0])
                check(lib_rel <= LIBRARY_TOL,
                      f"library attention disagrees ({lib_rel:.3e})")
                library_ms = time_ms(library, 3)
            for tier in TIERS:
                kw = dict(kernel_name=kernel, normalize_rows=normalize,
                          precision=tier)
                want, plain_ms = plain[tier == "bfloat16"]
                got = kernel_matvec(x, y, b, fixed_source=True, **kw)
                err, krel = compare(got, want)
                check(krel <= KERNEL_TOL[tier],
                      f"phase 11 {name} {tier}: kernel vs plain {krel:.3e} "
                      f"on all {n} rows")
                del got
                ms = time_ms(lambda: kernel_matvec(
                    x, y, b, fixed_source=True, **kw), 3)
                device_ms = kernel_device_ms(lambda: kernel_matvec(
                    x, y, b, fixed_source=True, **kw), call_ms=ms)
                bound, bound_by, engine = bound_ms(n, m, d, e, which,
                                                   normalize, tier, sfu_rate)
                query_s, rel = stored[tier]
                count = launches[tier][symbol]
                print(f"phase 11: {which} kernel, {name} [{tier}]: CLI best "
                      f"query {query_s * 1e3:.4f} ms, RMS rel error {rel:.3e}"
                      f" over all {n} rows, launches {count} in 2 queries; "
                      f"call {ms:.4f} ms (kernel alone {device_ms} ms), "
                      f"plain {plain_ms:.1f} ms (one call"
                      + (", float32's code" if tier == "float32x3" else "")
                      + f"), bound "
                      f"{bound:.4f} ms ({engine}), library {library_ms} ms, "
                      f"max_abs_err vs plain {err:.3e} on all {n} rows "
                      f"[{card}]")
                record["tiers"][tier] = dict(query_s=query_s, rms=rel,
                                             launches=count)
                entries.append(dict(
                    name=which, route="cuda", source=kernel_source(d, e),
                    replaces=REPLACES[which], launches=count,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
                    at=f"{name} (python -m kmb_tpu_torch)", precision=tier,
                    bound_engine=engine, kernel_device_ms=device_ms,
                    main_path=True, cli_query_ms=query_s * 1e3,
                    rms_vs_float64=rel))
            del x, y, b, plain, want
            torch.cuda.empty_cache()

        # The smoke twin; its test step imports JAX, which this machine
        # need not have, and would take minutes.
        skip = ["tests"]
        if importlib.util.find_spec("matplotlib") is None:
            skip += ["plot", "website"]   # they draw with matplotlib
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kmb_tpu_torch.smoke", "--hardware", "GPU",
             "--workdir", os.path.join(tmp, "smoke")]
            + [arg for step in skip for arg in ("--skip", step)],
            cwd=tmp, env=env, capture_output=True, text=True,
            timeout=SMOKE_TIMEOUT)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("== ")]
        check(proc.returncode == 0,
              f"phase 11: smoke exited with {proc.returncode}:\n"
              f"{(proc.stdout + proc.stderr)[-6000:]}")
        print(f"phase 11: python -m kmb_tpu_torch.smoke --hardware GPU in "
              f"{time.perf_counter() - t0:.1f} s, steps skipped {skip} (the "
              "tests: time and JAX; plot and website: "
              + ("matplotlib is not installed here" if "plot" in skip
                 else "run") + "): " + " | ".join(lines) + f" [{card}]")
        records.append(dict(smoke="ok", skipped=skip))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), "phase 11: temporary directory left")
    print(f"phase 11: {time.perf_counter() - started:.1f} s [{card}]")
    return records


def sweep_on_ranks(rank):
    """Phase 10 on one rank: the sweep over 1, 2 and 4 cards at each size;
    rank 0's answers held against the single card's.  Returns the rows
    and this rank's kernel launches."""
    from kmb_tpu_torch import scaling
    from kmb_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = []
    for n in SWEEP_SIZES:
        answers = []
        rows = scaling.measure(n, 3, 1, "gaussian", list(SWEEP_COUNTS),
                               SWEEP_RUNS, device="cuda", outputs=answers)
        rel = None
        if rank == 0:
            one = answers[0].double()
            rel = [float(torch.sqrt(torch.mean((a.double() - one) ** 2))
                         / torch.sqrt(torch.mean(one ** 2)))
                   for a in answers]
        out.append({"n": n, "rows": rows, "rms_vs_one_card": rel})
        del answers
        torch.cuda.empty_cache()
    return out, {k.symbol: k.launches for k in _build.KERNELS}


if __name__ == "__main__":
    sys.exit(main())
