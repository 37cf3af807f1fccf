#!/usr/bin/env python3
"""Where the Krylov solves on the direct kernel lose accuracy.

Run from the repository root on a machine with one CUDA card (sm_90a):

    python3 solver_accuracy.py [--seeds 5]

1. Nystrom PCG on solver-cube-D3-E1-M131072-N131072-gaussian (rank 256,
   tol 1e-6, as chip_smoke.py phase 5 runs it), with one preconditioner
   (sketched on the kernel), iterated once on the kernel and once on the
   plain PyTorch version: iterations, reported residual and the float64
   true residual ||K b - a|| / ||a||.
2. The E = 1 product's error against float64 on 1024 rows, for the kernel
   and for the plain version, on that cube and on the M = 2000 sphere:
   the error of the kernel values themselves (relative mean and RMS over
   the block), the error the values alone put into the product (their
   sum taken in float64), and the whole product's error.  The difference
   of the last two is what the float32 summation adds.
3. The card-only Krylov cases of tests/test_torch_cuda.py (SOLVES) on
   `--seeds` orderings of the points (seed 0: the registry's order; the
   others a seeded random permutation of points and right-hand side, the
   same problem with other float32 roundings): iterations and residuals
   on the kernel and on the plain version.  The plain version's spread
   over orderings is the band those tests hold the kernel to.

Prints one JSON object per measurement; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import torch

CUBE = "solver-cube-D3-E1-M131072-N131072-gaussian"
SPHERE = "solver-sphere-D3-E1-M2000-N2000-inverse-distance"
# (dataset, preconditioner, indefinite_method, tol): tests/test_torch_cuda.py
SOLVES = [
    ("solver-cube-D3-E1-M2000-N2000-gaussian", None, "auto", 1e-6),
    ("solver-cube-D3-E1-M2000-N2000-gaussian", "jacobi", "auto", 1e-6),
    (SPHERE, None, "auto", 1e-5),
    (SPHERE, "jacobi", "minres", 1e-5),
    (SPHERE, None, "normal", 1e-6),
]
ROWS = 1024


def emit(**record):
    print(json.dumps(record), flush=True)


def problem(name):
    """(kernel, float64 points, float32 points, float64 rhs) on the card."""
    from kmb_tpu_torch.datasets import ground_truth, make_arrays

    arrays = make_arrays(name)
    y64 = torch.tensor(arrays["source_points"], device="cuda")
    rhs = torch.tensor(ground_truth(arrays, device="cuda"), device="cuda")
    return arrays["kernel"], y64, y64.float(), rhs


def true_residual(kernel, y64, b, rhs):
    from kmb_tpu_torch.ops.product import kernel_matvec_torch

    kb = kernel_matvec_torch(y64, y64, b.double(), kernel_name=kernel)
    return float(torch.linalg.norm(kb - rhs) / torch.linalg.norm(rhs))


def plain(y, kernel):
    from kmb_tpu_torch.ops.product import kernel_matvec_torch

    return lambda v: kernel_matvec_torch(y, y, v, kernel_name=kernel)


def pcg_at_full_size():
    from kmb_tpu_torch.ops import solve

    kernel, y64, y, rhs = problem(CUBE)
    matvec = solve._default_matvec(y, kernel_name=kernel,
                                   precision="float32")
    u, lam = solve.nystrom_preconditioner(matvec, len(y), 256,
                                          device=y.device)
    pc = functools.partial(solve.apply_nystrom_precond, u, lam)
    for label, op in (("kernel", matvec), ("plain", plain(y, kernel))):
        b, it, res = solve.cg_solve(y, rhs.float(), kernel_name=kernel,
                                    tol=1e-6, max_iters=2000, matvec=op,
                                    precond=pc)
        emit(part=1, dataset=CUBE, matvec=label, iterations=it,
             reported_residual=res,
             true_residual=true_residual(kernel, y64, b, rhs))


def product_error(name):
    from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch

    kernel, _, y, _ = problem(name)
    y64 = y.double()        # the float32 points, exactly
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.randn((len(y), 1), generator=gen, device="cuda")
    rows = slice(0, min(ROWS, len(y)))
    eye = torch.eye(rows.stop, device="cuda")
    # Columns `rows` of K are rows `rows` of the symmetric K; with b = I
    # every sum has one non-zero term, so these are the values as computed.
    kw = dict(kernel_name=kernel, col_offset=rows.start)
    exact_k = kernel_matvec_torch(y64, y64[rows], eye.double(), **kw)
    exact = exact_k.T @ b.double()
    nonzero = exact_k != 0
    for label, fn in (("kernel", kernel_matvec),
                      ("plain", kernel_matvec_torch)):
        k = fn(y, y[rows], eye, **kw).double()
        rel = ((k - exact_k) / torch.where(nonzero, exact_k, 1.0))[nonzero]
        values_only = k.T @ b.double()
        whole = fn(y, y, b, kernel_name=kernel).double()[rows]
        scale = torch.linalg.norm(exact)
        emit(part=2, dataset=name, matvec=label,
             value_rel_mean=float(rel.mean()),
             value_rel_rms=float(rel.square().mean().sqrt()),
             product_error_values_only=float(
                 torch.linalg.norm(values_only - exact) / scale),
             product_error_whole=float(torch.linalg.norm(whole - exact)
                                       / scale))


def orderings(seeds):
    from kmb_tpu_torch.ops import _build, solve

    for name, precond, method, tol in SOLVES:
        kernel, _, y0, rhs0 = problem(name)
        for seed in range(seeds):
            perm = (torch.arange(len(y0), device="cuda") if seed == 0 else
                    torch.randperm(len(y0), device="cuda", generator=(
                        torch.Generator(device="cuda").manual_seed(seed))))
            y, rhs = y0[perm].contiguous(), rhs0[perm].float().contiguous()
            pc = (solve.block_jacobi_preconditioner(y, kernel_name=kernel,
                                                    leaf=512)
                  if precond == "jacobi" else None)
            kw = dict(kernel_name=kernel, tol=tol, max_iters=2000,
                      precond=pc, indefinite_method=method)
            before = _build.DIRECT.launches
            _, it, res = solve.cg_solve(y, rhs, **kw)
            launched = _build.DIRECT.launches - before
            _, pit, pres = solve.cg_solve(y, rhs, matvec=plain(y, kernel),
                                          **kw)
            emit(part=3, dataset=name, precond=precond, method=method,
                 seed=seed, iterations=it, residual=res,
                 plain_iterations=pit, plain_residual=pres,
                 kernel_launches=launched)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("solver_accuracy.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    product_error(CUBE)
    product_error(SPHERE)
    orderings(args.seeds)
    pcg_at_full_size()
    return 0


if __name__ == "__main__":
    sys.exit(main())
