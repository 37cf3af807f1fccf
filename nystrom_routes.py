#!/usr/bin/env python3
"""Nystrom PCG iterations by factor route and test-matrix draw, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 nystrom_routes.py

For the Gaussian solver cubes at 131072 and 10^4 points (tol 1e-6, rank
256, as chip_smoke.py's PCG), three draws of the test matrix (seeds 0-2 of
a torch.Generator on the card) and three routes to the factors:

- "svd": kmb_tpu_torch.ops.solve.nystrom_factors(method="svd"), the
  single-card TorchSolverCG's route (QR of the test matrix, tall SVD);
- "gram": nystrom_factors(method="gram"), the sharded solver's route
  (Cholesky QR of the test matrix and the sketch's Grams, in float64);
- "gram, float32, no QR": the same Grams in float32 on the raw test
  matrix, the JAX package's sharded route (kmb_tpu/ops/solve.py
  nystrom_preconditioner, method="gram").

Prints one line per (dataset, seed, route): PCG iterations, the loop's
relative residual and the solve's seconds.
"""

import functools
import math
import sys
import time

import torch


def gram_float32_no_qr(matvec, omega):
    """The JAX package's sharded route: float32 Grams, no QR."""
    eps = torch.finfo(torch.float32).eps
    tiny = torch.finfo(torch.float32).tiny
    sketch = matvec(omega)
    nu = math.sqrt(omega.shape[0]) * eps * torch.linalg.norm(sketch)
    sketch_nu = sketch + nu * omega
    gram = omega.T @ sketch_nu
    w, v = torch.linalg.eigh(0.5 * (gram + gram.T))
    half = sketch_nu @ (v / torch.sqrt(torch.clamp_min(w, tiny))[None, :])
    g2 = half.T @ half
    s2, v2 = torch.linalg.eigh(0.5 * (g2 + g2.T))
    s2 = torch.maximum(s2, torch.clamp_min(eps * s2[-1], tiny))
    u = half @ (v2 / torch.sqrt(s2)[None, :])
    return u.flip(1), torch.clamp_min(s2.flip(0) - nu, 0.0)


def main():
    if not torch.cuda.is_available():
        print("nystrom_routes: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    from kmb_tpu_torch.datasets import ground_truth, make_arrays
    from kmb_tpu_torch.ops import solve
    from kmb_tpu_torch.ops.product import kernel_matvec

    for name in ("solver-cube-D3-E1-M131072-N131072-gaussian",
                 "solver-cube-D3-E1-M10000-N10000-gaussian"):
        arrays = make_arrays(name)
        arrays["target_signal"] = ground_truth(arrays, device="cuda")
        y = torch.tensor(arrays["source_points"], dtype=torch.float32,
                         device="cuda")
        rhs = torch.tensor(arrays["target_signal"], dtype=torch.float32,
                           device="cuda")

        def matvec(v):
            return kernel_matvec(y, y, v, kernel_name=arrays["kernel"])

        for seed in range(3):
            omega = torch.randn(
                (len(y), 256), device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(seed))
            routes = {
                "svd": lambda: solve.nystrom_factors(matvec, omega,
                                                     method="svd"),
                "gram": lambda: solve.nystrom_factors(matvec, omega,
                                                      method="gram"),
                "gram, float32, no QR": lambda: gram_float32_no_qr(matvec,
                                                                   omega)}
            for route, factors in routes.items():
                with solve.highest_precision():
                    u, lam = factors()
                t0 = time.perf_counter()
                _, iterations, residual = solve._pcg(
                    matvec, rhs, 1e-6, 2000,
                    precond=functools.partial(solve.apply_nystrom_precond,
                                              u, lam))
                torch.cuda.synchronize()
                print(f"{name} seed {seed} {route}: {iterations} "
                      f"iterations, residual {residual:.3e}, "
                      f"{time.perf_counter() - t0:.3f} s "
                      f"[{torch.cuda.get_device_name(0)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
