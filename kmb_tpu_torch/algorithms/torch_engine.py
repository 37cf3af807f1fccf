"""The torch engine: harness-facing wrappers around the product and solvers.

The twins of kmb_tpu's engine (kmb_tpu/algorithms/tpu_engine.py):

- `TorchProduct` (`TpuProduct`, :88-137): the exact streaming kernel
  product and attention.  `fit` is a no-op, since the streaming design has
  no precomputation, so all cost lands in `query`.
- `TorchSolverDirect` (`TpuSolverDirect`, :140-173): fit materialises K
  and factorises it; query back-substitutes.
- `TorchSolverCG` (`TpuSolverCG`, :176-321): matrix-free Krylov solves on
  the streaming product; fit builds the preconditioner (Nystrom or
  block-Jacobi), query solves, or refines against float64 residuals.

Timing contract: data is staged on the device in the untimed `prepare_*`
hooks, and every `query()` ends with `hard_fence()` (a device synchronize
plus a readback that depends on every output), so the harness's host timer
measures finished device work.  On a CUDA device the query runs the
hand-written kernels; with device="cpu" it runs the plain PyTorch version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.algorithms.base import BaseProduct, BaseSolver
from kmb_tpu_torch.ops.kernels import KERNELS
from kmb_tpu_torch.ops.product import PRECISIONS, kernel_matvec
from kmb_tpu_torch.ops.solve import (
    SPD_KERNELS, apply_nystrom_precond, block_jacobi_preconditioner,
    cg_solve, dense_apply, dense_factor, ir_solve, nystrom_preconditioner,
)
from kmb_tpu_torch.trace import span
from kmb_tpu_torch.utils import hard_fence


class _TorchAlgorithm:
    """Shared helpers: device staging and device-aware memory accounting."""

    # Attributes that may pin device buffers between experiments; `done()`
    # drops them so a serial in-process sweep does not keep them alive.
    _DEVICE_ATTRS = ("x", "y", "b", "res", "rhs", "rhs64", "factor",
                     "_precond_fn")

    def _check_kernel(self, kernel):
        if kernel not in KERNELS:
            raise NotImplementedError(
                f"{type(self).__name__} doesn't support kernel {kernel!r}.")

    def _check_precision(self, precision):
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision {precision!r} is not one of {PRECISIONS}")

    def _stage(self, array, dtype=np.float32):
        return torch.as_tensor(np.asarray(array, dtype=dtype)).to(self.device)

    def get_result(self):
        with span("engine.read"):
            return np.ascontiguousarray(
                self.res.detach().cpu().numpy(), dtype=np.float64)

    def get_memory_usage(self):
        """Device bytes allocated (kB) on CUDA; host RSS on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.memory_allocated(self.device) / 1024
        return super().get_memory_usage()

    def get_additional(self):
        # Not "backend": the runner stores its own key of that name.
        extra = {"torch_device": str(self.device)}
        if self.device.type == "cuda":
            extra["device_name"] = torch.cuda.get_device_name(self.device)
        return extra

    def done(self):
        for attr in self._DEVICE_ATTRS:
            if hasattr(self, attr):
                setattr(self, attr, None)


class TorchProduct(_TorchAlgorithm, BaseProduct):
    """Streaming kernel product / attention on the hand-written kernels.

    precision tiers: "bfloat16" (bf16 signal and kernel values, bf16
    points only at D > 8, f32 accumulation), "float32x3" (full f32 here,
    so at least f32x3 accurate) and "float32" (full f32, never TF32).
    """

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", device="cuda", block_n=None):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self._check_precision(precision)
        self.device = resolve_device(device)
        self.block_n = block_n
        self.name = f"TorchProduct({precision})"

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        # Untimed: host->device transfer at float32; float64 never reaches
        # the kernels.
        self.y = self._stage(source_points)
        self.x = self.y if same_points else self._stage(target_points)
        self.same_points = same_points
        self.density_estimation = density_estimation

    def fit(self):
        # No precomputation: the streaming engine never builds K.
        pass

    def prepare_query(self, *, source_signal):
        if self.density_estimation:
            self.b = None
            return
        with span("engine.stage_signal"):
            self.b = self._stage(source_signal)

    def query(self):
        out = kernel_matvec(
            self.x, self.y, self.b,
            kernel_name=self.kernel,
            normalize_rows=self.normalize_rows,
            density_estimation=self.density_estimation,
            precision=self.precision,
            block_n=self.block_n,
            fixed_source=True,   # self.y stays as prepare_data staged it
        )
        self.res = hard_fence(out)


class TorchSolverDirect(_TorchAlgorithm, BaseSolver):
    """Dense factorisation solver (K fits on the device)."""

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", method="lu", rcond=1e-6,
                 device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self._check_precision(precision)
        self.device = resolve_device(device)
        self.method = method
        self.rcond = float(rcond)
        self.name = f"TorchSolverDirect({precision}, {method})"

    def set_query_arguments(self, rcond=None):
        if rcond is not None:
            self.rcond = float(rcond)

    def prepare_data(self, *, source_points):
        self.y = self._stage(source_points)

    def fit(self):
        # TIMED: materialise K on the device and factorise it.
        self.factor = hard_fence(dense_factor(
            self.y, kernel_name=self.kernel, precision=self.precision,
            method=self.method))

    def prepare_query(self, *, target_signal):
        self.rhs = self._stage(target_signal)

    def query(self):
        self.res = hard_fence(dense_apply(
            self.factor, self.rhs, method=self.method, rcond=self.rcond))


class TorchSolverCG(_TorchAlgorithm, BaseSolver):
    """Matrix-free Krylov solver on the streaming product.

    On a CUDA device every matvec launches the hand-written direct kernel.
    precond="nystrom" (with precond_rank > 0) builds randomised Nystrom
    factors of the iterated operator (K, or K^2 for the indefinite
    kernel); precond="jacobi" the block spectral-absolute-value Jacobi
    blocks of K over `leaf`-point clusters, which route the indefinite
    kernel to preconditioned MINRES.  refine_iters > 0 makes the query a
    mixed-precision iterative refinement: float64 residuals around
    float32 corrections, reusing the one preconditioner.
    """

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", tol=1e-6, max_iters=1000,
                 precond_rank=0, precond="nystrom", leaf=512,
                 refine_iters=0, inner_tol=1e-5, device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self._check_precision(precision)
        if precond not in ("nystrom", "jacobi"):
            raise ValueError(f"precond must be 'nystrom' or 'jacobi', "
                             f"not {precond!r}.")
        self.device = resolve_device(device)
        self.tol = tol
        self.max_iters = max_iters
        self.precond_rank = int(precond_rank)
        self.precond_type = precond
        self.leaf = int(leaf)
        self.refine_iters = int(refine_iters)
        self.inner_tol = float(inner_tol)
        self.iterations = 0
        self.residual = float("nan")
        self.outer_iterations = 0
        self._precond_fn = None
        self._param_tag = (f"leaf={leaf}" if precond == "jacobi"
                           else f"rank={precond_rank}")
        if self.refine_iters > 0:
            self._param_tag += f", ir={self.refine_iters}"
        self._set_name()

    def _set_name(self):
        self.name = (f"TorchSolverCG({self.precision}, tol={self.tol}, "
                     f"{self._param_tag})")

    def prepare_data(self, *, source_points):
        self.y = self._stage(source_points)

    def _matvec(self, v):
        return kernel_matvec(self.y, self.y, v, kernel_name=self.kernel,
                             precision=self.precision)

    def _iterated_op(self, v):
        """The SPD operator CG iterates on: K, or K^2 when K is
        indefinite (see ops/solve.cg_solve)."""
        if self.kernel in SPD_KERNELS:
            return self._matvec(v)
        return self._matvec(self._matvec(v))

    def fit(self):
        # TIMED: build the preconditioner.  Nystrom: one sketch of the
        # iterated operator with E = rank (rank = 0 skips it).
        # Block-Jacobi: eigendecompositions of the (leaf, leaf) diagonal
        # kernel blocks over the balanced-bisection clustering.
        m = self.y.shape[0]
        if self.precond_type == "jacobi":
            self._precond_fn = block_jacobi_preconditioner(
                self.y, kernel_name=self.kernel, leaf=min(self.leaf, m))
            hard_fence(self._precond_fn.args[:2])
        elif self.precond_rank > 0:
            u, lam = hard_fence(nystrom_preconditioner(
                self._iterated_op, m, min(self.precond_rank, m),
                device=self.device))
            self._precond_fn = functools.partial(apply_nystrom_precond, u,
                                                 lam)
        else:
            self._precond_fn = None

    def set_query_arguments(self, tol=None, max_iters=None,
                            refine_iters=None, inner_tol=None):
        if tol is not None:
            self.tol = tol
        if max_iters is not None:
            self.max_iters = max_iters
        if refine_iters is not None:
            self.refine_iters = int(refine_iters)
        if inner_tol is not None:
            self.inner_tol = float(inner_tol)
        self._set_name()

    def prepare_query(self, *, target_signal):
        with span("engine.stage_signal"):
            self.rhs = self._stage(target_signal)
            # The iterative refinement's outer residual is float64.
            self.rhs64 = self._stage(target_signal, np.float64)

    def query(self):
        # The indefinite kernel: the block-abs Jacobi blocks are an SPD
        # M^-1 of K itself -> preconditioned MINRES; the Nystrom factors
        # precondition K^2 -> normal equations (cg_solve's "auto").
        method = "minres" if self.precond_type == "jacobi" else "auto"
        solve = dict(kernel_name=self.kernel, precision=self.precision,
                     tol=float(self.tol), max_iters=int(self.max_iters),
                     matvec=self._matvec, precond=self._precond_fn,
                     indefinite_method=method)
        if self.refine_iters > 0:
            b64, info = ir_solve(self.y, self.rhs64,
                                 inner_tol=self.inner_tol,
                                 refine_iters=self.refine_iters, **solve)
            self.res = hard_fence(b64)
            self.iterations = int(info["inner_iterations"])
            self.outer_iterations = int(info["outer_iterations"])
            self.residual = float(info["relative_residual"])
            return
        b, iters, residual = cg_solve(self.y, self.rhs, **solve)
        self.res = hard_fence(b)
        self.iterations = int(iters)
        self.outer_iterations = 0
        self.residual = float(residual)

    def get_additional(self):
        extra = super().get_additional()
        extra.update(cg_iterations=self.iterations,
                     cg_relative_residual=self.residual)
        if self.outer_iterations:
            extra["ir_outer_iterations"] = self.outer_iterations
        return extra
