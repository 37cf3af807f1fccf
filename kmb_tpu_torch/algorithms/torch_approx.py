"""Approximate kernel products and solvers: the Htool slot of the port.

The twins of kmb_tpu/algorithms/tpu_approx.py, with the same names,
`get_additional` keys and compression formulas:

- `BlrProduct` (`tpu_approx.py:71-164`): the block-low-rank product
  (ops/blr.py): clusters, eta-admissibility, exact near field,
  randomized low-rank far field, with a fixed `rank` or Htool's
  adaptive `epsilon` (rank the cap).
- `NystromProduct` (`:167-206`): landmark low rank (ops/lowrank.py).
- `NystromSolver` (`:209-262`): the ridge solve (lam I + K_hat)^-1 a of
  the Nystrom K_hat through Woodbury.
- `BlrSolver` (`:264-408`): MINRES on the BLR matvec (ops/solve._minres),
  or iterative refinement around it with float64 residuals on the exact
  kernel; its true residual is one exact float32 product, which on the
  card is one launch of the hand-written direct kernel.
- `RandomFeatureProduct` (`:411-474`): random-feature maps; past
  `stream_bytes` of feature matrices it streams blocks of rows through the
  map in the query instead.

Random draws come from a torch.Generator on the device seeded with
`seed`, unless the constructor is given the arrays (`landmarks`,
`omega`, `phase`): torch cannot reproduce jax.random, and the parity tests
hand the port the JAX package's draws that way.  Staging is untimed;
`fit` and `query` end in `hard_fence`.
"""

from __future__ import annotations

import numpy as np
import torch

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.algorithms.base import BaseProduct, BaseSolver
from kmb_tpu_torch.algorithms.torch_engine import _TorchAlgorithm
from kmb_tpu_torch.ops.blr import BLR_KERNELS, BlrOperator
from kmb_tpu_torch.ops.lowrank import (
    LOWRANK_KERNELS, _as_float, _feature_block, feature_apply,
    feature_apply_streamed, nystrom_apply, nystrom_core, nystrom_factor,
    nystrom_factors, nystrom_solver_apply, nystrom_solver_build,
    random_feature_params, random_features_from_arrays, select_landmarks,
)
from kmb_tpu_torch.ops.product import kernel_matvec
from kmb_tpu_torch.ops.solve import _minres, ir_solve
from kmb_tpu_torch.utils import hard_fence

# The fitted state that `done()` drops, besides the engine's.
_APPROX_ATTRS = ("u", "inv_lam", "zx", "zy", "phi_x", "phi_y", "omega",
                 "phase", "c", "gram", "op", "b_blocks")


def _blr_extra(op):
    """The BLR operator's block counts, ranks and build steps."""
    plan = op.plan
    ranks = op.block_ranks
    return {"near_pairs": int(plan.near_pairs.shape[0]),
            "near_sym_pairs": int(plan.near_sym_pairs.shape[0]),
            "far_pairs": int(plan.far_pairs.shape[0]),
            "mean_block_rank": float(np.mean(ranks)) if ranks.size else 0.0,
            "build_qr_seconds": op.step_seconds["qr"],
            "build_eigh_seconds": op.step_seconds["eigh"]}


class _ApproxProduct(_TorchAlgorithm, BaseProduct):
    """Shared staging of the approximate products."""

    _DEVICE_ATTRS = _TorchAlgorithm._DEVICE_ATTRS + _APPROX_ATTRS

    def _check_kernel(self, kernel):
        if kernel not in LOWRANK_KERNELS:
            raise NotImplementedError(
                f"{type(self).__name__} doesn't support kernel {kernel!r} "
                f"(supported: {LOWRANK_KERNELS}).")

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        self.y = self._stage(source_points)
        self.x = self.y if same_points else self._stage(target_points)
        self.same_points = same_points
        self.density_estimation = density_estimation

    def prepare_query(self, *, source_signal):
        self.b = (None if self.density_estimation
                  else self._stage(source_signal))


class BlrProduct(_ApproxProduct):
    """Block-low-rank kernel product: the H-matrix (Htool) slot.

    Knobs as Htool's: `eta` (admissibility), `leaf` (maxblocksize), and a
    fixed `rank` or the adaptive `epsilon` with `rank` as the cap.  Takes
    the singular inverse-distance kernel (its near field stays exact), not
    the dot-product attention kernel.
    """

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", leaf=256, rank=16, eta=2.0,
                 epsilon=None, seed=0, omega=None, device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        if kernel not in BLR_KERNELS:
            raise NotImplementedError(
                f"BlrProduct supports {BLR_KERNELS}, not {kernel!r}.")
        self.device = resolve_device(device)
        self.leaf = int(leaf)
        self.rank = int(rank)
        self.eta = float(eta)
        self.epsilon = None if epsilon is None else float(epsilon)
        self.seed = int(seed)
        self._omega = omega
        if self.epsilon is None:
            self.name = f"BlrProduct(leaf={leaf}, rank={rank}, eta={eta})"
        else:
            self.name = (f"BlrProduct(leaf={leaf}, eps={epsilon}, "
                         f"eta={eta})")

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        # Host copies: the plan is built in NumPy at fit time.
        self.y_np = np.ascontiguousarray(source_points, dtype=np.float32)
        self.x_np = (self.y_np if same_points else
                     np.ascontiguousarray(target_points, dtype=np.float32))
        self.same_points = same_points
        self.density_estimation = density_estimation

    def fit(self):
        # TIMED: plan (host) and far-field compression (device), the
        # analogue of Htool's build_clusters + build_HMatrix.
        self.op = BlrOperator(
            self.x_np, self.y_np, kernel_name=self.kernel, leaf=self.leaf,
            rank=self.rank, eta=self.eta, epsilon=self.epsilon,
            same_points=self.same_points, seed=self.seed, omega=self._omega,
            device=self.device)
        hard_fence([t for group in self.op.far_groups for t in group[:2]])

    def prepare_query(self, *, source_signal):
        m = self.y_np.shape[0]
        if self.density_estimation:
            signal = np.ones((m, 1), dtype=np.float32)
        else:
            signal = np.asarray(source_signal, dtype=np.float32)
            if self.normalize_rows:
                # The denominator rides along as one extra signal column.
                signal = np.concatenate(
                    [signal, np.ones((m, 1), np.float32)], axis=1)
        self.b_blocks = hard_fence(self.op.block_signal(signal))
        self.e = (0 if self.density_estimation
                  else np.asarray(source_signal).shape[1])

    def query(self):
        if self.density_estimation and self.normalize_rows:
            # K 1 / K 1 == 1 exactly.
            self.res = hard_fence(torch.ones((self.op.n, 1),
                                             device=self.device))
            return
        out = self.op.unblock(self.op.matvec_blocked(self.b_blocks))
        if self.normalize_rows:
            out = out[:, :self.e] / out[:, self.e:]
        self.res = hard_fence(out)

    def get_additional(self):
        extra = super().get_additional()
        extra.update(rank=self.rank, symmetric=bool(self.op.plan.same_points),
                     compression=self.op.compression, **_blr_extra(self.op))
        return extra


class NystromProduct(_ApproxProduct):
    """Landmark low-rank (Nystrom) product: K ~= K(., L) W^+ K(L, .)."""

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", rank=256, rcond=1e-6, seed=0,
                 landmarks=None, device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self.device = resolve_device(device)
        self.rank = int(rank)
        self.rcond = float(rcond)
        self.seed = int(seed)
        self._landmarks = landmarks
        self.name = f"NystromProduct(rank={rank})"

    def fit(self):
        # TIMED: landmarks, the pseudo-inverse factor of W, the cross
        # blocks.
        landmarks = (select_landmarks(self.y, self.rank, seed=self.seed)
                     if self._landmarks is None
                     else _as_float(self._landmarks, self.device))
        self.u, self.inv_lam = nystrom_core(landmarks, self.kernel,
                                            rcond=self.rcond)
        if self.same_points:
            # K(x, L) == K(y, L): one factor.
            self.zy = nystrom_factor(self.y, landmarks, self.kernel)
            self.zx = self.zy
        else:
            self.zx, self.zy = nystrom_factors(self.x, self.y, landmarks,
                                               self.kernel)
        hard_fence((self.u, self.inv_lam, self.zx, self.zy))

    def query(self):
        self.res = hard_fence(nystrom_apply(
            self.zx, self.zy, self.u, self.inv_lam, self.b,
            normalize_rows=self.normalize_rows,
            density_estimation=self.density_estimation))

    def get_additional(self):
        n, m = self.zx.shape[0], self.zy.shape[0]
        r = self.u.shape[0]
        extra = super().get_additional()
        extra.update(rank=r,
                     compression=float(n * m) / float((n + m + r) * r))
        return extra


class NystromSolver(_TorchAlgorithm, BaseSolver):
    """Approximate ridge solver b ~= (lam I + K_hat)^-1 a, K_hat = C C^T
    the Nystrom approximation: `fit` builds the rank-r Woodbury workspace,
    each query is two (M, r) matmuls and an (r, r) Cholesky solve.  `lam`
    is a query argument."""

    _DEVICE_ATTRS = _TorchAlgorithm._DEVICE_ATTRS + _APPROX_ATTRS

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", rank=512, lam=1e-4, rcond=1e-6,
                 seed=0, landmarks=None, device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        if kernel not in LOWRANK_KERNELS:
            raise NotImplementedError(
                f"NystromSolver doesn't support kernel {kernel!r} "
                f"(supported: {LOWRANK_KERNELS}).")
        self.device = resolve_device(device)
        self.rank = int(rank)
        self.lam = float(lam)
        self.rcond = float(rcond)
        self.seed = int(seed)
        self._landmarks = landmarks
        self.name = f"NystromSolver(rank={rank}, lam={lam})"

    def prepare_data(self, *, source_points):
        self.y = self._stage(source_points)

    def fit(self):
        landmarks = (select_landmarks(self.y, self.rank, seed=self.seed)
                     if self._landmarks is None
                     else _as_float(self._landmarks, self.device))
        self.c, self.gram = hard_fence(nystrom_solver_build(
            self.y, landmarks, self.kernel, rcond=self.rcond))

    def set_query_arguments(self, lam=None):
        if lam is not None:
            self.lam = float(lam)
        self.name = f"NystromSolver(rank={self.rank}, lam={self.lam})"

    def prepare_query(self, *, target_signal):
        self.rhs = self._stage(target_signal)

    def query(self):
        self.res = hard_fence(nystrom_solver_apply(
            self.c, self.gram, self.rhs, self.lam))

    def get_additional(self):
        m, r = self.c.shape
        extra = super().get_additional()
        extra.update(rank=r, compression=float(m) / float(r))
        return extra


class BlrSolver(_TorchAlgorithm, BaseSolver):
    """MINRES on the compressed BLR operator (the H-matrix-accelerated
    solver the product-only Htool wrapper never wires up).

    `fit` builds the symmetric BLR operator; `query` runs MINRES on its
    matvec (the compressed operator is exactly symmetric but not certainly
    definite).  refine_iters > 0 wraps those solves in iterative
    refinement with float64 residuals on the exact kernel, which contracts
    past the compression floor.  `get_additional` reports the compressed
    operator's residual and the true one, from one exact float32 product
    (`kernel_matvec`: the direct kernel on the card).
    """

    _DEVICE_ATTRS = _TorchAlgorithm._DEVICE_ATTRS + _APPROX_ATTRS

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", leaf=256, rank=64, eta=2.0,
                 epsilon=None, tol=1e-5, max_iters=1000,
                 refine_iters=0, inner_tol=1e-4, seed=0, omega=None,
                 device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        if kernel not in BLR_KERNELS:
            raise NotImplementedError(
                f"BlrSolver doesn't support kernel {kernel!r} "
                f"(supported: {BLR_KERNELS}).")
        self.device = resolve_device(device)
        self.leaf = int(leaf)
        self.rank = int(rank)
        self.eta = float(eta)
        self.epsilon = None if epsilon is None else float(epsilon)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.refine_iters = int(refine_iters)
        self.inner_tol = float(inner_tol)
        self.seed = int(seed)
        self._omega = omega
        self.iterations = 0
        self.outer_iterations = 0
        self.residual = float("nan")
        self.true_residual = float("nan")
        self.op = None
        tag = (f"eps={epsilon}" if epsilon is not None else f"rank={rank}")
        if self.refine_iters > 0:
            tag += f", ir={self.refine_iters}"
        self.name = f"BlrSolver(leaf={leaf}, {tag}, tol={tol})"

    def prepare_data(self, *, source_points):
        self.y_host = np.ascontiguousarray(source_points, dtype=np.float32)
        self.y = self._stage(self.y_host)

    def fit(self):
        # TIMED: the whole compression build.
        self.op = BlrOperator(
            self.y_host, self.y_host, kernel_name=self.kernel,
            leaf=self.leaf, rank=self.rank, eta=self.eta,
            epsilon=self.epsilon, same_points=True, seed=self.seed,
            omega=self._omega, device=self.device)
        hard_fence([t for group in self.op.far_groups for t in group[:2]])

    def set_query_arguments(self, tol=None, max_iters=None,
                            refine_iters=None, inner_tol=None):
        if tol is not None:
            self.tol = float(tol)
        if max_iters is not None:
            self.max_iters = int(max_iters)
        if refine_iters is not None:
            self.refine_iters = int(refine_iters)
        if inner_tol is not None:
            self.inner_tol = float(inner_tol)
        tag = (f"eps={self.epsilon}" if self.epsilon is not None
               else f"rank={self.rank}")
        if self.refine_iters > 0:
            tag += f", ir={self.refine_iters}"
        self.name = f"BlrSolver(leaf={self.leaf}, {tag}, tol={self.tol})"

    def prepare_query(self, *, target_signal):
        self.rhs = self._stage(target_signal)
        self.rhs64 = self._stage(target_signal, np.float64)

    def _true_residual(self, b):
        """max over columns of ||a - K b|| / ||a||, K b the exact float32
        product (one direct-kernel launch on the card), the norms in
        float64."""
        kb = kernel_matvec(self.y, self.y, b.float(),
                           kernel_name=self.kernel, precision="float32")
        num = torch.linalg.vector_norm(self.rhs64 - kb.double(), dim=0)
        den = torch.clamp_min(torch.linalg.vector_norm(self.rhs64, dim=0),
                              torch.finfo(torch.float64).tiny)
        return float(torch.max(num / den))

    def query(self):
        matvec = self.op.matvec
        if self.refine_iters > 0:
            def inner(r):
                return _minres(matvec, r, self.inner_tol, self.max_iters)

            b, info = ir_solve(
                self.y, self.rhs64, kernel_name=self.kernel, tol=self.tol,
                max_iters=self.max_iters, inner_tol=self.inner_tol,
                refine_iters=self.refine_iters, inner_solve=inner)
            self.res = hard_fence(b)
            self.iterations = int(info["inner_iterations"])
            self.outer_iterations = int(info["outer_iterations"])
            self.residual = float(info["relative_residual"])
        else:
            b, iters, residual = _minres(matvec, self.rhs, self.tol,
                                         self.max_iters)
            self.res = hard_fence(b)
            self.iterations = int(iters)
            self.outer_iterations = 0
            self.residual = float(residual)
        self.true_residual = self._true_residual(self.res)

    def get_additional(self):
        extra = super().get_additional()
        extra.update(cg_iterations=self.iterations,
                     cg_relative_residual=self.residual,
                     true_relative_residual=self.true_residual,
                     compression=self.op.compression, **_blr_extra(self.op))
        if self.outer_iterations:
            extra["ir_outer_iterations"] = self.outer_iterations
        return extra


class RandomFeatureProduct(_ApproxProduct):
    """Random-feature product K b ~= Phi_x (Phi_y^T b).

    When the feature matrices would pass `stream_bytes` (2 GiB by
    default), `fit` keeps only the (D, F) spectral parameters and `query`
    streams row blocks through the feature map
    (`lowrank.feature_apply_streamed`): the same estimator in O(block F)
    memory, its cost moved into the timed query.
    """

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision="float32", num_features=1024, seed=0,
                 stream_bytes=2 << 30, omega=None, phase=None,
                 device="cuda"):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows, precision=precision)
        self._check_kernel(kernel)
        self.device = resolve_device(device)
        self.num_features = int(num_features)
        self.seed = int(seed)
        self.stream_bytes = int(stream_bytes)
        self._draw = None if omega is None else (omega, phase)
        self.streaming = False
        self.omega = self.phase = None
        self.name = f"RandomFeatureProduct(F={num_features})"

    def fit(self):
        # TIMED: the spectral draw and (materialised) both feature maps.
        n, m = self.x.shape[0], self.y.shape[0]
        rows = m if self.same_points else n + m
        self.streaming = rows * self.num_features * 4 > self.stream_bytes
        self.omega, self.phase = (
            random_feature_params(self.x.shape[1], self.kernel,
                                  self.num_features, seed=self.seed,
                                  device=self.device)
            if self._draw is None
            else random_features_from_arrays(*self._draw,
                                             device=self.device))
        if self.streaming:
            hard_fence((self.omega, self.phase))
            return
        self.phi_x = _feature_block(self.omega, self.phase, self.x)
        self.phi_y = (self.phi_x if self.same_points
                      else _feature_block(self.omega, self.phase, self.y))
        hard_fence((self.phi_x, self.phi_y))

    def query(self):
        if self.streaming:
            self.res = hard_fence(feature_apply_streamed(
                self.omega, self.phase, self.x, self.y, self.b,
                normalize_rows=self.normalize_rows,
                density_estimation=self.density_estimation))
            return
        self.res = hard_fence(feature_apply(
            self.phi_x, self.phi_y, self.b,
            normalize_rows=self.normalize_rows,
            density_estimation=self.density_estimation))

    def get_additional(self):
        n, m = self.x.shape[0], self.y.shape[0]
        f = self.num_features
        extra = super().get_additional()
        extra.update(num_features=f, streaming=self.streaming,
                     compression=float(n * m) / float((n + m) * f))
        return extra
