"""Kernel linear-system solvers b = K^-1 a, the twin of kmb_tpu.ops.solve.

Two regimes, as in the JAX package:

- `dense_solve`: materialise K once (`kernel_matrix`, plain torch, as the
  JAX package builds it with XLA outside any Pallas kernel) and factorise
  it: pivoted LU, Cholesky, or the truncated eigendecomposition ("svd").
- `cg_solve`: matrix-free Krylov solves whose matvec is the streaming
  kernel product (`ops/product.kernel_matvec`): on CUDA tensors every
  iteration launches the hand-written direct kernel, on CPU tensors it runs
  the plain PyTorch version.  SPD kernels run (preconditioned) CG; the
  indefinite inverse-distance kernel runs MINRES on K, or CG on the normal
  equations K^2 b = K a.

Preconditioners: the randomised Nystrom factors (`nystrom_preconditioner`)
and the block spectral-absolute-value Jacobi blocks
(`block_jacobi_preconditioner`); `ir_solve` refines float32 Krylov solves
against float64 residuals.

The Krylov loops keep the JAX package's iterate sequence and stop rule
(kmb_tpu/ops/solve.py:200-473): all E columns run jointly with per-column
scalars; a loop stops when every column reaches its tolerance, at
`max_iters`, or after PCG_STALL_WINDOW iterations with no new best
residual, and returns the best iterate.  The host tests the stop rule
after every iteration from one small device-to-host read.  The JAX
package's host segmenting of the loop (which exists for a TPU transport's
hang detector) has no counterpart here.

Every dense factorisation, eigendecomposition, QR, SVD, Gram and small
matmul runs in true float32 (`highest_precision`), whatever the caller set
with torch.set_float32_matmul_precision: the JAX package runs them at
HIGHEST because lower precision made the Nystrom Gram indefinite.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product
from kmb_tpu_torch.ops.blr import _cluster
from kmb_tpu_torch.ops.kernels import get_kernel
from kmb_tpu_torch.ops.product import kernel_matvec, kernel_matvec_torch
from kmb_tpu_torch.utils import highest_precision

# Kernels whose Gram matrix is symmetric positive (semi-)definite on
# distinct points; CG applies directly.  The zero-diagonal inverse-distance
# matrix is symmetric indefinite.
SPD_KERNELS = frozenset({"gaussian", "absolute-exponential", "exponential"})
DENSE_METHODS = ("lu", "cholesky", "svd")
INDEFINITE_METHODS = ("auto", "minres", "normal")
NYSTROM_METHODS = ("svd", "gram")
PCG_STALL_WINDOW = 60
# The Nystrom preconditioner's eigenvalue floor, relative to the largest.
NYSTROM_REL_FLOOR = 1e-4

_TINY = torch.finfo(torch.float32).tiny
_EPS = torch.finfo(torch.float32).eps


def _check_choice(name, value, choices):
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, not {value!r}")


def kernel_matrix(x, y, *, kernel_name: str, precision: str = "float32"):
    """Dense (..., N, M) kernel matrix, the twin of `kernel_matrix_xla`.

    x (..., N, D) and y (..., M, D) with matching leading dims (a batch of
    blocks for the block-Jacobi factors).  At D <= 8 the squared distance
    takes the cancellation-safe difference form; above it the expanded
    form |x|^2 + |y|^2 - 2<x, y>.  In the bfloat16 tier the points are
    rounded to bf16 first and the bf16 matmul's output is rounded to bf16,
    as XLA's is.  Kernels with a zero diagonal (inverse-distance) get
    entries i == j zeroed.
    """
    spec = get_kernel(kernel_name)
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    x = x.to(dtype)
    y = y.to(dtype)
    d = x.shape[-1]
    with highest_precision():
        if spec.on == "dot":
            form = torch.matmul(x, y.transpose(-1, -2)).float()
        elif d <= 8:
            xf, yf = x.float(), y.float()
            form = None
            for k in range(d):
                diff = xf[..., :, k:k + 1] - yf[..., None, :, k]
                term = diff * diff
                form = term if form is None else form + term
        else:
            xsq = torch.sum(x.float() ** 2, dim=-1, keepdim=True)
            ysq = torch.sum(y.float() ** 2, dim=-1)[..., None, :]
            form = xsq + ysq - 2.0 * torch.matmul(
                x, y.transpose(-1, -2)).float()
    k = spec.fn(form)
    if spec.zero_diagonal:
        n, m = k.shape[-2:]
        k = k.masked_fill(
            torch.eye(n, m, dtype=torch.bool, device=k.device), 0.0)
    return k


def dense_factor(y, *, kernel_name: str, precision: str = "float32",
                 method: str = "lu"):
    """Materialise K and factorise it (the timed `fit` of a dense solver).

    "lu": pivoted LU, robust for the indefinite inverse-distance matrix
    and ill-conditioned SPD kernels; "cholesky": the lower Cholesky factor
    (NaN where float32 Cholesky breaks down, as LAPACK's is in the JAX
    package); "svd": the eigendecomposition of 0.5 (K + K^T), for the
    truncated pseudo-inverse of `dense_apply`.
    """
    _check_choice("method", method, DENSE_METHODS)
    k = kernel_matrix(y, y, kernel_name=kernel_name, precision=precision)
    with highest_precision():
        if method == "cholesky":
            factor, info = torch.linalg.cholesky_ex(k)
            return torch.where(info == 0, factor, math.nan)
        if method == "svd":
            return tuple(torch.linalg.eigh(0.5 * (k + k.T)))
        lu, pivots, _ = torch.linalg.lu_factor_ex(k)
        return lu, pivots


def dense_apply(factor, rhs, *, method: str = "lu", rcond: float = 1e-6):
    """Back-substitution against a stored factorisation (the timed query).

    "svd" keeps the eigenvalues with |w| > rcond * max|w|.
    """
    _check_choice("method", method, DENSE_METHODS)
    rhs = rhs.float()
    with highest_precision():
        if method == "cholesky":
            return torch.cholesky_solve(rhs, factor)
        if method == "svd":
            w, v = factor
            keep = torch.abs(w) > rcond * torch.max(torch.abs(w))
            w_inv = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
            return v @ (w_inv[:, None] * (v.T @ rhs))
        lu, pivots = factor
        return torch.linalg.lu_solve(lu, pivots, rhs)


def dense_solve(y, rhs, *, kernel_name: str, precision: str = "float32",
                method: str = "lu", rcond: float = 1e-6):
    """Factorise-and-solve K b = rhs with K materialised on the device."""
    factor = dense_factor(y, kernel_name=kernel_name, precision=precision,
                          method=method)
    return dense_apply(factor, rhs, method=method, rcond=rcond)


def _default_matvec(y, *, kernel_name, precision):
    def matvec(v):
        return kernel_matvec(y, y, v, kernel_name=kernel_name,
                             precision=precision)
    return matvec


class NormalEquationsOp:
    """The K^2 operator v -> K (K v) of CG on the normal equations."""

    def __init__(self, matvec: Callable):
        self.matvec = matvec

    def __call__(self, v):
        return self.matvec(self.matvec(v))


def _read_flags(*flags):
    """One device-to-host read of several boolean scalars."""
    return torch.stack(flags).tolist()


def _pcg(matvec: Callable, rhs, tol: float, max_iters: int,
         precond: Optional[Callable] = None):
    """Multi-RHS preconditioned conjugate gradient.

    Runs all E columns jointly with per-column alpha and beta.  Stops when
    every column satisfies ||r|| <= tol * ||rhs|| (the true residual, not
    the preconditioned one), at max_iters, or after PCG_STALL_WINDOW
    iterations with no new best residual in any column (float32 CG on an
    ill-conditioned system reaches a rounding floor above tight
    tolerances).  Returns (best iterate, iterations, its relative
    residual, the largest over the columns).
    """
    rhs = rhs.float()
    apply_precond = (lambda v: v) if precond is None else precond
    b = torch.zeros_like(rhs)
    r = rhs
    p = apply_precond(r)
    rz = torch.sum(r * p, dim=0)
    rs = torch.sum(r * r, dim=0)
    rhs_sq = rs
    target_sq = (float(tol) ** 2) * rhs_sq
    best_b, best_rs = b, rs
    stall = it = 0
    (unmet,) = _read_flags(torch.any(rs > target_sq))
    while it < max_iters and stall < PCG_STALL_WINDOW and unmet:
        kp = matvec(p)
        denom = torch.sum(p * kp, dim=0)
        alpha = torch.where(denom != 0.0, rz / denom, 0.0)
        b = b + alpha * p
        r = r - alpha * kp
        z = apply_precond(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(rz != 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        rs = torch.sum(r * r, dim=0)
        improved = rs < best_rs
        best_b = torch.where(improved[None, :], b, best_b)
        best_rs = torch.minimum(rs, best_rs)
        it += 1
        any_improved, unmet = _read_flags(torch.any(improved),
                                        torch.any(rs > target_sq))
        stall = 0 if any_improved else stall + 1
    rel = torch.sqrt(torch.max(best_rs / torch.clamp_min(rhs_sq, 1e-30)))
    return best_b, it, float(rel)


def _beta_sq(value):
    # r' M^-1 r is MINRES's squared Lanczos beta; an indefinite M^-1 (a
    # misuse) would make it negative.  Clamped to 0, as the JAX package's
    # production path does.
    return torch.clamp_min(value, 0.0)


def _minres(matvec: Callable, rhs, tol: float, max_iters: int,
            precond: Optional[Callable] = None):
    """Multi-RHS (preconditioned) Paige-Saunders MINRES.

    The structure of SciPy's `minres`, with per-column Lanczos and Givens
    scalars: one matvec and one application of the SPD preconditioner
    M^-1 per iteration, on the symmetric, possibly indefinite operator.
    The in-loop residual estimate `phibar` is in the M^-1 norm, relative
    to the right-hand side's; the loop has the stall window and returns
    the best iterate, as `_pcg` does.  The reported relative residual
    comes from one true-residual matvec at the end (plain 2-norm), since
    `phibar` can drift in float32.
    """
    rhs = rhs.float()
    psolve = (lambda v: v) if precond is None else precond
    y = psolve(rhs)
    beta1_sq = _beta_sq(torch.sum(rhs * y, dim=0))
    beta1 = torch.sqrt(beta1_sq)
    target_sq = (float(tol) ** 2) * beta1_sq
    zeros = torch.zeros_like(rhs)
    zcol = torch.zeros_like(beta1)
    x, r1, r2, w, w2 = zeros, rhs, rhs, zeros, zeros
    oldb, beta, dbar, epsln, phibar = zcol, beta1, zcol, zcol, beta1
    cs, sn = -torch.ones_like(beta1), zcol
    best_x, best_rs = zeros, beta1_sq
    stall = it = 0
    (unmet,) = _read_flags(torch.any(phibar * phibar > target_sq))
    while it < max_iters and stall < PCG_STALL_WINDOW and unmet:
        beta_safe = torch.where(beta > 0.0, beta, 1.0)
        v = y / beta_safe[None, :]
        p = matvec(v)
        # Lanczos three-term recurrence (the first iteration has no r1
        # term).
        if it >= 1:
            oldb_safe = torch.where(oldb > 0.0, oldb, 1.0)
            p = p - (beta / oldb_safe)[None, :] * r1
        alfa = torch.sum(v * p, dim=0)
        p = p - (alfa / beta_safe)[None, :] * r2
        r1, r2 = r2, p
        y = psolve(r2)
        oldb = beta
        beta = torch.sqrt(_beta_sq(torch.sum(r2 * y, dim=0)))
        # The two previous Givens rotations on the new tridiagonal column,
        # then the new rotation that annihilates beta.
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta), _TINY)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps[None, :] * w1 - delta[None, :] * w2) / gamma[None, :]
        x = x + phi[None, :] * w
        rs = phibar * phibar
        improved = rs < best_rs
        best_x = torch.where(improved[None, :], x, best_x)
        best_rs = torch.minimum(rs, best_rs)
        it += 1
        any_improved, unmet = _read_flags(torch.any(improved),
                                        torch.any(rs > target_sq))
        stall = 0 if any_improved else stall + 1
    true_r = rhs - matvec(best_x)
    res_sq = torch.sum(true_r * true_r, dim=0)
    rhs2 = torch.sum(rhs * rhs, dim=0)
    rel = torch.sqrt(torch.max(res_sq / torch.clamp_min(rhs2, 1e-30)))
    return best_x, it, float(rel)


def _block_abs_factors(ypts, valid, *, kernel_name: str):
    """Batched |K_block|^-1 spectral factors of the diagonal kernel blocks.

    ypts (B, leaf, D) blocked points, valid (B, leaf) real-point mask.
    Pad rows and columns are masked to the identity, so pad components
    pass through and are dropped by the scatter.  One spectral path serves
    both regimes: for SPD kernels |K_b| = K_b, and the eigenvalue floor
    max|w| * 1e-6 stands where float32 Cholesky breaks down on blocks of
    low numerical rank; for the indefinite inverse-distance kernel
    |K_b| = V |w| V^T is the SPD surrogate with K_b's eigenbasis that
    preconditioned MINRES needs.  Returns (V, winv), winv = 1 / max(|w|,
    floor).
    """
    k = kernel_matrix(ypts, ypts, kernel_name=kernel_name)
    mask = valid[:, :, None] & valid[:, None, :]
    k = torch.where(mask, k, 0.0)
    k = k + torch.diag_embed(torch.where(valid, 0.0, 1.0))
    with highest_precision():
        w, v = torch.linalg.eigh(k)
    aw = torch.abs(w)
    floor = torch.clamp_min(torch.amax(aw, dim=1, keepdim=True) * 1e-6,
                            _TINY)
    return v, 1.0 / torch.maximum(aw, floor)


def apply_block_abs_jacobi(v, winv, gather, out_pos, x):
    """P^-1 x for the block spectral-absolute-value preconditioner: a
    gather into blocks, two batched matmuls and a scatter back."""
    xb = x.float()[gather]                                  # (B, leaf, E)
    with highest_precision():
        sol = v @ (winv[:, :, None] * (v.transpose(1, 2) @ xb))
    return sol.reshape(-1, x.shape[1])[out_pos]


def _out_positions(gid):
    """Flattened (block, slot) position of each original point."""
    flat_gid = gid.reshape(-1)
    real = flat_gid >= 0
    out_pos = np.empty(int(real.sum()), dtype=np.int64)
    out_pos[flat_gid[real]] = np.nonzero(real)[0]
    return out_pos


def block_jacobi_preconditioner(y, *, kernel_name: str, leaf: int = 512):
    """Block-Jacobi preconditioner over a balanced geometric clustering.

    Clusters the points with the BLR balanced bisection (`ops/blr.py`),
    factors every (leaf, leaf) diagonal kernel block once
    (`_block_abs_factors`) and applies all block solves as batched
    matmuls.  y is a float32 (M, D) tensor; the clustering runs on the
    host, the factors live on y's device.  Returns a
    `functools.partial(apply_block_abs_jacobi, ...)`, the `precond` of
    `cg_solve`.
    """
    device = y.device
    y_host = y.detach().cpu().numpy()
    gather, gid = _cluster(np.asarray(y_host, np.float64), leaf)
    ypts = torch.as_tensor(y_host[gather], dtype=torch.float32,
                           device=device)
    valid = torch.as_tensor(gid >= 0, device=device)
    v, winv = _block_abs_factors(ypts, valid, kernel_name=kernel_name)
    return functools.partial(
        apply_block_abs_jacobi, v, winv,
        torch.as_tensor(gather, dtype=torch.long, device=device),
        torch.as_tensor(_out_positions(gid), device=device))


def block_jacobi_precond_from_arrays(v, winv, gather, out_pos, *, device):
    """The block-Jacobi `precond` from fitted state held as arrays (the JAX
    package's `(V, winv, gather, out_pos)`, for one)."""
    def as_float(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    def as_index(a):
        return torch.tensor(np.asarray(a), dtype=torch.long, device=device)

    return functools.partial(apply_block_abs_jacobi, as_float(v),
                             as_float(winv), as_index(gather),
                             as_index(out_pos))


def nystrom_factors(matvec: Callable, omega, *, method: str = "svd"):
    """Randomised Nystrom factors (U, lam) of an SPD operator from the
    Gaussian test matrix `omega` (m, rank).

    The shift-stabilised algorithm of Frangella, Tropp and Udell
    ("Randomized Nystrom Preconditioning", 2021).  The sketch K @ omega is
    one call of `matvec` with E = rank.  method="svd" orthonormalises
    omega by QR first and takes U from a tall SVD; method="gram" uses only
    (rank, rank) Gram eigendecompositions and tall-skinny matmuls (the
    route of the JAX package's sharded solver).  Returns U (m, rank)
    orthonormal and lam (rank,) >= 0, descending.
    """
    _check_choice("method", method, NYSTROM_METHODS)
    omega = omega.float()
    m = omega.shape[0]
    with highest_precision():
        if method == "svd":
            omega, _ = torch.linalg.qr(omega)
        sketch = matvec(omega.contiguous())                # K @ omega
        # Stabilising shift at the float32 noise scale of the sketch.
        nu = math.sqrt(m) * _EPS * torch.linalg.norm(sketch)
        sketch_nu = sketch + nu * omega
        gram = omega.T @ sketch_nu
        gram = 0.5 * (gram + gram.T)
        # eigh-based inverse square root instead of Cholesky: tolerates
        # the residual indefiniteness a float32 Gram can carry.
        w, v = torch.linalg.eigh(gram)
        w = torch.clamp_min(w, _TINY)
        half = sketch_nu @ (v / torch.sqrt(w)[None, :])    # (m, rank)
        if method == "svd":
            u, s, _ = torch.linalg.svd(half, full_matrices=False)
            return u, torch.clamp_min(s * s - nu, 0.0)
        # half = U diag(s) V^T  =>  half^T half = V s^2 V^T.
        g2 = half.T @ half
        g2 = 0.5 * (g2 + g2.T)
        s2, v2 = torch.linalg.eigh(g2)                     # ascending
        # Clamped relative to the spectrum: an eigenvalue at numerical
        # zero under an absolute floor would give U a garbage column.
        s2 = torch.maximum(s2, torch.clamp_min(_EPS * s2[-1], _TINY))
        u = half @ (v2 / torch.sqrt(s2)[None, :])
        return u.flip(1), torch.clamp_min(s2.flip(0) - nu, 0.0)


def nystrom_preconditioner(matvec: Callable, m: int, rank: int, *, device,
                           method: str = "svd"):
    """Nystrom factors (U, lam) of an SPD operator of size m, from a
    Gaussian test matrix drawn by a torch.Generator seeded with 0 on
    `device` (see `nystrom_factors`)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    omega = torch.randn((m, rank), generator=generator, device=device,
                        dtype=torch.float32)
    return nystrom_factors(matvec, omega, method=method)


def apply_nystrom_precond(u, lam, v):
    """P^-1 v for P = U diag(max(lam, floor)) U^T + floor (I - U U^T).

    The floor is max(lam_r, NYSTROM_REL_FLOOR * lam_0): below it
    (spectra that decay past float32 resolution, as Gaussian kernels' do)
    the preconditioner smoothly becomes the identity instead of dividing
    by near-zero eigenvalues.
    """
    lam_r = torch.clamp_min(
        torch.maximum(lam[-1], NYSTROM_REL_FLOOR * lam[0]), _TINY)
    lam_safe = torch.maximum(lam, lam_r)
    with highest_precision():
        utv = u.T @ v
        return u @ ((lam_r / lam_safe)[:, None] * utv) + (v - u @ utv)


def nystrom_precond_from_arrays(u, lam, *, device):
    """The Nystrom `precond` from fitted factors held as arrays (the JAX
    package's `(U, lam)`, for one)."""
    return functools.partial(
        apply_nystrom_precond,
        torch.tensor(np.asarray(u), dtype=torch.float32, device=device),
        torch.tensor(np.asarray(lam), dtype=torch.float32, device=device))


def f64_residual_matvec(y, *, kernel_name: str):
    """Float64 matvec v -> K v for the outer residual of `ir_solve`.

    On a CUDA device: the plain PyTorch product in float64 on the card.
    On the CPU: the blocked NumPy oracle.  This plain product on the main
    path is no fallback from a kernel: no kernel of the repo computes in
    float64, and the JAX package computes this product on the host,
    outside any kernel.  Both mask the inverse-distance diagonal.
    Takes and returns float64 tensors on y's device.
    """
    y64 = y.detach().double()
    if y64.is_cuda:
        def matvec(v):
            return kernel_matvec_torch(y64, y64, v.double(),
                                       kernel_name=kernel_name)
        return matvec

    y_host = y64.numpy()

    def host_matvec(v):
        return torch.from_numpy(blocked_kernel_product(
            kernel=kernel_name, source_points=y_host,
            source_signal=v.double().numpy()))
    return host_matvec


def ir_solve(y, rhs, *, kernel_name: str, precision: str = "float32",
             tol: float = 1e-9, max_iters: int = 1000,
             inner_tol: float = 1e-5, refine_iters: int = 3,
             matvec: Optional[Callable] = None,
             precond: Optional[Callable] = None,
             indefinite_method: str = "auto",
             inner_solve: Optional[Callable] = None):
    """Mixed-precision iterative-refinement solve of K b = rhs.

    The outer loop keeps the iterate and the true residual in float64
    (`f64_residual_matvec`); each correction K delta = r is solved in
    float32 by `cg_solve`, rescaled to unit column norm, with one
    preconditioner reused across all outer passes.  A pass whose residual
    does not improve ends the loop and keeps the best iterate.
    `inner_solve` (a callable (M, E) float32 rhs -> (delta, iterations,
    residual)) replaces `cg_solve`.

    Returns (b, info): b float64 (M, E) on y's device; info holds the
    outer and inner iteration counts, the float64 relative residual and
    its history.
    """
    residual_matvec = f64_residual_matvec(y, kernel_name=kernel_name)
    rhs64 = torch.as_tensor(rhs, dtype=torch.float64, device=y.device)
    rhs_norms = torch.clamp_min(torch.linalg.vector_norm(rhs64, dim=0),
                                torch.finfo(torch.float64).tiny)
    b64 = torch.zeros_like(rhs64)
    r64 = rhs64
    history = []
    total_inner = 0

    def relative(r):
        return float(torch.max(torch.linalg.vector_norm(r, dim=0)
                               / rhs_norms))

    rel = relative(r64)
    for _ in range(int(refine_iters)):
        if rel <= tol:
            break
        scale = float(torch.max(torch.linalg.vector_norm(r64, dim=0)))
        if scale == 0.0:
            break
        r_scaled = (r64 / scale).float()
        if inner_solve is not None:
            delta, inner_iters, _ = inner_solve(r_scaled)
        else:
            delta, inner_iters, _ = cg_solve(
                y, r_scaled, kernel_name=kernel_name, precision=precision,
                tol=inner_tol, max_iters=max_iters, matvec=matvec,
                precond=precond, indefinite_method=indefinite_method)
        total_inner += int(inner_iters)
        b_new = b64 + delta.double() * scale
        r_new = rhs64 - residual_matvec(b_new)
        rel_new = relative(r_new)
        if rel_new >= rel:
            # The refinement floor (kappa * eps_f32 >= 1): keep the best
            # iterate.  rel starts from the raw rhs, so a diverging first
            # correction never replaces it either.
            history.append(rel_new)
            break
        b64, r64, rel = b_new, r_new, rel_new
        history.append(rel)
    return b64, {
        "outer_iterations": len(history),
        "inner_iterations": total_inner,
        "relative_residual": rel,
        "history": history,
    }


def cg_solve(y, rhs, *, kernel_name: str, precision: str = "float32",
             tol: float = 1e-6, max_iters: int = 1000,
             matvec: Optional[Callable] = None,
             precond: Optional[Callable] = None,
             indefinite_method: str = "auto"):
    """Matrix-free (preconditioned) Krylov solve of K b = rhs.

    SPD kernels run (preconditioned) CG on K.  The indefinite kernel runs
    MINRES on K (one matvec per iteration at condition kappa(K)) or CG on
    the normal equations K^2 b = K rhs (two matvecs per iteration at
    kappa^2).  "auto" routes to MINRES without a preconditioner and to the
    normal equations with one (taken to be Nystrom factors of K^2);
    "minres" with a preconditioner runs preconditioned MINRES, whose
    `precond` must be an SPD M^-1 of K itself (the block-abs Jacobi).

    Returns (b, iterations, relative_residual): the residual is relative
    to the operator iterated on (K for MINRES, from one true-residual
    matvec; K^2 b = K rhs for the normal equations).
    """
    _check_choice("indefinite_method", indefinite_method, INDEFINITE_METHODS)
    if matvec is None:
        matvec = _default_matvec(y, kernel_name=kernel_name,
                                 precision=precision)
    rhs = rhs.float()
    if kernel_name in SPD_KERNELS:
        return _pcg(matvec, rhs, tol, max_iters, precond=precond)
    if indefinite_method == "auto":
        indefinite_method = "minres" if precond is None else "normal"
    if indefinite_method == "minres":
        return _minres(matvec, rhs, tol, max_iters, precond=precond)
    return _pcg(NormalEquationsOp(matvec), matvec(rhs), tol, max_iters,
                precond=precond)
