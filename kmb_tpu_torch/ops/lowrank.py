"""Approximate kernel products: Nystrom and random features.

The twin of kmb_tpu.ops.lowrank.  Two global low-rank schemes built from
dense matmuls (the JAX package runs them as XLA ops outside any Pallas
kernel, so here they are plain PyTorch ops on whatever device the tensors
are on):

1. **Nystrom**: `rank` landmark points L of y and
       K(x, y) ~= K(x, L) W^+ K(L, y),     W = K(L, L),
   W^+ a clipped eigendecomposition pseudo-inverse.  A product query is two
   (tall, rank) matmuls.  `nystrom_solver_build` / `nystrom_solver_apply`
   solve the ridge system (lam I + K_hat) b = a through the Woodbury
   identity.
2. **Random features**: an explicit map phi with E[phi(x)^T phi(y)] =
   k(x, y), so K @ b ~= Phi_x (Phi_y^T b): random Fourier features for
   "gaussian" (omega ~ N(0, 2 I)) and "absolute-exponential" (omega from
   the isotropic Cauchy), positive Performer features for "exponential".

Neither scheme takes the singular "inverse-distance" kernel.  Row
normalisation (attention) and density estimation ride a ones column
appended to the signal.

Random draws: torch cannot reproduce `jax.random`, so the landmarks and the
feature frequencies are inputs of the functions that use them; the draws
here (`select_landmarks`, `random_feature_params`) use a torch.Generator
seeded with `seed`, and the `*_from_arrays` converters take fitted state
held as arrays (the JAX package's, for one).

Every matmul, eigendecomposition and Cholesky factor runs in true float32
(`utils.highest_precision`, TF32 off), as the reference's
Precision.HIGHEST.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kmb_tpu_torch.utils import highest_precision

LOWRANK_KERNELS = ("gaussian", "absolute-exponential", "exponential")
# Rows per block of `feature_apply_streamed`.
STREAM_BLOCK = 16384


def _check_kernel(kernel_name: str):
    if kernel_name not in LOWRANK_KERNELS:
        raise NotImplementedError(
            f"Low-rank approximation does not support {kernel_name!r} "
            f"(supported: {LOWRANK_KERNELS}).")


def _generator(seed: int, device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


def _as_float(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _cross_kernel(x, landmarks, kernel_name: str):
    """Dense (n, r) kernel block K(x, L), r small.

    The squared distance takes the BLAS form max(|x|^2 + |l|^2 - 2 x.l, 0),
    as the reference does.
    """
    with highest_precision():
        if kernel_name == "exponential":
            return torch.exp(x @ landmarks.T)
        xsq = torch.sum(x * x, dim=1, keepdim=True)
        lsq = torch.sum(landmarks * landmarks, dim=1)[None, :]
        sqd = torch.clamp_min(xsq + lsq - 2.0 * (x @ landmarks.T), 0.0)
    if kernel_name == "gaussian":
        return torch.exp(-sqd)
    return torch.exp(-torch.sqrt(sqd))  # absolute-exponential


def select_landmarks(y, rank: int, seed: int = 0):
    """`rank` landmark rows of y, uniformly without replacement, in index
    order (a torch.Generator on y's device seeded with `seed`)."""
    m = y.shape[0]
    rank = min(int(rank), m)
    idx = torch.randperm(m, generator=_generator(seed, y.device),
                         device=y.device)[:rank]
    return y[torch.sort(idx).values]


def nystrom_core(landmarks, kernel_name: str, rcond: float = 1e-6):
    """Clipped pseudo-inverse factor of W = K(L, L).

    Returns (u, inv_lam) with W^+ = u diag(inv_lam) u^T; eigenvalues at or
    below rcond * max|lam| get inverse 0.
    """
    w = _cross_kernel(landmarks, landmarks, kernel_name)
    with highest_precision():
        lam, u = torch.linalg.eigh(w)
    cutoff = rcond * torch.max(torch.abs(lam))
    keep = lam > cutoff
    inv_lam = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
    return u, inv_lam


def nystrom_factors(x, y, landmarks, kernel_name: str):
    """The two tall-skinny cross blocks K(x, L) (n, r) and K(y, L) (m, r)."""
    return (_cross_kernel(x, landmarks, kernel_name),
            _cross_kernel(y, landmarks, kernel_name))


def nystrom_factor(x, landmarks, kernel_name: str):
    """One cross block K(x, L): targets and sources share it when they are
    the same points."""
    return _cross_kernel(x, landmarks, kernel_name)


def _augment(b, m, device):
    """[b, 1] (m, E+1); b None (density estimation) is a ones column."""
    ones = torch.ones((m, 1), dtype=torch.float32, device=device)
    if b is None:
        b = ones
    return torch.cat([b.float(), ones], dim=1)


def _finish(out, *, normalize_rows, density_estimation):
    num, den = out[:, :-1], out[:, -1:]
    if density_estimation:
        return den
    if normalize_rows:
        return num / den
    return num


def nystrom_apply(zx, zy, u, inv_lam, b, *, normalize_rows=False,
                  density_estimation=False):
    """a ~= K(x, L) W^+ K(L, y) b, row sums from a ones column.

    zx (n, r) = K(x, L); zy (m, r) = K(y, L); (u, inv_lam) from
    `nystrom_core`; b (m, E), or None for density estimation.
    """
    if density_estimation and normalize_rows:
        return torch.ones((zx.shape[0], 1), dtype=torch.float32,
                          device=zx.device)
    b_aug = _augment(b, zy.shape[0], zy.device)
    with highest_precision():
        t = zy.T @ b_aug                                  # (r, E+1)
        s = u @ (inv_lam[:, None] * (u.T @ t))            # W^+ t
        out = zx @ s                                      # (n, E+1)
    return _finish(out, normalize_rows=normalize_rows,
                   density_estimation=density_estimation)


def nystrom_solver_build(y, landmarks, kernel_name: str,
                         rcond: float = 1e-6):
    """Woodbury workspace of the Nystrom ridge solver.

    K_hat = C C^T with C = K(y, L) u diag(inv_lam)^(1/2) (m, r), and the
    (r, r) Gram G = C^T C.  Returns (C, G).
    """
    u, inv_lam = nystrom_core(landmarks, kernel_name, rcond=rcond)
    z = _cross_kernel(y, landmarks, kernel_name)          # (m, r)
    with highest_precision():
        c = z @ (u * torch.sqrt(inv_lam)[None, :])
        gram = c.T @ c                                    # (r, r)
    return c, gram


def nystrom_solver_apply(c, gram, rhs, lam):
    """(lam I + C C^T)^-1 rhs through Woodbury; rhs (m, E), lam > 0.

    (lam I + C C^T)^-1 a = (a - C (lam I_r + G)^-1 C^T a) / lam, the inner
    system solved by its Cholesky factor (NaN where float32 Cholesky breaks
    down, as the reference's assume_a="pos" solve gives it).
    """
    r = gram.shape[0]
    rhs = rhs.float()
    with highest_precision():
        inner = lam * torch.eye(r, dtype=gram.dtype, device=gram.device)
        factor, info = torch.linalg.cholesky_ex(inner + gram)
        factor = torch.where(info == 0, factor, math.nan)
        t = c.T @ rhs                                     # (r, E)
        s = torch.cholesky_solve(t, factor)
        return (rhs - c @ s) / lam


def random_feature_params(dimension: int, kernel_name: str,
                          num_features: int, seed: int = 0, *, device):
    """Spectral parameters (omega (D, F), phase (F,) or None) of the
    feature map, drawn on `device` from a torch.Generator seeded with
    `seed`.  phase is None for the positive "exponential" features."""
    _check_kernel(kernel_name)
    gen = _generator(seed, device)
    shape = (int(dimension), int(num_features))

    def normal(size):
        return torch.randn(size, generator=gen, device=device,
                           dtype=torch.float32)

    if kernel_name == "exponential":
        return normal(shape), None
    if kernel_name == "gaussian":
        # exp(-|x - y|^2): the RBF with gamma = 1, omega ~ N(0, 2 I).
        omega = math.sqrt(2.0) * normal(shape)
    else:
        # absolute-exponential: the isotropic Cauchy, z / |g|.
        z = normal(shape)
        g = normal((1, shape[1]))
        omega = z / torch.clamp_min(torch.abs(g), 1e-20)
    phase = 2.0 * math.pi * torch.rand(shape[1], generator=gen,
                                       device=device, dtype=torch.float32)
    return omega, phase


def random_features_from_arrays(omega, phase, *, device):
    """(omega, phase) held as arrays (the JAX package's draw, for one) as
    float32 tensors on `device`; phase may be None."""
    return (_as_float(omega, device),
            None if phase is None else _as_float(phase, device))


def _feature_block(omega, phase, pts):
    """Phi of one block of points: (blk, D) -> (blk, F)."""
    pts = pts.float()
    num_features = omega.shape[1]
    with highest_precision():
        proj = pts @ omega
    if phase is None:
        log_phi = proj - 0.5 * torch.sum(pts * pts, dim=1, keepdim=True)
        return torch.exp(log_phi) / math.sqrt(float(num_features))
    return math.sqrt(2.0 / num_features) * torch.cos(proj + phase)


def random_feature_map(points, kernel_name: str, num_features: int,
                       seed: int = 0):
    """(n, F) feature matrix Phi with E[Phi(x) Phi(y)^T] = K(x, y), its
    parameters drawn on the points' device (`random_feature_params`)."""
    omega, phase = random_feature_params(
        points.shape[1], kernel_name, num_features, seed=seed,
        device=points.device)
    return _feature_block(omega, phase, points)


def feature_apply(phi_x, phi_y, b, *, normalize_rows=False,
                  density_estimation=False):
    """a ~= Phi_x (Phi_y^T [b, 1]): two matmuls, row sums from the ones
    column."""
    if density_estimation and normalize_rows:
        return torch.ones((phi_x.shape[0], 1), dtype=torch.float32,
                          device=phi_x.device)
    b_aug = _augment(b, phi_y.shape[0], phi_y.device)
    with highest_precision():
        out = phi_x @ (phi_y.T @ b_aug)
    return _finish(out, normalize_rows=normalize_rows,
                   density_estimation=density_estimation)


def feature_apply_streamed(omega, phase, x, y, b, *, normalize_rows=False,
                           density_estimation=False, block=STREAM_BLOCK):
    """`feature_apply` without materialising Phi_x or Phi_y.

    Streams y, then x, in blocks of `block` rows through the feature map:
    O(block F) memory instead of O((n + m) F).  The (F, E+1) bridge
    t = Phi_y^T [b, 1] accumulates block by block in a plain loop (the
    reference's lax.scan); the last block is short, so no pad row reaches
    the sum.
    """
    n, m = x.shape[0], y.shape[0]
    if density_estimation and normalize_rows:
        return torch.ones((n, 1), dtype=torch.float32, device=x.device)
    b_aug = _augment(b, m, y.device)
    t = torch.zeros((omega.shape[1], b_aug.shape[1]), dtype=torch.float32,
                    device=y.device)
    with highest_precision():
        for s in range(0, m, block):
            phi = _feature_block(omega, phase, y[s:s + block])
            t = t + phi.T @ b_aug[s:s + block]
        out = torch.cat([_feature_block(omega, phase, x[s:s + block]) @ t
                         for s in range(0, n, block)], dim=0)
    return _finish(out, normalize_rows=normalize_rows,
                   density_estimation=density_estimation)


def nystrom_from_arrays(landmarks, u, inv_lam, zx, zy, *, device):
    """Fitted Nystrom product state (landmarks, u, inv_lam, zx, zy) held as
    arrays (the JAX package's, for one) as float32 tensors on `device`."""
    return tuple(_as_float(a, device)
                 for a in (landmarks, u, inv_lam, zx, zy))


def nystrom_solver_from_arrays(c, gram, *, device):
    """Fitted Nystrom solver state (C, G) held as arrays as float32 tensors
    on `device`."""
    return _as_float(c, device), _as_float(gram, device)
