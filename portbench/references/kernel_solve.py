"""The plain kernel solve of the solve cells: K b = a, with K the Gaussian
kernel matrix k(x_i, x_j) = exp(-|x_i - x_j|^2) of the points.

Written from that definition and from the Nystrom-preconditioned
conjugate gradient of Frangella, Tropp and Udell ("Randomized Nystrom
Preconditioning", 2021, arXiv:2110.02820), in plain PyTorch: nothing of
the program under test, nothing of the JAX package.  Matrix products run
in true float32 or float64 (TF32 off, inside each call).

- `rhs(points, w)`: the right-hand sides a = K w, in float64.
- `residual_terms(points, b, rows)`: (K b)[rows], in float64, from all of
  b.  An answer is judged by its residual K b - a and never against
  K^-1 a: the Gram matrix of a smooth kernel on many points is singular
  to float64, so K^-1 a is not a number the reference could give.
- `control(points, pool, ...)`: the solve one precision below the
  configuration's float32: each kernel value and each vector K is
  applied to rounded to bfloat16, the products summed in float32 (as a
  bfloat16 kernel product keeps its sums), the iterates in float32.

Every product runs in blocks of at most `ENTRIES` kernel values, so that
it fits beside nothing on the card once the program's state is freed;
the control keeps K itself, in bfloat16 (N^2 x 2 bytes: 34 GB at
N = 131072), and applies it in blocks.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench.references.kernel_product import product

ENTRIES = 2**26          # kernel values in one block
# The control's stop rule, the configuration's solver's: the tolerance on
# ||a - K b|| / ||a|| of its float32 iterates, and STALL_WINDOW
# iterations without a new best residual in any column end a solve,
# which returns each column's best iterate.
STALL_WINDOW = 60
# The Nystrom preconditioner's eigenvalue floor, relative to the largest
# eigenvalue of the sketch: below it the preconditioner is the identity.
REL_FLOOR = 1e-4
# The seed of the control's Gaussian test matrix (it is the reference's
# own, whatever the cell's seed).
SKETCH_SEED = 0
EPS32 = float(torch.finfo(torch.float32).eps)


@contextlib.contextmanager
def _no_tf32():
    """Matrix products in true float32 inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rhs(points, w, *, device):
    """(N, S) float64 right-hand sides a = K w for the (N, S) columns w."""
    with _no_tf32():
        return product(points, points, w, kernel="gaussian",
                       normalize_rows=False, device=device)


def residual_terms(points, b, rows, *, device):
    """(R, S) float64 (K b)[rows] of the (N, S) answers b."""
    with _no_tf32():
        return product(points[rows], points, b, kernel="gaussian",
                       normalize_rows=False, device=device)


def _bf16(t):
    """float32 `t` rounded to bfloat16 (to nearest even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _gram_bf16(points, device):
    """K with each value rounded to bfloat16, (N, N), built by blocks of
    rows from float32 points (the squared distance summed by coordinate,
    the exponential in float32)."""
    x = torch.as_tensor(np.ascontiguousarray(points)).to(device,
                                                         torch.float32)
    n = len(x)
    k = torch.empty((n, n), dtype=torch.bfloat16, device=device)
    rows = max(1, ENTRIES // n)
    for r0 in range(0, n, rows):
        xr = x[r0:r0 + rows]
        d2 = None
        for c in range(x.shape[1]):
            diff = xr[:, c:c + 1] - x[:, c][None, :]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        k[r0:r0 + rows] = torch.exp(-d2).to(torch.bfloat16)
    return k


def _apply_bf16(k, v):
    """K v: the bfloat16 K against v rounded to bfloat16, summed in
    float32, (N, E) float32."""
    vb = _bf16(v)
    rows = max(1, ENTRIES // k.shape[1])
    return torch.cat([k[r0:r0 + rows].to(torch.float32) @ vb
                      for r0 in range(0, k.shape[0], rows)])


def _nystrom(apply, n, rank, device):
    """(U, lam) of the randomised Nystrom approximation of K from `apply`
    (Frangella, Tropp and Udell, Algorithm 2.1): a Gaussian test matrix
    omega, orthonormalised and rounded as `apply` rounds it; the sketch
    Y = K omega shifted by nu omega at the float32 noise scale of Y; and
    U, lam from the SVD of Y_nu C^-1, where C^T C = omega^T Y_nu.  The
    inverse square root of omega^T Y_nu comes from its eigendecomposition,
    over the eigenvalues above EPS32 times the largest (a rounded K need
    not be positive semi-definite below that).  The small factors run in
    float64."""
    rng = np.random.default_rng(SKETCH_SEED)
    omega = torch.as_tensor(rng.standard_normal((n, rank)),
                            dtype=torch.float64, device=device)
    omega = _bf16(torch.linalg.qr(omega)[0].float())
    sketch = apply(omega).double()
    omega = omega.double()
    nu = math.sqrt(n) * EPS32 * float(torch.linalg.norm(sketch))
    shifted = sketch + nu * omega
    gram = omega.T @ shifted
    w, v = torch.linalg.eigh(0.5 * (gram + gram.T))
    keep = w > EPS32 * w[-1]
    u, s, _ = torch.linalg.svd(
        shifted @ (v[:, keep] / torch.sqrt(w[keep])[None, :]),
        full_matrices=False)
    return u.float(), torch.clamp_min(s * s - nu, 0.0).float()


def _preconditioner(u, lam):
    """v -> P^-1 v for P = U diag(lam) U^T + lam_r (I - U U^T), with each
    eigenvalue held at or above the floor lam_r = max(lam_last,
    REL_FLOOR lam_0)."""
    floor = max(float(lam[-1]), REL_FLOOR * float(lam[0]),
                float(torch.finfo(torch.float32).tiny))
    scale = floor / torch.clamp_min(lam, floor)

    def apply(v):
        utv = u.T @ v
        return u @ (scale[:, None] * utv) + (v - u @ utv)
    return apply


def _pcg(apply, precond, a, tol, max_iters):
    """Each column of K b = a by preconditioned conjugate gradients, the
    columns side by side; returns each column's best iterate (the
    configuration's stop rule, above)."""
    b = torch.zeros_like(a)
    r = a
    z = precond(r)
    p = z
    rz = (r * z).sum(0)
    rs = (r * r).sum(0)
    target = tol * tol * rs
    best_b, best_rs = b, rs
    it = stall = 0
    while it < max_iters and stall < STALL_WINDOW and bool(
            (rs > target).any()):
        kp = apply(p)
        denom = (p * kp).sum(0)
        alpha = torch.where(denom != 0, rz / denom, 0.0)
        b = b + alpha * p
        r = r - alpha * kp
        z = precond(r)
        rz_new = (r * z).sum(0)
        rs = (r * r).sum(0)
        p = z + torch.where(rz != 0, rz_new / rz, 0.0) * p
        rz = rz_new
        improved = rs < best_rs
        best_b = torch.where(improved[None, :], b, best_b)
        best_rs = torch.minimum(rs, best_rs)
        it += 1
        stall = 0 if bool(improved.any()) else stall + 1
    return best_b


def control(points, pool, *, rank, tol, max_iters, device):
    """(S, N, 1) float64 answers b_s of K b_s = a_s for the pool's (S, N,
    1) right-hand sides, solved jointly in the lower precision of the
    module docstring, Nystrom-preconditioned at `rank`."""
    with _no_tf32():
        k = _gram_bf16(points, device)

        def apply(v):
            return _apply_bf16(k, v)
        u, lam = _nystrom(apply, len(k), min(rank, len(k)), device)
        a = torch.as_tensor(np.ascontiguousarray(
            np.asarray(pool)[:, :, 0].T)).to(device, torch.float32)
        b = _pcg(apply, _preconditioner(u, lam), a, tol, max_iters)
        out = b.double().cpu().numpy().T[:, :, None]
        del k
    return out
