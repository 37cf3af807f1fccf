"""Block-low-rank (BLR) kernel-matrix engine, the twin of kmb_tpu.ops.blr.

The H-matrix slot: a cluster tree over the points, an admissibility rule
that splits the (N, M) kernel matrix into near-field blocks (kept exact)
and far-field blocks (compressed to low rank), and a compressed matvec.

- **Plan** (host, NumPy, copied from the reference): balanced bisection
  into 2^L clusters of `leaf` slots (pads duplicate a real point of their
  block and carry id -1); block pair (i, j) is far-field iff
  dist(c_i, c_j) * eta >= r_i + r_j.  Symmetric operators keep one
  triangle: far factors are stored for i < j and applied transposed for
  (j, i), off-diagonal near tiles are formed once and applied both ways.
- **Compression** (device, the timed build): every far tile is formed on
  the fly and compressed by a randomized range finder shared across
  blocks, U = qr(K @ Omega), V = U^T K, in build segments of
  BUILD_SEGMENT pairs (cap-rank factors of every pair would not fit:
  2 * Pf * leaf * rank * 4 bytes is 17 GB at 131072 points, rank 64).
  The thin QR is LAPACK's Householder QR (`torch.geqrf`, batched), with Q
  formed from the reflectors in compact WY form as batched matmuls
  (`_thin_q`): torch.linalg.qr forms Q one matrix at a time on the card.
  With `epsilon`, the factors are rotated into per-block SVD form through
  the float64 eigendecomposition of the (rank, rank) Gram V V^T on the
  host (LAPACK, as the reference), each block keeps the smallest rank
  meeting ||K_p - U_p V_p||_F <= epsilon ||K_p||_F, and blocks are
  bucketed into power-of-two rank tiers.
- **Matvec** (device): near tiles are recomputed (masked: pad columns,
  pad rows of the symmetric tiles, the global diagonal of a zero-diagonal
  kernel); far blocks are U (V b_j).  Each block pair's contribution goes
  to its own slot of a (Bx, By, leaf, E) buffer that is then summed over
  the source blocks: a fixed summation order, so two matvecs of the same
  input agree bit for bit (a scatter-add on the card adds with atomics in
  a varying order, which would move Krylov iterates from run to run).

Every matmul runs in true float32 (`utils.highest_precision`): at lower
precision the sketch spectra floor near 1e-6 sigma_1^2 and every block
keeps its full rank.  The reference's `_pad_pairs`, `_BlrMatvecStatic`,
`matvec_partial` and `matvec_device` exist for XLA's static shapes and a
TPU transport's compile-payload limit and have no counterpart: Krylov
solvers take `BlrOperator.matvec` as a callable.

Random draws: torch cannot reproduce `jax.random`; the Gaussian test
matrix is drawn from a torch.Generator seeded with `seed` unless an
`omega` is given (`omega_from_array` converts one held as an array).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.ops.kernels import get_kernel
from kmb_tpu_torch.utils import highest_precision

BLR_KERNELS = ("gaussian", "absolute-exponential", "inverse-distance")

# Far pairs compressed per build segment (bounds the cap-rank working set).
BUILD_SEGMENT = 8192
# Near pairs whose (leaf, leaf) tiles are formed at once in a matvec.
NEAR_CHUNK = 2048


# ---------------------------------------------------------------------------
# Host-side planning (cluster tree + admissibility), NumPy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlrPlan:
    """Static geometry of one BLR operator (everything NumPy, host-side)."""

    leaf: int
    eta: float
    same_points: bool
    # gather_x[i, l]: the x row in slot l of block i (pads duplicate a real
    # row); gid_x[i, l]: that row's id, or -1 for pads.
    gather_x: np.ndarray  # (Bx, leaf) int32
    gid_x: np.ndarray  # (Bx, leaf) int32
    # out_pos[t]: flattened (block, slot) position of original target t.
    out_pos: np.ndarray  # (n,) int64
    gather_y: np.ndarray  # (By, leaf) int32
    gid_y: np.ndarray  # (By, leaf) int32
    # Dense (i, j) pairs applied forward only (the diagonal blocks when
    # symmetric, every near pair when not).
    near_pairs: np.ndarray  # (Pn, 2) int32
    # Symmetric off-diagonal near pairs, i < j, applied both ways.
    near_sym_pairs: np.ndarray  # (Ps, 2) int32
    # Compressed pairs; i < j when symmetric (mirrored at matvec time).
    far_pairs: np.ndarray  # (Pf, 2) int32

    @property
    def num_x_blocks(self) -> int:
        return self.gather_x.shape[0]

    @property
    def num_y_blocks(self) -> int:
        return self.gather_y.shape[0]


def _cluster(points: np.ndarray, leaf: int) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced bisection into 2^L equal blocks of `leaf` slots.

    Recursive bisection along the widest axis of each block (a stable sort
    of its coordinates, the first half taking the extra point).  Returns
    (gather, gid), both (B, leaf) int32; pads duplicate the block's own
    first point and carry gid == -1.
    """
    n = points.shape[0]
    num_blocks = 1
    while num_blocks * leaf < n:
        num_blocks *= 2
    blocks = [np.arange(n, dtype=np.int64)]
    while len(blocks) < num_blocks:
        nxt = []
        for idx in blocks:
            pts = points[idx]
            axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
            order = np.argsort(pts[:, axis], kind="stable")
            half = (len(idx) + 1) // 2
            nxt.append(idx[order[:half]])
            nxt.append(idx[order[half:]])
        blocks = nxt
    gather = np.zeros((num_blocks, leaf), dtype=np.int32)
    gid = np.full((num_blocks, leaf), -1, dtype=np.int32)
    for i, idx in enumerate(blocks):
        k = len(idx)
        if not 0 < k <= leaf:
            raise ValueError(f"block {i} holds {k} points, not 1..{leaf}")
        gather[i, :k] = idx
        gid[i, :k] = idx
        gather[i, k:] = idx[0]  # pads sit on a real point of this block
    return gather, gid


def _centers_radii(points, gather, gid):
    """Per-block bounding centers and radii over the real points (pads
    coincide with real points, so they never inflate a radius)."""
    del gid
    pts = points[gather]  # (B, leaf, D)
    lo, hi = pts.min(axis=1), pts.max(axis=1)
    return 0.5 * (lo + hi), 0.5 * np.linalg.norm(hi - lo, axis=1)


def build_plan(x: np.ndarray, y: np.ndarray, *, leaf: int = 256,
               eta: float = 2.0, same_points: bool = False) -> BlrPlan:
    """Cluster both clouds and split block pairs by admissibility."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    gather_x, gid_x = _cluster(x, leaf)
    if same_points:
        gather_y, gid_y = gather_x, gid_x
    else:
        gather_y, gid_y = _cluster(y, leaf)

    cx, rx = _centers_radii(x, gather_x, gid_x)
    cy, ry = _centers_radii(y, gather_y, gid_y)
    dist = np.linalg.norm(cx[:, None, :] - cy[None, :, :], axis=2)
    admissible = dist * eta >= (rx[:, None] + ry[None, :])

    far = np.argwhere(admissible).astype(np.int32)
    near = np.argwhere(~admissible).astype(np.int32)
    if same_points:
        # Admissibility is symmetric: keep one triangle.  Diagonal blocks
        # (dist == 0, never admissible) stay in the forward-only list.
        far = far[far[:, 0] < far[:, 1]]
        near_sym = near[near[:, 0] < near[:, 1]]
        near = near[near[:, 0] == near[:, 1]]
    else:
        near_sym = np.zeros((0, 2), dtype=np.int32)

    out_pos = np.empty(x.shape[0], dtype=np.int64)
    flat_gid = gid_x.reshape(-1)
    real = flat_gid >= 0
    out_pos[flat_gid[real]] = np.nonzero(real)[0]

    return BlrPlan(leaf=leaf, eta=float(eta), same_points=bool(same_points),
                   gather_x=gather_x, gid_x=gid_x, out_pos=out_pos,
                   gather_y=gather_y, gid_y=gid_y,
                   near_pairs=near, near_sym_pairs=near_sym, far_pairs=far)


def select_block_ranks(sv2: np.ndarray, epsilon: float) -> np.ndarray:
    """Per-block rank from the epsilon criterion (host-side, NumPy).

    Smallest r with ||K_p - (U_p V_p)[:r]||_F <= epsilon * ||K_p||_F,
    estimated from the sketch spectrum: residual^2 after keeping r
    components is total - cumsum(sv2)[r-1].  Blocks whose total energy
    is ~0 get rank 0 (dropped from the operator entirely).
    """
    sv2 = np.asarray(sv2, dtype=np.float64)
    total = sv2.sum(axis=1, keepdims=True)
    captured_needed = (1.0 - float(epsilon) ** 2) * total
    ranks = 1 + np.argmax(np.cumsum(sv2, axis=1) >= captured_needed - 1e-30,
                          axis=1)
    # argmax returns 0 when no prefix satisfies the bound -> full rank.
    satisfied = (np.cumsum(sv2, axis=1) >= captured_needed - 1e-30).any(axis=1)
    ranks = np.where(satisfied, ranks, sv2.shape[1])
    return np.where(total[:, 0] > 0.0, ranks, 0).astype(np.int64)


def _rank_tiers(ranks: np.ndarray, rank_max: int):
    """Bucket per-block ranks into power-of-two tiers.

    Returns [(tier_rank, indices)] covering every block with rank >= 1;
    rank-0 blocks are dropped (their best approximation is zero).
    """
    tiers = []
    tier = 1
    levels = []
    while tier < rank_max:
        levels.append(tier)
        tier *= 2
    levels.append(rank_max)
    lo = 1
    for level in levels:
        idx = np.nonzero((ranks >= lo) & (ranks <= level))[0]
        if idx.size:
            tiers.append((level, idx.astype(np.int64)))
        lo = level + 1
    return tiers


# ---------------------------------------------------------------------------
# Device-side tiles, compression, matvec
# ---------------------------------------------------------------------------


def _kernel_tile(spec, xb, yb):
    """(P, leaf, leaf) float32 kernel values of P block pairs (unmasked).

    xb, yb (P, leaf, D).  Squared-distance kernels at D <= 32 take the
    unrolled difference sum (non-negative by construction): near tiles
    hold arbitrarily close pairs, and the BLAS form |x|^2+|y|^2-2<x,y>
    cancels to <= 0 in float32 for pairs closer than ~sqrt(eps)|x|, which
    turns the singular inverse-distance kernel into inf/NaN on real
    entries.  Above D = 32 the BLAS form (the difference tensor would be
    (leaf, leaf, D)).  The form is the kernel zoo's scaled, signed one.
    """
    xb = xb * spec.point_scale
    yb = yb * spec.point_scale
    if spec.on == "dot":
        with highest_precision():
            form = xb @ yb.mT
        form = -form if spec.form_sign < 0 else form
    elif xb.shape[-1] <= 32:
        sqd = None
        for k in range(xb.shape[-1]):
            diff = xb[..., :, k, None] - yb[..., None, :, k]
            term = diff * diff
            sqd = term if sqd is None else sqd + term
        form = -sqd if spec.form_sign < 0 else sqd
    else:
        with highest_precision():
            dots = xb @ yb.mT
        xsq = torch.sum(xb * xb, dim=-1, keepdim=True)
        ysq = torch.sum(yb * yb, dim=-1)[..., None, :]
        if spec.form_sign < 0:
            form = 2.0 * dots - xsq - ysq
        else:
            form = xsq + ysq - 2.0 * dots
    return spec.scaled_fn(form)


class _Stopwatch:
    """Seconds per named build step; synchronises the card around a step,
    so a step's time is its finished device work."""

    def __init__(self, device):
        self.device = device
        self.seconds = {"qr": 0.0, "eigh": 0.0}

    def __call__(self, key, fn, *args):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[key] += time.perf_counter() - t0
        return out


def _untimed(key, fn, *args):
    del key
    return fn(*args)


def _thin_q(a):
    """Q (P, n, k) of the Householder QR of a batch a (P, n, k), n >= k.

    LAPACK's geqrf reflectors, combined in compact WY form (the forward,
    columnwise T of LAPACK's larft: H_1 ... H_k = I - Y T Y^T), so Q is
    two batched matmuls.  The same Q as orgqr's, up to rounding.
    """
    h, tau = torch.geqrf(a)
    p, n, k = h.shape
    eye = torch.eye(n, k, dtype=a.dtype, device=a.device)
    y = torch.tril(h, -1) + eye          # unit lower trapezoidal
    with highest_precision():
        s = y.mT @ y                     # (P, k, k)
        t = torch.zeros((p, k, k), dtype=a.dtype, device=a.device)
        for j in range(k):
            t[:, j, j] = tau[:, j]
            if j:
                t[:, :j, j] = -tau[:, j, None] * (
                    t[:, :j, :j] @ s[:, :j, j, None])[..., 0]
        return eye - y @ (t @ y[:, :k, :].mT)


def draw_test_matrix(leaf: int, rank: int, seed: int = 0, *, device):
    """The (leaf, rank) Gaussian test matrix shared by every far block,
    from a torch.Generator on `device` seeded with `seed`."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return torch.randn((leaf, rank), generator=generator, device=device,
                       dtype=torch.float32)


def omega_from_array(omega, *, device):
    """A test matrix held as an array (the JAX package's draw, for one) as
    a float32 tensor on `device`."""
    return torch.tensor(np.asarray(omega), dtype=torch.float32,
                        device=device)


def compress_far_blocks(xpts, ypts, far_i, far_j, *, kernel_name: str,
                        rank: int, seed: int = 0, omega=None,
                        step=_untimed):
    """Randomized range-finder factors of the far block pairs (far_i,
    far_j).

    xpts/ypts (B, leaf, D) blocked points; omega the (leaf, rank) test
    matrix (drawn with `seed` when None).  Returns U (P, leaf, rank) and
    V (P, rank, leaf) with K_ij ~= U_p V_p.  The sketch and the projection
    V = U^T K are true float32: V is the stored factor, and its noise
    floors every block's sketch spectrum.
    """
    spec = get_kernel(kernel_name)
    if omega is None:
        omega = draw_test_matrix(xpts.shape[1], rank, seed,
                                 device=xpts.device)
    k_tile = _kernel_tile(spec, xpts[far_i], ypts[far_j])
    with highest_precision():
        q = step("qr", _thin_q, k_tile @ omega)
        return q, q.mT @ k_tile


def compress_far_blocks_svd(xpts, ypts, far_i, far_j, *, kernel_name: str,
                            rank: int, seed: int = 0, omega=None,
                            step=_untimed):
    """Range-finder factors rotated into per-block SVD form.

    The (rank, rank) Grams V V^T (float32 on the device) are
    eigendecomposed in float64 on the host; the rotation U <- U W,
    V <- W^T V orders each block's factor rows by decreasing singular
    value, so the first r rows and columns are the best rank-r
    approximation the sketch supports.  Returns (U, V, sv2), sv2 (P, rank)
    the squared singular values, descending, float32 on the device.
    """
    u, v = compress_far_blocks(xpts, ypts, far_i, far_j,
                               kernel_name=kernel_name, rank=rank, seed=seed,
                               omega=omega, step=step)
    w, rot = step("eigh", _host_eigh, _batched_gram(v))
    sv2 = np.maximum(w[:, ::-1], 0.0)                   # descending
    rot = torch.as_tensor(np.ascontiguousarray(rot[:, :, ::-1]),
                          dtype=torch.float32, device=u.device)
    u, v = _rotate_factors(u, v, rot)
    return u, v, torch.as_tensor(sv2, dtype=torch.float32, device=u.device)


def _batched_gram(v):
    """(P, rank, leaf) factors -> (P, rank, rank) Grams V V^T."""
    with highest_precision():
        return v @ v.mT


def _rotate_factors(u, v, rot):
    """Batched rotation into SVD form: U <- U R, V <- R^T V."""
    with highest_precision():
        return u @ rot, rot.mT @ v


def _host_eigh(gram):
    """Stacked float64 LAPACK eigendecomposition (ascending) of float32
    Grams on any device."""
    return np.linalg.eigh(gram.detach().cpu().numpy().astype(np.float64))


def blr_matvec_blocks(xpts, ypts, gid_x, gid_y, far_groups, mirror_groups,
                      b_blocks, near, near_sym, *, kernel_name: str,
                      num_x_blocks: int, mask_diagonal: bool):
    """Blocked BLR matvec: returns (num_x_blocks * leaf, E), blocked order.

    b_blocks (By, leaf, E) carries zeros in pad rows.  `near` is the pair
    (near_i, near_j) of forward-only near pairs; `near_sym` the pair of
    symmetric i < j near pairs (None when not symmetric), each tile formed
    once and applied as K_ij b_j and K_ij^T b_i.  `far_groups` holds one
    (u, v, far_j, far_i) per rank tier, applied as u (v b_j) into block
    far_i; `mirror_groups` one (far_i, far_j) per tier for a symmetric
    operator (the same factors applied transposed, v^T (u^T b_i) into
    block far_j), or nothing.
    """
    if len(mirror_groups) not in (0, len(far_groups)):
        raise ValueError(
            f"{len(mirror_groups)} mirror groups for {len(far_groups)} far "
            "groups: a symmetric operator mirrors every tier")
    spec = get_kernel(kernel_name)
    num_y_blocks, leaf, e = b_blocks.shape
    # Slot (i, j) holds block pair (i, j)'s contribution to target block i.
    out = b_blocks.new_zeros((num_x_blocks, num_y_blocks, leaf, e))

    def near_tiles(i, j, rows_too):
        k_tile = _kernel_tile(spec, xpts[i], ypts[j])
        valid = (gid_y[j] >= 0)[:, None, :]
        if rows_too:
            valid = valid & (gid_x[i] >= 0)[:, :, None]
        if mask_diagonal:
            valid = valid & (gid_x[i][:, :, None] != gid_y[j][:, None, :])
        return torch.where(valid, k_tile, 0.0)

    with highest_precision():
        near_i, near_j = near
        for s in range(0, near_i.shape[0], NEAR_CHUNK):
            i, j = near_i[s:s + NEAR_CHUNK], near_j[s:s + NEAR_CHUNK]
            out[i, j] = near_tiles(i, j, False) @ b_blocks[j]
        if near_sym is not None:
            # Pad rows are masked too: the transposed application turns
            # them into columns.
            sym_i, sym_j = near_sym
            for s in range(0, sym_i.shape[0], NEAR_CHUNK):
                i, j = sym_i[s:s + NEAR_CHUNK], sym_j[s:s + NEAR_CHUNK]
                k_tile = near_tiles(i, j, True)
                out[i, j] = k_tile @ b_blocks[j]
                out[j, i] = k_tile.mT @ b_blocks[i]
        for u, v, far_j, far_i in far_groups:
            out[far_i, far_j] = u @ (v @ b_blocks[far_j])
        for (u, v, _, _), (far_i, far_j) in zip(far_groups, mirror_groups):
            out[far_j, far_i] = v.mT @ (u.mT @ b_blocks[far_i])
    return out.sum(dim=1).reshape(num_x_blocks * leaf, e)


# ---------------------------------------------------------------------------
# High-level operator
# ---------------------------------------------------------------------------


class BlrOperator:
    """Built BLR approximation of K(x, y): plan plus device-side factors.

    `rank` alone: every far block stores fixed-rank factors.  With
    `epsilon`, `rank` is the per-block cap and each block keeps the
    smallest rank meeting the epsilon Frobenius criterion, in
    power-of-two tiers.  x, y are host arrays; the factors live on
    `device` ("cuda" by default; it raises without a card).
    `step_seconds` holds the build's QR and eigh seconds.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, *, kernel_name: str,
                 leaf: int = 256, rank: int = 16, eta: float = 2.0,
                 epsilon: Optional[float] = None, same_points: bool = False,
                 seed: int = 0, omega=None, device="cuda"):
        if kernel_name not in BLR_KERNELS:
            raise NotImplementedError(
                f"BLR supports {BLR_KERNELS}, not {kernel_name!r} "
                "(Euclidean admissibility needs a squared-distance kernel).")
        self.device = dev = resolve_device(device)
        rank = int(min(rank, leaf))
        self.kernel_name = kernel_name
        self.rank = rank
        self.epsilon = None if epsilon is None else float(epsilon)
        self.plan = plan = build_plan(
            np.asarray(x), np.asarray(y), leaf=leaf, eta=eta,
            same_points=same_points)
        self.n = int(np.asarray(x).shape[0])
        self.m = int(np.asarray(y).shape[0])

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=dev)

        xf = np.asarray(x, dtype=np.float32)
        yf = xf if same_points else np.asarray(y, dtype=np.float32)
        self.xpts = torch.as_tensor(xf[plan.gather_x], device=dev)
        self.ypts = (self.xpts if same_points
                     else torch.as_tensor(yf[plan.gather_y], device=dev))
        self.gid_x = index(plan.gid_x)
        self.gid_y = self.gid_x if same_points else index(plan.gid_y)
        self.gather_y = index(plan.gather_y)
        self.out_pos = index(plan.out_pos)
        self._near = (index(plan.near_pairs[:, 0]),
                      index(plan.near_pairs[:, 1]))
        self._near_sym = ((index(plan.near_sym_pairs[:, 0]),
                           index(plan.near_sym_pairs[:, 1]))
                          if same_points else None)
        self.omega = (draw_test_matrix(leaf, rank, seed, device=dev)
                      if omega is None else omega_from_array(omega,
                                                             device=dev))
        if tuple(self.omega.shape) != (leaf, rank):
            raise ValueError(f"omega is {tuple(self.omega.shape)}, not "
                             f"{(leaf, rank)}")
        self._build(index(plan.far_pairs[:, 0]), index(plan.far_pairs[:, 1]))

    def _build(self, far_i, far_j):
        """Compress every far pair, BUILD_SEGMENT pairs at a time."""
        watch = _Stopwatch(self.device)
        kw = dict(kernel_name=self.kernel_name, rank=self.rank,
                  omega=self.omega, step=watch)
        symmetric = self.plan.same_points
        tiers: dict = {}
        ranks = []
        for s in range(0, far_i.shape[0], BUILD_SEGMENT):
            i, j = far_i[s:s + BUILD_SEGMENT], far_j[s:s + BUILD_SEGMENT]
            if self.epsilon is None:
                u, v = compress_far_blocks(self.xpts, self.ypts, i, j, **kw)
                tiers.setdefault(self.rank, []).append((u, v, j, i))
                ranks.append(np.full(i.shape[0], self.rank, np.int64))
                continue
            # Cut each segment's cap-rank factors down to its tiers before
            # the next segment is built.
            u, v, sv2 = compress_far_blocks_svd(self.xpts, self.ypts, i, j,
                                                **kw)
            seg_ranks = select_block_ranks(sv2.cpu().numpy(), self.epsilon)
            ranks.append(seg_ranks)
            for tier_rank, idx in _rank_tiers(seg_ranks, self.rank):
                sel = torch.as_tensor(idx, device=self.device)
                tiers.setdefault(tier_rank, []).append((
                    u[sel, :, :tier_rank], v[sel, :tier_rank, :], j[sel],
                    i[sel]))
            del u, v
        self.block_ranks = (np.concatenate(ranks) if ranks
                            else np.zeros(0, dtype=np.int64))
        groups = []
        for tier_rank in sorted(tiers):
            groups.append(tuple(torch.cat([part[k] for part in
                                           tiers[tier_rank]])
                                for k in range(4)))
        self.far_groups = tuple(groups)
        self.mirror_groups = (tuple((g[3], g[2]) for g in groups)
                              if symmetric else ())
        self.step_seconds = watch.seconds

    def block_signal(self, b) -> torch.Tensor:
        """(M, E) signal -> (By, leaf, E) blocked, pad rows zeroed."""
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        blocked = b[self.gather_y]
        return torch.where((self.gid_y >= 0)[:, :, None], blocked, 0.0)

    def matvec_blocked(self, b_blocks) -> torch.Tensor:
        """Blocked-signal matvec, result in blocked target order."""
        return blr_matvec_blocks(
            self.xpts, self.ypts, self.gid_x, self.gid_y, self.far_groups,
            self.mirror_groups, b_blocks, self._near, self._near_sym,
            kernel_name=self.kernel_name,
            num_x_blocks=self.plan.num_x_blocks,
            mask_diagonal=get_kernel(self.kernel_name).zero_diagonal)

    def unblock(self, out_blocked) -> torch.Tensor:
        """Blocked target order -> original (N, E) order."""
        return out_blocked[self.out_pos]

    def matvec(self, b) -> torch.Tensor:
        """(M, E) -> (N, E) on the operator's device."""
        return self.unblock(self.matvec_blocked(self.block_signal(b)))

    @property
    def compression(self) -> float:
        """Dense-entry count over stored plus recomputed entry count.

        Mirrored factors and symmetric near tiles count once, so symmetry
        shows up here as about 2x.  (The reference also counts its
        chunk-padding pairs, which the port does not have: the two agree
        when the far pairs fill its 64-pair chunks.)
        """
        leaf = self.plan.leaf
        tiles = (self.plan.near_pairs.shape[0]
                 + self.plan.near_sym_pairs.shape[0])
        stored = (sum(u.numel() + v.numel() for u, v, _, _ in self.far_groups)
                  + tiles * leaf * leaf)
        return float(self.n) * float(self.m) / float(max(stored, 1))
