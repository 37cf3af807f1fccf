"""Sharded kernel products and solves over torch.distributed process groups.

The port of kmb_tpu/parallel/sharded.py, with one process per card (see
parallel/multihost.py).  Where the JAX package lets XLA place shards and
insert collectives inside shard_map, each rank here holds its own shard as
a plain tensor and the collectives are explicit: NCCL between cards, gloo
between CPU processes (the tests).  Nothing falls back from NCCL to
anything else: a mesh on the card needs an NCCL group, and a failed
collective raises.

Schedules:

- "allpairs" (2-D mesh (tgt, src)): rank (ti, si) computes the deferred
  combination state of target shard ti against source shard si with the
  local engine (`ops/product.kernel_matvec`: the CUDA kernels on the card,
  the plain PyTorch version on the CPU); one reduction over its target
  row's group then gives the full rows.
- "ring" (1-D mesh): targets, sources and signal are all sharded on one
  axis; the (y, b) shards rotate to rank + 1 (`dist.batch_isend_irecv`)
  while each rank folds the visiting chunk into its running state.  The
  rotation is posted before the chunk's kernel launch, so the transfer
  overlaps the kernel; two buffers keep a chunk in flight from being
  overwritten.

Every collective goes through one of five `Mesh` methods (`allreduce`,
`src_allreduce`, `rotate`, `gather_rows`, `publish`); inside
`record_collectives(mesh)` each call is tallied (op, group, dtype, shape,
bytes, query), the port's counterpart of the collectives comm.py reads out
of XLA's HLO (kmb_tpu_torch/comm.py).  Outside it a call costs one None
check.

Both use the engines' deferred state and global-offset contract
(ops/product.py): row and column offsets and limits, the diagonal mask at
global positions, (num, den) and base-2 (acc, m, l) states merged across
shards.  Every rank ends with the whole (N, E) result (an all_gather inside
the call), as JAX's replicated output.

The distributed CG solver runs the port's Krylov loops (ops/solve.py) on
each rank's rows, with the ring product as the matvec and every dot
product summed over the mesh through the loops' `allreduce` hook, so every
rank takes the same branch at every iteration.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kmb_tpu_torch import resolve_device
from kmb_tpu_torch.ops.kernels import get_kernel
from kmb_tpu_torch.ops.product import (
    kernel_matvec, merge_flash_states as _merge_flash_splits)
from kmb_tpu_torch.ops.solve import (
    SPD_KERNELS, NormalEquationsOp, _minres, _pcg, apply_nystrom_precond,
    nystrom_factors)
from kmb_tpu_torch.trace import span

ROW_MULTIPLE = 8   # shards are padded to a multiple of p * 8 rows, as in JAX


def _ceil_to(n, k):
    return -(-n // k) * k


# -- meshes ---------------------------------------------------------------

# Process groups made for meshes, by (default group, ranks).  Every rank
# builds the same meshes in the same order, so every rank finds or creates
# the same groups in the same order, as dist.new_group needs.
_GROUPS = {}


def _group(ranks):
    """The process group over `ranks` (None: the default group)."""
    if len(ranks) == dist.get_world_size():
        return None
    key = (id(dist.group.WORLD), tuple(ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


class CollectiveRecorder:
    """The collectives a mesh issued while `record_collectives` was on: one
    entry per call, with the op (the torch.distributed call), its group
    ("mesh", "source axis" or "world"), the dtype, shape and bytes of the
    tensor this rank handed in (for a rotation: the one it sent), and the
    query it belongs to (`queries` counts the sharded products begun)."""

    def __init__(self):
        self.calls = []
        self.queries = 0

    def add(self, op, group, t):
        self.calls.append(dict(
            op=op, group=group, dtype=str(t.dtype).replace("torch.", ""),
            shape=list(t.shape), bytes=t.numel() * t.element_size(),
            query=self.queries))


@contextlib.contextmanager
def record_collectives(mesh):
    """Tally the collectives `mesh` issues inside the block; yields the
    `CollectiveRecorder`."""
    recorder = CollectiveRecorder()
    previous, mesh.recorder = mesh.recorder, recorder
    try:
        yield recorder
    finally:
        mesh.recorder = previous


class Mesh:
    """Ranks laid out as a 1-D mesh (JAX's "shard" axis) or a 2-D (target,
    source) mesh (JAX's ("tgt", "src")), the counterpart of
    jax.sharding.Mesh with one process per card.

    `ranks` are global ranks in row-major mesh order, so rank ranks[i] sits
    at (i // ps, i % ps) on a 2-D mesh, as jax.make_mesh places devices.
    Without a process group the mesh is this process alone and every
    collective is the identity.  `device` is where this rank's shards live.
    """

    def __init__(self, shape, ranks, device):
        self.shape = tuple(int(s) for s in shape)
        self.ranks = tuple(ranks)
        self.device = device
        self.distributed = dist.is_initialized()
        rank = dist.get_rank() if self.distributed else 0
        self.world = dist.get_world_size() if self.distributed else 1
        self.member = rank in self.ranks
        self.index = self.ranks.index(rank) if self.member else None
        self.group = _group(self.ranks) if self.distributed else None
        self.recorder = None   # a CollectiveRecorder while recording
        # 2-D: every target row's group, for the source-axis reductions;
        # none is needed (or made) when a row holds one rank.
        self.src_group = None
        if len(self.shape) == 2 and self.distributed and self.shape[1] > 1:
            ps = self.shape[1]
            rows = [_group(self.ranks[t * ps:(t + 1) * ps])
                    for t in range(self.shape[0])]
            if self.member:
                self.src_group = rows[self.index // ps]

    @property
    def size(self):
        return len(self.ranks)

    @property
    def coords(self):
        """This rank's position: (index,) on a 1-D mesh, (ti, si) on 2-D."""
        if len(self.shape) == 1:
            return (self.index,)
        return divmod(self.index, self.shape[1])

    def allreduce(self, t, op=dist.ReduceOp.SUM):
        """`t` reduced over the whole mesh, in place (the solvers' hook)."""
        if self.distributed:
            if self.recorder is not None:
                self.recorder.add("all_reduce", "mesh", t)
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def src_allreduce(self, t, op=dist.ReduceOp.SUM):
        """`t` reduced over this rank's target row (2-D meshes)."""
        if self.src_group is not None:
            if self.recorder is not None:
                self.recorder.add("all_reduce", "source axis", t)
            dist.all_reduce(t, op=op, group=self.src_group)
        return t

    def rotate(self, send, recv):
        """Post the ring rotation: `send` to the next rank, `recv` from the
        previous one.  Returns the requests to wait on."""
        p = self.size
        if self.recorder is not None:
            self.recorder.add("batch_isend_irecv", "mesh", send)
        ops = [dist.P2POp(dist.isend, send, self.ranks[(self.index + 1) % p],
                          self.group),
               dist.P2POp(dist.irecv, recv, self.ranks[(self.index - 1) % p],
                          self.group)]
        return dist.batch_isend_irecv(ops)

    def gather_rows(self, local, n):
        """The full (n, E) result on every rank of the mesh from each
        target shard's rows (JAX's replicated output, `_slice_rows`)."""
        if not self.distributed:
            return local[:n]
        if self.recorder is not None:
            self.recorder.add("all_gather", "mesh", local)
        with span("mesh.gather"):
            parts = [torch.empty_like(local) for _ in range(self.size)]
            dist.all_gather(parts, local.contiguous(), group=self.group)
            if len(self.shape) == 2:   # one copy of each target shard
                parts = parts[::self.shape[1]]
            return torch.cat(parts)[:n]

    def publish(self, t):
        """A mesh over some of the ranks: its result, sent from its first
        rank to every rank of the world (the others pass a buffer of the
        result's shape).  The identity when the mesh is the world."""
        if self.distributed and self.size < self.world:
            if self.recorder is not None:
                self.recorder.add("broadcast", "world", t)
            with span("mesh.publish"):
                dist.broadcast(t, src=self.ranks[0])
        return t


def make_mesh(shape=None, ranks=None, *, device="cuda"):
    """A mesh over `ranks` (default: every rank of the process group, or
    this process alone without one).

    Defaults to a 1-D mesh over them; shape=(pt, ps) gives the 2-D
    (target, source) layout of the all-pairs schedule.  On the card the
    process group must be NCCL and this rank's card is the one
    multihost.initialize bound; on the CPU it must be gloo.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        want = "nccl" if dev.type == "cuda" else "gloo"
        if backend != want:
            raise RuntimeError(
                f"a mesh on {dev.type} needs a {want} process group; this "
                f"process's group is {backend}")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        world = dist.get_world_size()
    else:
        world = 1
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if shape is None:
        shape = (len(ranks),)
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{int(np.prod(shape))} ranks, got {len(ranks)}")
    return Mesh(shape, ranks, dev)


def shard_rows(a, parts, index, device):
    """Rows index * L : (index + 1) * L of `a` (an array or tensor), padded
    with zero rows to `parts` * L rows, L = ceil(rows, parts * 8) / parts;
    float32 on `device`.  Only this shard is copied to the device."""
    t = torch.as_tensor(a)
    rows = _ceil_to(t.shape[0], parts * ROW_MULTIPLE) // parts
    lo = index * rows
    local = t[lo:lo + rows].to(device=device, dtype=torch.float32)
    return F.pad(local, (0, 0, 0, rows - local.shape[0])).contiguous()


# -- deferred-state algebra -------------------------------------------------

def merge_flash_states(a, b):
    """Exactly merge two base-2 flash (acc, m, l) states over disjoint
    sources: the split merge of ops/product.py on the pair."""
    return _merge_flash_splits(*(torch.stack(pair) for pair in zip(a, b)))


def combine_flash_psum(state, reduce):
    """Merge flash states across ranks: `reduce(t, op)` (an all-reduce over
    the ranks holding the other sources) of m with MAX, then one SUM of
    the rescaled acc and l."""
    acc, m, l = state
    m_g = reduce(m.clone(), dist.ReduceOp.MAX)
    scale = torch.exp2(m - m_g)
    sums = reduce(torch.cat([acc * scale, l * scale], dim=1),
                  dist.ReduceOp.SUM)
    return sums[:, :-1], m_g, sums[:, -1:]


def _combine_direct_psum(state, reduce):
    """Sum direct (num, den) states across ranks in one `reduce`."""
    num, den = state
    if den is None:
        return reduce(num.clone(), dist.ReduceOp.SUM), None
    sums = reduce(torch.cat([num, den], dim=1), dist.ReduceOp.SUM)
    return sums[:, :-1], sums[:, -1:]


def finalize(state, use_flash, normalize_rows, density_estimation):
    """The finished rows of a merged deferred state."""
    if use_flash:
        acc, _, l = state
        # Guard padded (fully masked) rows, whose normaliser is 0.
        return acc / torch.where(l > 0.0, l, 1.0)
    num, den = state  # den is None for a plain product (engine contract)
    if density_estimation and not normalize_rows:
        return den if den is not None else num
    if normalize_rows:
        return num / den
    return num


def _merge_direct(a, b):
    """Sum two deferred (num, den) states; den may be None on both."""
    return a[0] + b[0], None if a[1] is None else a[1] + b[1]


def fold(state, part, use_flash):
    """Fold a chunk's deferred state into the running one (None at the
    start: the first chunk's state is taken as it is)."""
    if state is None:
        return part
    return merge_flash_states(state, part) if use_flash else _merge_direct(
        state, part)


def uses_flash(kernel_name, normalize_rows):
    """Whether the engine returns base-2 flash states (attention rows of a
    kernel with a log form) rather than direct (num, den) ones."""
    return (normalize_rows
            and get_kernel(kernel_name).scaled_log2_fn is not None)


# -- all-pairs schedule (2-D mesh, one reduction over the source axis) -----

def allpairs_block(xs, ys, bs, *, ti, si, n, m, kernel_name,
                   normalize_rows=False, density_estimation=False,
                   precision="float32", block_n=None):
    """Deferred state of target shard `ti` against source shard `si` (JAX's
    `shard_fn` body, sharded.py:180-194); xs and ys are those shards."""
    return kernel_matvec(
        xs, ys, bs, kernel_name=kernel_name, normalize_rows=normalize_rows,
        density_estimation=density_estimation, precision=precision,
        block_n=block_n, deferred=True,
        row_offset=ti * xs.shape[0], col_offset=si * ys.shape[0],
        col_limit=m, row_limit=n)


def allpairs_shard(xs, ys, bs, *, mesh, n, m, kernel_name,
                   normalize_rows=False, density_estimation=False,
                   precision="float32", block_n=None):
    """This rank's finished rows of target shard ti, all sources merged
    over its target row."""
    ti, si = mesh.coords
    state = allpairs_block(
        xs, ys, bs, ti=ti, si=si, n=n, m=m, kernel_name=kernel_name,
        normalize_rows=normalize_rows, density_estimation=density_estimation,
        precision=precision, block_n=block_n)
    use_flash = uses_flash(kernel_name, normalize_rows)
    combine = combine_flash_psum if use_flash else _combine_direct_psum
    state = combine(state, mesh.src_allreduce)
    return finalize(state, use_flash, normalize_rows, density_estimation)


# -- ring schedule (1-D mesh, rotation to rank + 1) -------------------------

def ring_chunk(xs, y_chunk, b_chunk, *, me, step, p, n, m, kernel_name,
               normalize_rows=False, density_estimation=False,
               precision="float32", block_n=None):
    """Deferred state of rank `me`'s rows against the chunk it holds at
    ring step `step`: the source shard of rank (me - step) mod p (JAX's
    `compute`, sharded.py:226-235).  Shards have xs.shape[0] target and
    y_chunk.shape[0] source rows."""
    owner = (me - step) % p
    return kernel_matvec(
        xs, y_chunk, b_chunk, kernel_name=kernel_name,
        normalize_rows=normalize_rows, density_estimation=density_estimation,
        precision=precision, block_n=block_n, deferred=True,
        row_offset=me * xs.shape[0], col_offset=owner * y_chunk.shape[0],
        col_limit=m, row_limit=n)


def ring_shard(xs, ys, bs, *, mesh, n, m, kernel_name, normalize_rows=False,
               density_estimation=False, precision="float32", block_n=None):
    """This rank's finished rows: every source chunk folded in ring order.

    p - 1 rotations of the packed (y | b) chunk; the last chunk is consumed
    without being forwarded.  Each rotation is posted before the chunk's
    kernel is launched and waited for before the received chunk is read.
    p = 1 is the plain engine call.  Spans: `ring.step` per chunk, with
    `ring.post`, the chunk's `matvec`, `ring.fold` and `ring.wait` (the
    wait for the rotation, which NCCL queues on the stream) in it.
    """
    kw = dict(n=n, m=m, kernel_name=kernel_name,
              normalize_rows=normalize_rows,
              density_estimation=density_estimation, precision=precision,
              block_n=block_n)
    use_flash = uses_flash(kernel_name, normalize_rows)
    p, me = mesh.size, mesh.index
    if p == 1:
        state = ring_chunk(xs, ys, bs, me=0, step=0, p=1, **kw)
        return finalize(state, use_flash, normalize_rows, density_estimation)
    d = ys.shape[1]
    cur = torch.cat([ys, bs], dim=1)
    nxt = torch.empty_like(cur)
    state = None
    for step in range(p):
        with span("ring.step"):
            requests = []
            if step < p - 1:
                with span("ring.post"):
                    requests = mesh.rotate(cur, nxt)
            part = ring_chunk(xs, cur[:, :d], cur[:, d:], me=me, step=step,
                              p=p, **kw)
            with span("ring.fold"):
                state = fold(state, part, use_flash)
            if requests:
                with span("ring.wait"):
                    for request in requests:
                        request.wait()
        cur, nxt = nxt, cur
    return finalize(state, use_flash, normalize_rows, density_estimation)


def virtual_ring_product(x, y, b, *, p, kernel_name, normalize_rows=False,
                         density_estimation=False, precision="float32"):
    """The ring schedule's arithmetic for p virtual ranks in this process
    (no communication): every rank's chunks in ring order through
    `ring_chunk` and `fold`, each chunk's points and signal the halves of
    its packed (y | b) buffer as `ring_shard` passes them, the finished
    rows concatenated.  It checks the per-shard work of p cards on one;
    x, y and b are global tensors."""
    kw = dict(n=len(x), m=len(y), kernel_name=kernel_name,
              normalize_rows=normalize_rows,
              density_estimation=density_estimation, precision=precision)
    use_flash = uses_flash(kernel_name, normalize_rows)
    d = y.shape[1]
    rows = []
    for me in range(p):
        xs = shard_rows(x, p, me, x.device)
        state = None
        for step in range(p):
            owner = (me - step) % p
            cur = torch.cat([shard_rows(t, p, owner, x.device)
                             for t in (y, b)], dim=1)
            part = ring_chunk(xs, cur[:, :d], cur[:, d:], me=me, step=step,
                              p=p, **kw)
            state = fold(state, part, use_flash)
        rows.append(finalize(state, use_flash, normalize_rows,
                             density_estimation))
    return torch.cat(rows)[:len(x)]


def virtual_allpairs_product(x, y, b, *, pt, ps, kernel_name,
                             normalize_rows=False, density_estimation=False,
                             precision="float32"):
    """The all-pairs schedule's arithmetic on a virtual (pt, ps) grid in
    this process: each target shard's `allpairs_block` states folded over
    the source shards.  As `virtual_ring_product`."""
    kw = dict(n=len(x), m=len(y), kernel_name=kernel_name,
              normalize_rows=normalize_rows,
              density_estimation=density_estimation, precision=precision)
    use_flash = uses_flash(kernel_name, normalize_rows)
    rows = []
    for ti in range(pt):
        xs = shard_rows(x, pt, ti, x.device)
        state = None
        for si in range(ps):
            part = allpairs_block(xs, shard_rows(y, ps, si, x.device),
                                  shard_rows(b, ps, si, x.device), ti=ti,
                                  si=si, **kw)
            state = fold(state, part, use_flash)
        rows.append(finalize(state, use_flash, normalize_rows,
                             density_estimation))
    return torch.cat(rows)[:len(x)]


# -- the product on global arrays --------------------------------------------

def shard_layout(mesh, schedule):
    """((shards, index) of the target rows, (shards, index) of the source
    rows) that this rank holds under `schedule`."""
    if schedule == "allpairs":
        (ti, si), (pt, ps) = mesh.coords, mesh.shape
        return (pt, ti), (ps, si)
    return (mesh.size, mesh.index), (mesh.size, mesh.index)


def product_shard(xs, ys, bs, *, mesh, schedule, **kwargs):
    """`allpairs_shard` or `ring_shard` by schedule."""
    if mesh.recorder is not None:
        mesh.recorder.queries += 1
    if schedule == "allpairs":
        return allpairs_shard(xs, ys, bs, mesh=mesh, **kwargs)
    if schedule == "ring":
        return ring_shard(xs, ys, bs, mesh=mesh, **kwargs)
    raise ValueError(f"Unknown schedule {schedule!r}.")


def _sharded_product(x, y, b, *, mesh, schedule, kernel_name,
                     normalize_rows=False, density_estimation=False,
                     precision="float32", block_n=None, block_m=None):
    del block_m   # the kernels choose their own tiles
    n, m = len(x), len(y)
    if density_estimation and normalize_rows:
        return torch.ones((n, 1), dtype=torch.float32, device=mesh.device)
    if b is None:
        b = torch.ones((m, 1), dtype=torch.float32)
    targets, sources = shard_layout(mesh, schedule)
    xs = shard_rows(x, *targets, mesh.device)
    ys = shard_rows(y, *sources, mesh.device)
    bs = shard_rows(b, *sources, mesh.device)
    out = product_shard(xs, ys, bs, mesh=mesh, schedule=schedule, n=n, m=m,
                        kernel_name=kernel_name, normalize_rows=normalize_rows,
                        density_estimation=density_estimation,
                        precision=precision, block_n=block_n)
    return mesh.gather_rows(out, n)


def allpairs_kernel_matvec(x, y, b, *, mesh: Mesh, kernel_name: str,
                           **kwargs):
    """Sharded product on a 2-D (tgt, src) mesh with one reduction.  x, y
    and b are global (every rank passes them); every rank gets the (N, E)
    result."""
    return _sharded_product(x, y, b, mesh=mesh, schedule="allpairs",
                            kernel_name=kernel_name, **kwargs)


def ring_kernel_matvec(x, y, b, *, mesh: Mesh, kernel_name: str, **kwargs):
    """Ring-scheduled product on a 1-D mesh (ring attention, generalised);
    n and m may differ.  Arguments as `allpairs_kernel_matvec`."""
    return _sharded_product(x, y, b, mesh=mesh, schedule="ring",
                            kernel_name=kernel_name, **kwargs)


def sharded_kernel_matvec(x, y, b, *, mesh: Mesh, schedule="auto", **kwargs):
    """Dispatch on mesh shape: 2-D -> all-pairs, 1-D -> ring."""
    if schedule == "auto":
        schedule = "allpairs" if len(mesh.shape) == 2 else "ring"
    if schedule not in ("allpairs", "ring"):
        raise ValueError(f"Unknown schedule {schedule!r}.")
    return _sharded_product(x, y, b, mesh=mesh, schedule=schedule, **kwargs)


# -- distributed CG -------------------------------------------------------------

class RingMatvec:
    """K @ v on this rank's rows: the ring product of the padded source
    shard with itself, rows and columns past `m` masked to zero."""

    def __init__(self, y_local, *, mesh, kernel_name, precision, m):
        self.y = y_local
        self.mesh = mesh
        self.kernel_name = kernel_name
        self.precision = precision
        self.m = m

    def __call__(self, v):
        return ring_shard(self.y, self.y, v, mesh=self.mesh, n=self.m,
                          m=self.m, kernel_name=self.kernel_name,
                          precision=self.precision)


class ShardedNystromApply:
    """P^-1 v of the Nystrom preconditioner on this rank's rows of U and
    v; U^T v is summed over the mesh."""

    def __init__(self, u, lam, mesh):
        self.u = u
        self.lam = lam
        self.mesh = mesh

    def __call__(self, v):
        return apply_nystrom_precond(self.u, self.lam, v,
                                     allreduce=self.mesh.allreduce)


class PreparedCG(NamedTuple):
    matvec: RingMatvec
    m_pad: int
    precond: Optional[ShardedNystromApply]


def prepare_sharded_cg(y, *, mesh: Mesh, kernel_name: str,
                       precision: str = "float32", precond_rank: int = 0,
                       omega=None):
    """Stage this rank's padded source shard and build the ring matvec;
    with `precond_rank > 0` also the Nystrom preconditioner
    (`build_sharded_precond`).  Padded rows and columns of K are masked to
    zero, so CG in padded space iterates as on the unpadded problem:
    padded residual rows start and stay zero."""
    m = len(y)
    m_pad = _ceil_to(m, mesh.size * ROW_MULTIPLE)
    y_local = shard_rows(y, mesh.size, mesh.index, mesh.device)
    matvec = RingMatvec(y_local, mesh=mesh, kernel_name=kernel_name,
                        precision=precision, m=m)
    prepared = PreparedCG(matvec, m_pad, None)
    if precond_rank > 0:
        prepared = build_sharded_precond(
            prepared, kernel_name=kernel_name, precond_rank=precond_rank,
            omega=omega)
    return prepared


def draw_test_matrix(m_pad, rank, device):
    """The global (m_pad, rank) Gaussian test matrix of the sharded Nystrom
    sketch, from a torch.Generator seeded with 0 on `device`: the draw of
    the single-card build (ops/solve.nystrom_preconditioner) when
    m_pad == m."""
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    return torch.randn((m_pad, rank), generator=generator, device=device,
                       dtype=torch.float32)


def build_sharded_precond(prepared, *, kernel_name: str, precond_rank: int,
                          omega=None):
    """Attach Nystrom factors built from the ring matvec (method "gram":
    tall-skinny matmuls summed over the mesh and (rank, rank) eighs) to
    `prepared`.  The sketch operator is K for SPD kernels and K^2 (normal
    equations) for the indefinite one.  Each rank keeps its rows of the
    global test matrix `omega` (m_pad, rank) (default: `draw_test_matrix`)
    and gets its rows of U."""
    matvec = prepared.matvec
    mesh = matvec.mesh
    rank = min(int(precond_rank), matvec.m)
    op = (matvec if kernel_name in SPD_KERNELS
          else NormalEquationsOp(matvec))
    if omega is None:
        omega = draw_test_matrix(prepared.m_pad, rank, mesh.device)
    omega_local = shard_rows(omega, mesh.size, mesh.index, mesh.device)
    u, lam = nystrom_factors(op, omega_local, method="gram",
                             m=prepared.m_pad, allreduce=mesh.allreduce)
    return prepared._replace(precond=ShardedNystromApply(u, lam, mesh))


def sharded_precond_from_arrays(u, lam, *, mesh: Mesh):
    """The sharded Nystrom apply from global factors held as arrays (the
    JAX package's (U, lam), U with m_pad rows): each rank keeps its rows."""
    return ShardedNystromApply(
        shard_rows(u, mesh.size, mesh.index, mesh.device),
        torch.as_tensor(np.asarray(lam), dtype=torch.float32,
                        device=mesh.device), mesh)


def cg_solve_shard(prepared, rhs_local, *, kernel_name: str,
                   tol: float = 1e-6, max_iters: int = 1000):
    """Solve on this rank's rows of the padded rhs; returns (its rows of
    b, iterations, relative residual), the last two equal on every rank.

    Routed as the single-card solver: PCG for SPD kernels; for the
    indefinite kernel CG on the normal equations with the (K^2) Nystrom
    factors, MINRES on K without them.
    """
    matvec, _, precond = prepared
    reduce = matvec.mesh.allreduce
    if kernel_name in SPD_KERNELS:
        return _pcg(matvec, rhs_local, tol, max_iters, precond=precond,
                    allreduce=reduce)
    if precond is not None:
        return _pcg(NormalEquationsOp(matvec), matvec(rhs_local), tol,
                    max_iters, precond=precond, allreduce=reduce)
    return _minres(matvec, rhs_local, tol, max_iters, allreduce=reduce)


def sharded_cg_solve(y, rhs, *, mesh: Mesh, kernel_name: str,
                     precision: str = "float32", tol: float = 1e-6,
                     max_iters: int = 1000, schedule: str = "ring",
                     precond_rank: int = 0, prepared=None, omega=None):
    """Matrix-free (preconditioned) Krylov solve whose matvec is the ring
    product.  y and rhs are global; every rank gets the (M, E) solution.

    `prepared` (from `prepare_sharded_cg`) reuses the staged shard and the
    preconditioner across solves.  Returns (b, iterations, residual).
    """
    del schedule  # the ring schedule is the memory-scalable CG matvec
    if prepared is None:
        prepared = prepare_sharded_cg(
            y, mesh=mesh, kernel_name=kernel_name, precision=precision,
            precond_rank=precond_rank, omega=omega)
    rhs_local = shard_rows(rhs, mesh.size, mesh.index, mesh.device)
    b, iters, residual = cg_solve_shard(prepared, rhs_local,
                                        kernel_name=kernel_name, tol=tol,
                                        max_iters=max_iters)
    return mesh.gather_rows(b, len(y)), iters, residual
