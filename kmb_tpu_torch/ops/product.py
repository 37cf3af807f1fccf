"""Streaming kernel-matrix product a = K(x, y) @ b without storing K.

The twin of kmb_tpu.ops.product.  Three functions:

- `kernel_matvec_torch`: the plain PyTorch version, the twin of
  `kernel_matvec_xla`.  It streams `block_n` target rows at a time, works in
  any float dtype (float64 serves as the ground truth) and on any device.
- `kernel_matvec_cuda`: the same contract on the two hand-written CUDA
  kernels of `csrc/` (the direct kernel and the base-2 flash kernel,
  entry points in `csrc/product.cu`).  CUDA float32 tensors only.  One
  launch per call at any signal width: up to 8 columns the signal
  products run on the FP32 units; above 8 (the wide mode) each tile of
  kernel values is multiplied by a staged signal tile on the tensor cores,
  in blocks of 16, 64 or 256 columns at D <= 8 (each kernel value computed
  once per launch up to E = 256) and of 16 or 32 at D > 8 (64 too in the
  bfloat16 tier) along the launch's grid (`signal_plan`,
  `stage_wide_signal`).
- `kernel_matvec`: the dispatch.  CUDA tensors go to the kernels, CPU
  tensors to the plain version; nothing falls back from one to the other.

The contract (kmb_tpu/ops/product.py:663-810):

- `normalize_rows`: attention semantics, out_i = sum_j k_ij b_j / sum_j k_ij.
  Kernels with a log form use the base-2 online softmax (flash); the others
  divide by the row sums.
- `density_estimation`: b is all ones (and may be None); with
  normalize_rows the answer is all ones and nothing is computed.
- `mask_diagonal`: defaults to the spec's `zero_diagonal`; masks the global
  diagonal row_offset + i == col_offset + j.
- `row_offset`, `col_offset`, `col_limit`, `row_limit`: the global position
  of this block of the problem; global columns >= col_limit and global rows
  >= row_limit contribute nothing.
- `deferred`: return the raw combination state, (num, den | None) for the
  direct scheme (den only when something reads row sums) or (acc, m, l) for
  flash, with m a base-2 logit.
- `precision`: "float32" and "float32x3", f32-accurate (the kernel forms
  large-D dot products, and wide signal products, in 3xTF32 on the tensor
  cores, see `tf32_split`); "bfloat16", where the signal and each kernel
  value are rounded to bf16 before the product, with f32 accumulation.
  The points are rounded to
  bf16 only at D > 8, where the form runs on the tensor cores; at D <= 8
  the form takes the f32 points, as the Pallas kernel's VPU form does
  (kmb_tpu/ops/product.py:525-538).
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.ops.kernels import KernelSpec, get_kernel
from kmb_tpu_torch.trace import count, span

FLASH_NEG_INF = -1e30
PRECISIONS = ("float32", "float32x3", "bfloat16")
INT32_MAX = 2**31 - 1

# Kernel ids of csrc/common.cuh (enum KernelId).
_CUDA_KERNEL_ID = {"gaussian": 0, "absolute-exponential": 1,
                   "inverse-distance": 2, "exponential": 3}
_NARROW_WIDTHS = (1, 2, 4, 8)  # signal columns of the narrow mode
_WIDE_BLOCKS = (16, 64, 256)    # signal columns per E block, wide mode, D <= 8
# ... at D > 8, by tier (csrc/large_d_wide.cuh, supported_eb: 64 columns of
# 3xTF32 leave its consumers no registers).
_WIDE_BLOCKS_LARGE_D = {False: (16, 32), True: (16, 32, 64)}
# The wide mode's float32 tiers: the order of the source columns within
# each group of 8 in the staged signal (csrc/wide.cuh).
WIDE_TF32_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# Source columns per tile of the small-D wide kernel (csrc/small_d_wide.cuh,
# kTile): its signal is staged in whole tiles, each contiguous.
WIDE_TILE = 32
# The large-D wide kernel's signal: padded to whole groups of 128 bytes of
# source columns in both tiers (64 bf16 values), for its TMA loads.
TMA_SIGNAL_ALIGN = 64
_MIN_FILL = 0.9  # column splits fill at least this share of every wave
_MIN_SPLIT_COLUMNS = 512  # ... but give no split fewer source columns


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision {precision!r} is not one of {PRECISIONS}")


def _needs_den(spec: KernelSpec, normalize_rows, density_estimation,
               b_was_none):
    """Row sums are accumulated only when something reads them."""
    use_flash = normalize_rows and spec.scaled_log2_fn is not None
    return (not use_flash) and (
        normalize_rows or (density_estimation and not b_was_none))


def _finalize_direct(num, den, *, needs_den, normalize_rows,
                     density_estimation, deferred):
    if deferred:
        return num, (den if needs_den else None)
    if density_estimation and not normalize_rows:
        # With an implicit ones signal num IS the row sum.
        return den if needs_den else num
    if normalize_rows:
        return num / den
    return num


def kernel_matvec_torch(x, y, b, *, kernel_name: str,
                        normalize_rows: bool = False,
                        mask_diagonal: Optional[bool] = None,
                        density_estimation: bool = False,
                        precision: str = "float32",
                        block_n: int = 1024,
                        deferred: bool = False,
                        row_offset=0, col_offset=0, col_limit=INT32_MAX,
                        row_limit=INT32_MAX):
    """Plain PyTorch product with the full contract (see module docstring).

    Computes in float64 when x is float64, else in float32.  At D <= 8 the
    squared distance uses the cancellation-safe difference form; above, the
    expanded form |x|^2 + |y|^2 - 2<x, y> (one matmul per block).
    """
    spec = get_kernel(kernel_name)
    _check_precision(precision)
    if mask_diagonal is None:
        mask_diagonal = spec.zero_diagonal
    n, d = x.shape
    m = y.shape[0]
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    device = x.device

    if density_estimation and normalize_rows and not deferred:
        return torch.ones((n, 1), dtype=work, device=device)
    b_was_none = b is None
    if b_was_none:
        b = torch.ones((m, 1), dtype=work, device=device)

    bf16 = precision == "bfloat16"

    def rounded(t):
        return t.to(torch.bfloat16).to(work) if bf16 else t

    def points(t):
        t = t.to(work) * spec.point_scale
        return rounded(t) if d > 8 else t

    x = points(x)
    y = points(y)
    b = rounded(b.to(work))
    sign = spec.form_sign
    use_flash = normalize_rows and spec.scaled_log2_fn is not None
    needs_den = _needs_den(spec, normalize_rows, density_estimation,
                           b_was_none)

    cols = col_offset + torch.arange(m, device=device)
    col_bad = cols >= col_limit
    if spec.on == "sqdist" and d > 8:
        ysq = torch.sum(y * y, dim=1)

    parts = []
    for start in range(0, n, block_n):
        xb = x[start:start + block_n]
        if spec.on == "dot":
            form = sign * (xb @ y.T)
        elif d <= 8:
            form = None
            for k in range(d):
                diff = xb[:, k:k + 1] - y[:, k]
                term = diff * diff
                if sign < 0:
                    form = -term if form is None else form - term
                else:
                    form = term if form is None else form + term
        else:
            xsq = torch.sum(xb * xb, dim=1, keepdim=True)
            dots = xb @ y.T
            if sign < 0:
                form = 2.0 * dots - xsq - ysq
            else:
                form = xsq + ysq - 2.0 * dots

        rows = row_offset + torch.arange(start, start + xb.shape[0],
                                         device=device)
        invalid = col_bad[None, :] | (rows >= row_limit)[:, None]
        if mask_diagonal:
            invalid = invalid | (rows[:, None] == cols[None, :])
        if use_flash:
            # Base-2 logits: deferred states merge with the CUDA kernel's
            # and the JAX package's.
            logits = spec.scaled_log2_fn(form).masked_fill(
                invalid, FLASH_NEG_INF)
            mx = torch.amax(logits, dim=1, keepdim=True)
            p = torch.exp2(logits - mx).masked_fill(invalid, 0.0)
            parts.append((rounded(p) @ b, mx,
                          torch.sum(p, dim=1, keepdim=True)))
        else:
            k = spec.scaled_fn(form).masked_fill(invalid, 0.0)
            parts.append((rounded(k) @ b,
                          torch.sum(k, dim=1, keepdim=True)))

    if use_flash:
        acc, mx, l = (torch.cat(p) for p in zip(*parts))
        if deferred:
            return acc, mx, l
        return acc / l
    num, den = (torch.cat(p) for p in zip(*parts))
    return _finalize_direct(num, den, needs_den=needs_den,
                            normalize_rows=normalize_rows,
                            density_estimation=density_estimation,
                            deferred=deferred)


def _check_operand(name, t, device, rows=None, cols=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device or not t.is_cuda:
        raise ValueError(f"{name} must lie on {device}, not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, not {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {rows}")
    if cols is not None and t.shape[1] != cols:
        raise ValueError(f"{name} has {t.shape[1]} columns, expected {cols}")


def _as_int32(name, value):
    value = int(value)
    if not -INT32_MAX - 1 <= value <= INT32_MAX:
        raise ValueError(f"{name}={value} does not fit the kernels' int32")
    return value


def _ptr(t):
    return None if t is None else t.data_ptr()


def tf32_split(t):
    """Split float32 `t` into TF32 parts hi = tf32(t), lo = tf32(t - hi).

    The plain version of the split that the large-D kernel does in
    registers for the float32 tiers: it forms <x, y> as
    lo.hi + hi.lo + hi.hi on the tensor cores (3xTF32), each product of
    TF32 parts exact in f32, and hi + lo equals t to within 2^-22
    relative.  TF32 rounding keeps 10 mantissa bits, ties away from zero
    (an add and a mask on the bits, as the kernel does it).  Inf stays
    inf with lo = 0; NaN stays NaN; a finite value past TF32's largest
    finite value rounds to inf (with lo = 0).
    """
    t = t.float().contiguous()

    def rounded(v):
        bits = torch.bitwise_and(v.view(torch.int32) + 0x1000, ~0x1FFF)
        return torch.where(torch.isnan(v), v, bits.view(torch.float32))

    hi = rounded(t)
    lo = torch.where(torch.isfinite(hi), t - hi, torch.zeros_like(t))
    return hi, rounded(lo)


def tf32_planes(points, rows):
    """The first `rows` staged points (`_stage_points`, rows of whole 16
    bytes) as the large-D wide kernel's float32-tier operand: (2, rows, D),
    their TF32 hi parts then their lo parts (`tf32_split`).  The kernel's
    TMA loads take y's chunks from both planes into its 3xTF32 product
    (csrc/large_d_wide.cuh), half again the bytes of f32 points and x.
    The split takes a dozen elementwise passes over the points, so the
    wrapper makes it once per source tensor (`_staged_source`), not once
    per call."""
    return torch.stack(tf32_split(points[:rows]))


def merge_direct_states(num, den):
    """Merge direct states of column splits: (S, N, E) and (S, N, 1) | None."""
    return num.sum(0), None if den is None else den.sum(0)


def merge_flash_states(acc, mx, l):
    """Merge base-2 flash states of column splits, stacked on dim 0.

    acc (S, N, E), mx and l (S, N, 1) -> (acc, m, l) of the whole range.
    A split that saw no valid column has m = -1e30 and l = 0, and drops out.
    """
    m = torch.amax(mx, dim=0)
    w = torch.exp2(mx - m)
    return (w * acc).sum(0), m, (w * l).sum(0)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(device_index, *shape):
    with torch.cuda.device(device_index):
        return _build.plan(*shape)


def choose_splits(blocks, slots, m_eff):
    """Column splits for a grid of `blocks` row blocks on `slots` resident
    blocks (blocks per SM times SMs): the fewest splits whose launch fills
    at least 90% of the slots of every wave it takes, or failing that the
    best filled, and no split of fewer than 512 source columns."""
    cap = max(1, min(m_eff // _MIN_SPLIT_COLUMNS, 4096))

    def filled(s):
        total = blocks * s
        return total / (-(-total // slots) * slots)

    for s in range(1, cap + 1):
        if filled(s) >= _MIN_FILL:
            return s
    return max(range(1, cap + 1), key=lambda s: (filled(s), -s))


def _stage_points(t, scale, *, large, bf16):
    """Scale (and, at bfloat16 with large D, round) points; pad D.

    Returns (points, norms).  Small D keeps f32 points in every tier (only
    the kernel values and the signal are rounded there) and pads to 3 or 8
    coordinates.  Large D pads rows to whole 16 bytes (4 f32 or 8 bf16
    values), passes bf16 points in the bfloat16 tier, and computes the
    float32 norms |t|^2 once, from the staged values.  Zero coordinates
    change no form.  Each call counts as `points_staged`.
    """
    count("points_staged")
    t = t.float() * scale
    d = t.shape[1]
    if not large:
        return F.pad(t, (0, (3 if d <= 3 else 8) - d)).contiguous(), None
    if bf16:
        t = t.to(torch.bfloat16)
    pad = -d % (8 if bf16 else 4)
    if pad:
        t = F.pad(t, (0, pad))
    tf = t.float()
    return t.contiguous(), torch.sum(tf * tf, dim=1)


# The last source points staged for the kernels (`_staged_source`): a weak
# reference to the tensor, its version counter, what shaped the staging,
# and the staged operands.
_source_cache = [None]


def _drop_source(ref):
    entry = _source_cache[0]
    if entry is not None and entry[0] is ref:
        _source_cache[0] = None


def _staged_source(y, key, stage):
    """`stage()` for the source points `y`, reused while `y` is the same
    tensor object at the same version and `key` (what shapes the staging)
    is the same.  For callers that keep `y` fixed across calls
    (`fixed_source`: an engine's source points, passed to every query),
    so that the staging (scale, pad, norms and the TF32 planes) runs once
    per tensor, not once per call.  An in-place change of `y` moves its
    version counter and is staged anew; a write that bypasses the counter
    (through `.data`, DLPack or a collective's receive buffer) is not
    seen, which is why callers opt in.  One entry, dropped with `y`; an
    inference tensor, which has no version counter, is staged every
    time."""
    if y.is_inference():
        return stage()
    entry = _source_cache[0]
    if (entry is not None and entry[0]() is y and entry[1] == y._version
            and entry[2] == key):
        return entry[3]
    staged = stage()
    _source_cache[0] = (weakref.ref(y, _drop_source), y._version, key,
                        staged)
    return staged


def signal_plan(e, large, bf16=False):
    """(columns per block, blocks) of an E-column signal in one launch.

    E <= 8: one block of 1, 2, 4 or 8 columns, the narrow mode.  Above, the
    wide mode, blocks along the grid's z dimension, the narrowest that
    holds E, else the widest: at D <= 8 of 16, 64 or 256 columns (its
    warpgroups take half of a block's columns each, beside the kernel
    values that a block computes once), at D > 8 of 16 or 32, and 64 in
    the bfloat16 tier (`bf16`; the signal sums share the consumers'
    registers with the form's accumulators).  The kernel values are
    computed once per block.
    """
    if e <= 8:
        return next(w for w in _NARROW_WIDTHS if e <= w), 1
    widths = _WIDE_BLOCKS_LARGE_D[bool(bf16)] if large else _WIDE_BLOCKS
    eb = next((w for w in widths if e <= w), widths[-1])
    return eb, -(-e // eb)


@functools.lru_cache(maxsize=None)
def _order_index_of(device, size):
    """The gather index of WIDE_TF32_ORDER over `size` source columns, on
    `device`: built once per device and power-of-two size."""
    order = torch.tensor(WIDE_TF32_ORDER, device=device)
    return (torch.arange(0, size, 8, device=device)[:, None]
            + order).reshape(-1)


def _order_index(ldb, device):
    """The source columns of each group of 8 in WIDE_TF32_ORDER, for ldb
    columns: a prefix of a cached index, not copied from the host per
    call."""
    return _order_index_of(device, max(8, 1 << (ldb - 1).bit_length()))[:ldb]


def stage_wide_signal(b, width, bf16, align=8):
    """The wide mode's signal operand: b (M, E) -> (hi, lo, ldb).

    b transposed to (width, ldb): zero-padded to `width` columns (whole E
    blocks) and to ldb = M rounded up to `align` source columns (8, or
    WIDE_TILE for `tile_wide_signal`).  bfloat16: the values as bf16 (b is
    bf16-rounded already), lo None.  Float32 tiers: the source columns of
    each group of 8 in the order WIDE_TF32_ORDER (the A fragment of a TF32
    k8 step holds a thread's kernel values of columns 2t and 2t + 1 at
    k = t and t + 4), split into TF32 parts (`tf32_split`) for the 3xTF32
    product.
    """
    m, e = b.shape
    ldb = -(-m // align) * align
    bt = F.pad(b.T, (0, ldb - m, 0, width - e))
    if bf16:
        return bt.to(torch.bfloat16).contiguous(), None, ldb
    hi, lo = tf32_split(bt[:, _order_index(ldb, b.device)])
    return hi, lo, ldb


def tile_wide_signal(part, eb):
    """A staged part (width, ldb) of `stage_wide_signal` (align=WIDE_TILE)
    in the layout the small-D wide kernel reads: (width / eb, ldb /
    WIDE_TILE, eb * WIDE_TILE), each tile of WIDE_TILE source columns of
    each E block of eb columns contiguous, in the kernel's shared-memory
    order (csrc/wide.cuh, WideSignal::word: 8 signal columns x 16 bytes of
    source columns a core matrix, side by side along the source columns),
    so that a tile is copied as it lies.
    """
    width, ldb = part.shape
    tiles, blocks = ldb // WIDE_TILE, width // eb
    if part.dtype == torch.bfloat16:   # two source columns a 32-bit word
        v = part.view(blocks, eb // 8, 8, tiles, WIDE_TILE // 8, 4, 2)
        v = v.permute(0, 3, 1, 4, 2, 5, 6)
    else:
        v = part.view(blocks, eb // 8, 8, tiles, WIDE_TILE // 4, 4)
        v = v.permute(0, 3, 1, 4, 2, 5)
    return v.contiguous().view(blocks, tiles, eb * WIDE_TILE)


def tma_signal(hi, lo):
    """A staged signal of `stage_wide_signal` (align=TMA_SIGNAL_ALIGN), its
    parts (width, ldb), in the layout the large-D wide kernel's TMA loads
    read: groups of 128 bytes of source columns, each group of all signal
    columns contiguous -- (ldb / 64, width, 64) bf16, or (2, ldb / 32,
    width, 32) f32 with the TF32 lo part after the hi part -- so that one
    load takes a tile's 128 source columns of an E block (and both parts)
    into shared memory (csrc/large_d_wide.cuh, WideSignal)."""
    if lo is None:   # bf16: 64 source columns a group
        width, ldb = hi.shape
        return hi.view(width, ldb // 64, 64).permute(1, 0, 2).contiguous()
    width, ldb = hi.shape
    parts = torch.stack((hi, lo)).view(2, width, ldb // 32, 32)
    return parts.permute(0, 2, 1, 3).contiguous()


def _launch(kernel, points, signal, outs, *, n_ok, m_eff, kernel_id, diag,
            shift, splits, bf16, ldb, nc, eblocks):
    """Check the staged operands and launch one kernel on them.

    signal: (b, None) in the narrow mode, b (M, nc); the wide mode's
    (hi, lo) of `stage_wide_signal` (ldb > 0), at D <= 8 tiled
    (`tile_wide_signal`).
    """
    (x, xsq), (y, ysq) = points
    b, b_lo = signal
    wide = ldb > 0
    point_dtype = torch.bfloat16 if bf16 and x.shape[1] > 8 else torch.float32
    signal_dtype = torch.bfloat16 if bf16 and wide else torch.float32
    for name, t, dtype in (("x", x, point_dtype), ("y", y, point_dtype),
                           ("b", b, signal_dtype),
                           ("b_lo", b_lo, torch.float32),
                           ("xsq", xsq, torch.float32),
                           ("ysq", ysq, torch.float32),
                           *(("out", o, torch.float32) for o in outs)):
        if t is not None and not (t.is_cuda and t.is_contiguous()
                                  and t.dtype == dtype):
            raise ValueError(
                f"staged operand {name} must be a contiguous {dtype} CUDA "
                "tensor")
    n, d = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        kernel(_ptr(x), _ptr(y), _ptr(b), _ptr(b_lo), _ptr(xsq), _ptr(ysq),
               *(_ptr(o) for o in outs),
               n, n_ok, m_eff, d, nc, kernel_id, int(diag), shift,
               splits, int(bf16), ldb, eblocks, stream,
               eblocks=eblocks if wide else 0)


def kernel_matvec_cuda(x, y, b, *, kernel_name: str,
                       normalize_rows: bool = False,
                       mask_diagonal: Optional[bool] = None,
                       density_estimation: bool = False,
                       precision: str = "float32",
                       deferred: bool = False,
                       row_offset=0, col_offset=0, col_limit=INT32_MAX,
                       row_limit=INT32_MAX, fixed_source: bool = False):
    """The product on the hand-written CUDA kernels (see module docstring).

    x (N, D), y (M, D) and b (M, E) or None are float32 tensors on one CUDA
    device.  The wrapper scales (and, at bfloat16 with D > 8, rounds) the
    points, pads D, computes the norms of the large-D form, folds the
    limits into counts, stages the signal (padded to 1, 2, 4 or 8 columns,
    or for E > 8 as `stage_wide_signal` does), launches one kernel and
    merges the partial states of column splits.  `fixed_source`: the
    caller keeps `y` unchanged between calls (an engine's source points),
    so its staging is kept and reused (`_staged_source`).
    """
    spec = get_kernel(kernel_name)
    _check_precision(precision)
    md = spec.zero_diagonal if mask_diagonal is None else mask_diagonal
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError("kernel_matvec_cuda takes CUDA tensors")
    device = x.device
    _check_operand("x", x, device)
    n, d = x.shape
    _check_operand("y", y, device, cols=d)
    m = y.shape[0]
    if d == 0:
        raise ValueError("points must have at least one coordinate")

    if density_estimation and normalize_rows and not deferred:
        return torch.ones((n, 1), dtype=torch.float32, device=device)
    b_was_none = b is None
    if b_was_none:
        b = torch.ones((m, 1), dtype=torch.float32, device=device)
    _check_operand("b", b, device, rows=m)
    e = b.shape[1]

    use_flash = normalize_rows and spec.scaled_log2_fn is not None
    needs_den = _needs_den(spec, normalize_rows, density_estimation,
                           b_was_none)
    bf16 = precision == "bfloat16"
    large = d > 8

    row_offset = _as_int32("row_offset", row_offset)
    col_offset = _as_int32("col_offset", col_offset)
    n_ok = max(0, min(n, int(row_limit) - row_offset))
    m_eff = max(0, min(m, int(col_limit) - col_offset))
    shift = _as_int32("row_offset - col_offset", row_offset - col_offset)
    kernel_id = _CUDA_KERNEL_ID[spec.name]
    nc, eblocks = signal_plan(e, large, bf16)
    # The large-D wide kernel's float32 tiers take y as TF32 planes.
    planes = m_eff if nc > 8 and large and not bf16 else None

    def stage_y():
        points, norms = _stage_points(y, spec.point_scale, large=large,
                                      bf16=bf16)
        return (points, norms,
                None if planes is None else tf32_planes(points, planes))

    with span("matvec.stage_sources"):
        y_points, y_norms, y_planes = (
            _staged_source(y, (spec.point_scale, large, bf16, planes),
                           stage_y)
            if fixed_source else stage_y())
    if x is y:
        xp = (y_points, y_norms)
    else:
        with span("matvec.stage_targets"):
            xp = _stage_points(x, spec.point_scale, large=large, bf16=bf16)
    yp = (y_points if y_planes is None else y_planes, y_norms)
    if spec.on == "dot":   # no norms in a dot-product form
        xp, yp = (xp[0], None), (yp[0], None)
    dp = xp[0].shape[1]   # padded coordinates

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    with span("matvec.stage_signal"):
        bs = b.float()
        if bf16:
            bs = bs.to(torch.bfloat16).float()
        if nc > 8 and large:
            hi, lo, ldb = stage_wide_signal(bs, nc * eblocks, bf16,
                                            align=TMA_SIGNAL_ALIGN)
            signal = (tma_signal(hi, lo), None)
        elif nc > 8:
            hi, lo, ldb = stage_wide_signal(bs, nc * eblocks, bf16,
                                            align=WIDE_TILE)
            signal = tuple(None if p is None else tile_wide_signal(p, nc)
                           for p in (hi, lo))
        else:
            signal, ldb = (F.pad(bs, (0, nc - e)).contiguous(), None), 0
    with span("matvec.plan"):
        splits = 1
        if n:
            rows, per_sm = _plan(device.index, dp, nc, kernel_id, use_flash,
                                 needs_den, bf16)
            splits = choose_splits(-(-n // rows) * eblocks,
                                   per_sm * _sm_count(device.index), m_eff)
    launch = dict(n_ok=n_ok, m_eff=m_eff, kernel_id=kernel_id, diag=md,
                  shift=shift, splits=splits, bf16=bf16, ldb=ldb, nc=nc,
                  eblocks=eblocks)

    if use_flash:
        with span("matvec.launch"):
            out = new(splits, n, nc * eblocks)
            state = (new(splits, n, 1), new(splits, n, 1))
            if n:
                _launch(_build.FLASH, (xp, yp), signal, (out, *state),
                        **launch)
        with span("matvec.merge"):
            acc, mx, l = merge_flash_states(out, *state)
            acc = acc[:, :e]
            if deferred:
                return acc, mx, l
            return acc / l
    with span("matvec.launch"):
        out = new(splits, n, nc * eblocks)
        den = new(splits, n, 1) if needs_den else None
        if n:
            _launch(_build.DIRECT, (xp, yp), signal, (out, den), **launch)
    with span("matvec.merge"):
        num, den = merge_direct_states(out, den)
        return _finalize_direct(num[:, :e], den, needs_den=needs_den,
                                normalize_rows=normalize_rows,
                                density_estimation=density_estimation,
                                deferred=deferred)


def kernel_matvec(x, y, b, **kwargs):
    """Device dispatch: CUDA tensors to the kernels, others to plain torch.

    Takes and ignores kmb_tpu's TPU-only arguments (interpret, block_m,
    rows_aligned, cols_aligned); `block_n` sizes the plain version's row
    blocks and is ignored by the kernels, which choose their own tiles;
    `fixed_source` only keeps the kernels' staging of y
    (`kernel_matvec_cuda`).  Either path is the span `matvec`.
    """
    fixed_source = kwargs.pop("fixed_source", False)
    kwargs.pop("interpret", None)
    kwargs.pop("block_m", None)
    kwargs.pop("rows_aligned", None)
    kwargs.pop("cols_aligned", None)
    block_n = kwargs.pop("block_n", None)
    with span("matvec"):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return kernel_matvec_cuda(x, y, b, fixed_source=fixed_source,
                                      **kwargs)
        if block_n is not None:
            kwargs["block_n"] = block_n
        return kernel_matvec_torch(x, y, b, **kwargs)
