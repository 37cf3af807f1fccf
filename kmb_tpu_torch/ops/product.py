"""Streaming kernel-matrix product a = K(x, y) @ b without storing K.

The twin of kmb_tpu.ops.product.  Three functions:

- `kernel_matvec_torch`: the plain PyTorch version, the twin of
  `kernel_matvec_xla`.  It streams `block_n` target rows at a time, works in
  any float dtype (float64 serves as the ground truth) and on any device.
- `kernel_matvec_cuda`: the same contract on the two hand-written CUDA
  kernels of `csrc/` (the direct kernel and the base-2 flash kernel,
  entry points in `csrc/product.cu`).  CUDA float32 tensors only.
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
  large-D dot products in 3xTF32 on the tensor cores, see `tf32_split`);
  "bfloat16", where the signal and each kernel value are rounded to bf16
  before the product, with f32 accumulation.  The points are rounded to
  bf16 only at D > 8, where the form runs on the tensor cores; at D <= 8
  the form takes the f32 points, as the Pallas kernel's VPU form does
  (kmb_tpu/ops/product.py:525-538).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from kmb_tpu_torch.ops import _build
from kmb_tpu_torch.ops.kernels import KernelSpec, get_kernel

FLASH_NEG_INF = -1e30
PRECISIONS = ("float32", "float32x3", "bfloat16")
INT32_MAX = 2**31 - 1

# Kernel ids of csrc/common.cuh (enum KernelId).
_CUDA_KERNEL_ID = {"gaussian": 0, "absolute-exponential": 1,
                   "inverse-distance": 2, "exponential": 3}
_SIGNAL_CHUNK = 8  # signal columns per launch (the kernels take 1, 2, 4, 8)
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
    change no form.
    """
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


def _launch(kernel, points, b, outs, *, n_ok, m_eff, kernel_id, diag,
            shift, splits, bf16):
    """Check the staged operands and launch one kernel on them."""
    (x, xsq), (y, ysq) = points
    point_dtype = torch.bfloat16 if bf16 and x.shape[1] > 8 else torch.float32
    for name, t, dtype in (("x", x, point_dtype), ("y", y, point_dtype),
                           ("b", b, torch.float32),
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
        kernel(_ptr(x), _ptr(y), _ptr(b), _ptr(xsq), _ptr(ysq),
               *(_ptr(o) for o in outs),
               n, n_ok, m_eff, d, b.shape[1], kernel_id, int(diag), shift,
               splits, int(bf16), stream)


def kernel_matvec_cuda(x, y, b, *, kernel_name: str,
                       normalize_rows: bool = False,
                       mask_diagonal: Optional[bool] = None,
                       density_estimation: bool = False,
                       precision: str = "float32",
                       deferred: bool = False,
                       row_offset=0, col_offset=0, col_limit=INT32_MAX,
                       row_limit=INT32_MAX):
    """The product on the hand-written CUDA kernels (see module docstring).

    x (N, D), y (M, D) and b (M, E) or None are float32 tensors on one CUDA
    device.  The wrapper scales (and, at bfloat16 with D > 8, rounds) the
    points, pads D, computes the norms of the large-D form, folds the
    limits into counts, pads the signal width to what the kernels take,
    and merges the partial states of column splits.
    Signals wider than 8 columns run as several launches of 8.
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

    stage = dict(large=large, bf16=bf16)
    xp = _stage_points(x, spec.point_scale, **stage)
    yp = _stage_points(y, spec.point_scale, **stage)
    if spec.on == "dot":   # no norms in a dot-product form
        xp, yp = (xp[0], None), (yp[0], None)
    bs = b.float()
    if bf16:
        bs = bs.to(torch.bfloat16).float()
    dp = xp[0].shape[1]   # padded coordinates

    row_offset = _as_int32("row_offset", row_offset)
    col_offset = _as_int32("col_offset", col_offset)
    n_ok = max(0, min(n, int(row_limit) - row_offset))
    m_eff = max(0, min(m, int(col_limit) - col_offset))
    shift = _as_int32("row_offset - col_offset", row_offset - col_offset)
    kernel_id = _CUDA_KERNEL_ID[spec.name]

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    outs, mx, l, den = [], None, None, None
    for c0 in range(0, e, _SIGNAL_CHUNK):
        chunk = bs[:, c0:c0 + _SIGNAL_CHUNK]
        width = chunk.shape[1]
        nc = 1 if width == 1 else 2 if width == 2 else 4 if width <= 4 else 8
        chunk = F.pad(chunk, (0, nc - width)).contiguous()
        want_den = needs_den and c0 == 0 and not use_flash
        splits = 1
        if n:
            rows, per_sm = _plan(device.index, dp, nc, kernel_id, use_flash,
                                 want_den, bf16)
            splits = choose_splits(-(-n // rows),
                                   per_sm * _sm_count(device.index), m_eff)
        launch = dict(n_ok=n_ok, m_eff=m_eff, kernel_id=kernel_id, diag=md,
                      shift=shift, splits=splits, bf16=bf16)
        out = new(splits, n, nc)
        if use_flash:
            state = (new(splits, n, 1), new(splits, n, 1))
            if n:
                _launch(_build.FLASH, (xp, yp), chunk, (out, *state),
                        **launch)
            out, *state = merge_flash_states(out, *state)
            if c0 == 0:   # m and l do not depend on the signal
                mx, l = state
        else:
            part = new(splits, n, 1) if want_den else None
            if n:
                _launch(_build.DIRECT, (xp, yp), chunk, (out, part),
                        **launch)
            out, part = merge_direct_states(out, part)
            if c0 == 0:
                den = part
        outs.append(out[:, :width])
    acc = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    if use_flash:
        if deferred:
            return acc, mx, l
        return acc / l
    return _finalize_direct(acc, den, needs_den=needs_den,
                            normalize_rows=normalize_rows,
                            density_estimation=density_estimation,
                            deferred=deferred)


def kernel_matvec(x, y, b, **kwargs):
    """Device dispatch: CUDA tensors to the kernels, others to plain torch.

    Takes and ignores kmb_tpu's TPU-only arguments (interpret, block_m,
    rows_aligned, cols_aligned); `block_n` sizes the plain version's row
    blocks and is ignored by the kernels, which choose their own tiles.
    """
    kwargs.pop("interpret", None)
    kwargs.pop("block_m", None)
    kwargs.pop("rows_aligned", None)
    kwargs.pop("cols_aligned", None)
    block_n = kwargs.pop("block_n", None)
    if isinstance(x, torch.Tensor) and x.is_cuda:
        return kernel_matvec_cuda(x, y, b, **kwargs)
    if block_n is not None:
        kwargs["block_n"] = block_n
    return kernel_matvec_torch(x, y, b, **kwargs)
