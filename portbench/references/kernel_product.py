"""The plain kernel-matrix product, in float64, at chosen target rows.

    a_i = sum_j k(x_i, y_j) b_j        (normalize_rows: divided by
                                        sum_j k(x_i, y_j))

with k(x, y) = exp(-|x - y|^2) ("gaussian"), exp(-|x - y|)
("absolute-exponential") or exp(<x, y>) ("exponential").  Written from those definitions, in blocks of at most
`ENTRIES` kernel values, so that it fits beside nothing on the card once
the program's state is freed.  Row-normalised products fold the source
chunks with a running maximum, so no exponential overflows.

`control()` is the same arithmetic one precision below what the
configurations state (float32 with TF32 off): TF32.  Each matrix
product's operands are rounded to TF32 (10 explicit mantissa bits, to
nearest) and multiplied and summed in float32, which is what a TF32
tensor-core product computes, on the CPU as on the card.  The squared
distance then takes the expanded form |x|^2 + |y|^2 - 2 <x, y>, the form a
matrix product can serve.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ENTRIES = 2**26      # kernel values in one block
ROW_BLOCK = 1024


def tf32(t):
    """float32 `t` rounded to TF32 (10 explicit mantissa bits), to nearest,
    ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def _true_float32():
    """float32 matrix products in float32 (no TF32) inside."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _squared_distance(x, y, lowered):
    if lowered:
        dots = tf32(x) @ tf32(y).T
        return ((x * x).sum(1, keepdim=True) + (y * y).sum(1)[None, :]
                - 2.0 * dots)
    out = None
    for k in range(x.shape[1]):
        diff = x[:, k:k + 1] - y[:, k][None, :]
        out = diff * diff if out is None else out + diff * diff
    return out


def _form(kernel, x, y, lowered):
    """The exponent of k, (rows, cols)."""
    if kernel == "exponential":
        return tf32(x) @ tf32(y).T if lowered else x @ y.T
    if kernel == "gaussian":
        return -_squared_distance(x, y, lowered)
    if kernel == "absolute-exponential":
        return -torch.sqrt(torch.clamp_min(_squared_distance(x, y, lowered),
                                           0.0))
    raise NotImplementedError(f"no plain reference for kernel {kernel!r}")


def _product(x_rows, sources, signals, *, kernel, normalize_rows, device,
             lowered):
    dtype = torch.float32 if lowered else torch.float64

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    x_all, y, b = put(x_rows), put(sources), put(signals)
    if lowered:
        b = tf32(b)
    rows = min(len(x_all), ROW_BLOCK)
    cols = max(1, ENTRIES // rows)
    out = []
    for r0 in range(0, len(x_all), rows):
        x = x_all[r0:r0 + rows]
        acc = torch.zeros((len(x), b.shape[1]), dtype=dtype, device=device)
        top = torch.full((len(x), 1), -torch.inf, dtype=dtype, device=device)
        total = torch.zeros((len(x), 1), dtype=dtype, device=device)
        for c0 in range(0, len(y), cols):
            form = _form(kernel, x, y[c0:c0 + cols], lowered)
            bc = b[c0:c0 + cols]
            if normalize_rows:
                new_top = torch.maximum(top, form.amax(1, keepdim=True))
                scale = torch.exp(top - new_top)
                w = torch.exp(form - new_top)
                acc = acc * scale + (tf32(w) if lowered else w) @ bc
                total = total * scale + w.sum(1, keepdim=True)
                top = new_top
            else:
                k = torch.exp(form)
                acc += (tf32(k) if lowered else k) @ bc
        out.append((acc / total if normalize_rows else acc).double().cpu())
    return torch.cat(out).numpy()


def product(x_rows, sources, signals, *, kernel, normalize_rows, device):
    """(R, S) float64 product of the rows `x_rows` (R, D) against every
    source (M, D) for the signals (M, S), computed in float64."""
    return _product(x_rows, sources, signals, kernel=kernel,
                    normalize_rows=normalize_rows, device=device,
                    lowered=False)


def control(x_rows, sources, signals, *, kernel, normalize_rows, device):
    """The same product computed in TF32 (see the module docstring)."""
    with _true_float32():
        return _product(x_rows, sources, signals, kernel=kernel,
                        normalize_rows=normalize_rows, device=device,
                        lowered=True)
