"""The plain reference of the tests' solve-shaped task: the terms of the
residual (K + ridge I) b - a in float64, K the Gaussian kernel matrix,
and the control, the solve computed in float32."""

from __future__ import annotations

import numpy as np


def _kernel(x, y):
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2)


def residual_terms(points, b, rows, *, ridge):
    """((K + ridge I) b, |K| |b| + ridge |b|) at `rows`, in float64."""
    x = np.asarray(points, dtype=np.float64)
    k = _kernel(x[rows], x)
    b = np.asarray(b, dtype=np.float64)
    return (k @ b + ridge * b[rows],
            np.abs(k) @ np.abs(b) + ridge * np.abs(b[rows]))


def control(points, pool, *, ridge):
    """(S, N, E) answers of the solve in float32."""
    x = np.asarray(points, dtype=np.float32)
    k = _kernel(x, x).astype(np.float32)
    a = k + np.float32(ridge) * np.eye(len(x), dtype=np.float32)
    return np.stack([np.linalg.solve(a, p.astype(np.float32)).astype(
        np.float64) for p in pool])
