"""Block-low-rank (BLR) kernel-matrix engine, the twin of kmb_tpu.ops.blr.

For now it holds only the host-side clustering that the block-Jacobi
preconditioner of `ops/solve.py` needs: a copy of kmb_tpu/ops/blr.py:110-139
(NumPy code, copied because its module imports JAX).  The rest of the BLR
engine (admissibility, compression, the compressed matvec) is a later slice
of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
