"""Lifecycle contract for every benchmarked method.

A copy of kmb_tpu/algorithms/base.py (the port imports nothing of
kmb_tpu), itself a re-design of the reference API of
kernel-matrix-benchmarks (kernel_matrix_benchmarks/algorithms/base.py).
The lifecycle deliberately separates *untimed* data staging from the *timed*
compute phases, so that host<->device transfers and dtype casts never pollute
the benchmark numbers — the exact hooks where a device engine calls
`Tensor.to(device)` (in `prepare_data` / `prepare_query`) and fetches the
result back to host (in `get_result`):

    ctor(kernel=..., dimension=..., normalize_rows=..., precision=...)
      -> prepare_data(...)       untimed   (device transfer, casting)
      -> fit()                   TIMED     (precomputation / build)
      -> set_query_arguments(**) untimed   (per query-group parameters)
      -> prepare_query(...)      untimed   (device transfer, casting)
      -> query()                 TIMED     (the hot computation)
      -> get_result()            untimed   (device -> host, cast float64)
      -> done()                  untimed   (cleanup)

Tasks (reference base.py:54, 122):
- `BaseProduct.task == "product"`: result has shape (N, E) — one output row
  per *target* point.
- `BaseSolver.task == "solver"`: result has shape (M, E) — one output row
  per *source* point.
"""

from __future__ import annotations

import numpy as np


class BaseAlgorithm:
    """Common constructor + hooks shared by products and solvers."""

    #: overridden by subclasses
    task = "abstract"

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision=np.float64):
        """Store the problem parameters.

        Args:
            kernel: name of the kernel function the dataset expects
                ("gaussian", "absolute-exponential", "inverse-distance",
                "exponential").
            dimension: dimension D of the point clouds.
            normalize_rows: if True, rows of the kernel matrix are normalized
                to sum to 1 (attention semantics).
            precision: requested compute dtype.  The result returned by
                `get_result` is always float64 regardless.
        """
        self.kernel = kernel
        self.dimension = dimension
        self.normalize_rows = normalize_rows
        self.precision = precision
        self.name = type(self).__name__
        self.res = None

    # -- untimed hooks ----------------------------------------------------
    def set_query_arguments(self, **kwargs):
        """Set per-query-group parameters after fit() but before query()."""

    def get_additional(self):
        """Extra attrs merged into the stored result metadata."""
        return {}

    def get_memory_usage(self):
        """Current RSS in kilobytes (host-side memory footprint).

        Read from /proc/self/statm, the number psutil's `rss` reports on
        Linux: the card's machine has no psutil, and the host algorithms
        (the native oracle, the fixtures) run there too.
        """
        import os

        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1024

    def done(self):
        """Release resources; always called, even after an exception."""

    def __str__(self):
        return self.name

    # -- timed hooks ------------------------------------------------------
    def fit(self):
        """Timed precomputation (e.g. build K, clusters, preconditioner)."""

    def query(self):
        """Timed computation; stores its output in `self.res`."""
        raise NotImplementedError

    def get_result(self):
        """Return `self.res` as a contiguous float64 NumPy array."""
        return np.ascontiguousarray(self.res, dtype=np.float64)


class BaseProduct(BaseAlgorithm):
    """Kernel matrix products a = K b and attention layers (normalized rows)."""

    task = "product"

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        """Stage the point clouds (untimed).

        Args:
            source_points: (M, D) array of source positions y_j.
            target_points: (N, D) array of target positions x_i.
            same_points: if True, target_points is the same cloud as
                source_points (x_i == y_i, N == M).
            density_estimation: if True the source signal is all-ones and
                E == 1 (kernel density estimation).
        """

    def prepare_query(self, *, source_signal):
        """Stage the (M, E) source signal b_j (untimed).

        May be None when density_estimation is set.
        """


class BaseSolver(BaseAlgorithm):
    """Kernel linear-system solvers b = K^-1 a (assumes N == M)."""

    task = "solver"

    def prepare_data(self, *, source_points):
        """Stage the (M, D) source point cloud (untimed)."""

    def prepare_query(self, *, target_signal):
        """Stage the (N, E) right-hand side a_i (untimed)."""
