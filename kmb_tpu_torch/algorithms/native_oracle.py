"""Benchmark wrapper for the native C++ streaming oracle.

The port's copy of kmb_tpu/algorithms/native_oracle.py.  Plugs the OpenMP
kernel product (native/kmb_native.cpp, built at first use and loaded via
ctypes in kmb_tpu_torch.native) into the harness lifecycle: a streaming
float64 method that never materializes K — the CPU mirror of the
engines' streaming design, and a second dense-free baseline next to
BruteForceProductBLAS
(reference bruteforce.py:61-153 defines the lifecycle being mirrored).
"""

from __future__ import annotations

import numpy as np

from kmb_tpu_torch import native
from kmb_tpu_torch.algorithms.base import BaseProduct


class NativeProduct(BaseProduct):
    """Streaming kernel product via the native library; fit() is a no-op.

    Runs on the host whatever the hardware tier: a CPU baseline.
    """

    def __init__(self, *, kernel, dimension, normalize_rows=False,
                 precision=np.float64):
        super().__init__(kernel=kernel, dimension=dimension,
                         normalize_rows=normalize_rows,
                         precision=np.dtype(precision))
        if kernel not in native.KERNEL_IDS:
            raise NotImplementedError(
                f"NativeProduct doesn't support kernel {kernel!r}.")
        # Builds the library at first use; a failed build raises.
        self.name = f"NativeProduct(threads={native.num_threads()})"

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        self.source_points = np.ascontiguousarray(
            source_points, dtype=np.float64)
        self.target_points = (
            None if same_points
            else np.ascontiguousarray(target_points, dtype=np.float64))
        self.same_points = same_points
        self.density_estimation = density_estimation

    def fit(self):
        pass  # streaming method: no precomputation

    def prepare_query(self, *, source_signal):
        self.source_signal = (
            None if self.density_estimation
            else np.ascontiguousarray(source_signal, dtype=np.float64))

    def query(self):
        if self.normalize_rows and self.density_estimation:
            pts = (self.source_points if self.same_points
                   else self.target_points)
            self.res = np.ones((pts.shape[0], 1), dtype=np.float64)
            return
        out, rowsums = native.native_kernel_product(
            kernel=self.kernel,
            source_points=self.source_points,
            target_points=self.target_points,
            source_signal=self.source_signal,
            normalize_rows=self.normalize_rows,
            return_rowsums=True,
        )
        if self.density_estimation:
            self.res = rowsums[:, None]
        else:
            self.res = out

    def get_additional(self):
        return {"native_threads": native.num_threads()}
