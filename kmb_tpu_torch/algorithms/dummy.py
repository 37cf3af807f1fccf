"""Dummy algorithms: random output of the right shape.

The port's copy of kmb_tpu/algorithms/dummy.py (the port imports nothing of
kmb_tpu).  Harness test fixtures — they exercise the full pipeline (runner,
subprocess isolation, results, metrics, plots) without any actual math,
like reference dummy_algo.py:6-37.
"""

from __future__ import annotations

import numpy as np

from kmb_tpu_torch.algorithms.base import BaseProduct, BaseSolver


class DummyProduct(BaseProduct):
    """Returns an (N, E)-shaped standard-normal sample."""

    def prepare_data(self, *, source_points, target_points, same_points=False,
                     density_estimation=False):
        self.n_targets = len(target_points)

    def prepare_query(self, *, source_signal):
        self.n_outputs = 1 if source_signal is None else source_signal.shape[1]

    def query(self):
        self.res = np.random.randn(self.n_targets, self.n_outputs)


class SleepyProduct(DummyProduct):
    """Blocks in fit() — fixture for the runner's watchdog timeout."""

    def __init__(self, *, seconds=120.0, **kwargs):
        super().__init__(**kwargs)
        self.seconds = float(seconds)

    def fit(self):
        import time

        time.sleep(self.seconds)


class CrashyProduct(DummyProduct):
    """Raises in fit() — fixture for child-failure accounting."""

    def fit(self):
        raise RuntimeError("CrashyProduct always fails (test fixture)")


class DummySolver(BaseSolver):
    """Returns an (M, E)-shaped standard-normal sample."""

    def prepare_data(self, *, source_points):
        self.n_sources = len(source_points)

    def prepare_query(self, *, target_signal):
        self.n_outputs = target_signal.shape[1]

    def query(self):
        self.res = np.random.randn(self.n_sources, self.n_outputs)


class TrackingProduct(DummyProduct):
    """Counts concurrently-fitted instances — fixture for the runner's
    one-fitted-state-at-a-time build loop (two fitted states at once is
    the HBM-exhaustion mode at M=2^20)."""

    live_fitted = 0
    max_live_fitted = 0

    @classmethod
    def reset_counters(cls):
        cls.live_fitted = cls.max_live_fitted = 0

    def fit(self):
        cls = TrackingProduct
        cls.live_fitted += 1
        cls.max_live_fitted = max(cls.max_live_fitted, cls.live_fitted)
        self._fitted = True

    def done(self):
        if getattr(self, "_fitted", False):
            TrackingProduct.live_fitted -= 1
            self._fitted = False
