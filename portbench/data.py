"""Inputs from the seed: points, the signal pool and the rows checked.

The point generators are frozen copies of the port's dataset generators
(`uniform_cube`, `normal_cloud`), drawing from `--seed` instead of a
seed fixed by the dataset's name.  The traffic generator reads a traffic
file's parameters: how many signals set-up draws, and from which
distribution; the closed loop's queries take them in turn.  The same
seed gives the same inputs, and every seed the same sizes.

Everything is float32, as the engines stage it; the references read the
same arrays and widen them to float64 themselves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def uniform_cube(rng, n_points, dimension):
    """A uniform sample of [0, 1]^D."""
    return rng.random((n_points, dimension), dtype=np.float32)


def normal_cloud(rng, n_points, dimension):
    """An isotropic Gaussian cloud scaled by 1 / sqrt(D), so squared
    distances and dot products stay O(1) in any dimension."""
    scale = np.float32(1.0 / math.sqrt(dimension))
    return scale * rng.standard_normal((n_points, dimension),
                                       dtype=np.float32)


GENERATORS = {"uniform_cube": uniform_cube, "normal_cloud": normal_cloud}
SIGNALS = {"standard_normal": lambda rng, shape: rng.standard_normal(
    shape, dtype=np.float32)}


@dataclass
class Inputs:
    sources: np.ndarray           # (M, D) float32
    targets: np.ndarray           # (N, D) float32; the sources themselves
    same_points: bool             # when the targets are the sources
    pool: np.ndarray              # (S, M, E) float32 signals
    rows: np.ndarray              # (R,) sorted target rows checked

    def signal(self, i):
        """(pool index, signal) of the loop's i-th query."""
        s = i % len(self.pool)
        return s, self.pool[s]


def make_inputs(config, traffic, seed, check_rows):
    """The cell's inputs for `seed`: four independent streams (sources,
    targets, signals, checked rows) spawned from one seed sequence."""
    streams = [np.random.default_rng(s)
               for s in np.random.SeedSequence(int(seed)).spawn(4)]
    points = config["points"]
    make = GENERATORS[points["generator"]]
    m, n, d = config["n_sources"], config["n_targets"], config["dimension"]
    sources = make(streams[0], m, d)
    same = bool(config["same_points"])
    targets = sources if same else make(streams[1], n, d)
    draw = SIGNALS[traffic["distribution"]]
    size = int(traffic["signal_pool"])
    pool = draw(streams[2], (size, m, config["signal_columns"]))
    return Inputs(sources, targets, same, pool,
                  checked_rows(streams[3], n, check_rows))


def checked_rows(rng, n, count):
    """`count` distinct target rows drawn from the seed, the first and the
    last among them (all rows where `count` >= n)."""
    if count >= n:
        return np.arange(n)
    inner = rng.choice(np.arange(1, n - 1), size=count - 2, replace=False)
    return np.sort(np.concatenate([[0, n - 1], inner]))
