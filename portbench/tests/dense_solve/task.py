"""A solve-shaped task for the harness's tests: b = (K + ridge I)^-1 a
for Gaussian-process right-hand sides a, K the Gaussian kernel matrix of
points in the unit cube.  The "engine" is a dense float64 solver on the
CPU; an answer is judged by its residual at the checked rows, computed
by the plain reference from the points and the whole b, and the control
is the same solve in float32.

The test copies this file to `portbench/tasks/dense_solve.py` of a copy of
the benchmark, and `reference.py` beside it to
`portbench/references/kernel_ridge.py`: the files a later change would
add for such a task, with no edit to any file already there.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import numpy as np
import torch

from portbench import data

# Its traffic keys: more than the product's, read by its own make_inputs.
TRAFFIC_KEYS = {"signal_pool", "length_scale", "noise"}


class DenseSolver:
    def __init__(self, *, ridge, answer_scale=1.0):
        self.ridge, self.answer_scale = ridge, answer_scale

    def prepare_data(self, points):
        x = torch.as_tensor(points, dtype=torch.float64)
        k = torch.exp(-torch.cdist(x, x) ** 2)
        self.factor = torch.linalg.lu_factor(
            k + self.ridge * torch.eye(len(x), dtype=torch.float64))

    def prepare_query(self, rhs):
        self.rhs = torch.as_tensor(rhs, dtype=torch.float64)

    def query(self):
        self.res = torch.linalg.lu_solve(*self.factor, self.rhs)

    def get_result(self):
        return self.answer_scale * self.res.numpy()

    def done(self):
        self.factor = self.rhs = self.res = None


def make_inputs(config, traffic, seed, check_rows):
    """Points and right-hand sides from the seed: each a smooth function
    of the points (a random plane wave) plus noise."""
    streams = [np.random.default_rng(s)
               for s in np.random.SeedSequence(int(seed)).spawn(3)]
    n, d = config["n_points"], config["dimension"]
    points = data.uniform_cube(streams[0], n, d)
    size = int(traffic["signal_pool"])
    waves = streams[1].standard_normal((size, d)) / traffic["length_scale"]
    phases = streams[1].uniform(0, 2 * math.pi, size)
    pool = (np.sin(points @ waves.T + phases).T[:, :, None]
            + traffic["noise"] * streams[1].standard_normal((size, n, 1)))
    return data.Inputs(points, points, True, pool.astype(np.float32),
                       data.checked_rows(streams[2], n, check_rows))


def build(config, device):
    return DenseSolver(**config["engine"]["args"])


def prepare(engine, inputs):
    engine.prepare_data(inputs.sources)


def ask(engine, signal, span=lambda step: contextlib.nullcontext()):
    with span("stage"):
        engine.prepare_query(signal)
    with span("query"):
        engine.query()
    with span("read"):
        return engine.get_result()


def pairs(config):
    return config["n_points"] ** 2


def mesh(engine):
    return None


def keep(inputs, answer):
    """All of b: its residual at any row needs every entry."""
    return np.array(answer)


def _reference(config):
    return importlib.import_module(
        f"portbench.references.{config['reference']}")


def compared(inputs, config, kept, signal_ids, device):
    """((K + ridge I) b, a, |K| |b| + ridge |b|) at the checked rows."""
    module = _reference(config)
    out = []
    for b, s in zip(kept, signal_ids):
        got, size = module.residual_terms(inputs.sources, b, inputs.rows,
                                          ridge=config["ridge"])
        out.append((got, inputs.pool[int(s)][inputs.rows].astype(np.float64),
                    size))
    return out


def control(inputs, config, device):
    lowered = _reference(config).control(inputs.sources, inputs.pool,
                                         ridge=config["ridge"])
    return list(lowered), list(range(len(lowered)))


def launch_bound_ms(config, world, sfu_rate):
    return None
