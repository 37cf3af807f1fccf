"""The solve task: the port's Krylov solver (`TorchSolverCG`) answering
b = K^-1 a for right-hand side after right-hand side against points
staged and a preconditioner fitted once, as a Gaussian-process or
kriging user calls it.

- inputs: points from the seed; a pool of right-hand sides a_s = K w_s,
  each w_s standard normal from the seed, computed at set-up by the plain
  reference in float64 (one product with as many columns as the pool);
  the checked rows;
- set-up: `prepare_data(source_points)`, then `fit()`, which builds the
  preconditioner (for Nystrom, its sketch of K with E = rank);
- one query: `prepare_query(target_signal)` -> `query()` ->
  `get_result()`: the whole solve, staging and read-back included;
- what is kept of an answer: all of b, since K b at any row needs every
  entry, and its matvecs (the solver's iterations, one direct-kernel
  launch each);
- its pairs: N^2 for each matvec, so that `pairs_per_s` is the Krylov
  loop's kernel throughput; how many matvecs a solve takes is the
  right-hand side's and the preconditioner's, and is read on its own
  (`metrics/pcg_iterations.solve.py`);
- what is compared: for each kept b, (K b)[rows] from the plain
  reference in float64, against a[rows], measured against |a|[rows]: so
  `err_rms` is the relative residual ||K b - a|| / ||a|| at the checked
  rows, which is what the solver's tolerance promises.  A b that repeats
  the first answer of its signal to the bit reuses its product; one that
  differs gets its own, and `repeat_gap` shows the difference;
- the control: the plain reference's solve one precision lower
  (`references/<reference>.control`);
- the least time of one kernel launch: one matvec, the direct kernel on
  N^2 pairs with E = 1.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics

import numpy as np
import torch

from portbench import data, roofline

# A pool's size, and how its right-hand sides are made.
TRAFFIC_KEYS = {"signal_pool", "right_hand_side"}
RIGHT_HAND_SIDES = ("kernel_times_standard_normal",)

# The matvecs of each answer kept since the last `prepare`: a run's
# window, in which `pairs` counts each solve's own kernel pairs.
_MATVECS = []


def _reference(config):
    return importlib.import_module(
        f"portbench.references.{config['reference']}")


def _device():
    """Where the set-up's reference product runs: the card, where there
    is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_inputs(config, traffic, seed, check_rows):
    """Points, the pool of right-hand sides (S, N, 1) float64 and the
    checked rows, from three streams of one seed sequence."""
    if traffic["right_hand_side"] not in RIGHT_HAND_SIDES:
        raise ValueError(f"no right-hand side {traffic['right_hand_side']!r}")
    streams = [np.random.default_rng(s)
               for s in np.random.SeedSequence(int(seed)).spawn(3)]
    n = config["n_points"]
    points = data.GENERATORS[config["points"]["generator"]](
        streams[0], n, config["dimension"])
    size = int(traffic["signal_pool"])
    w = streams[1].standard_normal((n, size))
    a = _reference(config).rhs(points, w, device=_device())
    pool = np.ascontiguousarray(a.T[:, :, None])
    return data.Inputs(points, points, True, pool,
                       data.checked_rows(streams[2], n, check_rows))


def build(config, device):
    """The configuration's solver on `device`."""
    engine = config["engine"]
    cls = getattr(importlib.import_module(engine["module"]), engine["class"])
    return cls(kernel=config["kernel"], dimension=config["dimension"],
               precision=config["precision"], device=device,
               **engine.get("args", {}))


def prepare(engine, inputs):
    _MATVECS.clear()
    engine.prepare_data(source_points=inputs.sources)
    engine.fit()


def ask(engine, signal, span=lambda step: contextlib.nullcontext()):
    """One solve: the (N, 1) float64 b on the host and its matvecs.
    `span(step)` marks each step ("stage", "query", "read")."""
    with span("stage"):
        engine.prepare_query(target_signal=signal)
    with span("query"):
        engine.query()
    with span("read"):
        return engine.get_result(), engine.iterations


def pairs(config):
    """Kernel pairs of one solve, as a mean over the answers kept since
    the last `prepare`: N^2 for each of its matvecs.  N^2 where none was
    kept."""
    n2 = config["n_points"] ** 2
    return n2 * statistics.fmean(_MATVECS) if _MATVECS else n2


def mesh(engine):
    return getattr(engine, "mesh", None)


def keep(inputs, answer):
    b, matvecs = answer
    _MATVECS.append(int(matvecs))
    return np.array(b)


def compared(inputs, config, kept, signal_ids, device):
    """((K b)[rows], a[rows], |a|[rows]) of each kept b to the pool's
    right-hand sides `signal_ids`, one reference product for each b that
    differs from every other."""
    distinct, which = [], []
    seen = {}
    for b in kept:
        key = np.ascontiguousarray(b).tobytes()
        if key not in seen:
            seen[key] = len(distinct)
            distinct.append(b)
        which.append(seen[key])
    got = []
    if distinct:
        got = _reference(config).residual_terms(
            inputs.sources, np.concatenate(distinct, axis=1), inputs.rows,
            device=device)
    e = kept[0].shape[1] if kept else 1
    out = []
    for j, s in zip(which, signal_ids):
        wanted = inputs.pool[int(s)][inputs.rows]
        out.append((got[:, j * e:(j + 1) * e], wanted, np.abs(wanted)))
    return out


def control(inputs, config, device):
    """The reference's solve one precision lower, put in the program's
    place: an answer for every right-hand side of the pool, with their
    ids."""
    args = config["engine"].get("args", {})
    lowered = _reference(config).control(
        inputs.sources, inputs.pool, rank=args["precond_rank"],
        tol=args["tol"], max_iters=args.get("max_iters", 1000),
        device=device)
    return list(lowered), list(range(len(lowered)))


def launch_bound_ms(config, world, sfu_rate):
    """The least ms of one launch: one matvec of the direct kernel, N
    targets by N sources, E = 1."""
    n = config["n_points"]
    return roofline.bound_ms(n, n, config["dimension"],
                             config["signal_columns"], "direct", False,
                             config["precision"], sfu_rate)[0]
