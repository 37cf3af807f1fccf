"""The product task: the port's product engines (`TorchProduct`,
`ShardedProduct`) under the calls its harness makes, and how their
answers are judged.

- set-up: `prepare_data(source_points, target_points, same_points)`, then
  `fit()`;
- one query: `prepare_query(source_signal)` -> `query()` ->
  `get_result()`, so staging the signal and reading the answer back to
  the host belong to the query, as a user pays them;
- what is kept of an answer: its checked rows;
- what is compared: each kept answer against the plain reference's
  float64 product for its signal, measured against the product with
  |signal| (check.py);
- the least time of one kernel launch: the whole product on one card, one
  ring step's chunk on several.

A task module gives `build`, `prepare`, `ask`, `pairs`, `mesh`, `keep`,
`compared`, `control` and `launch_bound_ms`.  It may also give
`TRAFFIC_KEYS` and `make_inputs(config, traffic, seed, check_rows)`, in
place of `cell.TRAFFIC_KEYS` and `data.make_inputs`: an object whose
`signal(i)` is the (signal id, query argument) of the loop's i-th query.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np

from portbench import roofline


def build(config, device):
    """The configuration's engine on `device`."""
    engine = config["engine"]
    cls = getattr(importlib.import_module(engine["module"]), engine["class"])
    return cls(kernel=config["kernel"], dimension=config["dimension"],
               normalize_rows=config["normalize_rows"],
               precision=config["precision"], device=device,
               **engine.get("args", {}))


def prepare(engine, inputs):
    engine.prepare_data(source_points=inputs.sources,
                        target_points=inputs.targets,
                        same_points=inputs.same_points)
    engine.fit()


def ask(engine, signal, span=lambda step: contextlib.nullcontext()):
    """One query: the (N, E) float64 answer on the host.  `span(step)`
    marks each step ("stage", "query", "read")."""
    with span("stage"):
        engine.prepare_query(source_signal=signal)
    with span("query"):
        engine.query()
    with span("read"):
        return engine.get_result()


def pairs(config):
    """Kernel pairs one query computes."""
    return config["n_targets"] * config["n_sources"]


def mesh(engine):
    """The engine's mesh of ranks, where it has one."""
    return getattr(engine, "mesh", None)


def keep(inputs, answer):
    """What the check reads of an answer: its checked rows."""
    return np.array(answer[inputs.rows])


def compared(inputs, config, kept, signal_ids, device):
    """(got, wanted, size) of each kept answer (R, E) to the pool signals
    `signal_ids`: the answer, the plain reference's float64 product of its
    signal, and the product of its |signal|, at the checked rows."""
    reference, magnitude = _reference(inputs, config, device, "product")
    return [(answer, reference[int(s)], magnitude[int(s)])
            for answer, s in zip(kept, signal_ids)]


def control(inputs, config, device):
    """The control put in the program's place: kept answers of every pool
    signal from the reference computed one precision lower, and their
    signal ids."""
    lowered, _ = _reference(inputs, config, device, "control")
    return list(lowered), list(range(len(lowered)))


def launch_bound_ms(config, world, sfu_rate):
    """The least ms of one kernel launch: on one card the whole product;
    on `world` cards one step of the ring, a rank's share of the targets
    against one rank's share of the sources.  None for another schedule,
    whose launches this does not know."""
    schedule = config["engine"].get("args", {}).get("schedule", "ring")
    if world > 1 and schedule != "ring":
        return None
    return roofline.bound_ms(
        -(-config["n_targets"] // world), -(-config["n_sources"] // world),
        config["dimension"], config["signal_columns"],
        roofline.launch_kind(config), config["normalize_rows"],
        config["precision"], sfu_rate)[0]


def _reference(inputs, config, device, which):
    """The plain reference at the checked rows for every pool signal:
    (S, R, E) float64 products of each signal and of its absolute value.
    which="control": the lowered version's products."""
    module = importlib.import_module(
        f"portbench.references.{config['reference']}")
    pool, rows = inputs.pool, inputs.rows
    s, m, e = pool.shape
    signals = pool.transpose(1, 0, 2).reshape(m, s * e)
    out = getattr(module, which)(
        inputs.targets[rows], inputs.sources,
        np.concatenate([signals, np.abs(signals)], axis=1),
        kernel=config["kernel"], normalize_rows=config["normalize_rows"],
        device=device)
    out = out.reshape(len(rows), 2, s, e).transpose(1, 2, 0, 3)
    return out[0], out[1]
