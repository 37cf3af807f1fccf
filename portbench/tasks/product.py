"""The product protocol of the port's engines (`TorchProduct`,
`ShardedProduct`), the calls its harness makes:

- set-up: `prepare_data(source_points, target_points, same_points)`, then
  `fit()`;
- one query: `prepare_query(source_signal)` -> `query()` ->
  `get_result()`, so staging the signal and reading the answer back to
  the host belong to the query, as a user pays them.
"""

from __future__ import annotations

import contextlib
import importlib


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
