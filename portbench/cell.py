"""A cell's files, found by the names BENCHMARK.json gives them."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# What data.make_inputs reads of a traffic file; a key it would not read
# is refused rather than silently ignored.
TRAFFIC_KEYS = {"signal_pool", "distribution"}


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with any overrides
    traffic: dict         # traffic/<traffic>.json
    check_rows: int       # rows of each answer compared
    limits: dict          # number compared -> its limit
    end_to_end: list      # BENCHMARK.json's metrics this cell reports
    per_layer: list


def load(name, override=None):
    """The cell `name`; `override` replaces configuration keys (tests run
    a cell's path at a small size)."""
    bench = load_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")
    entry = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(ROOT / files[entry["config"]])
    config.update(override or {})
    extra = load_json(HERE / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    unread = set(traffic) - TRAFFIC_KEYS
    if unread:
        raise ValueError(f"traffic {entry['traffic']!r}: keys the harness "
                         f"does not read: {sorted(unread)}")
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                check_rows=int(extra["check_rows"]), limits=extra["limits"],
                end_to_end=e2e, per_layer=per_layer)
