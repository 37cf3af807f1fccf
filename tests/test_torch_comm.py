"""The port's collective inventory (kmb_tpu_torch.comm, the twin of
comm.py) on gloo worlds of CPU ranks.

One run of `python -m kmb_tpu_torch.comm --devices 2 4` (its only spawn
here: a world of 2 and one of 4 ranks) records one query of the ring and
the all-pairs ShardedProduct at two sizes on every rank; the recorded
collectives must equal the per-query formula written out below from the
schedules (ring: p - 1 rotations of the (y | b) chunk, then the all_gather
of the rows; all-pairs on a (2, p / 2) mesh: the source-axis all_reduce,
then the all_gather), and recording must leave each answer bit-identical.
Without a card the module needs `--rate`; with it the rows scale the
formula to -n on the H100's NVLink rate.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from kmb_tpu_torch import comm
from kmb_tpu_torch.parallel.sharded import make_mesh, record_collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 65536
RATE = 1e12


def _expected(schedule, p, n, d=3, e=1):
    """The collectives of one Gaussian ShardedProduct query on p ranks,
    per rank, as sorted (op, group, shape, count)."""
    if schedule == "ring":
        rows = -(-n // (8 * p)) * 8   # rows a shard: ceil(n, 8p) / p
        return sorted([["batch_isend_irecv", "mesh", [rows, d + e], p - 1],
                       ["all_gather", "mesh", [rows, e], 1]])
    rows = -(-n // 16) * 8            # two target shards
    out = [["all_gather", "mesh", [rows, e], 1]]
    if p > 2:                          # a source axis of p / 2 ranks
        out.append(["all_reduce", "source axis", [rows, e], 1])
    return sorted(out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    report = tmp / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "kmb_tpu_torch.comm", "-n", str(N),
         "--devices", "2", "4", "--rate", str(RATE), "--report",
         str(report), "--markdown", str(tmp / "COMM.md")],
        cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(report) as f:
        return proc, json.load(f), (tmp / "COMM.md").read_text()


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("schedule", ["ring", "allpairs"])
def test_recorded_collectives_are_the_formula(run, schedule, p):
    _, report, _ = run
    for n in comm.SIZES:
        record = report["recorded"][str(p)][f"{schedule}/{n}"]
        assert record["queries"] == 1
        got = [list(c) for c in comm.inventory(record["calls"])]
        assert got == _expected(schedule, p, n)
        assert got == sorted(list(c) for c in comm.analytic(
            schedule, p, n, 3, 1))
        for call in record["calls"]:
            assert call["dtype"] == "float32"
            assert call["bytes"] == 4 * call["shape"][0] * call["shape"][1]


def test_recording_leaves_the_answers_bit_identical(run):
    _, report, _ = run
    flags = [record["bit_identical"] for records in
             report["recorded"].values() for record in records.values()]
    assert len(flags) == 2 * 2 * len(comm.SIZES) and all(flags)


def test_rows_scale_the_formula_to_n(run):
    proc, report, markdown = run
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert rows == report["rows"]
    assert [(r["schedule"], r["devices"]) for r in rows] == [
        ("ring", 2), ("ring", 4), ("allpairs", 2), ("allpairs", 4)]
    for row in rows:
        got = sorted([c["op"], c["group"], c["shape"], c["count"]]
                     for c in row["collectives"])
        assert got == _expected(row["schedule"], row["devices"], N)
        assert row["rate_pairs_per_s"] == RATE
        assert row["rate_source"] == "--rate"
        assert row["link_bytes_per_s"] == comm.NVLINK_BYTES_PER_S
        assert 0 < row["predicted_efficiency"] <= 1
    ring4 = rows[1]
    assert ring4["per_step_bytes_per_device"] == 16384 * 4 * 4
    assert ring4["t_comp_step_s"] == pytest.approx((N / 4) ** 2 / RATE)
    assert "| schedule | p |" in proc.stderr and "| ring | 4 |" in markdown
    text = proc.stdout + proc.stderr + markdown
    for tpu in ("v5e", "ICI", "BENCH_SUITE"):
        assert tpu not in text


def test_without_a_card_it_needs_a_rate(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --rate"):
        comm.main(["--devices", "2"])


def test_the_recorder_is_off_outside_its_block():
    mesh = make_mesh(device="cpu")   # no process group: a world of one
    assert mesh.recorder is None
    with pytest.raises(RuntimeError):
        with record_collectives(mesh) as recorder:
            assert mesh.recorder is recorder
            raise RuntimeError
    assert mesh.recorder is None
