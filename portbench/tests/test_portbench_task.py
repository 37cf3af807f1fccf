"""The task protocol: the product task's hooks give the numbers the
harness gave before it had them, the port's spans and counters reach the
queries, and a second task, added as new files only, runs through
`portbench.run` and is judged by its own comparison."""

import importlib
import json
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from portbench import calibrate, check, data, roofline, run
from portbench import cell as cells
from portbench.references import kernel_product
from portbench.session import Session
from portbench.tests.test_portbench_harness import SMALL

CELLS = sorted(SMALL)


def frozen_reference(inputs, config, which):
    """The harness's arithmetic before the task protocol (the session's
    own `reference`), kept here to hold the task's hooks to it."""
    pool, rows = inputs.pool, inputs.rows
    s, m, e = pool.shape
    signals = pool.transpose(1, 0, 2).reshape(m, s * e)
    out = getattr(kernel_product, which)(
        inputs.targets[rows], inputs.sources,
        np.concatenate([signals, np.abs(signals)], axis=1),
        kernel=config["kernel"], normalize_rows=config["normalize_rows"],
        device="cpu")
    out = out.reshape(len(rows), 2, s, e).transpose(1, 2, 0, 3)
    return out[0], out[1]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 77])
@pytest.mark.parametrize("name", CELLS)
def test_product_hooks_give_the_frozen_numbers(name, seed):
    c = cells.load(name, SMALL[name])
    inputs = data.make_inputs(c.config, c.traffic, seed, c.check_rows)
    reference, magnitude = frozen_reference(inputs, c.config, "product")
    lowered, _ = frozen_reference(inputs, c.config, "control")
    # Answers off by a little in every row, two to each signal.
    rng = np.random.default_rng(seed)
    ids = [i % len(lowered) for i in range(2 * len(lowered))]
    answers = [reference[s] * (1 + 1e-7 * rng.standard_normal(
        reference[s].shape)) for s in ids]
    kept = [c.task.keep(inputs, np.zeros((c.config["n_targets"], 1)))]
    assert kept[0].shape == reference[0].shape
    for got, ours in zip(c.task.compared(inputs, c.config, answers, ids,
                                         "cpu"),
                         zip(answers, (reference[s] for s in ids),
                             (magnitude[s] for s in ids))):
        for a, b in zip(got, ours):
            assert np.array_equal(a, b)
    control, control_ids = c.task.control(inputs, c.config, "cpu")
    assert control_ids == list(range(len(lowered)))
    assert all(np.array_equal(a, b) for a, b in zip(control, lowered))
    before = [check.answer_numbers(a, reference[s], magnitude[s],
                                   answers[ids.index(s)])
              for a, s in zip(answers, ids)]
    _, _, numbers = check.judge(
        c.task.compared(inputs, c.config, answers, ids, "cpu"), ids,
        c.limits)
    for key in check.NAMES:
        assert numbers[key] == max(b[key] for b in before)


# An H100 SXM: 132 SMs at a 1980 MHz maximum clock.
SFU = roofline.special_function_rate(132, 1980.0)


@pytest.mark.parametrize("name,launches", [
    ("cube-n2p20.signal-stream", 1), ("glove25.signal-stream", 1),
    ("cube-n2p21-ring4.signal-stream", 4)])
def test_launch_bounds_sum_to_the_frozen_query_bound(name, launches):
    # One query's least time on one rank, as the harness had it before
    # the task protocol: the rank's share of the targets against every
    # source.  The ring launches four chunks of a quarter of the sources.
    c = cells.load(name)
    config = c.config
    before = roofline.bound_ms(
        -(-config["n_targets"] // c.chips), config["n_sources"],
        config["dimension"], config["signal_columns"],
        roofline.launch_kind(config), config["normalize_rows"],
        config["precision"], SFU)[0]
    launch = c.task.launch_bound_ms(config, c.chips, SFU)
    assert launch * launches == before
    allpairs = dict(config, engine={"args": {"schedule": "allpairs"}})
    assert c.task.launch_bound_ms(allpairs, 4, SFU) is None


def test_counted_queries_carry_the_port_spans_and_counts():
    name = "glove25.signal-stream"
    c = cells.load(name, SMALL[name])
    session = Session(c, 2**31 + 21, device="cpu")
    session.set_up()
    session.window(1e9, counted=True, queries=3)
    session.window(1e9, queries=2)
    counted, plain = session.report.queries[:3], session.report.queries[3:]
    for q in counted:
        assert {"engine.stage_signal", "matvec", "fence.wait",
                "fence.check", "engine.read"} <= set(q.span_ms)
        assert all(ms >= 0 for ms in q.span_ms.values())
        # Self times: the spans of a query fit inside its host time.
        assert sum(q.span_ms.values()) <= q.ms
        # The plain version on the CPU stages no points.
        assert q.counts == {}
    assert all(q.span_ms is None and q.counts is None for q in plain)


def test_calibration_through_the_hooks(repo_env, capsys):
    name = "cube-n2p20.signal-stream"
    calibrate.calibrate(calibrate.parse([
        "--workload", name, "--seeds", "3", "--queries", "4", "--device",
        "cpu", "--override", json.dumps(SMALL[name])]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = cells.load(name).limits
    assert line["queries"] == 4
    assert all(line["program"][k] <= limits[k] for k in check.NAMES)
    assert line["control"]["err_rms"] > limits["err_rms"]


# -- a second task, from new files only ---------------------------------------

SOLVE = "dense-solve.gp-rhs"


def solve_checkout(repo, tmp_path):
    """A copy of the benchmark's files with a solve-shaped task added:
    new files, and new entries in the copy's BENCHMARK.json."""
    shutil.copy(repo / "BENCHMARK.json", tmp_path)
    here = repo / "portbench" / "tests" / "dense_solve"
    pb = tmp_path / "portbench"
    shutil.copytree(repo / "portbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(here / "task.py", pb / "tasks" / "dense_solve.py")
    shutil.copy(here / "reference.py", pb / "references" / "kernel_ridge.py")
    files = {
        "configs/dense-solve.json": {
            "name": "dense-solve", "task": "dense_solve",
            "reference": "kernel_ridge", "dimension": 3, "n_points": 300,
            "ridge": 1e-2, "engine": {"args": {"ridge": 1e-2}}},
        "traffic/gp-rhs.json": {"signal_pool": 4, "length_scale": 0.5,
                                "noise": 0.1},
        f"workloads/{SOLVE}.json": {
            "check_rows": 64,
            "limits": {"err_max": 1e-9, "err_rms": 1e-10,
                       "repeat_gap": 0.0}}}
    for path, body in files.items():
        (pb / path).write_text(json.dumps(body))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "dense-solve", "source": "test", "reduced": [],
        "file": "portbench/configs/dense-solve.json", "why": "test"})
    bench["workloads"].append({"name": SOLVE, "config": "dense-solve",
                               "traffic": "gp-rhs", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_in(checkout, trace=0, override=None):
    code = textwrap.dedent(f"""
        import json
        from portbench import run
        args = run.parse(["--workload", {SOLVE!r}, "--seed",
                          str(2**31 + 99), "--seconds", "0.3", "--trace",
                          "{trace}", "--device", "cpu", "--override",
                          {json.dumps(override or {})!r}])
        result, lines = run.run_cell(args)
        print(json.dumps(result))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_solve_task_from_new_files_runs_and_is_judged(repo_env,
                                                        tmp_path):
    checkout = solve_checkout(repo_env, tmp_path)
    for trace in (0, 1):
        result = run_in(checkout, trace)
        assert result["correct"] is True, result
        assert result["attempted"] >= 4 and result["failed"] == 0
        assert result["checks"]["err_max"]["value"] < 1e-12
    wrong = run_in(checkout, override={"engine": {
        "args": {"ridge": 1e-2, "answer_scale": 1.01}}})
    assert wrong["correct"] is False
    assert wrong["failed"] == wrong["attempted"]
    assert wrong["checks"]["err_max"]["value"] > 1e-7


def test_the_solve_task_control_fails_its_limits(repo_env, tmp_path):
    checkout = solve_checkout(repo_env, tmp_path)
    code = textwrap.dedent(f"""
        import json
        from portbench import calibrate
        calibrate.calibrate(calibrate.parse([
            "--workload", {SOLVE!r}, "--seeds", "5,6", "--queries", "4",
            "--device", "cpu"]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in out.stdout.strip().splitlines():
        numbers = json.loads(line)
        assert numbers["program"]["err_max"] < 1e-12
        assert numbers["control"]["err_max"] > 1e-9


def test_a_task_declares_its_traffic_keys(monkeypatch):
    task = importlib.import_module("portbench.tasks.product")
    monkeypatch.setattr(task, "TRAFFIC_KEYS",
                        cells.TRAFFIC_KEYS | {"clients"}, raising=False)
    real = cells.load_json

    def load_json(path):
        out = real(path)
        return dict(out, clients=8) if "traffic" in str(path) else out
    monkeypatch.setattr(cells, "load_json", load_json)
    assert cells.load("cube-n2p20.signal-stream").traffic["clients"] == 8
