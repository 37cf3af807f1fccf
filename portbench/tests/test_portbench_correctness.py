"""The comparison that decides `correct`: the control (the reference one
precision lower) fails every cell's limits, and so does a run with each
fault the cell can have planted under its timed path."""

import json
import sys

import numpy as np
import pytest

from portbench import cell as cells
from portbench import check, data, run
from portbench.session import Session
from portbench.tests import faults
from portbench.tests.test_portbench_harness import SMALL, cpu_args

CELLS = sorted(SMALL)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, seed):
    c = cells.load(name, SMALL[name])
    session = Session(c, seed, device="cpu")
    session.inputs = data.make_inputs(c.config, c.traffic, seed,
                                      c.check_rows)
    lowered, ids = c.task.control(session.inputs, c.config, "cpu")
    correct, failed, numbers = check.judge(*session.compared(lowered, ids),
                                           c.limits)
    assert not correct and failed == len(lowered)
    assert numbers["err_rms"] > c.limits["err_rms"]


def test_judge_counts_each_failed_answer():
    ref = np.array([[[1.0], [2.0]], [[3.0], [-1.0]]])
    size = np.abs(ref) + 1.0
    answers = [ref[0], ref[1] + 1e-3, ref[0] + [[0.0], [1e-9]], ref[1]]
    ids = [0, 1, 0, 1]
    limits = {"err_max": 1e-6, "err_rms": 1e-6, "repeat_gap": 0.0}
    correct, failed, numbers = check.judge(
        [(a, ref[s], size[s]) for a, s in zip(answers, ids)], ids, limits)
    assert not correct and failed == 3
    assert numbers["repeat_gap"] == pytest.approx(1e-3)
    # Measured against the size of the terms: RMS of (4, 2) for signal 1.
    assert numbers["err_max"] == pytest.approx(1e-3 / np.sqrt(10))
    nan = [(ref[0] * float("nan"), ref[0], size[0])]
    correct, failed, numbers = check.judge(nan, [0], limits)
    assert not correct and failed == 1 and numbers["err_max"] is None
    assert check.judge([], [], limits)[0] is False


FAULTS = [(name, fault) for name in CELLS
          for fault in ("stale", "half", "altered")]
FAULTS.append(("cube-n2p21-ring4.signal-stream", "exchange"))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_each_fault_fails_the_run(repo_env, name, fault):
    undo = faults.plant(fault)
    try:
        result, lines = run.run_cell(
            cpu_args(name, seconds=0.5),
            prefix=[sys.executable, "-m", "portbench.tests.fault_rank",
                    fault])
    finally:
        undo()
    assert result["correct"] is False, json.dumps(result)
    assert result["failed"] >= 1
