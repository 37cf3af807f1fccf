"""On the card: each cell's path at a reduced size prints the result
line with the metrics BENCHMARK.json lists for it, and is correct.  Run
from the repository root: `python -m pytest -p no:cacheprovider -q
portbench/tests` (this directory's conftest registers the `cuda`
marker)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import cell as cells

RING = "cube-n2p21-ring4.signal-stream"

SIZES = {
    "cube-n2p20.signal-stream": {"n_targets": 65536, "n_sources": 65536},
    "glove25.signal-stream": {"n_targets": 10000, "n_sources": 131072},
    "cube-n2p21-ring4.signal-stream": {"n_targets": 131072,
                                       "n_sources": 131072},
}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_cell_on_the_card(card, repo_env, name, trace):
    cell = cells.load(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace),
         "--override", json.dumps(SIZES[name])], cwd=repo_env,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == cell.chips
    assert device["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < device["busy_s"] <= device["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
    assert out.stderr.strip().splitlines()[-1].startswith(
        "check repeat_gap")


def _traced_ring(cwd, module, *before):
    out = subprocess.run(
        [sys.executable, "-m", module, *before, "--workload", RING,
         "--seed", str(2**31 + 5), "--seconds", "4", "--trace", "1",
         "--override", json.dumps(SIZES[RING])], cwd=cwd,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    return result["metrics"]["lockstep_ms.ring4"]["value"]


@pytest.mark.cuda
def test_lockstep_moves_with_a_slow_rank(card, repo_env):
    # Rank 1 sleeps about 5 ms on its card before each of the four ring
    # steps: every rank's query() call waits for it, its kernels do not
    # lengthen, so the lockstep grows by about 20 ms.
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    plain = _traced_ring(repo_env, "portbench.run")
    slow = _traced_ring(repo_env, "portbench.tests.fault_rank", "slow_rank")
    assert slow > plain + 10.0, (plain, slow)
