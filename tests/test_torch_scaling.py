"""The port's device-count sweep (kmb_tpu_torch.scaling) beside the
repository's scaling.py.

On the CPU the times say nothing of a card; the rows' keys, the
efficiency's definition, the answers and the process groups are what is
checked.  Answers: against the float64 oracle at 1e-5 relative to the
largest entry (float32 inputs and sums), and across mesh sizes at 1e-5.
"""

import json

import numpy as np
import pytest

import scaling as jax_scaling

from kmb_tpu_torch import scaling
from kmb_tpu_torch.algorithms.bruteforce_numpy import blocked_kernel_product

from torch_sharded_worker import spawn_ranks

N = 512
TOL = 1e-5


def _oracle(n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 3)).astype(np.float32).astype(np.float64)
    b = rng.standard_normal((n, 1)).astype(np.float32).astype(np.float64)
    return blocked_kernel_product(kernel="gaussian", source_points=x,
                                  source_signal=b)


def test_rows_match_the_jax_sweep():
    answers = []
    rows = scaling.measure(n=N, d=3, e=1, kernel="gaussian",
                           device_counts=[1], runs=2, device="cpu",
                           outputs=answers)
    jax_rows = jax_scaling.measure(n=N, d=3, e=1, kernel="gaussian",
                                   device_counts=[1], runs=1)
    assert [sorted(row) for row in rows] == [sorted(row) for row in jax_rows]
    (row,) = rows
    assert row["devices"] == 1
    assert row["efficiency"] == 1.0
    assert row["seconds"] > 0
    assert row["pairs_per_second"] == N * N / row["seconds"]
    truth = _oracle(N)
    got = answers[0].double().numpy()
    assert np.abs(got - truth).max() <= TOL * np.abs(truth).max()


def test_more_cards_than_ranks_raise():
    with pytest.raises(ValueError, match="2 ranks"):
        scaling.measure(n=64, d=3, e=1, kernel="gaussian",
                        device_counts=[1, 2], runs=1, device="cpu")


def test_main_prints_the_table_and_json_rows(capsys):
    rows = scaling.main(["-n", "256", "--runs", "1", "--hardware", "CPU"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["devices", "seconds", "pairs/s", "per-device",
                              "efficiency"]
    printed = [json.loads(line) for line in out if line.startswith("{")]
    assert printed == rows and [r["devices"] for r in rows] == [1]


def test_two_ranks_equal_answers(tmp_path):
    # Rank 1 sits outside the first mesh; the per-test timeout of the
    # ranks' processes catches a rank left waiting in a collective.
    outputs = spawn_ranks("scaling", 2, {"n": np.int64(N)}, str(tmp_path),
                          timeout=120)
    rank0, rank1 = outputs
    assert bool(rank0["answer1/member"]) and not bool(rank1["answer1/member"])
    assert bool(rank1["answer2/member"])
    one, two = rank0["answer1"], rank0["answer2"]
    scale = np.abs(one).max()
    assert np.abs(two - one).max() <= TOL * scale
    np.testing.assert_array_equal(rank1["answer2"], two)
    truth = _oracle(N)
    assert np.abs(one - truth).max() <= TOL * np.abs(truth).max()
    for out in outputs:   # every rank holds the same rows
        assert float(out["row1/efficiency"]) == 1.0
        for p in (1, 2):
            assert float(out[f"row{p}/devices"]) == p
            assert float(out[f"row{p}/seconds"]) == float(
                rank0[f"row{p}/seconds"])
            assert float(out[f"row{p}/pairs_per_second"]) == (
                N * N / float(out[f"row{p}/seconds"]))
