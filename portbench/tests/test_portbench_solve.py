"""The solve cell (`tasks/solve.py`, `references/kernel_solve.py`) on the
CPU at a small size: it runs through `portbench.run` and is correct; an
early stop, a scaled answer and the control are not; its pairs are each
solve's own matvecs; its four readers read a counted solve and read
nothing where the port lacks the spans or the counter."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from kmb_tpu_torch.algorithms import torch_engine
from portbench import cell as cells
from portbench import check, roofline, run
from portbench.readings import DIRECT
from portbench.references import kernel_solve
from portbench.session import Session

NAME = "cube-n2p17-pcg.krige-stream"
ENGINE = {"module": "kmb_tpu_torch.algorithms.torch_engine",
          "class": "TorchSolverCG",
          "args": {"precond": "nystrom", "precond_rank": 64, "tol": 1e-5}}
SMALL = {"n_points": 2048, "engine": ENGINE}
SEED = 2**31 + 77


def small(**args):
    return dict(SMALL, engine=dict(ENGINE, args=dict(ENGINE["args"],
                                                      **args)))


def cpu_args(override, trace=0, seconds=0.5, seed=SEED):
    return run.parse(["--workload", NAME, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace), "--device",
                      "cpu", "--override", json.dumps(override)])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_solve_cell_runs_on_the_cpu(repo_env, trace):
    result, lines = run.run_cell(cpu_args(SMALL, trace))
    assert result["correct"] is True, result
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"] == {}
    checks = result["checks"]
    # err_rms is the relative residual at the checked rows: at most a
    # little over the tolerance.
    assert checks["err_rms"]["value"] <= checks["err_rms"]["limit"]
    assert checks["repeat_gap"]["value"] == 0.0


def test_an_early_stop_fails(repo_env):
    result, _ = run.run_cell(cpu_args(small(tol=1e-4)))
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
    assert result["checks"]["err_rms"]["value"] > \
        cells.load(NAME).limits["err_rms"]


def test_a_scaled_answer_fails(repo_env, monkeypatch):
    original = torch_engine.TorchSolverCG.get_result
    monkeypatch.setattr(torch_engine.TorchSolverCG, "get_result",
                        lambda self: original(self) * (1 + 1e-3))
    result, _ = run.run_cell(cpu_args(SMALL))
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_the_control_fails_the_limits(seed):
    c = cells.load(NAME, SMALL)
    session = Session(c, seed, device="cpu")
    session.inputs = c.task.make_inputs(c.config, c.traffic, seed,
                                        c.check_rows)
    lowered, ids = c.task.control(session.inputs, c.config, "cpu")
    assert ids == list(range(c.traffic["signal_pool"]))
    correct, failed, numbers = check.judge(*session.compared(lowered, ids),
                                           c.limits)
    assert not correct and failed == len(lowered)
    assert numbers["err_rms"] > c.limits["err_rms"]


def test_inputs_repeat_for_a_seed_and_are_kernel_products():
    c = cells.load(NAME, dict(SMALL, n_points=300))
    one = c.task.make_inputs(c.config, c.traffic, SEED, 64)
    two = c.task.make_inputs(c.config, c.traffic, SEED, 64)
    other = c.task.make_inputs(c.config, c.traffic, SEED + 1, 64)
    for key in ("sources", "pool", "rows"):
        assert np.array_equal(getattr(one, key), getattr(two, key))
    assert not np.array_equal(one.pool, other.pool)
    assert one.pool.shape == (16, 300, 1) and one.pool.dtype == np.float64
    assert one.rows[0] == 0 and one.rows[-1] == 299 and len(one.rows) == 64
    # Each right-hand side is K w: it lies in K's range, to float64.
    x = one.sources.astype(np.float64)
    k = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    w = np.linalg.lstsq(k, one.pool[0], rcond=None)[0]
    assert np.linalg.norm(k @ w - one.pool[0]) <= 1e-8 * np.linalg.norm(
        one.pool[0])


def test_a_repeat_that_differs_gets_its_own_product():
    c = cells.load(NAME, dict(SMALL, n_points=300))
    inputs = c.task.make_inputs(c.config, c.traffic, SEED, 32)
    b = np.random.default_rng(1).standard_normal((300, 1))
    off = b.copy()
    off[5] += 1e-6
    out = c.task.compared(inputs, c.config, [b, b, off, b], [0, 0, 0, 1],
                          "cpu")
    assert np.array_equal(out[0][0], out[1][0])
    _, _, numbers = check.judge(out, [0, 0, 0, 1], c.limits)
    assert numbers["repeat_gap"] > 0
    want = kernel_solve.residual_terms(inputs.sources, off, inputs.rows,
                                       device="cpu")
    assert np.allclose(out[2][0], want, rtol=1e-12, atol=0)
    assert np.array_equal(out[3][1], inputs.pool[1][inputs.rows])


def test_the_least_time_is_one_matvec_on_the_special_function_units():
    sfu = roofline.special_function_rate(132, 1980.0)
    c = cells.load(NAME)
    n = c.config["n_points"]
    assert n == 131072
    ms = c.task.launch_bound_ms(c.config, 1, sfu)
    assert ms == pytest.approx(n * n / sfu * 1e3, rel=1e-12)
    assert roofline.bound_ms(n, n, 3, 1, "direct", False, "float32",
                             sfu)[2] == "special-function units"


def test_a_solve_counts_the_pairs_of_its_own_matvecs():
    # pairs_per_s = queries x pairs / window: N^2 for each matvec of the
    # window's solves, however many each took.
    c = cells.load(NAME, SMALL)
    session = Session(c, SEED, device="cpu")
    session.set_up()
    assert c.task.pairs(c.config) == 2048**2
    session.window(1e9, counted=True, queries=3)
    matvecs = [q.counts["pcg_iterations"] for q in session.report.queries]
    assert all(m > 0 for m in matvecs)
    assert c.task.pairs(c.config) * 3 == pytest.approx(2048**2
                                                       * sum(matvecs))
    # A new run's set-up starts the count again.
    c.task.prepare(c.task.build(c.config, "cpu"), session.inputs)
    assert c.task.pairs(c.config) == 2048**2


# -- the plain reference ---------------------------------------------------------

def test_reference_products_follow_the_definition():
    rng = np.random.default_rng(5)
    points = rng.random((300, 3)).astype(np.float32)
    w = rng.standard_normal((300, 2))
    x = points.astype(np.float64)
    k = np.exp(-((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    assert np.allclose(kernel_solve.rhs(points, w, device="cpu"), k @ w,
                       rtol=1e-12, atol=1e-12)
    rows = np.array([0, 17, 299])
    assert np.allclose(kernel_solve.residual_terms(points, w, rows,
                                                   device="cpu"),
                       (k @ w)[rows], rtol=1e-12, atol=1e-12)


def test_reference_control_is_a_lower_precision_solve():
    # The same solve with bfloat16 kernel values and vectors: its residual
    # stays far above the float32 solver's tolerance.
    rng = np.random.default_rng(7)
    points = rng.random((1024, 3)).astype(np.float32)
    a = kernel_solve.rhs(points, rng.standard_normal((1024, 3)),
                         device="cpu")
    tol = ENGINE["args"]["tol"]
    lowered = kernel_solve.control(points, a.T[:, :, None], rank=64,
                                   tol=tol, max_iters=1000, device="cpu")
    assert lowered.shape == (3, 1024, 1) and lowered.dtype == np.float64
    kb = kernel_solve.residual_terms(points, lowered[:, :, 0].T,
                                     np.arange(1024), device="cpu")
    residual = np.linalg.norm(kb - a, axis=0) / np.linalg.norm(a, axis=0)
    assert np.all(residual > 10 * tol) and np.all(residual < 0.5)


# -- the readers ------------------------------------------------------------------

READERS = ("pcg_iterations.solve", "iteration_overhead_ms.solve",
           "small_d_roofline.solve", "device_idle_share.solve")


def counted_solves(queries=2):
    """Counted CPU solves, each given the launches the card would make:
    one direct-kernel launch of 2 ms an iteration."""
    c = cells.load(NAME, SMALL)
    session = Session(c, SEED, device="cpu")
    session.set_up()
    session.window(1e9, counted=True, queries=queries)
    for q in session.report.queries:
        q.launches = {DIRECT: q.counts["pcg_iterations"]}
        q.launch_ms = [2.0] * q.counts["pcg_iterations"]
    return session.report.queries


def measured(queries, trace=None):
    return SimpleNamespace(
        config={"dimension": 3}, world=1, setup_s=1.0, window_s=1.0,
        reports=[SimpleNamespace(queries=queries, trace=trace)],
        queries=queries, pairs=2048**2, launch_bound_ms=1.5)


def test_the_readers_read_a_counted_solve():
    queries = counted_solves()
    m = measured(queries, trace={"busy_s": 0.9, "window_s": 1.0})
    iterations = [q.counts["pcg_iterations"] for q in queries]
    assert all(i > 0 for i in iterations)
    assert run.read_metric("pcg_iterations.solve", m) == \
        sum(iterations) / len(iterations)
    overheads = []
    for q, i in zip(queries, iterations):
        inside = sum(ms for name, ms in q.span_ms.items()
                     if name.split(".")[0] in ("pcg", "matvec"))
        assert inside <= q.ms
        overheads.append((inside - 2.0 * i) / i)
    assert run.read_metric("iteration_overhead_ms.solve", m) == \
        pytest.approx(float(np.median(overheads)))
    assert run.read_metric("small_d_roofline.solve", m) == \
        pytest.approx(100 * 1.5 / 2.0)
    assert run.read_metric("device_idle_share.solve", m) == \
        pytest.approx(10.0)


def test_the_readers_read_nothing_without_the_spans_or_counter():
    queries = counted_solves(1)
    # A port without the loop's spans and counter (the parent's): the
    # query's other spans, no `pcg`, no counts.
    for q in queries:
        q.span_ms = {k: v for k, v in q.span_ms.items()
                     if not k.startswith("pcg")}
        q.counts = {}
    m = measured(queries)
    assert run.read_metric("pcg_iterations.solve", m) is None
    assert run.read_metric("iteration_overhead_ms.solve", m) is None
    assert run.read_metric("device_idle_share.solve", m) is None
    # A port with no trace module at all.
    for q in queries:
        q.span_ms = q.counts = None
    assert run.read_metric("pcg_iterations.solve", m) is None
    assert run.read_metric("iteration_overhead_ms.solve", m) is None
    # Nothing counted: every reader reads nothing.
    plain = measured([SimpleNamespace(launches=None)])
    plain.reports[0].trace = None
    for name in READERS:
        assert run.read_metric(name, plain) is None
