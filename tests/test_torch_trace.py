"""The port's spans and counters (kmb_tpu_torch/trace.py) and where the
port opens them: the engine, the wrapper, the fence, the ring and the
mesh.

On the CPU: the recorder's bookkeeping, the CPU engine's query, the
wrapper's staging counters, the profiler's `kmb.` records (in the
runner's KMB_PROFILE_DIR trace too), a gloo ring of 2 and 4 processes,
and what the benchmark's trace summary makes of `kmb.` records.  Marked
`cuda`: the same on the card.  This file imports
neither jax nor kmb_tpu, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_trace.py
"""

import contextlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmb_tpu_torch import trace
from kmb_tpu_torch.algorithms.torch_engine import TorchProduct
from kmb_tpu_torch.ops import product
from kmb_tpu_torch.ops.product import kernel_matvec_torch

from torch_sharded_worker import spawn_ranks

# A CPU query's spans, in the order they open.
CPU_QUERY = ["engine.stage_signal", "matvec", "fence.wait", "fence.check",
             "engine.read"]
# The card's: the wrapper's steps inside `matvec`.
CARD_QUERY = ["engine.stage_signal", "matvec", "matvec.stage_sources",
              "matvec.stage_targets", "matvec.stage_signal", "matvec.plan",
              "matvec.launch", "matvec.merge", "fence.wait", "fence.check",
              "engine.read"]


def _engine(device, n=200, m=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    engine = TorchProduct(kernel="exponential", dimension=d,
                          normalize_rows=True, device=device)
    engine.prepare_data(source_points=rng.standard_normal((m, d)) / d,
                        target_points=rng.standard_normal((n, d)) / d)
    engine.fit()
    return engine, rng.standard_normal((m, 1))


def _query(engine, signal):
    engine.prepare_query(source_signal=signal)
    engine.query()
    return engine.get_result()


# -- the recorder -------------------------------------------------------------

def test_off_hands_out_one_shared_context_and_records_nothing():
    assert trace._open is None
    first, second = trace.span("a"), trace.span("b")
    assert first is second
    with first:
        with second:
            pass
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_nesting_parents_identifier_and_self_time():
    with trace.recording() as first:
        pass
    with trace.recording() as rec:
        with trace.span("outer"):
            with trace.span("inner"):
                time.sleep(0.02)
            with trace.span("sibling"):
                with trace.span("leaf"):
                    pass
            time.sleep(0.01)
        with trace.span("after"):
            pass
    assert [s.name for s in rec.spans] == ["outer", "inner", "sibling",
                                           "leaf", "after"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2, -1]
    assert {s.query for s in rec.spans} == {rec.id} and rec.id != first.id
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    outer, inner, sibling, leaf, _ = rec.spans
    selves = trace.self_times(rec.spans)
    assert selves[0] == pytest.approx(outer.ms - inner.ms - sibling.ms)
    assert selves[2] == pytest.approx(sibling.ms - leaf.ms)
    assert selves[1] == inner.ms and inner.ms >= 20
    assert 10 <= selves[0] < outer.ms - 20


def test_self_times_by_name():
    spans = [trace.Span("a", -1, 0, 0, 10_000_000),
             trace.Span("b", 0, 0, 1_000_000, 4_000_000),
             trace.Span("c", 1, 0, 2_000_000, 3_000_000),
             trace.Span("b", -1, 0, 11_000_000, 12_000_000)]
    assert trace.self_times(spans) == pytest.approx([7.0, 2.0, 1.0, 1.0])
    rec = trace.Recording(7, spans=spans)
    assert rec.self_ms() == pytest.approx({"a": 7.0, "b": 3.0, "c": 1.0})


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match="open already"):
            with trace.recording():
                pass
    assert trace._open is None


def test_counters_snapshots_and_deltas():
    before = trace.counters()
    trace.count("test.things")
    trace.count("test.things", 4)
    with trace.recording() as rec:
        trace.count("test.other", 2)
    after = trace.counters()
    assert trace.delta(before, after) == {"test.things": 5, "test.other": 2}
    assert rec.counts == {"test.other": 2}
    assert trace.delta(after, trace.counters()) == {}
    snapshot = trace.counters()
    snapshot["test.things"] = -1   # a copy: the counters stay
    assert trace.counters()["test.things"] == after["test.things"]


# -- the engine, the wrapper and the fence on the CPU ---------------------------

def test_cpu_query_spans_in_order_with_its_counters():
    engine, signal = _engine("cpu")
    with trace.recording() as rec:
        answer = _query(engine, signal)
    assert [s.name for s in rec.spans] == CPU_QUERY
    assert [s.parent for s in rec.spans] == [-1] * len(CPU_QUERY)
    assert rec.counts == {}   # the plain product stages no points
    assert answer.dtype == np.float64 and answer.shape == (200, 1)
    # Outside a recording the same query keeps nothing.
    _query(engine, signal)
    assert trace._open is None


def test_wrapper_counts_stagings_not_served_by_the_source_cache():
    y = torch.rand(40, 3)

    def stage():
        return product._stage_points(y, 1.0, large=False, bf16=False)

    def counted(call):
        before = trace.counters()
        out = call()
        moved = trace.delta(before, trace.counters())
        return out, moved.get("points_staged", 0)

    key = ("test", 1.0)
    first, n = counted(lambda: product._staged_source(y, key, stage))
    assert n == 1
    again, n = counted(lambda: product._staged_source(y, key, stage))
    assert n == 0 and again is first   # served by the cache
    y.mul_(2.0)   # a new version: staged anew
    _, n = counted(lambda: product._staged_source(y, key, stage))
    assert n == 1
    _, n = counted(lambda: product._staged_source(y, ("other",), stage))
    assert n == 1
    with torch.inference_mode():
        frozen = torch.rand(40, 3)
    for _ in range(2):   # no version counter: staged every time
        _, n = counted(lambda: product._staged_source(
            frozen, key, lambda: product._stage_points(
                frozen, 1.0, large=True, bf16=False)))
        assert n == 1


def test_spans_are_profiler_records_only_when_asked():
    engine, signal = _engine("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording(profile=True) as rec:
            _query(engine, signal)
    events = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    assert [e.name for e in events] == [trace.PREFIX + n for n in CPU_QUERY]
    assert [s.name for s in rec.spans] == CPU_QUERY
    assert all(e.is_user_annotation for e in events)
    # The plain product's operators sit under the `matvec` span.
    (matvec,) = [e for e in events if e.name == "kmb.matvec"]
    assert any(c.name.startswith("aten::") for c in matvec.cpu_children)
    # A profiler session alone, or a plain recording inside one, leaves
    # the profiler's trace as it was without the port's spans.
    for recorder in (contextlib.nullcontext, trace.recording):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with recorder():
                _query(engine, signal)
        assert not any(e.name.startswith(trace.PREFIX)
                       for e in prof.events())
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("matvec") is trace.span("fence.wait")


def test_the_runner_trace_carries_the_spans(tmp_path, monkeypatch):
    from kmb_tpu_torch import runner
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.definitions import Definition

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path / "traces"))
    arrays = make_arrays("product-cube-D3-E1-M1000-N1000-gaussian")
    arrays["target_signal"] = arrays["source_signal"]   # any truth
    definition = Definition(
        algorithm="torch-product", module="kmb_tpu_torch.algorithms."
        "torch_engine", constructor="TorchProduct",
        arguments={"kernel": "gaussian", "dimension": 3, "device": "cpu"},
        query_argument_groups=[{}])
    (row,) = runner.run_on_arrays(definition, arrays, runs=2)
    with open(os.path.join(row.attrs["profile_trace"],
                           runner.TRACE_FILE)) as f:
        ours = sorted((e["ts"], e["name"]) for e in json.load(f)[
            "traceEvents"] if e.get("name", "").startswith(trace.PREFIX))
    names = [name for _, name in ours]
    # The traced repetition's query (its staging and read-back are not in
    # the runner's timed window).
    assert names == ["kmb.matvec", "kmb.fence.wait", "kmb.fence.check"]
    assert row.attrs["points_staged_per_query"] == 0.0   # the plain path


def test_the_runner_row_reports_points_staged_per_query(monkeypatch):
    from kmb_tpu_torch import runner
    from kmb_tpu_torch.datasets import make_arrays
    from kmb_tpu_torch.definitions import Definition

    query = TorchProduct.query

    def staging_query(self):   # as the card's wrapper stages the targets
        trace.count("points_staged")
        return query(self)

    monkeypatch.setattr(TorchProduct, "query", staging_query)
    arrays = make_arrays("product-cube-D3-E1-M1000-N1000-gaussian")
    arrays["target_signal"] = arrays["source_signal"]   # any truth
    definition = Definition(
        algorithm="torch-product", module="kmb_tpu_torch.algorithms."
        "torch_engine", constructor="TorchProduct",
        arguments={"kernel": "gaussian", "dimension": 3, "device": "cpu"},
        query_argument_groups=[{}, {}])
    rows = runner.run_on_arrays(definition, arrays, runs=3)
    assert [row.attrs["points_staged_per_query"] for row in rows] == [1, 1]


# -- the ring on gloo ranks -------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_ring_spans_and_counters_per_query(world, tmp_path):
    rng = np.random.default_rng(world)
    inputs = {"x": rng.random((37, 3)), "y": rng.random((45, 3)),
              "b": rng.standard_normal((45, 1))}
    ranks = spawn_ranks("trace", world, inputs, str(tmp_path))
    want = kernel_matvec_torch(*(torch.tensor(inputs[k])
                                 for k in ("x", "y", "b")),
                               kernel_name="gaussian").numpy()
    for out in ranks:
        names, parents = list(out["names"]), list(out["parents"])
        assert len(set(out["queries"])) == 1
        assert names.count("ring.step") == world
        assert names.count("ring.post") == world - 1
        assert names.count("ring.wait") == world - 1
        assert names.count("ring.fold") == world
        assert names.count("matvec") == world
        assert names.count("mesh.gather") == 1
        assert "mesh.publish" not in names   # the mesh is the world
        assert names[0] == "engine.stage_signal"
        assert names[-3:] == ["fence.wait", "fence.check", "engine.read"]
        for name, parent in zip(names, parents):
            if name in ("ring.post", "ring.fold", "ring.wait", "matvec"):
                assert names[parent] == "ring.step"
            if name == "ring.step":
                assert parent == -1
        # The plain product stages nothing through the kernels' wrapper
        # (on the card: each step's targets and visiting chunk).
        assert out["points_staged"] == 0
        for key in ("answer0", "answer1"):
            np.testing.assert_allclose(out[key], want, rtol=1e-5, atol=1e-6)


# -- what the benchmark's trace summary makes of the port's records -------------

def _event(name, start, end, device="CPU", annotation=False, children=()):
    return SimpleNamespace(
        name=name, device_type=f"DeviceType.{device}",
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation, cpu_children=list(children))


KERNEL = "void kmb::(anonymous namespace)::small_d_kernel<0, 3, 1>(kmb::Args)"


def _timeline(spans):
    """A made-up profiled query (microseconds): staging, the kernel, the
    fence's reduction and the read-back, with or without the port's
    spans (and their device-side copies, which cover idle time)."""
    copy_in, pad = _event("aten::copy_", 10, 90), _event("aten::pad", 110, 150)
    empty = _event("aten::empty", 170, 190)
    checks = [_event("aten::abs", 705, 715), _event("aten::item", 780, 800)]
    copy_out = _event("aten::copy_", 820, 940)
    if spans:
        stage = [_event("kmb.engine.stage_signal", 5, 95, annotation=True,
                        children=[copy_in])]
        query = [_event("kmb.matvec", 105, 200, annotation=True, children=[
                     _event("kmb.matvec.stage_targets", 108, 152,
                            annotation=True, children=[pad]),
                     _event("kmb.matvec.launch", 165, 195, annotation=True,
                            children=[empty])]),
                 _event("kmb.fence.wait", 700, 704, annotation=True),
                 _event("kmb.fence.check", 704, 800, annotation=True,
                        children=checks)]
        read = [_event("kmb.engine.read", 815, 945, annotation=True,
                       children=[copy_out])]
    else:
        stage, query, read = [copy_in], [pad, empty, *checks], [copy_out]
    events = [
        _event("portbench.window", 0, 1000, annotation=True),
        _event("portbench.stage", 0, 100, annotation=True, children=stage),
        _event("portbench.query", 100, 800, annotation=True, children=query),
        _event("portbench.read", 800, 950, annotation=True, children=read),
        _event("portbench.query", 150, 730, "CUDA", annotation=True),
        _event("Memcpy HtoD", 20, 80, "CUDA"),
        _event("pad_kernel", 155, 160, "CUDA"),
        _event(KERNEL, 200, 700, "CUDA"),
        _event("reduce_kernel", 720, 730, "CUDA"),
        _event("Memcpy DtoH", 850, 900, "CUDA")]
    if spans:   # the device-side copies of the port's spans
        events += [_event("kmb.matvec", 155, 700, "CUDA", annotation=True),
                   _event("kmb.fence.check", 720, 730, "CUDA",
                          annotation=True)]
    flat, todo = [], list(events)   # every event, as prof.events() has them
    while todo:
        event = todo.pop()
        flat.append(event)
        todo += event.cpu_children
    return SimpleNamespace(events=lambda: flat)


def test_the_benchmark_summary_reads_the_same_busy_time_with_spans():
    from kmb_tpu_torch.ops import _build
    from portbench import devtrace

    plain = devtrace.summarize(_timeline(False), _build.KERNEL_NAME, 1)
    spanned = devtrace.summarize(_timeline(True), _build.KERNEL_NAME, 1)
    for key in ("busy_s", "window_s", "hand_kernel_ms", "device_ops"):
        assert spanned[key] == plain[key], key
    assert plain["busy_s"] == pytest.approx(625e-6)
    idle = dict(plain["idle_gaps"])
    assert idle == pytest.approx({
        "stage/aten::copy_": 20e-6, "query/aten::pad": 75e-6,
        "query/aten::empty": 40e-6, "query/aten::abs": 20e-6,
        "query/aten::item": 120e-6, "read": 100e-6})
    # The same gaps, named by the outermost span of the port under the
    # harness's step.
    assert dict(spanned["idle_gaps"]) == pytest.approx({
        "stage/kmb.engine.stage_signal": 20e-6,
        "query/kmb.matvec": 115e-6, "query/kmb.fence.check": 140e-6,
        "read": 100e-6})


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_query_spans_in_order(card):
    engine, signal = _engine(card, n=2000, m=30000, d=25)
    _query(engine, signal)   # builds the library; stages the sources
    with trace.recording() as rec:
        _query(engine, signal)
    assert [s.name for s in rec.spans] == CARD_QUERY
    matvec = CARD_QUERY.index("matvec")
    for s in rec.spans:
        assert s.end_ns > s.start_ns, s.name
        if s.name.startswith("matvec."):
            assert s.parent == matvec
    # The targets, staged again; the sources come from the cache.
    assert rec.counts == {"points_staged": 1}
    assert all(ms >= 0 for ms in rec.self_ms().values())


@pytest.mark.cuda
def test_card_profiler_copies_of_spans_are_annotations(card):
    engine, signal = _engine(card, n=2000, m=30000, d=25)
    _query(engine, signal)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording(profile=True):
            _query(engine, signal)
    ours = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    host = [e.name for e in ours if not str(e.device_type).endswith("CUDA")]
    assert host == [trace.PREFIX + n for n in CARD_QUERY]
    # Device-side copies, where the profiler makes them, are marked as
    # annotations, so the benchmark's busy time leaves them out.
    assert all(e.is_user_annotation for e in ours)
