"""The runner's torch.profiler hook (KMB_PROFILE_DIR), beside kmb_tpu's.

With KMB_PROFILE_DIR set, the last query repetition of each query-argument
group is traced and written as one Chrome trace into
KMB_PROFILE_DIR/<dataset>__<algorithm>__g<pos> (the directory name
kmb_tpu's jax.profiler hook uses), stored as that group's `profile_trace`
attribute.  Without the variable nothing is traced.  The query timer runs
inside the profiler's context and the export outside the timed window.
"""

import json
import os
import time

import pytest
from torch.profiler import profile

import kmb_tpu.runner as jax_runner
from kmb_tpu.definitions import Definition as JaxDefinition

import kmb_tpu_torch.runner as runner
from kmb_tpu_torch.algorithms.torch_engine import TorchSolverDirect
from kmb_tpu_torch.definitions import Definition
from kmb_tpu_torch.parallel import multihost
from kmb_tpu_torch.results import load_all_results

PRODUCT = "product-cube-D3-E1-M1000-N1000-gaussian"
SOLVER = "solver-cube-D3-E1-M1000-N1000-gaussian"
SLOW = 0.5   # seconds a monkeypatched profiler start and export take


def _product(cls=Definition, module="kmb_tpu_torch.algorithms.dummy"):
    return cls(algorithm="dummy-product", module=module,
               constructor="DummyProduct",
               arguments={"kernel": "gaussian", "dimension": 3},
               query_argument_groups=[{}])


def _solver():
    # Two query-argument groups of a cheap query (a back-substitution).
    return Definition(
        algorithm="torch-solver-direct",
        module="kmb_tpu_torch.algorithms.torch_engine",
        constructor="TorchSolverDirect",
        arguments={"kernel": "gaussian", "dimension": 3,
                   "precision": "float32", "device": "cpu"},
        query_argument_groups=[{"rcond": 1e-12}, {"rcond": 1e-10}])


def _trace_files(root):
    return sorted(os.path.join(d, name) for d, _, names in os.walk(root)
                  for name in names)


def test_one_trace_per_group_from_the_last_repetition(tmp_path, monkeypatch):
    traces = tmp_path / "traces"
    monkeypatch.setenv("KMB_PROFILE_DIR", str(traces))
    log = []

    def logged(name, method):
        def wrapper(self, *args):
            log.append(name)
            return method(self, *args)
        return wrapper

    monkeypatch.setattr(TorchSolverDirect, "query",
                        logged("query", TorchSolverDirect.query))
    monkeypatch.setattr(profile, "__enter__",
                        logged("start", profile.__enter__))
    monkeypatch.setattr(profile, "__exit__", logged("stop", profile.__exit__))
    runner.run(definition=_solver(), dataset=SOLVER, runs=3, device="cpu")

    # Three repetitions per group, the last one alone traced.
    assert log == ["query", "query", "start", "query", "stop"] * 2
    groups = {}
    for props, _ in load_all_results(SOLVER):
        groups[props["profile_trace"]] = props
    assert sorted(os.path.basename(d) for d in groups) == [
        f"{SOLVER}__torch-solver-direct__g1",
        f"{SOLVER}__torch-solver-direct__g2"]
    files = _trace_files(traces)
    assert files == sorted(os.path.join(d, runner.TRACE_FILE)
                           for d in groups)
    for fn in files:
        with open(fn) as f:
            trace = json.load(f)
        ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
        assert ops, f"{fn} holds no operator"


def _arrays():
    from kmb_tpu_torch.datasets import make_arrays

    arrays = make_arrays(PRODUCT)
    arrays["target_signal"] = arrays["source_signal"]   # any truth
    return arrays


def test_no_variable_no_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("KMB_PROFILE_DIR", raising=False)
    started = []
    monkeypatch.setattr(profile, "__enter__",
                        lambda self: started.append(self))
    rows = runner.run_on_arrays(_product(), _arrays(), runs=2)
    assert "profile_trace" not in rows[0].attrs
    assert started == []
    assert os.listdir(tmp_path) == []


def test_start_and_export_are_untimed(tmp_path, monkeypatch):
    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path / "traces"))
    start, export = profile.__enter__, profile.export_chrome_trace

    def slow_start(self):
        time.sleep(SLOW)
        return start(self)

    def slow_export(self, path):
        time.sleep(SLOW)
        return export(self, path)

    monkeypatch.setattr(profile, "__enter__", slow_start)
    monkeypatch.setattr(profile, "export_chrome_trace", slow_export)
    t0 = time.perf_counter()
    (row,) = runner.run_on_arrays(_product(), _arrays(), runs=1)
    assert time.perf_counter() - t0 >= 2 * SLOW   # both ran ...
    assert row.attrs["query_time"] < SLOW         # ... outside the timer
    assert _trace_files(tmp_path / "traces") == [
        os.path.join(row.attrs["profile_trace"], runner.TRACE_FILE)]


def test_trace_names_match_kmb_tpu(tmp_path, monkeypatch):
    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path / "traces"))
    names = {}
    for package, run, definition, kwargs in (
            ("kmb_tpu", jax_runner.run,
             _product(JaxDefinition, "kmb_tpu.algorithms.dummy"), {}),
            ("kmb_tpu_torch", runner.run, _product(), {"device": "cpu"})):
        monkeypatch.setenv("KMB_RESULTS_DIR", str(tmp_path / package))
        run(definition=definition, dataset=PRODUCT, runs=2, **kwargs)
        (props, _), = list(load_all_results(PRODUCT))
        names[package] = os.path.relpath(props["profile_trace"],
                                         str(tmp_path / "traces"))
    assert names["kmb_tpu"] == names["kmb_tpu_torch"] == (
        f"{PRODUCT}__dummy-product__g1")


def test_each_rank_writes_its_own_trace(tmp_path, monkeypatch):
    import torch.distributed

    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    monkeypatch.setattr(multihost, "num_hosts", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    tracer, trace_dir = runner._maybe_profile(PRODUCT, _product(), 1, 2, 3,
                                              None)
    assert isinstance(tracer, profile)
    assert trace_dir == os.path.join(
        str(tmp_path), f"{PRODUCT}__dummy-product__g3__rank1")
    tracer, trace_dir = runner._maybe_profile(PRODUCT, _product(), 0, 2, 3,
                                              None)
    assert trace_dir is None   # not the last repetition


@pytest.mark.parametrize("device,activities", [
    ("cpu", {"CPU"}), ("cuda", {"CPU", "CUDA"})])
def test_activities_follow_the_device(device, activities, tmp_path,
                                      monkeypatch):
    import torch

    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    tracer, _ = runner._maybe_profile(PRODUCT, _product(), 0, 1, 1,
                                      torch.device(device))
    assert {a.name for a in tracer.activities} == activities


class _FakeProfile:
    """What the hook's trace callback reads of a finished profile: events
    of these device types, with these names (default: none of the hand
    kernels')."""

    def __init__(self, device_types, names=None):
        self.device_types = device_types
        self.names = names or [""] * len(device_types)
        self.exported = []

    def events(self):
        return [type("Event", (), {"device_type": t, "name": n})()
                for t, n in zip(self.device_types, self.names)]

    def export_chrome_trace(self, path):
        self.exported.append(path)


@pytest.mark.parametrize("device_types, written", [
    (["DeviceType.CPU", "DeviceType.CUDA"], True),
    (["DeviceType.CPU"], False),
    ([], False)])
def test_a_cuda_trace_without_kernels_is_refused(device_types, written,
                                                 tmp_path, monkeypatch):
    # CUPTI has dropped a process's kernel records before: a trace of a
    # query on the card with no device event is not written; the hook
    # leaves the reason beside it and raises.
    import torch

    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    tracer, trace_dir = runner._maybe_profile(PRODUCT, _product(), 0, 1, 1,
                                              torch.device("cuda"))
    prof = _FakeProfile(device_types)
    failed = os.path.join(trace_dir, runner.FAILED_TRACE_FILE)
    if written:
        tracer.on_trace_ready(prof)
        assert prof.exported == [os.path.join(trace_dir, runner.TRACE_FILE)]
        assert not os.path.exists(failed)
    else:
        with pytest.raises(RuntimeError, match="no CUDA kernel"):
            tracer.on_trace_ready(prof)
        assert prof.exported == []
        with open(failed) as f:
            assert "no CUDA kernel" in f.read()


KERNEL = ("void kmb::(anonymous namespace)::small_d_kernel<0, 3, 1, false, "
          "false, false>(kmb::Args)")


@pytest.mark.parametrize("names, launched, written", [
    (["aten::mul", KERNEL], 1, True),
    (["aten::mul", "Memset (Device)"], 0, True),   # no hand kernel launched
    (["aten::mul", "Memset (Device)"], 1, False),  # launched, records lost
    (["aten::mul", "Memset (Device)"], 3, False)])
def test_a_trace_without_the_hand_kernels_is_refused(
        names, launched, written, tmp_path, monkeypatch):
    # CUPTI has dropped the hand kernels' records while keeping other
    # device events (tools/profiler_sequence.py): a trace of a query that
    # launched them must hold one of theirs, or the hook refuses it.
    import torch

    from kmb_tpu_torch.ops import _build

    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    tracer, trace_dir = runner._maybe_profile(PRODUCT, _product(), 0, 1, 1,
                                              torch.device("cuda"))
    monkeypatch.setattr(_build.DIRECT, "launches",
                        _build.DIRECT.launches + launched)
    prof = _FakeProfile(["DeviceType.CPU", "DeviceType.CUDA"], names)
    if written:
        tracer.on_trace_ready(prof)
        assert prof.exported == [os.path.join(trace_dir, runner.TRACE_FILE)]
    else:
        with pytest.raises(RuntimeError, match=f"no CUDA kernel of the "
                           f"{launched} launches"):
            tracer.on_trace_ready(prof)
        assert prof.exported == []
        assert os.path.exists(os.path.join(trace_dir,
                                           runner.FAILED_TRACE_FILE))


def test_a_cpu_trace_needs_no_kernel(tmp_path, monkeypatch):
    import torch

    monkeypatch.setenv("KMB_PROFILE_DIR", str(tmp_path))
    tracer, trace_dir = runner._maybe_profile(PRODUCT, _product(), 0, 1, 1,
                                              torch.device("cpu"))
    prof = _FakeProfile(["DeviceType.CPU"])
    tracer.on_trace_ready(prof)
    assert prof.exported == [os.path.join(trace_dir, runner.TRACE_FILE)]
