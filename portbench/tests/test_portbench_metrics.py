"""Each metric reader on measurements made up by hand, and the device
trace's arithmetic on made-up events."""

import re
from types import SimpleNamespace

import pytest

from portbench import devtrace, run
from portbench.session import Query, Report

DIRECT, FLASH = "kmb_direct_matvec", "kmb_flash_matvec"


def query(start, ms, kernel=None, launch_ms=(), signal=0, query_ms=None):
    q = Query(start, start + ms / 1e3, signal)
    if kernel is not None:
        q.launches = {DIRECT: 0, FLASH: 0}
        q.launches[kernel] = len(launch_ms)
        q.launch_ms = list(launch_ms)
        q.step_ms = {"stage": 1.0, "query": ms - 2.0 if query_ms is None
                     else query_ms, "read": 1.0}
    return q


def measured(reports, *, dimension=3, world=1, bound_ms=250.0):
    return SimpleNamespace(
        config={"dimension": dimension}, world=world, setup_s=7.5,
        window_s=2.0, reports=reports, queries=reports[0].queries,
        pairs=2**40, bound_ms=bound_ms)


def read(name, m):
    return run.read_metric(name, m)


def test_end_to_end_readers():
    qs = [query(i, 100.0 + i) for i in range(100)]
    m = measured([Report(queries=qs)])
    assert read("pairs_per_s", m) == 100 * 2**40 / 2.0
    assert read("pairs_per_s.attn", m) == read("pairs_per_s", m)
    assert read("setup_s", m) == 7.5
    # Inclusive 95th percentile of 100..199 ms.
    assert read("query_ms_p95", m) == pytest.approx(100 + 0.95 * 99)
    assert read("query_ms_p95", measured([Report(queries=qs[:1])])) is None


def test_counted_half_readers():
    counted = [query(i, 400.0, DIRECT, [330.0]) for i in range(4)]
    plain = [query(10 + i, 350.0) for i in range(4)]
    m = measured([Report(queries=counted + plain)])
    assert read("launches_per_query", m) == 1
    assert read("launches_per_query.attn", m) == 1
    assert read("non_kernel_ms.attn", m) == pytest.approx(70.0)
    assert read("small_d_roofline", m) == pytest.approx(100 * 250 / 330)
    assert read("flash_roofline", m) is None
    assert read("small_d_roofline", measured(m.reports, dimension=25)) \
        is None
    assert read("small_d_roofline", measured(m.reports, bound_ms=None)) \
        is None
    assert read("lockstep_ms.ring4", m) is None


def test_flash_roofline_reads_only_flash_queries():
    qs = [query(0, 20.0, FLASH, [15.0]), query(1, 20.0, DIRECT, [5.0])]
    m = measured([Report(queries=qs)], dimension=25, bound_ms=3.0)
    assert read("flash_roofline", m) == pytest.approx(100 * 3 / 15)
    assert read("small_d_roofline", m) is None


def test_readers_over_ranks():
    ranks = []
    for r in range(4):
        # Every rank's query() call takes 345 ms (the ranks end together);
        # rank r's kernels take 85 - r ms a step.
        qs = [query(i, 350.0, DIRECT, [85.0 - r] * 4, query_ms=345.0 + i)
              for i in range(3)]
        ranks.append(Report(queries=qs,
                            collective_bytes=3 * 27_262_976,
                            collective_queries=3,
                            trace={"busy_s": 9.0 + r / 10,
                                   "window_s": 10.0}))
    m = measured(ranks, world=4, bound_ms=263.0)
    # Rank 3 waits longest: 345 + i - 4 * 82 ms, i = 0, 1, 2.
    assert read("lockstep_ms.ring4", m) == pytest.approx(18.0)
    assert read("collective_mb_per_query.ring4", m) == pytest.approx(
        27.262976)
    assert read("launches_per_query", m) == 4
    assert read("small_d_roofline", m) == pytest.approx(
        100 * 4 * 263 / (4 * (340 - 6)))
    assert read("device_idle_share", m) == pytest.approx(
        100 * (1 - (36 + 0.6) / 40))
    assert read("device_idle_share.attn", m) == read("device_idle_share", m)


class Event:
    def __init__(self, name, start, end, device=False, children=()):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.cpu_children = list(children)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def trace_events():
    item = Event("aten::item", 55, 60)
    return [
        Event(devtrace.WINDOW, 0, 100),
        Event("portbench.stage", 0, 10, children=[Event("aten::to", 2, 9)]),
        Event("portbench.query", 10, 60, children=[item]),
        Event("portbench.read", 60, 100),
        Event("Memcpy HtoD", 5, 9, device=True),
        Event("void small_d_kernel<0, 3>", 12, 50, device=True),
        Event("Memcpy DtoH", 61, 70, device=True),
        Event("Memcpy DtoH", 65, 72, device=True),
    ]


def test_device_trace_busy_idle_and_breakdown():
    hand = re.compile(r"small_d_kernel")
    out = devtrace.summarize(Prof(trace_events()), hand, launched=1)
    # Busy: 5-9, 12-50, 61-72 = 4 + 38 + 11 us.
    assert out["busy_s"] == pytest.approx(53e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["hand_kernel_ms"] == pytest.approx(38e-3)
    assert out["device_ops"][0] == ["void small_d_kernel<0, 3>",
                                    pytest.approx(38e-6)]
    gaps = dict(out["idle_gaps"])
    # 0-5 and 9-12 under stage (aten::to covers 2-9; 10.5 is in query),
    # 50-61 in query at 55.5 (aten::item), 72-100 in read.
    assert gaps["read"] == pytest.approx(28e-6)
    assert gaps["query/aten::item"] == pytest.approx(11e-6)
    assert sum(gaps.values()) == pytest.approx(47e-6)


def test_device_trace_refuses_lost_records():
    with pytest.raises(devtrace.MissingRecords):
        devtrace.summarize(Prof(trace_events()), re.compile("small_d"),
                           launched=2)
