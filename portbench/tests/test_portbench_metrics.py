"""Each metric reader on measurements made up by hand, and the device
trace's arithmetic on made-up events."""

import re
from types import SimpleNamespace

import pytest

from portbench import devtrace, run
from portbench.session import Query, Report

DIRECT, FLASH = "kmb_direct_matvec", "kmb_flash_matvec"


def query(start, ms, kernel=None, launch_ms=(), signal=0, query_ms=None,
          span_ms=None, counts=None):
    q = Query(start, start + ms / 1e3, signal)
    if kernel is not None:
        q.launches = {DIRECT: 0, FLASH: 0}
        q.launches[kernel] = len(launch_ms)
        q.launch_ms = list(launch_ms)
        q.step_ms = {"stage": 1.0, "query": ms - 2.0 if query_ms is None
                     else query_ms, "read": 1.0}
        q.span_ms, q.counts = span_ms, counts
    return q


def measured(reports, *, dimension=3, world=1, bound_ms=250.0):
    """`bound_ms`: the least time of one launch."""
    return SimpleNamespace(
        config={"dimension": dimension}, world=world, setup_s=7.5,
        window_s=2.0, reports=reports, queries=reports[0].queries,
        pairs=2**40, launch_bound_ms=bound_ms)


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
    # Without the port's spans and counters (a port with no trace module).
    for name in ("stage_ms.attn", "fence_ms.attn", "read_ms.attn",
                 "points_staged_per_query", "points_staged_per_query.attn",
                 "one_chunk_launches_per_query.attn",
                 "port_idle_share.attn"):
        assert read(name, m) is None, name


@pytest.mark.parametrize("launches", [1, 4, 150])
def test_roofline_share_counts_every_launch(launches):
    # Each launch has the least time 2 ms and takes 5 ms on the device; a
    # query that launched the other kernel too is left out.
    qs = [query(i, 40.0 * launches, DIRECT, [5.0] * launches)
          for i in range(3)]
    mixed = query(3, 40.0, DIRECT, [5.0, 5.0])
    mixed.launches[FLASH] = 1
    m = measured([Report(queries=qs + [mixed])], bound_ms=2.0)
    assert read("small_d_roofline", m) == pytest.approx(100 * 2 / 5)
    uneven = [query(0, 40.0, DIRECT, [4.0]),
              query(1, 40.0, DIRECT, [6.0] * launches)]
    m = measured([Report(queries=uneven)], bound_ms=2.0)
    assert read("small_d_roofline", m) == pytest.approx(
        100 * 2 * (1 + launches) / (4 + 6 * launches))


def test_span_and_counter_readers():
    spans = [{"engine.stage_signal": 1.3, "matvec.stage_targets": 0.05,
              "matvec.stage_signal": 0.02, "matvec.launch": 0.1,
              "fence.wait": 7.4, "fence.check": 0.2, "engine.read": 0.2 + i}
             for i in range(3)]
    counts = [{"points_staged": 1, "one_chunk_launches": 1}, {},
              {"points_staged": 2}]
    qs = [query(i, 10.0, FLASH, [7.5], span_ms=sp, counts=ct)
          for i, (sp, ct) in enumerate(zip(spans, counts))]
    m = measured([Report(queries=qs + [query(9, 10.0)])], dimension=25)
    assert read("stage_ms.attn", m) == pytest.approx(1.37)
    assert read("fence_ms.attn", m) == pytest.approx(0.2)
    assert read("read_ms.attn", m) == pytest.approx(1.2)
    assert read("points_staged_per_query", m) == 1.0
    assert read("points_staged_per_query.attn", m) == 1.0
    assert read("one_chunk_launches_per_query.attn", m) == pytest.approx(
        1 / 3)
    # The cube stages nothing: 0, not "nothing to read".
    none = [query(i, 10.0, DIRECT, [7.5], span_ms={}, counts={})
            for i in range(2)]
    assert read("points_staged_per_query",
                measured([Report(queries=none)])) == 0.0


def test_port_idle_share_reader():
    ranks = [Report(queries=[query(0, 1.0)],
                    trace={"busy_s": 8.0, "window_s": 10.0,
                           "port_idle_s": 1.0 + r}) for r in range(2)]
    assert read("port_idle_share.attn", measured(ranks)) == pytest.approx(
        100 * 3.0 / 20.0)
    ranks[0].trace["port_idle_s"] = ranks[1].trace["port_idle_s"] = None
    assert read("port_idle_share.attn", measured(ranks)) is None


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
    m = measured(ranks, world=4, bound_ms=263.0 / 4)
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


def port_events(annotated=True):
    """trace_events() with the port's spans: the host's `kmb.` records
    and, where `annotated`, their device-side copies flagged as
    annotations; otherwise copies known only by their name."""
    stage = Event("kmb.engine.stage_signal", 1, 9,
                  children=[Event("aten::to", 2, 9)])
    fence = Event("kmb.fence.check", 52, 60,
                  children=[Event("aten::item", 55, 60)])
    events = [e for e in trace_events()
              if e.name not in ("portbench.stage", "portbench.query")]
    events += [Event("portbench.stage", 0, 10, children=[stage]),
               Event("portbench.query", 10, 60, children=[fence]),
               stage, fence,
               Event("kmb.fence.check", 50, 61, device=True)]
    events[-1].is_user_annotation = annotated
    return events


@pytest.mark.parametrize("annotated", [True, False])
def test_device_trace_with_the_port_records(annotated):
    hand = re.compile(r"small_d_kernel")
    plain = devtrace.summarize(Prof(trace_events()), hand, launched=1)
    out = devtrace.summarize(Prof(port_events(annotated)), hand, launched=1)
    for key in ("busy_s", "window_s", "hand_kernel_ms", "device_ops"):
        assert out[key] == plain[key], key
    assert plain["port_idle_s"] is None
    gaps = dict(out["idle_gaps"])
    # The gap 50-61 is named by the port's span over its middle (55.5).
    assert gaps["query/kmb.fence.check"] == pytest.approx(11e-6)
    assert gaps["stage/kmb.engine.stage_signal"] == pytest.approx(5e-6)
    # Idle inside kmb. spans: 1-5 and 9 (stage), 52-60 (fence).
    assert out["port_idle_s"] == pytest.approx((4 + 0 + 8) * 1e-6)
