"""What the metric readers share: the counted half's queries, which of
the port's kernels launched in them (by its C entry point), and the
readers of a quantity that cells with different end-to-end metrics
report under names of their own (`pairs_per_s`, `pairs_per_s.attn`)."""

from __future__ import annotations

DIRECT = "kmb_direct_matvec"
FLASH = "kmb_flash_matvec"


def counted(queries):
    """The queries of a traced run's counted half."""
    return [q for q in queries if q.launches is not None]


def only(queries, kernel):
    """Counted queries whose launches were all of `kernel`."""
    return [q for q in counted(queries)
            if q.launches.get(kernel, 0) > 0
            and sum(q.launches.values()) == q.launches[kernel]]


def roofline_share(measured, kernel):
    """Percent: the least time of the queries that launched only `kernel`,
    over the device time of their launches, on every rank; None when no
    query launched it or no least time is known."""
    if measured.bound_ms is None:
        return None
    least = device = 0.0
    for report in measured.reports:
        for q in only(report.queries, kernel):
            least += measured.bound_ms
            device += sum(q.launch_ms)
    return 100.0 * least / device if device > 0 else None


def pairs_per_s(measured):
    """Kernel pairs (N x M per query) answered in the window, per second
    of the window, from its first query's start to its last answer."""
    return len(measured.queries) * measured.pairs / measured.window_s


def launches_per_query(measured):
    """Launches of the port's kernels per query on rank 0 (its launch
    counters over the counted half)."""
    queries = counted(measured.queries)
    if not queries:
        return None
    return sum(sum(q.launches.values()) for q in queries) / len(queries)


def device_idle_share(measured):
    """Percent of the profiled half in which no kernel, copy or set ran on
    the device, from torch.profiler's trace, averaged over the ranks."""
    traces = [r.trace for r in measured.reports if r.trace]
    if not traces:
        return None
    busy = sum(t["busy_s"] for t in traces)
    window = sum(t["window_s"] for t in traces)
    return 100.0 * (1.0 - busy / window)
