"""The device's busy and idle time from one torch.profiler session.

One session per process, over the second half of a traced run's window:
the port's records show that CUPTI may drop the hand kernels' records in a
later session of a process, never in its first.  The harness marks its
own work with `record_function` spans named `portbench.<step>`; the
window is the `portbench.window` span.  The port's own spans are records
named `kmb.<step>` (its `trace.recording(profile=True)`): annotations of
the host's work, never device time.

`summarize` returns the seconds in which a device operation (a kernel, a
copy or a set) ran inside the window, the window's length, the ten device
operations that took most time, the device's idle time grouped by what
the host was doing: the harness step and the outermost operation under
it at the middle of each gap (the port's outermost span, where one covers
it), and the idle time in which the host was inside one of the port's
spans (`port_idle_s`; None where the session holds no `kmb.` record).  It
raises `MissingRecords` when the session holds fewer records of the hand
kernels than they were launched.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

WINDOW = "portbench.window"
STEP = "portbench."
PORT = "kmb."
TOP = 10


class MissingRecords(RuntimeError):
    pass


@contextlib.contextmanager
def session(cuda):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def _is_device(event):
    """A device operation: not the device-side copy of a harness or port
    span."""
    return (str(event.device_type).endswith("CUDA")
            and not event.name.startswith((STEP, PORT))
            and not getattr(event, "is_user_annotation", False))


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(prof, hand_kernel, launched):
    """See the module docstring.  `hand_kernel` matches the hand kernels'
    names; `launched` is how many launches the session saw."""
    events = prof.events()
    windows = [e for e in events if e.name == WINDOW]
    if not windows:
        raise MissingRecords("the trace holds no portbench.window span")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device, ops = [], defaultdict(float)
    hand, hand_us = 0, 0.0
    for e in events:
        if not _is_device(e):
            continue
        start = max(e.time_range.start, w0)
        end = min(e.time_range.end, w1)
        if end <= start:
            continue
        device.append((start, end))
        ops[e.name[:100]] += end - start
        if hand_kernel.search(e.name):
            hand += 1
            hand_us += end - start
    if hand < launched:
        raise MissingRecords(
            f"torch.profiler kept {hand} records of the hand kernels' "
            f"{launched} launches in this session")
    busy = _merge(device)
    gaps, edge = [], w0
    for start, end in busy:
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    if edge < w1:
        gaps.append((edge, w1))
    idle = defaultdict(float)
    label = _labeller(events)
    for start, end in gaps:
        idle[label((start + end) / 2)] += end - start
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    port = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in events if e.name.startswith(PORT)
            and not str(e.device_type).endswith("CUDA")]
    port = [(start, end) for start, end in port if end > start]
    return {"busy_s": sum(end - start for start, end in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "hand_kernel_ms": hand_us * 1e-3,
            "device_ops": [[name, us * 1e-6] for name, us in top],
            "idle_gaps": [[name, us * 1e-6] for name, us in worst],
            "port_idle_s": (_overlap(gaps, _merge(port)) * 1e-6
                            if port else None)}


def _overlap(a, b):
    """Total length shared by two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _labeller(events):
    """time -> "<harness step>/<outermost operation under it>"."""
    steps = sorted((e for e in events if e.name.startswith(STEP)
                    and e.name != WINDOW
                    and not str(e.device_type).endswith("CUDA")),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in steps]
    children = {}

    def covering(items, keys, t):
        i = bisect.bisect_right(keys, t) - 1
        if i >= 0 and items[i].time_range.end >= t:
            return items[i]
        return None

    def label(t):
        step = covering(steps, starts, t)
        if step is None:
            return "between steps"
        if id(step) not in children:
            kids = sorted(step.cpu_children, key=lambda e: e.time_range.start)
            children[id(step)] = (kids, [k.time_range.start for k in kids])
        kids, keys = children[id(step)]
        op = covering(kids, keys, t)
        name = step.name[len(STEP):]
        return name if op is None else f"{name}/{op.name[:60]}"

    return label
