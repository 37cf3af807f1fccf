"""The port's spans and counters.

A span marks one step of the port where it happens: the engine's staging
and read-back, the wrapper's staging, plan, launch and merge, the fence,
the ring's steps and the mesh's gather.  Span names are short and stable
(`engine.read`, `matvec.launch`, `ring.wait`, ...).

- Off, the default: `span()` hands out one shared no-op context.  A span
  site then costs one module-level check: no allocation, no
  `record_function`.
- Inside `recording()`: every span is kept in memory, with its name, the
  index of the span it sits in and its host start and end
  (`time.perf_counter_ns`).  The spans of one block share its identifier,
  one block being one query.
- Inside `recording(profile=True)`: each span is also a
  `record_function("kmb." + name)`, so that under torch.profiler the
  port's steps sit on the device's timeline (the runner's
  `KMB_PROFILE_DIR` traces).  A profiler session alone does not turn the
  spans on.

Counters (`count`) are plain integers, always on, like the kernels'
launch counters: `points_staged`, a staging of points by the kernels'
wrapper (the runner's rows report it per query).  Read a snapshot
(`counters()`) before and after a block; `recording()` keeps the
difference over its block.

The state is the process's: spans and counters of one thread (the port's
queries run on one).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass, field

from torch.autograd import profiler as _profiler

PREFIX = "kmb."

_NOOP = contextlib.nullcontext()
_open = None       # the Recording of the open recording() block
_counts = {}       # counter -> total since the process started
_ids = itertools.count()


@dataclass
class Span:
    """One span of a recording."""
    name: str
    parent: int                  # index of the enclosing span, -1 at the top
    query: int                   # the recording's identifier
    start_ns: int
    end_ns: int = 0

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) * 1e-6


@dataclass
class Recording:
    """The spans of one `recording()` block, in the order they opened,
    and the counters' differences over the block (filled at its end)."""
    id: int
    profile: bool = False
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    _stack: list = field(default_factory=list, repr=False)

    def _begin(self, name):
        index = len(self.spans)
        self.spans.append(Span(name, self._stack[-1] if self._stack else -1,
                               self.id, time.perf_counter_ns()))
        self._stack.append(index)
        return index

    def _end(self, index):
        self.spans[index].end_ns = time.perf_counter_ns()
        self._stack.pop()

    def self_ms(self):
        """Self time in ms summed by span name (`self_times`)."""
        out = {}
        for s, ms in zip(self.spans, self_times(self.spans)):
            out[s.name] = out.get(s.name, 0.0) + ms
        return out


class _Active:
    """A span inside a recording."""
    __slots__ = ("name", "recording", "index", "annotation")

    def __init__(self, name, recording):
        self.name = name
        self.recording = recording

    def __enter__(self):
        self.annotation = None
        if self.recording.profile:
            self.annotation = _profiler.record_function(PREFIX + self.name)
            self.annotation.__enter__()
        self.index = self.recording._begin(self.name)
        return self

    def __exit__(self, *exc):
        self.recording._end(self.index)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name):
    """A context that marks one step of the port (see the module
    docstring)."""
    if _open is None:
        return _NOOP
    return _Active(name, _open)


@contextlib.contextmanager
def recording(profile=False):
    """Keep the spans opened inside the block and the counters'
    differences over it; yields the `Recording`.  With `profile`, each
    span is also a profiler record.  One at a time."""
    global _open
    if _open is not None:
        raise RuntimeError("a trace recording is open already")
    rec = Recording(next(_ids), profile)
    before = counters()
    _open = rec
    try:
        yield rec
    finally:
        _open = None
        rec.counts = delta(before, _counts)


def count(name, n=1):
    """Add `n` to the counter `name`."""
    _counts[name] = _counts.get(name, 0) + n


def counters():
    """A snapshot of every counter's total."""
    return dict(_counts)


def delta(before, after):
    """The counters that moved from snapshot `before` to `after`, by how
    much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def self_times(spans):
    """Each span's self time in ms: its host duration less its children's.
    `spans` are one recording's, whose `parent` indices point into the
    same list."""
    out = [s.ms for s in spans]
    for s, child in zip(spans, list(out)):
        if s.parent >= 0:
            out[s.parent] -= child
    return out
