"""One process's part of a run: set-up, the measured window, and what the
window saw.

The loop is closed, one client: each query starts when the previous
answer is on the host, and takes the next signal of the pool.  On several
ranks rank 0 decides before each query whether the window goes on, and
tells the others over a gloo group of the harness's own, so every rank
runs the same queries and the card's NCCL stream carries only the
program's traffic.

A traced run splits its window in two halves.  In the first, every query
starts from a barrier of the ranks, the port's launch timer times each
kernel launch, the launch counters and the collective recorder count, and
each rank's query time and the host time of each of its steps are kept;
each query also runs inside the port's own `trace.recording()`, whose
spans give the self time of each of the port's steps and whose counters
give what they counted.  In the second, one torch.profiler session covers
the queries, inside `trace.recording(profile=True)`, so that the port's
steps sit on the device's timeline as `kmb.` records.  An untraced run
does none of this.

What the run keeps of each answer, and how it is judged afterwards, is
the cell's task's (tasks/<task>.py): the session only hands it the
inputs, the configuration and the kept answers.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from kmb_tpu_torch.ops import _build
from portbench import data, devtrace

try:   # the port's spans and counters, where the port has them
    from kmb_tpu_torch import trace as port_trace
except ImportError:
    port_trace = None


@dataclass
class Query:
    start: float
    end: float
    signal: int
    launch_ms: list = None        # each launch's device ms (counted half)
    launches: dict = None         # launches by kernel (counted half)
    step_ms: dict = None          # host ms of each step (counted half)
    span_ms: dict = None          # self ms of each port span (counted half)
    counts: dict = None           # the port's counters' deltas (same)

    @property
    def ms(self):
        return (self.end - self.start) * 1e3


@dataclass
class Report:
    """What one rank measured, sent to rank 0 after the window."""
    queries: list = field(default_factory=list)
    collective_bytes: int = 0
    collective_queries: int = 0
    trace: dict = None            # devtrace.summarize's, profiled half
    memory_peak_bytes: int = 0


def _span(step):
    return record_function(devtrace.STEP + step)


@contextlib.contextmanager
def _timed_span(steps, step):
    """`_span(step)`, its host-clock ms kept in `steps[step]`."""
    start = time.perf_counter()
    with _span(step):
        yield
    steps[step] = (time.perf_counter() - start) * 1e3


def _launch_counts():
    return {k.symbol: k.launches for k in _build.KERNELS}


def _port_recording(on, profile=False):
    """The port's recording of its spans and counters (with `profile`,
    each span also a profiler record), where `on` and the port has a
    trace module."""
    if port_trace is None or not on:
        return contextlib.nullcontext()
    return port_trace.recording(profile=profile)


class Session:
    def __init__(self, cell, seed, *, device, rank=0, world=1, control=None):
        self.cell = cell
        self.config = cell.config
        self.seed = seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rank, self.world, self.control = rank, world, control
        self.task = cell.task
        self.report = Report()
        self.answers = []

    # -- set-up ------------------------------------------------------------

    def set_up(self):
        """Inputs from the seed, the engine built and fitted, and one warm
        query of the window's shape."""
        stamps = [time.perf_counter()]
        make_inputs = getattr(self.task, "make_inputs", data.make_inputs)
        self.inputs = make_inputs(self.config, self.cell.traffic, self.seed,
                                  self.cell.check_rows)
        stamps.append(time.perf_counter())
        self.engine = self.task.build(self.config, self.device)
        self.task.prepare(self.engine, self.inputs)
        stamps.append(time.perf_counter())
        self.task.ask(self.engine, self.inputs.signal(0)[1])
        if self.cuda:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        self.setup_steps = dict(zip(("inputs", "prepare", "warm query"),
                                    np.diff(stamps).tolist()))

    # -- the window --------------------------------------------------------

    def _barrier(self):
        if self.world > 1:
            dist.barrier(group=self.control)

    def _go(self, deadline):
        """Whether the window goes on: rank 0's clock decides for all."""
        go = time.perf_counter() < deadline
        if self.world > 1:
            flag = torch.tensor([int(go)], dtype=torch.int32)
            dist.broadcast(flag, src=0, group=self.control)
            go = bool(flag.item())
        return go

    def window(self, seconds, *, counted=False, profiled=False,
               queries=None):
        """Queries back to back for `seconds` (or, given `queries`, that
        many); returns the window's seconds from its first query's start
        to its last answer."""
        mesh = self.task.mesh(self.engine)
        recorder = contextlib.nullcontext()
        if counted and mesh is not None and mesh.distributed:
            from kmb_tpu_torch.parallel.sharded import record_collectives
            recorder = record_collectives(mesh)
        tracer = (devtrace.session(self.cuda) if profiled
                  else contextlib.nullcontext())
        launched = sum(_launch_counts().values())
        with tracer as prof, _port_recording(profiled, profile=True):
            self._barrier()
            with recorder as tally, record_function(devtrace.WINDOW):
                start = time.perf_counter()
                deadline = start + seconds
                for _ in range(queries or 2**62):
                    with _span("loop"):
                        if not self._go(deadline):
                            break
                    self._query(counted)
                end = time.perf_counter()
        if tally is not None:
            self.report.collective_bytes += sum(c["bytes"]
                                                for c in tally.calls)
            self.report.collective_queries += tally.queries
        if profiled and self.cuda:
            launched = sum(_launch_counts().values()) - launched
            try:
                self.report.trace = devtrace.summarize(
                    prof, _build.KERNEL_NAME, launched)
            except devtrace.MissingRecords as lost:
                # Rank 0 refuses the run once every rank has reported.
                self.report.trace = {"missing": str(lost)}
        return end - start

    def _query(self, counted):
        i = len(self.report.queries)
        s, signal = self.inputs.signal(i)
        if counted:
            with _span("loop"):
                self._barrier()
        before = _launch_counts() if counted else None
        timer = (_build.launch_timer() if counted and self.cuda
                 else contextlib.nullcontext())
        steps = {}
        span = (functools.partial(_timed_span, steps) if counted
                else _span)
        with timer as times, _port_recording(counted) as rec:
            t0 = time.perf_counter()
            answer = self.task.ask(self.engine, signal, span)
            t1 = time.perf_counter()
        query = Query(t0, t1, s)
        if counted:
            after = _launch_counts()
            query.launches = {k: after[k] - before[k] for k in after}
            query.launch_ms = list(times) if times is not None else []
            query.step_ms = steps
            if rec is not None:
                query.span_ms = rec.self_ms()
                query.counts = dict(rec.counts)
        self.report.queries.append(query)
        with _span("loop"):
            self.answers.append(self.task.keep(self.inputs, answer))

    # -- after the window ----------------------------------------------------

    def gather(self):
        """Every rank's Report on rank 0 (a list); None elsewhere."""
        if self.cuda:
            self.report.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        if self.world == 1:
            return [self.report]
        box = [None] * self.world if self.rank == 0 else None
        dist.gather_object(self.report, box, dst=0, group=self.control)
        return box

    def free(self):
        """Drop the program's state, so the reference has the card."""
        if self.engine is not None:
            self.engine.done()
        self.engine = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def compared(self, answers=None, signal_ids=None):
        """The task's (got, wanted, size) of each kept answer, by default
        the window's, with their signal ids."""
        if answers is None:
            answers = self.answers
            signal_ids = [q.signal for q in self.report.queries]
        return (self.task.compared(self.inputs, self.config, answers,
                                   signal_ids, self.device), signal_ids)
