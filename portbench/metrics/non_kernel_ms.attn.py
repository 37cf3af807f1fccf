"""Median over the counted queries of the host-clock query time less the
device time of its kernel launches (the port's launch timer): staging,
the wrapper's work, the fence and the read-back."""

import statistics

from portbench.readings import counted


def read(measured):
    queries = counted(measured.queries)
    if not queries:
        return None
    return statistics.median(q.ms - sum(q.launch_ms) for q in queries)
