"""Per query, the largest over the ranks of the host time of the engine's
`query()` call (the ring's steps, the all-gather of the rows and the
fence) less that rank's own kernels' device time (the port's launch
timer): the time a rank spends on the exchange and waiting for the
others.  A slow rank lengthens every rank's call but only its own
kernels.  The median over the counted queries, which start from a
barrier of the ranks."""

import statistics

from portbench.readings import counted


def read(measured):
    if measured.world < 2:
        return None
    per_rank = [counted(r.queries) for r in measured.reports]
    n = min(len(q) for q in per_rank)
    if n == 0:
        return None
    return statistics.median(
        max(q[i].step_ms["query"] - sum(q[i].launch_ms) for q in per_rank)
        for i in range(n))
