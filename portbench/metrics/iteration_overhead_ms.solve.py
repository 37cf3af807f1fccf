"""Host ms per conjugate-gradient iteration that is not the direct
kernel: the median over the counted solves of the port's `pcg` span
(its self ms and that of every span inside it: the preconditioner's
application, the stop rule's read, the wrapper's steps) less the device
ms of the solve's kernel launches (the port's launch timer), over its
iterations (`pcg_iterations`).  The preconditioner, the column sums, the
host's read of the stop flags and the gaps between launches.  None
without the `pcg` span or the counter."""

import statistics

from portbench.readings import DIRECT, only

COUNTER = "pcg_iterations"


def _inside_pcg(name):
    return name.split(".")[0] in ("pcg", "matvec")


def read(measured):
    values = []
    for q in only(measured.queries, DIRECT):
        if not (q.span_ms and "pcg" in q.span_ms and q.counts
                and q.counts.get(COUNTER)):
            continue
        pcg_ms = sum(ms for name, ms in q.span_ms.items()
                     if _inside_pcg(name))
        values.append((pcg_ms - sum(q.launch_ms)) / q.counts[COUNTER])
    return statistics.median(values) if values else None
