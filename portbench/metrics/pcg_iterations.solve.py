"""Conjugate-gradient iterations per solve: the mean over the counted
solves of the port's counter `pcg_iterations` (one matvec each,
readings.per_query); None where no counted solve carries the counter (a
port without it)."""

from portbench.readings import counted, per_query

COUNTER = "pcg_iterations"


def read(measured):
    if not any(q.counts and COUNTER in q.counts
               for q in counted(measured.queries)):
        return None
    return per_query(measured, COUNTER)
