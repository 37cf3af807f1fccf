"""95th percentile of every query in the window, from `prepare_query` to
the answer on the host (inclusive quantiles)."""

import statistics


def read(measured):
    ms = [q.ms for q in measured.queries]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
