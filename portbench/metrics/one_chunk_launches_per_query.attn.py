"""Launches the port's wrapper sent to the one-chunk large-D kernel per
query (its counter `one_chunk_launches`, readings.per_query), in the
attention cell."""

from portbench.readings import per_query


def read(measured):
    return per_query(measured, "one_chunk_launches")
