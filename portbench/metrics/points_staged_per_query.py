"""Stagings of points by the port's wrapper per query (its counter
`points_staged`, readings.per_query), in the cells of the direct
kernel."""

from portbench.readings import per_query


def read(measured):
    return per_query(measured, "points_staged")
