"""Launches of the port's kernels per query (readings.launches_per_query),
in the cells of the direct kernel."""

from portbench.readings import launches_per_query as read  # noqa: F401
