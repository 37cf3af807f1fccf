"""Launches of the port's kernels per query (readings.launches_per_query),
in the attention cell."""

from portbench.readings import launches_per_query as read  # noqa: F401
