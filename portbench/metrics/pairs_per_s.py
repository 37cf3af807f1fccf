"""Kernel pairs answered per second of the window (readings.pairs_per_s),
in the cells of the direct kernel."""

from portbench.readings import pairs_per_s as read  # noqa: F401
