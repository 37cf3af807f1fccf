"""Kernel pairs answered per second of the window (readings.pairs_per_s),
in the attention cell, under a bound of its own."""

from portbench.readings import pairs_per_s as read  # noqa: F401
