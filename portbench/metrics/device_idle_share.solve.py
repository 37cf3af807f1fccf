"""The device's idle share of the profiled half
(readings.device_idle_share), in the solve cells: the idle that the
host's read of the stop flags leaves once per iteration."""

from portbench.readings import device_idle_share as read  # noqa: F401
