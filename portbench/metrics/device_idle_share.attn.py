"""The device's idle share of the profiled half
(readings.device_idle_share), in the attention cell."""

from portbench.readings import device_idle_share as read  # noqa: F401
