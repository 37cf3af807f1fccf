"""The device's idle share of the profiled half
(readings.device_idle_share), in the cells of the direct kernel."""

from portbench.readings import device_idle_share as read  # noqa: F401
