"""The device's idle share of the profiled half while the host was inside
one of the port's spans (readings.port_idle_share), in the attention
cell."""

from portbench.readings import port_idle_share as read  # noqa: F401
