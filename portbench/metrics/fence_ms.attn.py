"""Median over the counted queries of the host self time of the fence's
check (`fence.check`: the reduction read back once the device is done).
`fence.wait` is left out: its self time is the host waiting for the
kernel, whose device time the launch timer counts already."""

from portbench.readings import span_ms


def read(measured):
    return span_ms(measured, lambda name: name == "fence.check")
