"""Median over the counted queries of the host self time of the answer's
read-back (`engine.read`: the copy to the host and its widening to
float64)."""

from portbench.readings import span_ms


def read(measured):
    return span_ms(measured, lambda name: name == "engine.read")
