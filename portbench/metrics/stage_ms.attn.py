"""Median over the counted queries of the host self time of the port's
staging: `engine.stage_signal` (the signal's copy to the card) and the
wrapper's `matvec.stage_*` (sources, targets, signal)."""

from portbench.readings import span_ms


def read(measured):
    return span_ms(measured, lambda name: name == "engine.stage_signal"
                   or name.startswith("matvec.stage_"))
