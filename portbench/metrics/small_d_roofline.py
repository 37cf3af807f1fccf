"""Percent of its least time the direct kernel at D <= 8 (small_d.cuh)
reached: the frozen least time of each query's pairs over the device time
of its launches (the port's launch timer), summed over every rank."""

from portbench.readings import DIRECT, roofline_share


def read(measured):
    if measured.config["dimension"] > 8:
        return None
    return roofline_share(measured, DIRECT)
