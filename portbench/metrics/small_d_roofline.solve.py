"""Percent of its least time the direct kernel at D <= 8 (small_d.cuh)
reached over every launch of the counted solves (readings.roofline_share:
one matvec's frozen least time per launch over the launches' device
time), in the solve cells."""

from portbench.readings import DIRECT, roofline_share


def read(measured):
    if measured.config["dimension"] > 8:
        return None
    return roofline_share(measured, DIRECT)
