"""Percent of its least time the flash kernel (row-normalised products)
reached: the frozen least time of each query's pairs over the device time
of its launches (the port's launch timer), summed over every rank."""

from portbench.readings import FLASH, roofline_share


def read(measured):
    return roofline_share(measured, FLASH)
