"""Seconds from process start to the first timed query."""


def read(measured):
    return measured.setup_s
