"""Percent of the traced span of the window in which no operation ran on
the device."""
from cfl_bench import readers


def read(rec):
    return readers.idle_share(rec)
