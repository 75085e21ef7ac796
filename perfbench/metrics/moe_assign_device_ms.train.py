"""Exclusive device ms a step of the program's range ``moe.assign``, the
capacity assignment (forward and recomputation), in the ranges-only window
(``perfbench.attribution``)."""
from perfbench import attribution

RANGES = ("moe.assign",)


def read(run):
    return attribution.device_ms(run, RANGES)
