"""Exclusive device ms a step of the program's range ``moe.shared`` (the
shared experts, forward and recomputation) in the ranges-only window
(``perfbench.attribution``)."""
from perfbench import attribution

RANGES = ("moe.shared",)


def read(run):
    return attribution.device_ms(run, RANGES)
