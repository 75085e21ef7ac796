"""Exclusive device ms a step of the program's range ``moe``, its five steps
and ``moe.bwd`` in the ranges-only window (``perfbench.attribution``)."""
from perfbench import attribution

RANGES = ("moe", "moe.router", "moe.assign", "moe.dispatch", "moe.experts",
          "moe.combine", "moe.bwd")


def read(run):
    return attribution.device_ms(run, RANGES)
