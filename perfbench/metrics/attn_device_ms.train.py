"""Exclusive device ms a step of the program's ranges ``attn`` (forward and
recomputation) and ``attn.bwd`` in the ranges-only window
(``perfbench.attribution``)."""
from perfbench import attribution

RANGES = ("attn", "attn.bwd")


def read(run):
    return attribution.device_ms(run, RANGES)
