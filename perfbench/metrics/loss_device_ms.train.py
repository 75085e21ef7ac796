"""Exclusive device ms a step of the program's ranges ``lm_loss`` and
``lm_loss.bwd`` (the tied head, the chunked cross entropy and its
recomputation) in the ranges-only window (``perfbench.attribution``)."""
from perfbench import attribution

RANGES = ("lm_loss", "lm_loss.bwd")


def read(run):
    return attribution.device_ms(run, RANGES)
