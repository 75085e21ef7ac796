"""Exclusive device ms a step of the program's range ``attn.latent`` (latent
attention's Wkv_a, the latent's norm, Wkv_b and the shared rotary key,
forward and recomputation) in the ranges-only window
(``perfbench.attribution``)."""
from perfbench import attribution

RANGES = ("attn.latent",)


def read(run):
    return attribution.device_ms(run, RANGES)
