"""Hand-written Hopper kernels of the port, their plain versions and wrappers.

``ops`` holds the public wrappers (``matmul``, ``attention``,
``decay_scan``, ``conv2d``), ``ref`` the plain PyTorch versions, and
``banked_matmul``, ``flash_attention``, ``ssm_scan`` and ``banked_conv2d``
the kernels' bindings, each with its ``launches`` count.  ``_build`` builds
the CUDA sources under ``csrc/`` at first use.  ``checks`` (imported on its
own) holds the attention, scan and conv check cases that ``chip_smoke.py``
and the card tests share.
"""
from . import banked_conv2d, banked_matmul, flash_attention, ops, ref, ssm_scan

__all__ = ["banked_conv2d", "banked_matmul", "flash_attention", "ops", "ref",
           "ssm_scan"]
