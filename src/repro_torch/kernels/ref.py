"""Plain PyTorch versions of the port's kernels.

The CPU path of each wrapper in ``ops`` and the yardstick each CUDA kernel
is held against on the card.  Port of ``repro.kernels.ref``; only the
refs of kernels already ported are here.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import full_f32


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """float32 product of ``a @ b`` (no TF32), cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    with full_f32():
        return (a.float() @ b.float()).to(out_dtype)
