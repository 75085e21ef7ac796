"""Public wrappers for the port's kernels.

Each wrapper dispatches on where its operands lie: a CPU tensor goes to the
kernel's plain version in ``ref``, a CUDA tensor to the hand-written Hopper
kernel, which launches or raises.  There is no fallback from the kernel to
the plain version.  Port of ``repro.kernels.ops``; only the wrappers of
kernels already ported are here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import banked_matmul as _bm
from . import ref


def matmul(a: torch.Tensor, b: torch.Tensor,
           banks: Tuple[int, int, int] = (1, 1, 1),
           block: Optional[Tuple[int, int, int]] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if a.device.type == "cuda":             # checks its operands itself
        return _bm.banked_matmul(a, b, banks=banks, block=block,
                                 out_dtype=out_dtype)
    out_dtype = _bm.check_operands(a, b, banks, block, out_dtype)
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b, out_dtype)
    raise ValueError(f"matmul runs on CPU or CUDA tensors; got {a.device}")
