"""Public wrappers for the port's kernels.

Each wrapper dispatches on where its operands lie: a CPU tensor goes to the
kernel's plain version in ``ref``, a CUDA tensor to the hand-written Hopper
kernel, which launches or raises.  There is no fallback from the kernel to
the plain version.  Port of ``repro.kernels.ops``, with its signatures and
layouts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import banked_conv2d as _bc
from . import banked_matmul as _bm
from . import flash_attention as _fa
from . import ref
from . import ssm_scan as _ss


def _not_cpu_or_cuda(name: str, device: torch.device) -> ValueError:
    return ValueError(f"{name} runs on CPU or CUDA tensors; got {device}")


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
    raise _not_cpu_or_cuda("matmul", a.device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B,Hq,S,D), k/v (B,Hkv,Sk,D) -> (B,Hq,S,D).  Causal needs S == Sk
    (``ValueError`` otherwise, on either device)."""
    if q.device.type == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                   block_q=block_q, block_k=block_k)
    _fa.check_operands(q, k, v, causal, block_q, block_k)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    raise _not_cpu_or_cuda("attention", q.device)


def decay_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: Optional[torch.Tensor] = None,
               chunk: int = 32, diag_mode: str = "inclusive") -> torch.Tensor:
    """q/k/w (B,H,S,dk), v (B,H,S,dv), u (H,dk) -> (B,H,S,dv)."""
    if q.device.type == "cuda":
        return _ss.ssm_scan(q, k, v, w, u=u, chunk=chunk, diag_mode=diag_mode)
    _ss.check_operands(q, k, v, w, u, chunk, diag_mode)
    if q.device.type == "cpu":
        return ref.ssm_scan_ref(q, k, v, w, u=u, diag_mode=diag_mode)
    raise _not_cpu_or_cuda("decay_scan", q.device)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           banks: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """x (Cin,H,W), w (Cout,Cin,kh,kw) -> (Cout,H-kh+1,W-kw+1)."""
    if x.device.type == "cuda":
        return _bc.banked_conv2d(x, w, banks=banks)
    _bc.check_operands(x, w, banks)
    if x.device.type == "cpu":
        return ref.conv2d_ref(x, w)
    raise _not_cpu_or_cuda("conv2d", x.device)
