"""Flash attention (online softmax) with GQA and a causal mask, as a Hopper
CUDA kernel.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(Pallas, grid ``(B*Hq, S/bq, Sk/bk)`` with the kv axis sequential and the
running max, denominator and accumulator in f32 VMEM scratch).  The kernel
is ``csrc/flash_attention.cu``, built for ``sm_90a`` at first use and bound
with ``ctypes``.

Layout: q (B, Hq, S, D); k/v (B, Hkv, Sk, D) with Hq % Hkv == 0; out in q's
dtype.  One block per (b*Hq, q tile of 64 rows in f32, 128 in bf16); a
loop inside the block walks the kv tiles in order, the next one copied by
``cp.async`` while the current one computes, keeping m, l and the
accumulator in f32 registers.  bf16 runs both products on the tensor cores
(``wgmma``, two warpgroups of 64 rows, f32 accumulation, P as two bf16
terms hi + lo); f32 runs them as register-tiled FMA products (no TF32).
The kv head is ``h // group`` in the pointer arithmetic (no repeated
copy).  The causal mask is the reference kernel's top-left
``q_id >= k_id`` with a -1e30 fill, on the tiles that cross the diagonal;
tiles wholly above it are skipped, and the causal q tiles launch heaviest
first.  ``block_q``/``block_k`` are checked as the reference checks them;
the kernel's own tiles give the same result up to rounding.  The checks run
once per call signature (shapes, dtypes, devices, flags), whose kernel
arguments are kept.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

launches = 0   # kernel launches made by ``flash_attention`` in this process

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, block_q: int, block_k: int) -> Tuple[int, int]:
    """Validate devices, dtypes, shapes and blocks; return (bq, bk) as the
    reference derives them."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device} and {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes q (B,Hq,S,D) and k, v (B,Hkv,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if 0 in q.shape or 0 in k.shape:
        raise ValueError(f"empty operand: {tuple(q.shape)}, {tuple(k.shape)}")
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: "
                         f"batch and head dim must match, Hq % Hkv == 0")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"operands must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"blocks must be positive; got {block_q}, {block_k}")
    sk = k.shape[2]
    bq, bk = min(block_q, s), min(block_k, sk)
    if s % bq or sk % bk:
        raise ValueError(f"seq lens must divide block sizes: S={s} by {bq}, "
                         f"Sk={sk} by {bk}")
    if causal and s != sk:
        # the reference kernel masks top-left, its oracle bottom-right: they
        # agree only when S == Sk, the one causal case either is held to
        raise ValueError(f"causal attention needs S == Sk; got S={s}, Sk={sk}")
    return bq, bk


_fn = None
# per call signature: the kernel's int and float arguments
_prepared: Dict[tuple, tuple] = {}


def _prepare(q, k, v, causal, scale, block_q, block_k) -> tuple:
    check_operands(q, k, v, causal, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors; got {q.device}")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM}; got {d}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    # rows are copied 16 bytes at a time where D fills whole 16-byte chunks
    chunked = d % (16 // q.element_size()) == 0
    return (b, hq, hkv, s, sk, d, scale, int(causal),
            int(q.dtype == torch.bfloat16)), chunked


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Attention on the card.  ``q``, ``k``, ``v`` are CUDA tensors of one
    dtype (made contiguous if they are not); head dim at most 128.  Raises
    if the kernel does not build or its launch is refused."""
    global launches, _fn
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, q.device,
           k.device, v.device, causal, scale, block_q, block_k)
    prepared = _prepared.get(key)
    if prepared is None:
        prepared = _prepared[key] = _prepare(q, k, v, causal, scale, block_q, block_k)
    args, chunked = prepared
    if _fn is None:
        _fn = _build.function("flash_attention", "flash_attention",
                              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                              + [ctypes.c_float] + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    vec = int(chunked and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16 == 0)
    _build.launch(_fn, q.device, *ptrs, *args, vec,
                  what=lambda: f"flash_attention (q {tuple(q.shape)}, "
                               f"k {tuple(k.shape)})")
    launches += 1
    return out
