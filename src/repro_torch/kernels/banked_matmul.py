"""Banked tiled matmul — the paper's FFNN hot loop as a Hopper CUDA kernel.

Replaces the TPU kernel ``repro/kernels/banked_matmul.py::banked_matmul``
(Pallas, grid ``(M/bm, N/bn, K/bk)`` with K sequential and an f32 VMEM
accumulator).  The kernel is ``csrc/banked_matmul.cu``, built for
``sm_90a`` at first use and bound with ``ctypes``.

Bank plan: ``derive_block`` is the reference's, unchanged — the bank counts
``(c_m, c_n, c_k)`` become the (bm, bn, bk) tile partition.  On the card a
bank tile of C is split further into 64 x 64 thread-block tiles that never
straddle a bank boundary, so ``banks=(1, 1, 1)`` on a 1024^2 product still
launches 256 blocks over the 132 SMs.  The sequential K grid dimension
becomes a loop inside each block over the K banks, in 16-deep steps staged
through shared memory; each thread keeps a 4 x 4 register tile of C in
f32, whatever the input type.  Ragged edges are masked in the kernel
(the reference zero-pads; no padded copy is made here).  The result
differs from the reference only in summation order.

What bounds it: at the paper's shapes (M <= 8, K <= 5472, N <= 48) a
product moves at most ~100 KB and the launch itself dominates; at 1024^3
in f32 the bound is the 67 TFLOP/s of the CUDA cores (TF32 is not allowed:
it would miss the 2e-5 tolerance).  This first version uses plain FMAs,
no tensor cores, TMA or ``wgmma``; bf16 inputs are widened with
``__bfloat162float`` as they are staged.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0   # kernel launches made by ``banked_matmul`` in this process

DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def derive_block(m: int, n: int, k: int,
                 banks: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Bank counts -> MXU-aligned VMEM tile sizes (the BlockSpec analogue of
    the paper's per-dimension cyclic factors)."""
    bm = _round_up(max(1, -(-m // banks[0])), 8)
    bn = _round_up(max(1, -(-n // banks[1])), 128 if n >= 128 else 8)
    bk = _round_up(max(1, -(-k // banks[2])), 128 if k >= 128 else 8)
    return (min(bm, _round_up(m, 8)),
            min(bn, _round_up(n, 128 if n >= 128 else 8)),
            min(bk, _round_up(k, 128 if k >= 128 else 8)))


def check_operands(a: torch.Tensor, b: torch.Tensor,
                   banks: Tuple[int, int, int],
                   block: Optional[Tuple[int, int, int]],
                   out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """Validate device, dtype and shape; return the output dtype."""
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (M,K) @ (K,N); got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if 0 in a.shape or 0 in b.shape:
        raise ValueError(f"empty operand: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"operands must both be float32 or bfloat16; got "
                        f"{a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16; got {out_dtype}")
    for what, t in (("banks", banks), ("block", block)):
        if t is not None and (len(t) != 3 or min(t) < 1):
            raise ValueError(f"{what} must be three positive ints; got {t}")
    return out_dtype


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("banked_matmul").banked_matmul
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def banked_matmul(a: torch.Tensor, b: torch.Tensor,
                  banks: Tuple[int, int, int] = (1, 1, 1),
                  block: Optional[Tuple[int, int, int]] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] on the card with bank-derived tiling.

    ``a`` and ``b`` are CUDA tensors of one dtype, with any strides (a
    transposed view is read in place).  Raises if the kernel does not build
    or its launch is refused.
    """
    global launches
    out_dtype = check_operands(a, b, banks, block, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"banked_matmul runs on CUDA tensors; got {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"banked_matmul indexes with 32-bit ints; got "
                         f"{m}x{k} @ {k}x{n}")
    bm, bn, bk = block or derive_block(m, n, k, banks)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    # the launch goes to the current device; switch only when it differs
    switch = a.device.index not in (None, torch.cuda.current_device())
    with torch.cuda.device(a.device) if switch else contextlib.nullcontext():
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                       a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                       bm, bn, bk, int(a.dtype == torch.bfloat16),
                       int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"banked_matmul launch failed: CUDA error {rc} "
                           f"({m}x{k} @ {k}x{n}, block {(bm, bn, bk)})")
    launches += 1
    return out
