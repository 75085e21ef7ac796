"""Banked 2-D convolution — the paper's CNN hot loop as a Hopper CUDA kernel.

Replaces the TPU kernel ``repro/kernels/banked_conv2d.py::banked_conv2d``
(Pallas, grid ``(Cout banks, output-row banks)``, the whole input resident
in VMEM, kh x kw taps each an einsum over Cin in f32).  The kernel is
``csrc/banked_conv2d.cu``, built for ``sm_90a`` at first use and bound with
``ctypes``.

Layout: x (Cin, H, W); w (Cout, Cin, kh, kw); out (Cout, H', W') with
H' = H-kh+1, W' = W-kw+1 (valid, unit stride), in x's dtype.

Bank plan: the reference's, unchanged — ``bank_tiles`` turns ``banks =
(cout_banks, row_banks)`` into bank tiles of ``bc`` output channels by
``bh`` output rows.  On the card each bank tile is cut into 4-channel x
4-row x 32-column block tiles that never straddle a bank, and each block
stages only its own input window and its channels' weights in shared
memory.  Taps are summed as the reference sums them, (dy, dx) outer and
Cin inner, in f32; ragged edges are masked, no padded copy is made.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launches = 0   # kernel launches made by ``banked_conv2d`` in this process

DTYPES = (torch.float32, torch.bfloat16)


def bank_tiles(cout: int, hout: int, banks: Tuple[int, int]) -> Tuple[int, int]:
    """(bc, bh): output channels and rows per bank tile, as the reference's
    ``banked_conv2d`` derives them."""
    return max(1, -(-cout // banks[0])), max(1, -(-hout // banks[1]))


def check_operands(x: torch.Tensor, w: torch.Tensor,
                   banks: Tuple[int, int]) -> None:
    """Validate device, dtype, shapes and banks; raise on what is refused."""
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.dim() != 3 or w.dim() != 4 or x.shape[0] != w.shape[1]:
        raise ValueError(f"conv2d takes x (Cin,H,W) and w (Cout,Cin,kh,kw); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"empty operand: {tuple(x.shape)}, {tuple(w.shape)}")
    if w.shape[2] > x.shape[1] or w.shape[3] > x.shape[2]:
        raise ValueError(f"kernel {tuple(w.shape[2:])} larger than the input "
                         f"{tuple(x.shape[1:])}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"operands must both be float32 or bfloat16; got "
                        f"{x.dtype} and {w.dtype}")
    if len(banks) != 2 or min(banks) < 1:
        raise ValueError(f"banks must be two positive ints; got {banks}")


def _kernel():
    return _build.function("banked_conv2d", "banked_conv2d", [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def banked_conv2d(x: torch.Tensor, w: torch.Tensor,
                  banks: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Valid unit-stride conv on the card with bank-derived tiling.

    ``x`` and ``w`` are CUDA tensors of one dtype (made contiguous if they
    are not).  Raises if the kernel does not build or its launch is refused
    (a window that does not fit in the card's shared memory is refused).
    """
    global launches
    check_operands(x, w, banks)
    if x.device.type != "cuda":
        raise ValueError(f"banked_conv2d runs on CUDA tensors; got {x.device}")
    cin, h, width = x.shape
    cout, _, kh, kw = w.shape
    hout, wout = h - kh + 1, width - kw + 1
    bc, bh = bank_tiles(cout, hout, banks)
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((cout, hout, wout), dtype=x.dtype, device=x.device)
    _build.launch(_kernel(), x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  cin, h, width, cout, kh, kw, bc, bh, int(x.dtype == torch.bfloat16),
                  what=f"banked_conv2d (x {tuple(x.shape)}, w {tuple(w.shape)}, "
                       f"bank tile {(bc, bh)})")
    launches += 1
    return out
