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
``bh`` output rows.  On the card ``plan`` cuts each bank tile into blocks of
one channel x ``rows`` rows x ``bw`` columns that never straddle a bank
(``block_tiles`` lists them, as the kernel decodes its grid); each block
stages only its own input window and its channel's weights in shared
memory (``smem_bytes``), and each of its ``rows * bw / 2`` threads computes
two output rows of one column.  The block is 8 x 64 outputs (256 threads)
and is halved while its window would not fit in the card's shared memory.
Taps are summed as the reference sums them, (dy, dx) outer and Cin inner,
in f32; ragged edges are masked, no padded copy is made.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Tuple

import torch

from . import _build

launches = 0   # kernel launches made by ``banked_conv2d`` in this process

DTYPES = (torch.float32, torch.bfloat16)
ROWS = 2             # output rows a thread
# (rows, bw) of a block, largest first: each halves the one before
BLOCKS = ((8, 64), (4, 64), (2, 64), (2, 32))


class Plan(NamedTuple):
    bc: int                         # bank tile: output channels
    bh: int                         # bank tile: output rows
    rows: int                       # block: output rows (one channel)
    bw: int                         # block: output columns (64 or 32)
    threads: int                    # threads a block: rows * bw / ROWS
    sub_r: int                      # blocks a bank tile, along rows
    grid: Tuple[int, int, int]      # (columns, row blocks, channels)


def bank_tiles(cout: int, hout: int, banks: Tuple[int, int]) -> Tuple[int, int]:
    """(bc, bh): output channels and rows per bank tile, as the reference's
    ``banked_conv2d`` derives them."""
    return max(1, -(-cout // banks[0])), max(1, -(-hout // banks[1]))


def smem_bytes(cin: int, kh: int, kw: int, rows: int, bw: int) -> int:
    """Shared memory of one block, as ``csrc/banked_conv2d.cu`` sizes it: the
    input window (Cin, rows+kh-1, bw+kw-1) and the channel's weights, f32."""
    return 4 * cin * ((rows + kh - 1) * (bw + kw - 1) + kh * kw)


def plan(cout: int, hout: int, wout: int, banks: Tuple[int, int], cin: int,
         kh: int, kw: int, smem_limit: int) -> Plan:
    """The kernel's blocks: each bank tile cut into blocks of one channel x
    ``rows`` x ``bw`` outputs, the largest of ``BLOCKS`` whose window fits
    in ``smem_limit`` bytes (the card's opt-in limit a block).  Raises
    ``ValueError`` when none fits."""
    for rows, bw in BLOCKS:
        if smem_bytes(cin, kh, kw, rows, bw) <= smem_limit:
            break
    else:
        raise ValueError(
            f"banked_conv2d: the input window of {cin} channels at {kh}x{kw} taps "
            f"needs {smem_bytes(cin, kh, kw, *BLOCKS[-1])} bytes of shared memory "
            f"at the smallest block; the card allows {smem_limit}")
    bc, bh = bank_tiles(cout, hout, banks)
    sub_r = -(-min(bh, hout) // rows)
    gy = -(-hout // bh) * sub_r
    return Plan(bc, bh, rows, bw, rows * bw // ROWS, sub_r, (-(-wout // bw), gy, cout))


def block_tiles(p: Plan, cout: int, hout: int,
                wout: int) -> Iterator[Tuple[int, int, int, int, int, int]]:
    """(o0, o1, r0, r1, c0, c1) of every block of the grid that has work,
    decoded from its index as ``csrc/banked_conv2d.cu`` decodes it."""
    gx, gy, gz = p.grid
    for o in range(gz):
        for y in range(gy):
            bank_r = y // p.sub_r
            r0 = bank_r * p.bh + (y % p.sub_r) * p.rows
            r1 = min(bank_r * p.bh + p.bh, hout, r0 + p.rows)
            for x in range(gx):
                c0 = x * p.bw
                if r0 < r1:
                    yield o, o + 1, r0, r1, c0, min(c0 + p.bw, wout)


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
                           + [ctypes.c_int] * 13 + [ctypes.c_void_p])


_smem_limits = {}   # device index -> the card's opt-in shared memory a block


def smem_limit(device: torch.device) -> int:
    """Bytes of shared memory a block may opt into on ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _smem_limits:
        fn = _build.function("banked_conv2d", "banked_conv2d_smem_limit", [ctypes.c_int])
        limit = fn(index)
        if limit <= 0:
            raise RuntimeError(f"banked_conv2d: reading device {index}'s shared "
                               f"memory limit failed")
        _smem_limits[index] = limit
    return _smem_limits[index]


def banked_conv2d(x: torch.Tensor, w: torch.Tensor,
                  banks: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Valid unit-stride conv on the card with bank-derived tiling.

    ``x`` and ``w`` are CUDA tensors of one dtype (made contiguous if they
    are not).  Raises ``ValueError`` if even the smallest block's input
    window does not fit in the card's shared memory, ``RuntimeError`` if the
    kernel does not build or its launch is refused.
    """
    global launches
    check_operands(x, w, banks)
    if x.device.type != "cuda":
        raise ValueError(f"banked_conv2d runs on CUDA tensors; got {x.device}")
    cin, h, width = x.shape
    cout, _, kh, kw = w.shape
    hout, wout = h - kh + 1, width - kw + 1
    p = plan(cout, hout, wout, banks, cin, kh, kw, smem_limit(x.device))
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((cout, hout, wout), dtype=x.dtype, device=x.device)
    _build.launch(_kernel(), x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  cin, h, width, cout, kh, kw, p.bh, p.rows, p.bw, p.sub_r,
                  p.grid[0], p.grid[1], int(x.dtype == torch.bfloat16),
                  what=f"banked_conv2d (x {tuple(x.shape)}, w {tuple(w.shape)}, "
                       f"bank tile {(p.bc, p.bh)})")
    launches += 1
    return out
