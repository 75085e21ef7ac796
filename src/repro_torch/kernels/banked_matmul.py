"""Banked matmul — the paper's FFNN hot loop as a Hopper CUDA kernel.

Replaces the TPU kernel ``repro/kernels/banked_matmul.py::banked_matmul``
(Pallas, grid ``(M/bm, N/bn, K/bk)`` with K sequential and an f32 VMEM
accumulator).  The kernel is ``csrc/banked_matmul.cu``, built for
``sm_90a`` at first use and bound with ``ctypes``.

Bank plan: ``derive_block`` is the reference's, unchanged — the bank counts
``(c_m, c_n, c_k)`` become the (bm, bn, bk) tile partition.  On the card a
bank tile of C is cut further into thread-block tiles that never straddle a
bank boundary; K is summed inside a block in f32, whatever the input type,
and ragged edges are masked in the kernel (the reference zero-pads; no
padded copy is made).  The result differs from the reference only in
summation order, and is the same on every run: no float atomics.

``plan`` decides, from the shapes and the bank tiles alone, which of the
kernel's two variants runs and how it is cut:

* **skinny** (M <= 16: every product of the paper's designs, M <= 8,
  N <= 48, K <= 64, and the CNN's 1 x 5472 x 2).  Such a product moves at
  most ~65 KB, so its time is latency.  One block per bank tile of C x
  sub-tile (<= 8 x 64, or <= 16 x 32); a warp owns a 4 x 8 micro-tile and
  its lanes spread over K (4 consecutive k a lane, 128 a warp, in one
  coalesced pass over the whole of K); the block's warps take interleaved
  K slices, about 8 k values a thread.  Partials reduce in a fixed order:
  a reduce-scatter of warp shuffles, then a tree over the warps in shared
  memory.  Where one block would leave a thread more than 32 k values, K
  is split over blocks and a second launch sums the splits in index order
  from an f32 workspace, which the wrapper allocates.
* **tiled** (M > 16): 128 x 128 block tiles, K through a 3-stage
  shared-memory ring that ``cp.async`` fills two steps ahead.  f32: an 8 x 8
  register tile per thread, plain FMAs (at 1024^3 the bound is the 67
  TFLOP/s of the CUDA cores; TF32 would miss the 2e-5 tolerance).  bf16
  whose rows are 16-byte aligned (``tensor_cores``): ``wgmma`` on the
  tensor cores with f32 accumulators; other bf16 operands are widened into
  the FMA kernel.

The wrapper keeps its per-shape decisions (checks, plan, the kernel's
argument block) in a cache keyed by shapes, strides, dtypes, devices and
banks, so a repeated call costs an output allocation and one C call.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from . import _build

launches = 0   # kernel launches made by ``banked_matmul`` in this process

DTYPES = (torch.float32, torch.bfloat16)


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




SKINNY_MAX_M = 16     # M at or below it takes the skinny variant
RT, CT = 4, 8         # a warp's micro-tile of C (one output a lane)
WARP_K = 128          # k a warp takes per step: 4 consecutive k a lane
MAX_THREADS = 512     # a skinny block's threads (16 warps)
K_PER_THREAD = 8      # the k values a skinny thread aims at
MAX_K_PER_THREAD = 32  # beyond it K is split over blocks
TILE = 128            # the tiled variant's block tile (128 x 128, 256 threads)
TILED_THREADS = 256


class Plan(NamedTuple):
    """How one product is cut on the card (``csrc/banked_matmul.cu``)."""
    skinny: bool
    grid: Tuple[int, int, int]   # (x: N pieces, y: M pieces, z: K splits)
    threads: int
    sub_m: int                   # block tiles per bank tile, in M (tiled)
    sub_n: int                   # and in N
    sc: int                      # columns of a block tile
    og_c: int                    # micro-tiles across a block tile (skinny)
    kw: int                      # warps along K in a block (skinny)
    ksplit: int                  # K per split
    splits: int
    workspace: int               # f32 elements of the split-K workspace


@lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, block: Tuple[int, int, int]) -> Plan:
    """The variant, grid, block size, split-K count and workspace size of
    an (m, k) @ (k, n) product with bank tiles ``block`` = (bm, bn, bk)."""
    bm, bn, _ = block
    n_bank_m, n_bank_n = -(-m // bm), -(-n // bn)
    if m > SKINNY_MAX_M:
        sub_m, sub_n = -(-min(bm, m) // TILE), -(-min(bn, n) // TILE)
        return Plan(False, (n_bank_n * sub_n, n_bank_m * sub_m, 1), TILED_THREADS,
                    sub_m, sub_n, TILE, 0, 1, k, 1, 0)
    og_r = -(-min(bm, m) // RT)                 # at most 4: a bank row <= 16 rows
    sc = 64 if og_r <= 2 else 32                # at most 16 micro-tiles a block
    sub_n = -(-min(bn, n) // sc)
    og_c = -(-min(bn, n, sc) // CT)
    kw_max = MAX_THREADS // 32 // (og_r * og_c)
    splits = -(-k // (32 * kw_max * MAX_K_PER_THREAD))
    ksplit = _round_up(-(-k // splits), WARP_K)
    splits = -(-k // ksplit)
    kw = max(1, min(kw_max, -(-ksplit // (32 * K_PER_THREAD))))
    return Plan(True, (n_bank_n * sub_n, n_bank_m, splits), 32 * og_r * og_c * kw,
                1, sub_n, sc, og_c, kw, ksplit, splits,
                splits * m * n if splits > 1 else 0)


def tiles(m: int, n: int, k: int, block: Tuple[int, int, int]
          ) -> Iterator[Tuple[Tuple[int, int, int], Tuple[int, int, int, int, int, int]]]:
    """Each block of ``plan``'s grid and the pieces of C it computes, as the
    kernel's index arithmetic cuts them: (blockIdx, (r0, r1, c0, c1, k0,
    k1)) for each warp micro-tile (skinny) or block tile (tiled), over
    ``[k0, k1)`` of K.  Empty blocks yield nothing."""
    p = plan(m, n, k, block)
    bm, bn, _ = block
    gx, gy, gz = p.grid
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                bank_m, bank_n = y // p.sub_m, x // p.sub_n
                r0 = bank_m * bm + (y % p.sub_m) * TILE
                r1 = min(bank_m * bm + bm, m, r0 + TILE)
                c0 = bank_n * bn + (x % p.sub_n) * p.sc
                c1 = min(bank_n * bn + bn, n, c0 + p.sc)
                if r0 >= r1 or c0 >= c1:
                    continue
                k0, k1 = z * p.ksplit, min(k, (z + 1) * p.ksplit)
                if not p.skinny:
                    yield (x, y, z), (r0, r1, c0, c1, k0, k1)
                    continue
                for og in range(p.threads // 32 // p.kw):
                    wr0, wc0 = r0 + (og // p.og_c) * RT, c0 + (og % p.og_c) * CT
                    if wr0 < r1 and wc0 < c1:
                        yield (x, y, z), (wr0, min(wr0 + RT, r1),
                                          wc0, min(wc0 + CT, c1), k0, k1)


def tensor_cores(p: Plan, dtype: torch.dtype, strides: Tuple[int, int, int, int],
                 bn: int, aligned: bool) -> int:
    """Whether a tiled product runs on the tensor cores: 0 no (the FMA
    kernel), 1 with B a transposed view (its K axis contiguous), 2 with B
    row-major.  ``wgmma`` reads bf16 tiles that ``cp.async`` copies 16
    bytes at a time, so A's rows, B's rows along its contiguous axis and the
    bank tiles' columns must fall on 16-byte (8-element) bounds."""
    sa0, sa1, sb0, sb1 = strides
    if p.skinny or dtype != torch.bfloat16 or not aligned:
        return 0
    if sa1 != 1 or sa0 % 8 or bn % 8:
        return 0
    if sb0 == 1 and sb1 % 8 == 0:
        return 1
    if sb1 == 1 and sb0 % 8 == 0:
        return 2
    return 0


def params(p: Plan, m: int, n: int, k: int, block: Tuple[int, int, int],
           strides: Tuple[int, int, int, int], vec: bool, in_bf16: bool,
           out_bf16: bool, tc: int) -> Tuple[int, ...]:
    """The kernel's argument block, in the order of ``enum Param`` in
    ``csrc/banked_matmul.cu``."""
    return (m, n, k, *strides, block[0], block[1], int(p.skinny), *p.grid,
            p.threads, p.sub_m, p.sub_n, p.sc, p.og_c, p.kw, p.ksplit,
            int(vec), int(in_bf16), int(out_bf16), tc)


_fn = None
# per call signature: (out dtype, plan, the kernel's argument block)
_prepared: Dict[tuple, Tuple[torch.dtype, Plan, ctypes.Array]] = {}


def _prepare(a: torch.Tensor, b: torch.Tensor, banks, block, out_dtype,
             a_aligned: bool, b_aligned: bool
             ) -> Tuple[torch.dtype, Plan, ctypes.Array]:
    out_dtype = check_operands(a, b, banks, block, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"banked_matmul runs on CUDA tensors; got {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"banked_matmul indexes with 32-bit ints; got "
                         f"{m}x{k} @ {k}x{n}")
    block = tuple(block or derive_block(m, n, k, banks))
    p = plan(m, n, k, block)
    # A's rows are read 4 k at a time where they are contiguous and aligned
    vec = a_aligned and a.stride(1) == 1 and a.stride(0) % 4 == 0
    strides = (*a.stride(), *b.stride())
    tc = tensor_cores(p, a.dtype, strides, block[1], a_aligned and b_aligned)
    vals = params(p, m, n, k, block, strides, vec, a.dtype == torch.bfloat16,
                  out_dtype == torch.bfloat16, tc)
    return out_dtype, p, (ctypes.c_int64 * len(vals))(*vals)


def banked_matmul(a: torch.Tensor, b: torch.Tensor,
                  banks: Tuple[int, int, int] = (1, 1, 1),
                  block: Optional[Tuple[int, int, int]] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] on the card with bank-derived tiling.

    ``a`` and ``b`` are CUDA tensors of one dtype, with any strides (a
    transposed view is read in place).  Raises if the kernel does not build
    or its launch is refused.
    """
    global launches, _fn
    a_aligned, b_aligned = a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0
    key = (a.shape, b.shape, a.stride(), b.stride(), a.dtype, b.dtype,
           a.device, b.device, tuple(banks), block and tuple(block), out_dtype,
           a_aligned, b_aligned)
    prepared = _prepared.get(key)
    if prepared is None:
        prepared = _prepared[key] = _prepare(a, b, banks, block, out_dtype,
                                             a_aligned, b_aligned)
    out_dtype, p, args = prepared
    if _fn is None:
        _fn = _build.function("banked_matmul", "banked_matmul",
                              [ctypes.c_void_p] * 4
                              + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype, device=a.device)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=a.device)
          if p.workspace else None)
    _build.launch(_fn, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), args,
                  what=lambda: f"banked_matmul ({tuple(a.shape)} @ {tuple(b.shape)}, "
                               f"{p})")
    launches += 1
    return out
