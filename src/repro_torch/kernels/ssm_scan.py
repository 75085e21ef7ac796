"""Chunked decay scan (SSD / linear attention) for Mamba2 and RWKV6, as a
Hopper CUDA kernel.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py::ssm_scan`` (Pallas,
grid ``(B*H, S/chunk)`` with the chunk axis sequential and the f32
``(dk, dv)`` state in VMEM scratch).  The kernel is ``csrc/ssm_scan.cu``,
built for ``sm_90a`` at first use and bound with ``ctypes``.

    h_t = exp(w_t) (.) h_{t-1} + k_t (x) v_t
    inclusive (Mamba2): o_t = q_t . h_t
    bonus (RWKV6):      o_t = q_t . h_{t-1} + (q_t . (u (.) k_t)) v_t

Layout: q/k/w (B, H, S, dk); v (B, H, S, dv); u (H, dk), zeros if absent;
out (B, H, S, dv) in q's dtype.

A call runs three kernels in order on the current stream (``grids`` gives
their blocks): ``chunk_state`` forms each chunk's own contribution to the
state, ``Delta_c = (k exp(win[C-1, s]))^T v``, and its decay
``e_c = exp(sum_t w_t)`` for all chunks at once, into an f32 workspace of
``B*H*(S/chunk)*(dk*dv + dk)`` floats (``workspace_floats``) that this
wrapper allocates; ``state_pass`` walks the chunks in order, one thread per
state element, writing the state entering each chunk in place of its
``Delta_c`` and stepping ``h <- e_c h + Delta_c``; ``chunk_out`` forms each
chunk's output from its entering state and its scores.  The reference's
numerics are kept: every window decay ``sum_{s<i<=t} w_i`` is a running sum
over its own window, formed on the fly (the (C, C, dk) table is never
stored), never a difference of two cumulative sums.  ``launches`` counts
calls: one per call, after its three kernels are launched.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches = 0   # kernel launches made by ``ssm_scan`` in this process

DTYPES = (torch.float32, torch.bfloat16)
DIAG_MODES = ("inclusive", "bonus")
MAX_DK = 512                 # 32 lanes x 16 channels in the kernel's walk
THREADS = 256                # threads a block, in all three kernels


def workspace_floats(b: int, h: int, s: int, dk: int, dv: int, chunk: int) -> int:
    """f32 values of the workspace a call needs: per (b*H, chunk), its
    ``Delta_c`` (dk*dv) and its ``e_c`` (dk)."""
    return b * h * (s // chunk) * (dk * dv + dk)


def grids(b: int, h: int, s: int, dk: int, dv: int,
          chunk: int) -> Tuple[int, int, int]:
    """Blocks of ``THREADS`` threads of the three kernels, as
    ``csrc/ssm_scan.cu`` launches them: one per (b*H, chunk) for
    ``chunk_state`` and ``chunk_out``, one thread per (b*H, state element)
    for ``state_pass``."""
    per_chunk = b * h * (s // chunk)
    return per_chunk, -(-b * h * dk * dv // THREADS), per_chunk


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: Optional[torch.Tensor], chunk: int,
                   diag_mode: str) -> None:
    """Validate devices, dtypes, shapes, chunk and mode; raise on refusal."""
    ops = [q, k, v, w] + ([u] if u is not None else [])
    if len({t.device for t in ops}) != 1:
        raise ValueError(f"operands on {sorted(str(t.device) for t in ops)}")
    if q.dim() != 4 or k.shape != q.shape or w.shape != q.shape:
        raise ValueError(f"decay_scan takes q, k, w (B,H,S,dk); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(w.shape)}")
    b, h, s, dk = q.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (b, h, s):
        raise ValueError(f"v must be (B,H,S,dv) = ({b},{h},{s},dv); got {tuple(v.shape)}")
    if u is not None and tuple(u.shape) != (h, dk):
        raise ValueError(f"u must be (H,dk) = ({h},{dk}); got {tuple(u.shape)}")
    if 0 in q.shape or 0 in v.shape:
        raise ValueError(f"empty operand: {tuple(q.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ops):
        raise TypeError(f"operands must all be float32 or bfloat16; got "
                        f"{[t.dtype for t in ops]}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} must be divisible by chunk={chunk}")
    if diag_mode not in DIAG_MODES:
        raise ValueError(f"diag_mode must be one of {DIAG_MODES}; got {diag_mode!r}")


def _kernel():
    return _build.function("ssm_scan", "ssm_scan", [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: Optional[torch.Tensor] = None,
             chunk: int = 32, diag_mode: str = "inclusive") -> torch.Tensor:
    """The chunked decay scan on the card.  All operands are CUDA tensors of
    one dtype (made contiguous if they are not).  Allocates the f32
    workspace (``workspace_floats``) and launches the three kernels.  Raises
    if the kernels do not build or a launch is refused (a chunk that does
    not fit in the card's shared memory is refused)."""
    global launches
    check_operands(q, k, v, w, u, chunk, diag_mode)
    if q.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA tensors; got {q.device}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if dk > MAX_DK:
        raise ValueError(f"ssm_scan takes dk up to {MAX_DK}; got {dk}")
    if u is None:
        u = torch.zeros((h, dk), dtype=q.dtype, device=q.device)
    q, k, v, w, u = (t.contiguous() for t in (q, k, v, w, u))
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    ws = torch.empty(workspace_floats(b, h, s, dk, dv, chunk), dtype=torch.float32,
                     device=q.device)
    _build.launch(_kernel(), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  b, h, s, dk, dv, chunk,
                  int(diag_mode == "bonus"), int(q.dtype == torch.bfloat16),
                  what=f"ssm_scan (q {tuple(q.shape)}, v {tuple(v.shape)}, chunk {chunk})")
    launches += 1
    return out
