"""Plain PyTorch versions of the port's kernels.

The CPU path of each wrapper in ``ops`` and the yardstick each CUDA kernel
is held against on the card.  Port of ``repro.kernels.ref``: each function
computes in float32 (no TF32) and returns the input's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..device import full_f32

_NEG_INF = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """float32 product of ``a @ b`` (no TF32), cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    with full_f32():
        return (a.float() @ b.float()).to(out_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,S,D); k/v: (B,Hkv,Sk,D); GQA by head repetition.

    The causal mask is the reference oracle's bottom-right ``tril(k=Sk-S)``;
    it equals the kernel's top-left mask only when ``S == Sk``.
    """
    s, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    with full_f32():
        kr = k.float().repeat_interleave(group, dim=1)
        vr = v.float().repeat_interleave(group, dim=1)
        s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
        if causal:
            sk = k.shape[2]
            mask = torch.ones((s, sk), dtype=torch.bool,
                              device=q.device).tril(sk - s)
            s_mat = torch.where(mask, s_mat, _NEG_INF)
        p = torch.softmax(s_mat, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return out.to(q.dtype)


def ssm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: Optional[torch.Tensor] = None,
                 diag_mode: str = "inclusive") -> torch.Tensor:
    """Step-by-step recurrence (a loop over time) — the ground truth.

        h_t = exp(w_t) (.) h_{t-1} + k_t (x) v_t
        inclusive: o_t = q_t . h_t
        bonus:     o_t = q_t . h_{t-1} + (q_t . (u (.) k_t)) v_t
    """
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if u is None:
        u = torch.zeros((h, dk), dtype=q.dtype, device=q.device)
    with full_f32():
        qf, kf, vf, wf = q.float(), k.float(), v.float(), w.float()
        uf = u.float()[None].expand(b, h, dk)
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
        outs = []
        for t in range(s):
            qt, kt, vt, wt = qf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
            h_new = torch.exp(wt)[..., None] * state + kt[..., None] * vt[..., None, :]
            if diag_mode == "inclusive":
                o = torch.einsum("bhk,bhkv->bhv", qt, h_new)
            else:
                o = torch.einsum("bhk,bhkv->bhv", qt, state)
                bonus = torch.einsum("bhk,bhk->bh", qt, uf * kt)
                o = o + bonus[..., None] * vt
            state = h_new
            outs.append(o)
    return torch.stack(outs, dim=2).to(q.dtype)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (Cin,H,W); w: (Cout,Cin,kh,kw) -> valid unit-stride conv."""
    with full_f32():
        out = F.conv2d(x[None].float(), w.float(), stride=1, padding=0)
    return out[0].to(x.dtype)
