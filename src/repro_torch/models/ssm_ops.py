"""Chunked decay scan in plain PyTorch, the model-side twin of the scan
kernel; the port of ``repro.models.ssm_ops``.

Two paths:
  * scalar decay per head (Mamba2 SSD): w (B,H,S); (C,C) relative-decay
    matrices;
  * per-channel decay (RWKV6): w (B,H,S,dk); (C,C,dk) intermediates inside
    the chunk step.

The reference's arithmetic is kept, not the kernel's (``ROADMAP.md`` C.2):
relative decays are differences ``W_t - W_s`` of an inclusive cumsum, the
upper triangle is masked to -1e30 *before* the exp, q/k/v stay in their
own dtype with decays and accumulation in float32 (bf16 operands are upcast
before each product, as ``preferred_element_type`` asks), and the chunk
must divide the sequence (C.9: the port raises where the reference asserts;
it does not pad).  The reference runs its chunk step under
``jax.checkpoint``, a training device with no effect on the forward: the
port leaves it out.  Products run in full float32 (``device.full_f32``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import full_f32
from .common import on_mesh, per_device

_NEG = -1e30


def chunked_decay_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: Optional[torch.Tensor] = None,
                       chunk: int = 64, diag_mode: str = "inclusive",
                       h0: Optional[torch.Tensor] = None,
                       return_state: bool = False):
    """q/k: (B,H,S,dk); v: (B,H,S,dv); w: (B,H,S) scalar or (B,H,S,dk).

    h_t = exp(w_t) (.) h_{t-1} + k_t (x) v_t
    inclusive: o_t = q_t . h_t          (Mamba2)
    bonus:     o_t = q_t . h_{t-1} + (q_t . (u (.) k_t)) v_t   (RWKV6)

    Returns o (B,H,S,dv) in q's dtype, and the float32 state (B,H,dk,dv)
    after the last step when ``return_state``.
    """
    if on_mesh(q):      # per device: independent over batch and heads
        def scan(q, k, v, w, u, h0):
            return chunked_decay_scan(q, k, v, w, u=u, chunk=chunk,
                                      diag_mode=diag_mode, h0=h0,
                                      return_state=return_state)
        return per_device(scan, q, k, v, w, u, h0, like=q,
                          remap={4: {1: 0}}, n_out=2 if return_state else 1)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    scalar_decay = w.ndim == 3
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"the chunk must divide the sequence: {(s, chunk)}")
    n = s // chunk
    f32, dt = torch.float32, q.dtype
    dev = q.device

    qc = q.reshape(b, h, n, chunk, dk)
    kc = k.reshape(b, h, n, chunk, dk)
    vc = v.reshape(b, h, n, chunk, dv)
    wc = (w.to(f32).reshape(b, h, n, chunk) if scalar_decay
          else w.to(f32).reshape(b, h, n, chunk, dk))
    uf = u.to(f32) if u is not None else None        # (H, dk)

    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=dev)
    mask_incl, mask_strict = ones.tril(), ones.tril(-1)

    def rel_scores(qb, kb, Wq_t, W_s, mask):
        """The intra-chunk scores q_t . k_s weighted by exp(Wq_t - W_s)."""
        if scalar_decay:
            diff = Wq_t[..., :, None] - W_s[..., None, :]       # (b,h,C,C)
            rel = torch.exp(torch.where(mask, diff, _NEG))
            return torch.einsum("bhtd,bhsd->bhts", qb.to(f32),
                                kb.to(f32)) * rel
        diff = Wq_t[..., :, None, :] - W_s[..., None, :, :]     # (b,h,C,C,dk)
        rel = torch.exp(torch.where(mask[..., None], diff, _NEG))
        return (qb.to(f32)[..., :, None, :] * rel
                * kb.to(f32)[..., None, :, :]).sum(-1)

    def step(hstate, qb, kb, vb, wb):
        W = torch.cumsum(wb, dim=2)                 # inclusive
        Wq = W[..., None] if scalar_decay else W    # (b,h,C,1|dk)
        if diag_mode == "inclusive":
            Wq_t, mask = W, mask_incl
            qW = qb * torch.exp(Wq).to(dt)
        else:
            Wq_t, mask = W - wb, mask_strict
            qW = qb * torch.exp(Wq_t[..., None] if scalar_decay
                                else Wq_t).to(dt)
        o_inter = torch.einsum("bhck,bhkv->bhcv", qW.to(f32),
                               hstate.to(dt).to(f32))
        scores = rel_scores(qb, kb, Wq_t, W, mask)
        o = o_inter + torch.einsum("bhts,bhsv->bhtv",
                                   scores.to(dt).to(f32), vb.to(f32))
        if diag_mode != "inclusive":
            bonus = (qb.to(f32) * uf[None, :, None, :] * kb.to(f32)).sum(-1)
            o = o + bonus[..., None] * vb.to(f32)
        w_last = W[..., -1][..., None] if scalar_decay else W[..., -1, :]
        k_dec = kb * torch.exp(w_last[..., None, :] - Wq).to(dt)
        h_new = (torch.exp(w_last)[..., None] * hstate
                 + torch.einsum("bhck,bhcv->bhkv", k_dec.to(f32), vb.to(f32)))
        return h_new, o

    hstate = (torch.zeros((b, h, dk, dv), dtype=f32, device=dev) if h0 is None
              else h0.to(f32))
    outs = []
    with full_f32():
        for i in range(n):
            hstate, o = step(hstate, qc[:, :, i], kc[:, :, i], vc[:, :, i],
                             wc[:, :, i])
            outs.append(o)
    o = torch.stack(outs, dim=2).reshape(b, h, s, dv).to(q.dtype)
    if return_state:
        return o, hstate
    return o


def decay_scan_step(hstate: torch.Tensor, q1, k1, v1, w1,
                    u: Optional[torch.Tensor] = None,
                    diag_mode: str = "inclusive"):
    """Single-token recurrence step for decode, in float32.

    hstate: (B,H,dk,dv); q1/k1/w1: (B,H,dk) (w scalar -> (B,H)); v1: (B,H,dv).
    Returns (o (B,H,dv), new state), both float32, whatever ``hstate``'s
    dtype (a bf16 state comes back float32, as in the reference).
    """
    if on_mesh(hstate):
        def step(hstate, q1, k1, v1, w1, u):
            return decay_scan_step(hstate, q1, k1, v1, w1, u, diag_mode)
        return per_device(step, hstate, q1, k1, v1, w1, u, like=hstate,
                          remap={5: {1: 0}}, n_out=2)
    f32 = torch.float32
    q1, k1, v1, hstate = q1.to(f32), k1.to(f32), v1.to(f32), hstate.to(f32)
    if w1.ndim == 2:
        decay = torch.exp(w1.to(f32))[..., None, None]
    else:
        decay = torch.exp(w1.to(f32))[..., :, None]
    h_new = decay * hstate + k1[..., :, None] * v1[..., None, :]
    with full_f32():
        if diag_mode == "inclusive":
            o = torch.einsum("bhk,bhkv->bhv", q1, h_new)
        else:
            o = torch.einsum("bhk,bhkv->bhv", q1, hstate)
            bonus = (q1 * u.to(f32) * k1).sum(-1)
            o = o + bonus[..., None] * v1
    return o, h_new
