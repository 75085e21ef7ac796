"""GQA attention: chunked (flash-style) training path, cached decode path.

The port of ``repro.models.attention``.  ``chunked_attention`` keeps the
reference's static flash schedule: the q-chunk loop and each chunk's live
kv range are Python, with the mask applied only to boundary chunks.  GQA is
an einsum over a folded group dimension, never a materialized head repeat.
Scores and the probability-value product accumulate in float32: bf16
operands are upcast before the product, as ``preferred_element_type``
asks in the reference.

The decode path writes the cache in place and returns it.  It keeps the
reference's traps (``ROADMAP.md`` C): ring slots by floor-mod (C.4), a
write position past the cache end clamped to the last slot as
``dynamic_update_slice`` does (C.8), and attention over the full cache
length in float32 with the mask ``k_pos <= pos`` (C.7).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import (apply_rope, constrain, on_mesh, per_device, rope_freqs,
                     softcap, unshard)
from .config import ModelConfig

_NEG = -1e30


def qkv_proj(cfg: ModelConfig, p, x: torch.Tensor,
             kv_x: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> q (B,H,S,dh), k/v (B,Hkv,Sk,dh)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    # under rules the projections' columns are gathered before the heads
    # are split out of them: DTensor cannot split a dimension its shards do
    # not divide (C.20); the constraints below replicate heads anyway
    q = unshard(q, -1).reshape(b, s, h, dh).transpose(1, 2)
    k = unshard(k, -1).reshape(b, sk, hkv, dh).transpose(1, 2)
    v = unshard(v, -1).reshape(b, sk, hkv, dh).transpose(1, 2)
    return constrain(q, "batch", "heads", None, None), \
        constrain(k, "batch", "kv_heads", None, None), \
        constrain(v, "batch", "kv_heads", None, None)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, scale: float,
                      q_chunk: int = 512, kv_chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention with a static flash schedule.

    Each q chunk visits exactly its live kv range (causal frontier, sliding
    window), masked on the boundary chunks only; interior chunks run
    mask-free and dead chunks are never visited.

    ``q_offset``: absolute position of q[0] (decode/prefill continuation).
    q: (B,H,Sq,dh), k/v: (B,Hkv,Sk,dh).
    """
    if on_mesh(q):
        def attend(q, k, v):
            return chunked_attention(
                q, k, v, causal=causal, window=window,
                attn_softcap=attn_softcap, scale=scale, q_chunk=q_chunk,
                kv_chunk=kv_chunk, q_offset=q_offset)
        return per_device(attend, q, k, v, like=q)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // kv_chunk)
    sq_p, sk_p = nq * q_chunk, nk * kv_chunk
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = F.pad(k, (0, 0, 0, sk_p - sk))
        v = F.pad(v, (0, 0, 0, sk_p - sk))

    qg = q.reshape(b, hkv, g, sq_p, dh)
    k_blocks = k.reshape(b, hkv, nk, kv_chunk, dh)
    v_blocks = v.reshape(b, hkv, nk, kv_chunk, dh)
    full_chunks = sk // kv_chunk       # chunks with no padding
    dev = q.device

    def kv_step(carry, q_blk, q_pos, kj, masked):
        m, l, acc = carry
        k_blk, v_blk = k_blocks[:, :, kj], v_blocks[:, :, kj]
        s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk.float(),
                         k_blk.float()) * scale
        if attn_softcap:
            s = softcap(s, attn_softcap)
        if masked:
            k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            mask &= (k_pos < sk)[None, :]
            s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v_blk.dtype).float(), v_blk.float())
        return m_new, l_new, acc_new

    def q_chunk_attend(q_blk, qi):
        a_pos = q_offset + qi * q_chunk             # first q position
        b_pos = a_pos + q_chunk - 1                 # last q position
        q_pos = a_pos + torch.arange(q_chunk, device=dev)
        # live kv chunk range [lo, hi)
        hi = min(nk, b_pos // kv_chunk + 1) if causal else nk
        lo = 0
        if window:
            # first key any query in the chunk needs: a_pos - window + 1
            lo = max(0, -(-(a_pos - window + 2 - kv_chunk) // kv_chunk))
        # fully-unmasked interior [lo_full, hi_full)
        hi_full = hi
        if causal:
            hi_full = max(lo, min(hi, (a_pos - kv_chunk + 1) // kv_chunk + 1
                                  if a_pos - kv_chunk + 1 >= 0 else 0))
        lo_full = lo
        if window:
            # chunk is unmasked only if the LAST query (b_pos) sees all keys
            lo_full = min(hi_full, max(lo, -(-(b_pos - window + 1)
                                             // kv_chunk)))
        hi_full = min(hi_full, full_chunks)          # padding needs masking
        lo_full = min(lo_full, hi_full)

        carry = (torch.full((b, hkv, g, q_chunk, 1), _NEG, device=dev),
                 torch.zeros((b, hkv, g, q_chunk, 1), device=dev),
                 torch.zeros((b, hkv, g, q_chunk, dh), device=dev))
        for lo_i, hi_i, masked in ((lo, lo_full, True),       # window boundary
                                   (lo_full, hi_full, False),  # interior
                                   (hi_full, hi, True)):       # causal/pad
            for kj in range(lo_i, hi_i):
                carry = kv_step(carry, q_blk, q_pos, kj, masked)
        m, l, acc = carry
        return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)

    outs = [q_chunk_attend(qg[:, :, :, qi * q_chunk:(qi + 1) * q_chunk], qi)
            for qi in range(nq)]
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    out = out.reshape(b, h, sq_p, dh)
    return out[:, :, :sq]


def attn_block(cfg: ModelConfig, p, x: torch.Tensor, *,
               rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               causal: bool = True, window: int = 0,
               kv_x: Optional[torch.Tensor] = None,
               attn_softcap: float = 0.0) -> torch.Tensor:
    """Full attention sub-block (projections + mixing + output proj)."""
    b, s, d = x.shape
    q, k, v = qkv_proj(cfg, p, x, kv_x=kv_x)
    if rope is not None and kv_x is None:
        cos, sin = rope
        q = apply_rope(q, cos[:s], sin[:s])
        k = apply_rope(k, cos[:s], sin[:s])
    scale = 1.0 / (cfg.head_dim ** 0.5)
    out = chunked_attention(q, k, v, causal=causal and kv_x is None,
                            window=window, attn_softcap=attn_softcap,
                            scale=scale)
    out = out.transpose(1, 2).reshape(b, s, -1)
    out = out @ p["wo"]
    return constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Decode path (single new token against a static KV cache)
# ---------------------------------------------------------------------------


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 KV entry with a per-token absmax scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True) + 1e-6
    scale = amax / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def attend_cache(qg, kc, vc, mask=None, attn_softcap: float = 0.0):
    """qg (B,Hkv,g,1,dh) against cached k/v (B,Hkv,L,dh), under ``mask``
    (L,) where one is given, in float32 -> (B,Hkv,g,1,dh)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     kc.float()) / (qg.shape[-1] ** 0.5)
    if attn_softcap:
        s = softcap(s, attn_softcap)
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    pgs = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", pgs, vc.float())


def attn_decode(cfg: ModelConfig, p, x1: torch.Tensor, cache: dict, pos,
                *, window: int = 0, attn_softcap: float = 0.0,
                ring: bool = False) -> Tuple[torch.Tensor, dict]:
    """x1: (B, 1, D); cache: {'k','v'} (B, Hkv, S_max, dh); pos: int.

    ``ring=True`` treats the cache as a circular window buffer (sliding-
    window layers): slot i holds absolute position pos - ((pos - i) mod L).

    Writes the new key and value into ``cache`` in place and returns
    (attn output (B,1,D), cache).
    """
    b, _, d = x1.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    pos = int(pos)
    dev = x1.device
    q, k1, v1 = qkv_proj(cfg, p, x1)
    if cfg.rope_theta:
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        cos, sin = rope_freqs(dh, cfg.rope_theta, posv)
        q = apply_rope(q, cos, sin)
        k1 = apply_rope(k1, cos, sin)
    smax = cache["k"].shape[2]
    # ring: floor-mod (C.4); otherwise the write start clamps into the cache
    # as dynamic_update_slice's does (C.8)
    slot = pos % smax if ring else min(max(pos, 0), smax - 1)
    if "k_scale" in cache:
        k_q, k_s = _quant(k1)
        v_q, v_s = _quant(v1)
        cache["k"][:, :, slot] = k_q[:, :, 0]
        cache["v"][:, :, slot] = v_q[:, :, 0]
        cache["k_scale"][:, :, slot] = k_s[:, :, 0]
        cache["v_scale"][:, :, slot] = v_s[:, :, 0]
        kc = cache["k"].float() * cache["k_scale"]
        vc = cache["v"].float() * cache["v_scale"]
    else:
        cache["k"][:, :, slot] = k1[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot] = v1[:, :, 0].to(cache["v"].dtype)
        kc, vc = cache["k"], cache["v"]
    k_pos = torch.arange(smax, device=dev)
    if ring:
        abs_pos = pos - torch.remainder(pos - k_pos, smax)
        mask = abs_pos >= 0
        if window:
            mask &= (pos - abs_pos) < window
    else:
        mask = k_pos <= pos
        if window:
            mask &= (pos - k_pos) < window
    qg = q.reshape(b, hkv, g, 1, dh)
    out = per_device(functools.partial(attend_cache,
                                       attn_softcap=attn_softcap),
                     qg, kc, vc, mask, like=kc)
    out = out.reshape(b, h, 1, dh).transpose(1, 2).reshape(b, 1, -1)
    out = out.to(x1.dtype) @ p["wo"]
    return out, cache
