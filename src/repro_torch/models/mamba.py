"""Mamba2 (SSD) block, zamba2's backbone layer; the port of
``repro.models.mamba``.

Structure per layer: norm -> in_proj -> causal depthwise conv over
(x, B, C) -> SSD recurrence (scalar per-head decay via the chunked decay
scan) -> gate -> out_proj.  State size 64, head dim 64, d_inner = 2 * d_model.

The model path runs on torch ops and the model-side scan
(``models.ssm_ops``, its scalar-decay inclusive path), as the reference's
runs on jnp: it calls no kernel.  The dtypes follow the reference's term by
term: ``dt``, the decay and ``k = B * dt`` in float32, ``q`` (from C) and
the values in the model dtype, ``y`` cast back to the model dtype only
before ``out_proj``.  The forward's scan uses chunk 64, so a sequence longer
than 64 that 64 does not divide raises (``ROADMAP.md`` C.9).  The decode
step returns the new cache entries and leaves the cache as it was;
``models.decode`` writes them.  Its ``conv`` entry holds the last K-1 conv
*inputs*, before the conv and the SiLU (C.11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import constrain, norm, on_mesh, per_device
from .config import ModelConfig
from .ssm_ops import chunked_decay_scan, decay_scan_step


def _dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    return d_inner, nh, cfg.ssm_state


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """in_proj's output -> (z, x, B, C, dt)."""
    d_inner, nh, st = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner, st, st, nh], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over (B, S, CH), width K, in the reference's
    shift-and-add order (tap 0 first), then ``silu(out + b)``.  On a mesh
    it runs per device, independent over batch and channels: the card's
    torch (2.11) cannot pad a DTensor (ROADMAP.md C.24)."""
    if on_mesh(x):
        return per_device(_causal_conv, x, w, b, like=x, dims=(0, 2),
                          remap={1: {2: 1}, 2: {2: 0}})
    k = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[i]
    return F.silu(out + b)


def _decay(p, dt: torch.Tensor):
    """(dt_full, log decay), both float32: softplus(dt + dt_bias) and
    -dt_full * exp(A_log)."""
    dt_full = F.softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(p["A_log"].float())
    return dt_full, -dt_full * a


def mamba_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    d_inner, nh, st = _dims(cfg)
    hx = norm(cfg, p["ln"], x)
    # on a mesh the projection can come out a partial sum over the data
    # axes: placed on the batch first, its columns whole for the split, so
    # the conv runs on each device's own rows (ROADMAP.md C.24)
    proj = constrain(hx @ p["in_proj"], "batch", "seq", None)
    z, xs, bmat, cmat, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = torch.split(conv_out, [d_inner, st, st], dim=-1)

    dt_full, w = _decay(p, dt)                                 # (B,S,nh)
    w_log = w.transpose(1, 2)                                  # (B,nh,S)
    xh = xs.reshape(b, s, nh, cfg.ssm_head_dim).transpose(1, 2)
    q = cmat[:, None].expand(b, nh, s, st)
    k = bmat[:, None].expand(b, nh, s, st)
    k = k * dt_full.transpose(1, 2)[..., None]                 # dt * B, f32
    y = chunked_decay_scan(q, k, xh.to(q.dtype), w_log, chunk=64,
                           diag_mode="inclusive")              # (B,nh,S,hd)
    y = y + p["D"].to(y.dtype)[None, :, None, None] * xh.to(y.dtype)
    y = y.transpose(1, 2).reshape(b, s, d_inner)
    y = y * F.silu(z)
    out = y.to(x.dtype) @ p["out_proj"]
    return constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Decode (O(1) state per layer)
# ---------------------------------------------------------------------------


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    d_inner, nh, st = _dims(cfg)
    conv_ch = d_inner + 2 * st
    return {
        "h": (batch, nh, st, cfg.ssm_head_dim),
        "conv": (batch, cfg.ssm_conv_width - 1, conv_ch),
    }


def mamba_decode_step(cfg: ModelConfig, p, x1: torch.Tensor, cache: Dict
                      ) -> Tuple[torch.Tensor, Dict]:
    """x1: (B, 1, D); cache: {'h','conv'} per ``mamba_cache_shape``.

    Returns the layer's output (the residual's increment) and the new cache
    entries: the float32 state and the window's last K-1 conv inputs.  The
    window's dot runs as an einsum, a product ``FlopCounterMode`` counts, as
    the reference's HLO counts its dot."""
    b = x1.shape[0]
    d_inner, nh, st = _dims(cfg)
    hx = norm(cfg, p["ln"], x1)
    z, xs, bmat, cmat, dt = _split_proj(cfg, hx @ p["in_proj"])
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)             # (B,1,CH)
    window = torch.cat([cache["conv"], conv_in], dim=1)       # (B,K,CH)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None]                      # (B,1,CH)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, st, st], dim=-1)

    dt_full, w1 = _decay(p, dt[:, 0])                         # (B,nh)
    xh = xs[:, 0].reshape(b, nh, cfg.ssm_head_dim)
    q1 = cmat[:, 0, None].expand(b, nh, st)
    k1 = bmat[:, 0, None].expand(b, nh, st) * dt_full[..., None]
    o, h_new = decay_scan_step(cache["h"], q1, k1, xh, w1)
    o = o + p["D"].to(o.dtype)[None, :, None] * xh.to(o.dtype)
    y = o.reshape(b, 1, d_inner) * F.silu(z)
    out = y.to(x1.dtype) @ p["out_proj"]
    return out, {"h": h_new, "conv": window[:, 1:]}
