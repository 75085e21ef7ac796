"""Shared layers: norms, RoPE, activations, embedding and the LM head.

The port of ``repro.models.common``.  Each function keeps the reference's
dtype at every step: norm statistics in float32 with the data path in the
model dtype, rotations in the model dtype, logits cast to float32 after the
head.  ``constrain`` is the identity: the port runs on one card, and the
reference's sharding rules wait for the mesh tooling (``ROADMAP.md`` item
20).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's logical-axis sharding constraint; one card, no mesh."""
    return x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """Statistics in f32; the (B,S,D) data path stays in the model dtype."""
    dt = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    scale = (1.0 + w.float()).to(dt) if plus_one else w.to(dt)
    return x * inv * scale


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - mu.to(dt)) * inv.to(dt) * w.to(dt) + b.to(dt)


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Family-appropriate normalization.  p is dict with 'w' (+ 'b' for LN)."""
    if cfg.family in ("audio",) or cfg.family == "ssm":
        return layer_norm(x, p["w"], p["b"], eps=cfg.norm_eps)
    plus_one = cfg.name.startswith("gemma")
    return rms_norm(x, p["w"], eps=cfg.norm_eps, plus_one=plus_one)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    if cfg.act == "relu":
        return torch.clamp_min(x, 0.0)
    raise ValueError(cfg.act)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor) -> Tuple:
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim//2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (B, S, D/2) or (S, D/2).  Rotations in the
    model dtype: the cos/sin tables are cast to x's dtype."""
    if cos.ndim == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, None].to(x.dtype)    # (B, 1, S, D/2)
    sin = sin[:, None].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]            # (B, S, D)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return constrain(x, "batch", "seq", "embed")


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The head in the model dtype, then the logits in f32."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = softcap(logits.float(), cfg.logit_softcap)
    return constrain(logits, "batch", "seq", "vocab")
