"""LM forward + loss, dense family; the port of ``repro.models.transformer``.

The layer stack is a Python loop over the stacked group axis of
``params["blocks"]`` (the reference scans it).  The dense family runs here,
gemma2's local/global pair included; the other families raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import attention as A
from .common import embed, lm_logits, norm, rope_freqs
from .config import ModelConfig
from .mlp import mlp_block

# families still to be ported, by ROADMAP.md item
_LATER = {"ssm": "item 13 (RWKV6)", "hybrid": "item 15 (zamba2)",
          "moe": "item 16 (MoE)", "audio": "item 17 (Whisper)",
          "vlm": "item 17 (Llama-3.2-vision)"}


def require_dense(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md {_LATER.get(cfg.family, 'A')})")


def group_params(tree, i: int):
    """Group ``i`` of a tree stacked over groups (views, no copy)."""
    if isinstance(tree, dict):
        return {k: group_params(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def dense_layer(cfg: ModelConfig, p, x, rope, *, window: int = 0):
    """The reference's dense layer without its cross-attention gates, which
    only the VLM uses (ROADMAP.md item 17)."""
    h = norm(cfg, p["ln1"], x)
    a = A.attn_block(cfg, p["attn"], h, rope=rope, causal=True,
                     window=window, attn_softcap=cfg.attn_softcap)
    if "ln1_post" in p:
        a = norm(cfg, p["ln1_post"], a)
    x = x + a
    h = norm(cfg, p["ln2"], x)
    m = mlp_block(cfg, p["mlp"], h)
    if "ln2_post" in p:
        m = norm(cfg, p["ln2_post"], m)
    return x + m


def _group_step(cfg: ModelConfig, x, gp, rope):
    if cfg.local_global:
        x = dense_layer(cfg, gp["local"], x, rope, window=cfg.sliding_window)
        return dense_layer(cfg, gp["global"], x, rope)
    return dense_layer(cfg, gp["lyr"], x, rope)


# ---------------------------------------------------------------------------
# Public forward / loss
# ---------------------------------------------------------------------------


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, S) -> final-norm hidden states (B, S, D) + aux."""
    require_dense(cfg)
    b, s = tokens.shape
    x = embed(cfg, params, tokens)
    rope = None
    if cfg.rope_theta:
        rope = rope_freqs(cfg.head_dim, cfg.rope_theta,
                          torch.arange(s, device=tokens.device))
    for i in range(cfg.num_groups):
        x = _group_step(cfg, x, group_params(params["blocks"], i), rope)
    return norm(cfg, params["final_norm"], x), {}


def forward(cfg: ModelConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-logit forward (prefill/serving path)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return lm_logits(cfg, params, x), aux


def chunked_ce(cfg: ModelConfig, params, x: torch.Tensor,
               tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
               chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy over sequence chunks, each chunk's (B, c, V)
    logits formed on its own, summed in the reference's chunk order."""
    b, s, d = x.shape
    tgt = torch.cat([tokens[:, 1:], torch.zeros((b, 1), dtype=tokens.dtype,
                                                device=tokens.device)], dim=1)
    valid = torch.ones((b, s), device=x.device)
    valid[:, -1] = 0.0
    if mask is not None:
        valid = valid * mask.float()
    c = min(chunk, s)
    n = s // c if s % c == 0 else 1
    c = s // n
    total = torch.zeros((), device=x.device)
    for i in range(n):
        xc, tc, vc = (t[:, i * c:(i + 1) * c] for t in (x, tgt, valid))
        logits = lm_logits(cfg, params, xc)      # (B, c, V)
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.take_along_dim(lp, tc[..., None].long(), dim=-1)[..., 0]
        total = total + (nll * vc).sum()
    return total / torch.clamp_min(valid.sum(), 1.0)


def loss_fn(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy, chunked over sequence."""
    tokens = batch["tokens"]
    x, aux = forward_hidden(cfg, params, tokens)
    loss = chunked_ce(cfg, params, x, tokens, mask=batch.get("mask"))
    return loss, {"ce_loss": loss, "loss": loss}
