"""LM forward + loss; the port of ``repro.models.transformer``.

The layer stack is a Python loop over the stacked group axis of
``params["blocks"]`` (the reference scans it).  Every family runs here:
dense (gemma2's local/global pair included), ssm (RWKV6), hybrid (zamba2:
two Mamba2 layers a group, then the one shared attention+MLP block,
``params["shared_block"]``, applied after every group), moe (its auxiliary
losses summed over groups, as the reference sums them), vlm (four self
layers a group, then a cross layer over the patch embeddings whose
attention and MLP are gated by ``tanh`` of their gates, which the draw
makes zero) and audio (whisper: the encoder over the frame embeddings,
then decoder layers of self attention, cross attention over the encoder's
output and an MLP).  Both modality families need their ``modality``.  A
latent-attention config (``MLAConfig``, DeepSeek-V2; the port's alone)
runs its ``first_k_dense`` dense lead layers (``params["lead"]``) before
the stacked MoE groups, every layer's attention ``attention.mla_block``
on YaRN's rotary tables.

When gradients are being taken (grad mode on and a tensor that requires
one) the reference's rematerialization is honoured: with ``cfg.remat``
each group step and each encoder layer runs under
``torch.utils.checkpoint`` (its activations recomputed in the backward
pass, as ``jax.checkpoint`` of the scan body does), and each chunk of
``chunked_ce`` always does, so the live logits are one chunk's.  The gradients are bit-equal either way (tested).  Otherwise
(serving, decode, ``no_grad``) nothing is wrapped.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import mamba as M
from . import moe as MOE
from . import rwkv as R
from ..obs.ranges import bwd_span, span
from .common import (embed, lm_logits, norm, rope_freqs, sinusoid_pos,
                     yarn_freqs)
from .config import ModelConfig
from .mlp import mlp_block

# the families the port runs: all of the reference's
PORTED_FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


def group_params(tree, i: int):
    """Group ``i`` of a tree stacked over groups (views, no copy)."""
    if isinstance(tree, dict):
        return {k: group_params(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_groups(tree, n: int):
    """The ``n`` groups of a tree stacked over groups, as a list of trees
    of views: one ``unbind`` a leaf, whose backward stacks the groups'
    gradients once (indexing each group would add a full-size gradient a
    group)."""
    if isinstance(tree, dict):
        per_key = {k: unbind_groups(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _taking_grads(*trees) -> bool:
    """Grad mode is on and some tensor of ``trees`` requires a gradient."""
    def needs(t) -> bool:
        if isinstance(t, dict):
            return any(needs(v) for v in t.values())
        return isinstance(t, torch.Tensor) and t.requires_grad
    return torch.is_grad_enabled() and any(needs(t) for t in trees)


def _remat(cfg: ModelConfig, grads: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``cfg.remat``
    and ``grads`` (gradients are being taken)."""
    if cfg.remat and grads:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def dense_layer(cfg: ModelConfig, p, x, rope, *, window: int = 0,
                kv_x=None, gated: bool = False):
    """A dense layer; with ``kv_x`` its attention is cross attention over
    ``kv_x`` (no rope, no causal mask), and ``gated`` scales the attention
    and MLP outputs by ``tanh`` of the layer's gates (the VLM's cross
    layer)."""
    h = norm(cfg, p["ln1"], x)
    a = A.attn_block(cfg, p["attn"], h, rope=rope, causal=True,
                     window=window, kv_x=kv_x, attn_softcap=cfg.attn_softcap)
    if gated:
        a = a * torch.tanh(p["gate_attn"]).to(a.dtype)
    if "ln1_post" in p:
        a = norm(cfg, p["ln1_post"], a)
    x = x + a
    h = norm(cfg, p["ln2"], x)
    m = mlp_block(cfg, p["mlp"], h)
    if gated:
        m = m * torch.tanh(p["gate_mlp"]).to(m.dtype)
    if "ln2_post" in p:
        m = norm(cfg, p["ln2_post"], m)
    return x + m


def _self_attn(cfg: ModelConfig, p, h, rope):
    """Causal self attention: latent (``attention.mla_block``) for an
    ``MLAConfig``, else grouped-query."""
    if cfg.kv_lora_rank:
        return A.mla_block(cfg, p, h, rope)
    return A.attn_block(cfg, p, h, rope=rope, causal=True)


def lead_layer(cfg: ModelConfig, p, x, rope):
    """A dense lead layer of an MoE stack, its MLP in the ranges ``mlp`` and
    ``mlp.bwd``."""
    h = norm(cfg, p["ln1"], x)
    x = x + _self_attn(cfg, p["attn"], h, rope)
    h = norm(cfg, p["ln2"], x)
    with span("mlp"):
        h, mark = bwd_span("mlp", h)
        return x + mark(mlp_block(cfg, p["mlp"], h))


def moe_layer(cfg: ModelConfig, p, x, rope) -> Tuple[torch.Tensor, Dict]:
    """(output, the layer's auxiliary losses)."""
    h = norm(cfg, p["ln1"], x)
    x = x + _self_attn(cfg, p["attn"], h, rope)
    h = norm(cfg, p["ln2"], x)
    y, aux = MOE.moe_block(cfg, p["moe"], h)
    return x + y, aux


def whisper_dec_layer(cfg: ModelConfig, p, x, enc_out):
    h = norm(cfg, p["ln1"], x)
    x = x + A.attn_block(cfg, p["attn"], h, rope=None, causal=True)
    h = norm(cfg, p["ln2"], x)
    x = x + A.attn_block(cfg, p["cross"], h, rope=None, kv_x=enc_out)
    h = norm(cfg, p["ln3"], x)
    return x + mlp_block(cfg, p["mlp"], h)


def whisper_enc_layer(cfg: ModelConfig, p, x):
    h = norm(cfg, p["ln1"], x)
    x = x + A.attn_block(cfg, p["attn"], h, rope=None, causal=False)
    h = norm(cfg, p["ln2"], x)
    return x + mlp_block(cfg, p["mlp"], h)


def _group_step(cfg: ModelConfig, params, x, gp, rope, modality
                ) -> Tuple[torch.Tensor, Dict]:
    """One group: (output, the group's auxiliary losses, {} but for moe).
    The losses are returned, not accumulated here, so that a recomputed
    group adds them once."""
    if cfg.family == "audio":
        return whisper_dec_layer(cfg, gp["lyr"], x, modality), {}
    if cfg.family == "vlm":
        for lp in unbind_groups(gp["self"], cfg.cross_attn_every - 1):
            x = dense_layer(cfg, lp, x, rope)
        return dense_layer(cfg, gp["cross"], x, rope, kv_x=modality,
                           gated=True), {}
    if cfg.family == "ssm":
        return R.rwkv_block(cfg, gp["lyr"], x), {}
    if cfg.family == "moe":
        return moe_layer(cfg, gp["lyr"], x, rope)
    if cfg.family == "hybrid":
        for lp in unbind_groups(gp["mamba"], cfg.hybrid_attn_every - 1):
            x = x + M.mamba_block(cfg, lp, x)
        return dense_layer(cfg, params["shared_block"], x, rope), {}
    if cfg.local_global:
        x = dense_layer(cfg, gp["local"], x, rope, window=cfg.sliding_window)
        return dense_layer(cfg, gp["global"], x, rope), {}
    return dense_layer(cfg, gp["lyr"], x, rope), {}


# ---------------------------------------------------------------------------
# Public forward / loss
# ---------------------------------------------------------------------------


def encode_audio(cfg: ModelConfig, params, frames: torch.Tensor
                 ) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, enc_seq, D)."""
    x = frames + sinusoid_pos(frames.shape[1], cfg.d_model,
                              device=frames.device).to(frames.dtype)
    grads = _taking_grads(params["encoder"], x)
    for lp in unbind_groups(params["encoder"], cfg.encoder_layers):
        x = _remat(cfg, grads, whisper_enc_layer, cfg, lp, x)
    return norm(cfg, params["enc_norm"], x)


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor,
                   modality: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, S) -> final-norm hidden states (B, S, D) + aux.
    ``modality``: the frame embeddings (audio) or patch embeddings (vlm)."""
    b, s = tokens.shape
    x = embed(cfg, params, tokens)
    rope = None
    if cfg.kv_lora_rank:
        rope = yarn_freqs(cfg, torch.arange(s, device=tokens.device))
    elif cfg.rope_theta:
        rope = rope_freqs(cfg.head_dim, cfg.rope_theta,
                          torch.arange(s, device=tokens.device))
    if cfg.family == "audio":
        assert modality is not None, "whisper needs frame embeddings"
        modality = encode_audio(cfg, params, modality)
        x = x + sinusoid_pos(s, cfg.d_model, device=x.device).to(x.dtype)
    if cfg.family == "vlm":
        assert modality is not None, "vlm needs patch embeddings"
    aux: Dict = {}
    if cfg.family == "moe":         # the reference's scan starts from zeros
        aux = {k: torch.zeros((), device=x.device)
               for k in ("moe_aux", "moe_zloss")}
    grads = _taking_grads(params, x, modality)
    for lp in unbind_groups(params.get("lead", {}), cfg.first_k_dense):
        x = _remat(cfg, grads, lead_layer, cfg, lp, x, rope)
    for gp in unbind_groups(params["blocks"], cfg.num_groups):
        x, group_aux = _remat(cfg, grads, _group_step, cfg, params, x, gp,
                              rope, modality)
        for k, v in group_aux.items():
            aux[k] = aux[k] + v
    return norm(cfg, params["final_norm"], x), aux


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            modality: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-logit forward (prefill/serving path)."""
    x, aux = forward_hidden(cfg, params, tokens, modality=modality)
    return lm_logits(cfg, params, x), aux


def chunked_ce(cfg: ModelConfig, params, x: torch.Tensor,
               tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
               chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy over sequence chunks, each chunk's (B, c, V)
    logits formed on its own (and, when gradients are being taken, formed
    again in the backward pass, as the reference's ``jax.checkpoint`` of
    the chunk),
    summed in the reference's chunk order.  In the ranges ``lm_loss`` and
    ``lm_loss.bwd`` (the chunks' recomputation inside the latter)."""
    with span("lm_loss"):
        x, mark = bwd_span("lm_loss", x)
        b, s, d = x.shape
        tgt = torch.cat([tokens[:, 1:],
                         torch.zeros((b, 1), dtype=tokens.dtype,
                                     device=tokens.device)], dim=1)
        valid = torch.ones((b, s), device=x.device)
        valid[:, -1] = 0.0
        if mask is not None:
            valid = valid * mask.float()
        c = min(chunk, s)
        n = s // c if s % c == 0 else 1
        c = s // n

        def body(xc, tc, vc):
            logits = lm_logits(cfg, params, xc)      # (B, c, V)
            lp = torch.log_softmax(logits.float(), dim=-1)
            nll = -torch.take_along_dim(lp, tc[..., None].long(),
                                        dim=-1)[..., 0]
            return (nll * vc).sum()

        grads = _taking_grads(params, x)
        total = torch.zeros((), device=x.device)
        for i in range(n):
            xc, tc, vc = (t[:, i * c:(i + 1) * c] for t in (x, tgt, valid))
            if grads:
                total = total + checkpoint(body, xc, tc, vc,
                                           use_reentrant=False)
            else:
                total = total + body(xc, tc, vc)
        return mark(total / torch.clamp_min(valid.sum(), 1.0))


def loss_fn(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux losses, averaged over groups,
    the MoE layers), chunked over sequence."""
    tokens = batch["tokens"]
    x, aux = forward_hidden(cfg, params, tokens,
                            modality=batch.get("modality"))
    loss = chunked_ce(cfg, params, x, tokens, mask=batch.get("mask"))
    metrics = {"ce_loss": loss}
    if aux:
        n = cfg.num_groups
        metrics["moe_aux"] = aux["moe_aux"] / n
        metrics["moe_zloss"] = aux["moe_zloss"] / n
        loss = loss + 0.01 * metrics["moe_aux"] + 1e-3 * metrics["moe_zloss"]
    metrics["loss"] = loss
    return loss, metrics
