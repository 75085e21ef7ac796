"""Mixture-of-Experts with the paper's banking discipline applied to experts;
the port of ``repro.models.moe``.

``banked`` dispatch (default, the layout-embedded scheme): experts are
memory banks.  Tokens are moved into a static expert-leading capacity
buffer (E, C, D), row-wise data movement of O(T*k*D), and all compute is
dense products over the expert dimension.

``gather`` dispatch (the "branchy" analogue, for the ablation): per-token
expert-weight gathers, O(T*D*F) data movement with data-dependent indexing.

The reference's expert-parallel dispatch (``moe_block_banked_ep``, a
``shard_map`` over a mesh) waits for the mesh tooling (``ROADMAP.md`` item
20); on one card ``moe_block`` takes the banked path, as the reference does
with no mesh.  Two traps are kept (C.12): the top-k breaks ties toward the
lower expert index, as ``jax.lax.top_k`` does (a stable descending sort;
``torch.topk`` promises no order), and dropped assignments scatter zero rows
onto the last capacity slot with an add (``index_put_(...,
accumulate=True)``), never an overwrite.  The router runs in float32
whatever the model dtype, in full float32 (``device.full_f32``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import full_f32
from .common import activation, constrain
from .config import ModelConfig
from .params import gated_mlp


def _router(cfg: ModelConfig, p, x2: torch.Tensor, aux: bool = True):
    """x2: (T, D) -> (probs (T,k), idx (T,k), aux metrics).  ``aux=False``
    skips the two auxiliary losses (an empty dict), which the decode step
    discards, as the reference's jitted step lets XLA drop them."""
    with full_f32():
        logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt[:, :k], order[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    if not aux:
        return top_p, top_i, {}
    e = cfg.num_experts
    me = F.one_hot(top_i, e).sum(1).float().mean(dim=0)       # load/expert
    pe = probs.mean(dim=0)
    moe_aux = e * torch.sum(me / k * pe)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, {"moe_aux": moe_aux, "moe_zloss": zloss}


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.experts_per_token
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)   # pad to lane multiple


def _expert_ffn(cfg: ModelConfig, p, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D): dense over the leading expert 'banks'."""
    h = torch.bmm(xe, p["w1"])
    if gated_mlp(cfg):
        g = torch.bmm(xe, p["wg"])
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    return constrain(torch.bmm(h, p["w2"]), "experts", "capacity", None)


def moe_block_banked(cfg: ModelConfig, p, x: torch.Tensor, aux: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, D).  Static-capacity dispatch: scatter rows into the
    expert-leading buffer, dense expert FFN, gather back."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, t)
    x2 = x.reshape(t, d)
    top_p, top_i, aux_m = _router(cfg, p, x2, aux)

    # flat (T*k,) assignment stream, token-major; position inside each
    # expert's capacity buffer = number of earlier assignments to it
    eid = top_i.reshape(t * k)
    gate = top_p.reshape(t * k)
    oh = F.one_hot(eid, e)                                    # (T*k, E)
    pos = torch.cumsum(oh, dim=0) - oh                        # exclusive
    pos = torch.take_along_dim(pos, eid[:, None], dim=1)[:, 0]
    keep = pos < cap
    pos_c = torch.clamp_max(pos, cap - 1)

    # dropped assignments add zero rows onto the last slot (C.12)
    x_rep = torch.repeat_interleave(x2, k, dim=0)             # (T*k, D)
    upd = x_rep * keep[:, None].to(x.dtype)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((eid, pos_c), upd, accumulate=True)
    ye = _expert_ffn(cfg, p, buf)
    y_rows = ye[eid, pos_c]                                   # (T*k, D)
    y_rows = y_rows.float() * (gate * keep.float())[:, None]
    y2 = y_rows.reshape(t, k, d).sum(dim=1)
    return y2.to(x.dtype).reshape(b, s, d), aux_m


def moe_block_gather(cfg: ModelConfig, p, x: torch.Tensor, aux: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """Ablation path: per-token expert-weight gathers (the 'branchy'
    analogue), only sane at small scale."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    top_p, top_i, aux_m = _router(cfg, p, x2, aux)
    y2 = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for slot in range(cfg.experts_per_token):
        idx = top_i[:, slot]                       # (T,) dynamic
        w1 = p["w1"][idx]                          # (T, D, F) gather
        w2 = p["w2"][idx]
        h = torch.bmm(x2[:, None], w1)[:, 0]
        if gated_mlp(cfg):
            wg = p["wg"][idx]
            h = activation(cfg, torch.bmm(x2[:, None], wg)[:, 0]) * h
        else:
            h = activation(cfg, h)
        y = torch.bmm(h[:, None], w2)[:, 0]
        y2 = y2 + top_p[:, slot, None] * y.float()
    return y2.to(x.dtype).reshape(b, s, d), aux_m


def moe_block(cfg: ModelConfig, p, x: torch.Tensor, aux: bool = True
              ) -> Tuple[torch.Tensor, Dict]:
    if cfg.moe_dispatch == "banked":
        return moe_block_banked(cfg, p, x, aux)
    return moe_block_gather(cfg, p, x, aux)
