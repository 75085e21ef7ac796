"""Plain reference of the MoE decoder LM that the port serves and trains.

Written from the configuration file alone, in plain PyTorch and float32
with TF32 off: no kernel, no cache, no batching engine, nothing of the
program.  It owns the weight tree the harness makes (``shapes``, drawn by
``perfbench/weights.py``) and works out again everything the program
derives from it; what no layer of its own decides is in ``common.py``.

The model, as the configuration runs it (its ``departures`` say where that
differs from the published model):

- token embedding; per layer, pre-norm RMSNorm, multi-head attention with
  grouped keys and values, rotary embedding (rotate-half form) at the
  token's position, causal, scale 1/sqrt(head_dim); residual;
- pre-norm RMSNorm, a float32 router softmax over the experts, the top
  ``experts_per_token`` by probability with ties to the lower expert,
  their probabilities renormalised to sum to one; each expert a gated SiLU
  FFN, silu(x Wg) * (x W1) then W2; residual;
- expert capacity: within one dispatch group, an expert takes at most
  ``capacity(n)`` assignments (counts.capacity) in token order, then
  expert-rank order; later ones are dropped and add nothing;
- final RMSNorm and the LM head (the embedding transposed when tied).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import counts
from perfbench.reference.common import (gqa_attention, head_loss,
                                        head_weight, layer_weights, mm,
                                        no_tf32, rms_norm)


def shapes(c: Dict) -> Dict[str, Any]:
    """{name: (shape, kind)} of the MoE decoder LM, nested as the port nests
    it: ``blocks/lyr/{attn,ln1,ln2,moe}`` stacked over the layers."""
    n, d, v = c["num_layers"], c["d_model"], c["vocab_size"]
    h, hkv, dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    e, f = c["num_experts"], c["d_ff"]
    lyr = {
        "attn": {"wq": ((n, d, h * dh), "normal"),
                 "wk": ((n, d, hkv * dh), "normal"),
                 "wv": ((n, d, hkv * dh), "normal"),
                 "wo": ((n, h * dh, d), "normal")},
        "ln1": {"w": ((n, d), "ones")},
        "ln2": {"w": ((n, d), "ones")},
        "moe": {"router": ((n, d, e), "normal"),
                "w1": ((n, e, d, f), "expert"),
                "wg": ((n, e, d, f), "expert"),
                "w2": ((n, e, f, d), "expert")},
    }
    tree: Dict[str, Any] = {"embed": ((v, d), "embed"),
                            "blocks": {"lyr": lyr},
                            "final_norm": {"w": ((d,), "ones")}}
    if not c["tie_embeddings"]:
        tree["lm_head"] = ((d, v), "normal")
    return tree


def moe(c: Dict, p: Dict, x2: torch.Tensor, groups: torch.Tensor,
        group_size: int, precision: Optional[str]
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (N, D) in token order, ``groups`` (N,) the dispatch group of each
    token (each of ``group_size`` tokens).  Returns (y (N, D), aux, zloss),
    the two router losses only where gradients are taken (else zeros)."""
    n = x2.shape[0]
    e, k = c["num_experts"], c["experts_per_token"]
    logits = mm(x2, p["router"], precision)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt[:, :k], order[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    eid = top_i.reshape(-1)
    gate = top_p.reshape(-1)
    key = groups.repeat_interleave(k) * e + eid
    perm = torch.sort(key, stable=True).indices
    sk = key[perm]
    idx = torch.arange(sk.numel(), device=x2.device)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - start
    keep = rank < counts.capacity(c, group_size)

    tok = torch.arange(n, device=x2.device).repeat_interleave(k)
    y = torch.zeros_like(x2)
    for j in range(e):
        sel = torch.nonzero((eid == j) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = tok[sel]
        xe = x2[rows]
        h = F.silu(mm(xe, p["wg"][j], precision)) * mm(xe, p["w1"][j], precision)
        out = mm(h, p["w2"][j], precision) * gate[sel, None]
        if torch.is_grad_enabled():
            y = y.index_add(0, rows, out)
        else:
            y.index_add_(0, rows, out)

    if not torch.is_grad_enabled():
        zero = torch.zeros((), device=x2.device)
        return y, zero, zero
    me = F.one_hot(top_i, e).sum(1).float().mean(0)
    aux = e * torch.sum(me / k * probs.mean(0))
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, aux, zloss


def layer(c: Dict, p: Dict, x: torch.Tensor, positions: torch.Tensor,
          groups: torch.Tensor, group_size: int, precision: Optional[str],
          seq_block: int):
    """One decoder layer on x (B, S, D); attention runs over ``seq_block``
    rows of the batch at a time.  Returns (x, aux, zloss)."""
    b, s, d = x.shape
    hn = rms_norm(x, p["ln1"]["w"], c["norm_eps"])
    x = x + gqa_attention(c, p["attn"], hn, positions, precision, seq_block)
    hn = rms_norm(x, p["ln2"]["w"], c["norm_eps"])
    y, aux, z = moe(c, p["moe"], hn.reshape(b * s, d), groups, group_size,
                    precision)
    return x + y.reshape(b, s, d), aux, z


# ---------------------------------------------------------------------------
# Serving: the lockstep engine's token streams
# ---------------------------------------------------------------------------

@torch.no_grad()
def stream_logits(c: Dict, w: Dict, streams: torch.Tensor,
                  rows: Sequence[Tuple[int, int]],
                  precision: Optional[str] = None, seq_block: int = 8
                  ) -> torch.Tensor:
    """streams (slots, T): the token each slot was fed at each position of
    one engine session.  Every slot is one causal sequence over positions
    0..T-1, and the tokens of one position are one MoE dispatch group,
    slot 0 first.  Returns the float32 logits at each (slot, position) of
    ``rows``, (len(rows), V)."""
    no_tf32()
    slots, t = streams.shape
    dev = streams.device
    positions = torch.arange(t, device=dev)
    groups = positions.repeat(slots)           # row-major (slot, position)
    x = F.embedding(streams, w["embed"]).float()
    for i in range(c["num_layers"]):
        x, _, _ = layer(c, layer_weights(w, i), x, positions, groups, slots,
                        precision, seq_block)
    x = rms_norm(x, w["final_norm"]["w"].float(), c["norm_eps"])
    si = torch.tensor([r[0] for r in rows], device=dev)
    ti = torch.tensor([r[1] for r in rows], device=dev)
    return mm(x[si, ti], head_weight(c, w), precision)


# ---------------------------------------------------------------------------
# Training: the loss (``common.train`` takes its gradients)
# ---------------------------------------------------------------------------

def loss(c: Dict, w: Dict, tokens: torch.Tensor,
         precision: Optional[str] = None, ce_rows: int = 2048
         ) -> torch.Tensor:
    """Next-token cross entropy over every position but each row's last,
    plus 0.01 x the load-balance loss and 1e-3 x the router z-loss, each
    averaged over the layers; one MoE dispatch group for the whole batch.
    Each layer and each block of rows of the head is recomputed in the
    backward pass."""
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)
    groups = torch.zeros(b * s, dtype=torch.long, device=dev)
    x = F.embedding(tokens, w["embed"])
    aux = torch.zeros((), device=dev)
    z = torch.zeros((), device=dev)
    for i in range(c["num_layers"]):
        def body(x, i=i):
            return layer(c, layer_weights(w, i), x, positions, groups, b * s,
                         precision, 1)
        x, a, zz = checkpoint(body, x, use_reentrant=False)
        aux, z = aux + a, z + zz
    n = c["num_layers"]
    return head_loss(c, w, x, tokens, precision, ce_rows) \
        + 0.01 * aux / n + 1e-3 * z / n
