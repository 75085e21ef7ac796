"""Plain reference of the DeepSeek-V2 decoder LM that the port trains: latent
attention, a leading dense layer, then MoE layers with shared experts and
a router over more experts than are held here.

Written from the configuration file alone, in plain PyTorch and float32
with TF32 off: no kernel, no cache, nothing of the program.  It owns the
weight tree the harness makes (``shapes``, drawn by
``perfbench/weights.py``); what no layer of its own decides is in
``common.py``.

The model, as the configuration runs it (the file's ``departures`` say
where that differs from the published model; arXiv:2405.04434):

- token embedding; ``first_k_dense`` dense layers, then MoE layers; each
  layer pre-norm RMSNorm, latent attention, residual, pre-norm RMSNorm,
  the MLP or the MoE, residual;
- latent attention (MLA, no query compression): q = x Wq,
  ``qk_nope_head_dim`` + ``qk_rope_head_dim`` wide a head; the latent
  [c_kv, k_pe] = x Wkv_a, ``kv_lora_rank`` + ``qk_rope_head_dim`` wide;
  c_kv RMS-normed, then c_kv Wkv_b gives each head's k_nope and v
  (``v_head_dim``); k_pe is one key that every head shares.  Rotary
  embedding (rotate-half form) on the pe dimensions alone, with YaRN's
  frequencies (the file's ``yarn_*``: ``rope_scaling``); causal attention of
  q = [q_nope, q_pe] on k = [k_nope, k_pe] at the scale
  (qk width)^-1/2 x (0.1 mscale_all_dim ln(factor) + 1)^2; the heads' values
  then Wo;
- a dense layer's MLP: silu(x Wg) * (x Wi), then Wo, ``dense_d_ff`` wide;
- the MoE: a float32 router softmax over ``router_experts`` experts, the
  top ``experts_per_token`` by probability with ties to the lower expert,
  renormalised only where ``norm_topk_prob`` is true; the experts held
  here, ``num_experts`` of them from ``expert_offset`` on, each a gated
  SiLU FFN of width ``d_ff``, weighted by its probability; an assignment
  to an expert held elsewhere is left out.  Shared experts, one gated MLP
  ``n_shared_experts`` x ``d_ff`` wide, on every token, added unweighted;
- expert capacity: over the whole batch, an expert takes at most
  ``capacity(tokens)`` assignments in token order, then expert-rank order:
  the capacity factor over an even share among the ``router_experts``,
  rounded up to ``capacity_multiple``; later ones are dropped;
- final RMSNorm and the LM head; the loss adds 0.01 x the load-balance loss
  and 1e-3 x the router z-loss, each averaged over the MoE layers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import causal_attention, head_loss, mm, rms_norm


def shapes(c: Dict) -> Dict[str, Any]:
    """{name: (shape, kind)}, nested as the port nests it: ``lead/`` stacked
    over the dense lead layers, ``blocks/lyr/`` over the MoE layers."""
    d, v, h = c["d_model"], c["vocab_size"], c["num_heads"]
    r, dn = c["kv_lora_rank"], c["qk_nope_head_dim"]
    dr, dv = c["qk_rope_head_dim"], c["v_head_dim"]
    nl = c["first_k_dense"]
    n = c["num_layers"] - nl
    e, f = c["num_experts"], c["d_ff"]
    fs = c["n_shared_experts"] * f

    def attn(m):
        return {"wq": ((m, d, h * (dn + dr)), "normal"),
                "wkv_a": ((m, d, r + dr), "normal"),
                "kv_norm": {"w": ((m, r), "ones")},
                "wkv_b": ((m, r, h * (dn + dv)), "normal"),
                "wo": ((m, h * dv, d), "normal")}

    def mlp(m, width):
        return {"wi": ((m, d, width), "normal"), "wg": ((m, d, width), "normal"),
                "wo": ((m, width, d), "normal")}

    def norms(m):
        return {"ln1": {"w": ((m, d), "ones")}, "ln2": {"w": ((m, d), "ones")}}

    lead = {"attn": attn(nl), "mlp": mlp(nl, c["dense_d_ff"]), **norms(nl)}
    lyr = {"attn": attn(n), **norms(n),
           "moe": {"router": ((n, d, c["router_experts"]), "normal"),
                   "w1": ((n, e, d, f), "expert"),
                   "wg": ((n, e, d, f), "expert"),
                   "w2": ((n, e, f, d), "expert"),
                   "shared": mlp(n, fs)}}
    return {"embed": ((v, d), "embed"), "lead": lead, "blocks": {"lyr": lyr},
            "final_norm": {"w": ((d,), "ones")}, "lm_head": ((d, v), "normal")}


def _layer(w: Dict, i: int) -> Dict:
    """Layer ``i`` of a tree stacked over layers, in float32."""
    if isinstance(w, dict):
        return {k: _layer(t, i) for k, t in w.items()}
    return w[i].float()


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_rope(c: Dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x (..., S, qk_rope_head_dim) rotated at ``positions`` (S,) by YaRN's
    frequencies: the base ones where a dimension turns more than
    ``yarn_beta_fast`` times over the original context, the base over
    ``yarn_factor`` where it turns fewer than ``yarn_beta_slow`` times, a
    linear ramp over the dimensions between."""
    dim, base = c["qk_rope_head_dim"], c["rope_theta"]
    orig, factor = c["yarn_original_max_position"], c["yarn_factor"]

    def dim_of(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(c["yarn_beta_fast"])), 0)
    high = min(math.ceil(dim_of(c["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=x.device)
    base_f = 1.0 / base ** (2 * i / dim)
    ramp = ((i - low) / (high - low)).clamp(0, 1)     # 1: interpolated
    inv = base_f / factor * ramp + base_f * (1 - ramp)
    ang = positions.float()[:, None] * inv[None]
    m = _mscale(factor, c["yarn_mscale"]) / _mscale(factor, c["yarn_mscale_all_dim"])
    cos, sin = torch.cos(ang) * m, torch.sin(ang) * m
    x1, x2 = x[..., : dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla_attention(c: Dict, a: Dict, hn: torch.Tensor, positions: torch.Tensor,
                  precision: Optional[str]) -> torch.Tensor:
    """Latent attention on the normed x (B, S, D), without its residual, one
    row of the batch at a time."""
    h, r = c["num_heads"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    scale = (dn + dr) ** -0.5 * _mscale(c["yarn_factor"], c["yarn_mscale_all_dim"]) ** 2
    outs = []
    for xb in hn.split(1, dim=0):
        s = xb.shape[1]
        q = mm(xb, a["wq"], precision).reshape(1, s, h, dn + dr).transpose(1, 2)
        lat = mm(xb, a["wkv_a"], precision)
        c_kv = rms_norm(lat[..., :r], a["kv_norm"]["w"], c["norm_eps"])
        kv = mm(c_kv, a["wkv_b"], precision).reshape(1, s, h, dn + dv).transpose(1, 2)
        k_pe = yarn_rope(c, lat[:, None, :, r:], positions).expand(1, h, s, dr)
        q = torch.cat([q[..., :dn], yarn_rope(c, q[..., dn:], positions)], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe], dim=-1)
        # common's causal attention divides by sqrt(qk width): q carries the
        # rest of the model's scale
        o = causal_attention(q * (scale * math.sqrt(dn + dr)), k, kv[..., dn:],
                             precision)
        outs.append(mm(o.transpose(1, 2).reshape(1, s, h * dv), a["wo"], precision))
    return torch.cat(outs, dim=0)


def mlp(p: Dict, x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wg"], precision)) * mm(x, p["wi"], precision),
              p["wo"], precision)


def capacity(c: Dict, tokens: int) -> int:
    """Slots of each expert for ``tokens`` tokens: the capacity factor over an
    even share among the ``router_experts``, rounded up to
    ``capacity_multiple`` and at least that."""
    mult = c["capacity_multiple"]
    share = math.ceil(tokens * c["experts_per_token"] * c["moe_capacity_factor"]
                      / c["router_experts"])
    return max(mult, -(-share // mult) * mult)


def moe(c: Dict, p: Dict, x2: torch.Tensor, precision: Optional[str]):
    """x2 (N, D) in token order, one dispatch group.  Returns (y (N, D), aux,
    zloss): the held experts' part, the shared experts added."""
    n = x2.shape[0]
    big, k = c["router_experts"], c["experts_per_token"]
    lo = c.get("expert_offset", 0)
    logits = mm(x2, p["router"], precision)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt[:, :k], order[:, :k]
    if c["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    eid = top_i.reshape(-1)
    gate = top_p.reshape(-1)
    # each assignment's rank among its expert's, in token then rank order
    perm = torch.sort(eid, stable=True).indices
    se = eid[perm]
    idx = torch.arange(se.numel(), device=x2.device)
    first = torch.ones_like(se, dtype=torch.bool)
    first[1:] = se[1:] != se[:-1]
    start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - start
    keep = rank < capacity(c, n)

    tok = torch.arange(n, device=x2.device).repeat_interleave(k)
    y = mlp(p["shared"], x2, precision)
    for j in range(c["num_experts"]):
        sel = torch.nonzero((eid == lo + j) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        rows = tok[sel]
        xe = x2[rows]
        h = F.silu(mm(xe, p["wg"][j], precision)) * mm(xe, p["w1"][j], precision)
        y = y.index_add(0, rows, mm(h, p["w2"][j], precision) * gate[sel, None])

    me = F.one_hot(top_i, big).sum(1).float().mean(0)
    aux = big * torch.sum(me / k * probs.mean(0))
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, aux, zloss


def lead_layer(c, p, x, positions, precision):
    hn = rms_norm(x, p["ln1"]["w"], c["norm_eps"])
    x = x + mla_attention(c, p["attn"], hn, positions, precision)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"]["w"], c["norm_eps"]), precision)


def moe_layer(c, p, x, positions, precision):
    b, s, d = x.shape
    hn = rms_norm(x, p["ln1"]["w"], c["norm_eps"])
    x = x + mla_attention(c, p["attn"], hn, positions, precision)
    hn = rms_norm(x, p["ln2"]["w"], c["norm_eps"])
    y, aux, z = moe(c, p["moe"], hn.reshape(b * s, d), precision)
    return x + y.reshape(b, s, d), aux, z


def loss(c: Dict, w: Dict, tokens: torch.Tensor,
         precision: Optional[str] = None, ce_rows: int = 2048) -> torch.Tensor:
    """Next-token cross entropy over every position but each row's last,
    plus 0.01 x the load-balance loss and 1e-3 x the router z-loss, each
    averaged over the MoE layers; one MoE dispatch group for the whole
    batch.  Each layer and each block of rows of the head is recomputed in
    the backward pass."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = F.embedding(tokens, w["embed"])
    for i in range(c["first_k_dense"]):
        x = checkpoint(lambda x, i=i: lead_layer(c, _layer(w["lead"], i), x,
                                                 positions, precision),
                       x, use_reentrant=False)
    n = c["num_layers"] - c["first_k_dense"]
    aux = torch.zeros((), device=tokens.device)
    z = torch.zeros((), device=tokens.device)
    for i in range(n):
        x, a, zz = checkpoint(
            lambda x, i=i: moe_layer(c, _layer(w["blocks"]["lyr"], i), x,
                                     positions, precision),
            x, use_reentrant=False)
        aux, z = aux + a, z + zz
    return head_loss(c, w, x, tokens, precision, ce_rows) \
        + 0.01 * aux / n + 1e-3 * z / n
