"""Plain reference of the MoE decoder LM that the port serves and trains.

Written from the configuration file alone, in plain PyTorch and float32
with TF32 off: no kernel, no cache, no batching engine, nothing of the
program.  It reads the weight tree the harness made (the layout of
``perfbench/weights.py``) and works out again everything the program
derives from it.

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

``precision="fp8"`` computes every product on float8 (e4m3) operands, each
row of an activation and each column of a weight scaled to the format's
range: the control that the check has to refuse.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import counts

_FP8_MAX = 448.0


def no_tf32():
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim`` to its range; the
    rounding passes the gradient straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / _FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def mm(a: torch.Tensor, w: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(a, -1) @ _fp8(w, -2)
    return a @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, dh) at ``positions`` (S,)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = positions.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, precision: Optional[str], q_block: int = 1024):
    """q (B, H, S, dh), k/v (B, Hkv, S, dh) -> (B, H, S, dh); query head h
    reads key head h // (H / Hkv)."""
    b, h, s, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    outs = []
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        sc = mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2), precision) \
            / math.sqrt(dh)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(mm(torch.softmax(sc, dim=-1), v[:, :, :hi], precision))
    return torch.cat(outs, dim=2)


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


def layer_weights(w: Dict, i: int, dtype=torch.float32) -> Dict:
    """Layer ``i`` of the stacked block weights, in float32."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t[i].to(dtype)
    return walk(w["blocks"]["lyr"])


def layer(c: Dict, p: Dict, x: torch.Tensor, positions: torch.Tensor,
          groups: torch.Tensor, group_size: int, precision: Optional[str],
          seq_block: int):
    """One decoder layer on x (B, S, D); attention runs over ``seq_block``
    rows of the batch at a time.  Returns (x, aux, zloss)."""
    b, s, d = x.shape
    h, hkv, dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    a = p["attn"]
    hn = rms_norm(x, p["ln1"]["w"], c["norm_eps"])
    outs = []
    for lo in range(0, b, seq_block):
        xb = hn[lo:lo + seq_block]
        nb = xb.shape[0]
        q = mm(xb, a["wq"], precision).reshape(nb, s, h, dh).transpose(1, 2)
        kk = mm(xb, a["wk"], precision).reshape(nb, s, hkv, dh).transpose(1, 2)
        vv = mm(xb, a["wv"], precision).reshape(nb, s, hkv, dh).transpose(1, 2)
        q = rope(q, positions, c["rope_theta"])
        kk = rope(kk, positions, c["rope_theta"])
        o = causal_attention(q, kk, vv, precision)
        outs.append(mm(o.transpose(1, 2).reshape(nb, s, h * dh), a["wo"],
                       precision))
    x = x + torch.cat(outs, dim=0)
    hn = rms_norm(x, p["ln2"]["w"], c["norm_eps"])
    y, aux, z = moe(c, p["moe"], hn.reshape(b * s, d), groups, group_size,
                    precision)
    return x + y.reshape(b, s, d), aux, z


def head_weight(c: Dict, w: Dict) -> torch.Tensor:
    return (w["embed"].T if c["tie_embeddings"] else w["lm_head"]).float()


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
# Training: loss, gradients and AdamW
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
    x = rms_norm(x, w["final_norm"]["w"], c["norm_eps"])
    head = w["embed"].T if c["tie_embeddings"] else w["lm_head"]
    xs = x[:, :-1].reshape(-1, c["d_model"])
    tgt = tokens[:, 1:].reshape(-1)

    def ce(xc, tc):
        return F.cross_entropy(mm(xc, head, precision), tc, reduction="sum")

    nll = torch.zeros((), device=dev)
    for lo in range(0, xs.shape[0], ce_rows):
        nll = nll + checkpoint(ce, xs[lo:lo + ce_rows], tgt[lo:lo + ce_rows],
                               use_reentrant=False)
    n = c["num_layers"]
    return nll / xs.shape[0] + 0.01 * aux / n + 1e-3 * z / n


def lr_at(o: Dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` (step >= 1)."""
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    frac = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return o["lr"] * warm * frac


def leaf_norms(named) -> Dict[str, float]:
    """The norm of each leaf of (path, tensor) pairs; a leaf stacked over
    the layers (under ``blocks/``) counts as one leaf a layer, ``path#i``."""
    out: Dict[str, float] = {}
    for path, t in named:
        if path.startswith("blocks/"):
            for i in range(t.shape[0]):
                out[f"{path}#{i}"] = float(torch.linalg.vector_norm(t[i].float()))
        else:
            out[path] = float(torch.linalg.vector_norm(t.float()))
    return out


def train(c: Dict, w: Dict, batches: Sequence[torch.Tensor], o: Dict,
          precision: Optional[str] = None, storage: torch.dtype = torch.bfloat16
          ) -> Dict:
    """AdamW with global-norm clipping over ``batches``, one step each, from
    the weights ``w`` (float32 leaves, updated in place).  The parameters
    are stored in ``storage``: each update is made in float32 and the new
    value rounded to it.  Returns the losses, the norm of each leaf's
    clipped gradient of the first step and of each leaf's change over all
    the steps (``leaf_norms``)."""
    no_tf32()
    from perfbench.weights import leaf_paths
    named = list(leaf_paths(w))
    params = [t for _, t in named]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = o["beta1"], o["beta2"]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, tokens in enumerate(batches, start=1):
        for p in params:
            p.requires_grad_(True)
        lv = loss(c, w, tokens, precision)
        grads = torch.autograd.grad(lv, params)
        for p in params:
            p.requires_grad_(False)
        losses.append(float(lv.detach()))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(o["clip_norm"] / gnorm.clamp_min(1e-9), max=1.0)
        lr = lr_at(o, step)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            if step == 1:
                grad_norms = leaf_norms((path, g * scale) for (path, _), g
                                        in zip(named, grads))
            for j, (p, g) in enumerate(zip(params, grads)):
                g = g * scale
                m[j].mul_(b1).add_((1 - b1) * g)
                v[j].mul_(b2).add_((1 - b2) * g * g)
                delta = (m[j] / bc1) / (torch.sqrt(v[j] / bc2) + o["eps"]) \
                    + o["weight_decay"] * p
                p.copy_((p - lr * delta).to(storage).float())
        del grads
    with torch.no_grad():
        change = leaf_norms((path, params[j] - start[j])
                            for j, (path, _) in enumerate(named))
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
