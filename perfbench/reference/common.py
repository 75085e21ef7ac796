"""What every plain reference shares, whatever its layers: products in float32
with TF32 off and their float8 control, RMSNorm, rotary embedding, causal
attention over grouped keys and values and the grouped-query attention
sub-block around it, the LM head's next-token loss, and AdamW's training
loop with the norms that the check compares.

A configuration file's ``reference`` key names the module beside this one
that holds its layers (``cells.reference``).  That module owns:

- ``shapes(c)``: its weight tree, {name: (shape, kind)} nested as the port
  nests it, a stacked layer axis in front of every block weight.  Kinds:
  ``normal``, a product, drawn normal at 1/sqrt(fan_in) (fan_in the
  second-last axis); ``expert``, drawn exactly alike, a product with an
  expert axis, of which a token multiplies ``experts_per_token`` of the
  experts the router chooses among (``counts.active_params``); ``embed``,
  normal at the file's ``embed_std``; ``ones``, a norm weight;
- ``loss(c, w, tokens, precision)``: the training loss that ``train``
  takes gradients of;
- for serving, ``stream_logits(c, w, streams, rows, precision)``
  (``serve_driver.reference_errors``).

Written from the configuration file alone, in plain PyTorch: nothing here
or beside it imports the program.

``precision="fp8"`` computes every product on float8 (e4m3) operands, each
row of an activation and each column of a weight scaled to the format's
range: the control that the check has to refuse.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def gqa_attention(c: Dict, a: Dict, hn: torch.Tensor, positions: torch.Tensor,
                  precision: Optional[str], seq_block: int) -> torch.Tensor:
    """The attention sub-block on the normed x (B, S, D), without its
    residual: the q, k, v projections ``a["wq"]``, ``a["wk"]``, ``a["wv"]``
    (``num_heads`` queries, ``num_kv_heads`` keys and values, each
    ``head_dim`` wide), rotary embedding at ``positions``, causal attention
    at scale 1/sqrt(head_dim) and the output projection ``a["wo"]``, over
    ``seq_block`` rows of the batch at a time."""
    b, s, _ = hn.shape
    h, hkv, dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
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
    return torch.cat(outs, dim=0)


def layer_weights(w: Dict, i: int, dtype=torch.float32) -> Dict:
    """Layer ``i`` of the stacked block weights ``blocks/lyr``, in float32."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t[i].to(dtype)
    return walk(w["blocks"]["lyr"])


def head_weight(c: Dict, w: Dict) -> torch.Tensor:
    return (w["embed"].T if c["tie_embeddings"] else w["lm_head"]).float()


def head_loss(c: Dict, w: Dict, x: torch.Tensor, tokens: torch.Tensor,
              precision: Optional[str], ce_rows: int = 2048) -> torch.Tensor:
    """From the last layer's output x (B, S, D): the final RMSNorm, the LM
    head (the embedding transposed when tied) and the next-token cross
    entropy over every position but each row's last, averaged.  Each block
    of ``ce_rows`` rows of the head is recomputed in the backward pass."""
    x = rms_norm(x, w["final_norm"]["w"], c["norm_eps"])
    head = w["embed"].T if c["tie_embeddings"] else w["lm_head"]
    xs = x[:, :-1].reshape(-1, c["d_model"])
    tgt = tokens[:, 1:].reshape(-1)

    def ce(xc, tc):
        return F.cross_entropy(mm(xc, head, precision), tc, reduction="sum")

    nll = torch.zeros((), device=tokens.device)
    for lo in range(0, xs.shape[0], ce_rows):
        nll = nll + checkpoint(ce, xs[lo:lo + ce_rows], tgt[lo:lo + ce_rows],
                               use_reentrant=False)
    return nll / xs.shape[0]


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


def train(loss: Callable, c: Dict, w: Dict, batches: Sequence[torch.Tensor],
          o: Dict, precision: Optional[str] = None,
          storage: torch.dtype = torch.bfloat16) -> Dict:
    """AdamW with global-norm clipping over ``batches``, one step each, on
    ``loss(c, w, tokens, precision)`` from the weights ``w`` (float32
    leaves, updated in place).  The parameters are stored in ``storage``:
    each update is made in float32 and the new value rounded to it.
    Returns the losses, the norm of each leaf's clipped gradient of the
    first step and of each leaf's change over all the steps
    (``leaf_norms``)."""
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
