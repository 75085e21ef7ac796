"""Shared layers: norms, RoPE, activations, embedding and the LM head.

The port of ``repro.models.common``.  Each function keeps the reference's
dtype at every step: norm statistics in float32 with the data path in the
model dtype, rotations in the model dtype, logits cast to float32 after the
head.  ``constrain`` is the reference's logical-axis sharding constraint:
the identity without rules or on a plain tensor; on a DTensor under the
rules that ``set_sharding_rules`` installs (the dry run's fake mesh), a
``redistribute`` to the placements the logical axes name.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..obs.ranges import bwd_span, span
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Logical-axis sharding constraints.  The launcher installs rules; model code
# annotates activations with logical axes and stays mesh-agnostic.
# ---------------------------------------------------------------------------

_RULES: dict = {}
_MESH = None


def set_sharding_rules(mesh, rules: dict) -> None:
    global _RULES, _MESH
    _RULES, _MESH = dict(rules), mesh


def clear_sharding_rules() -> None:
    global _RULES, _MESH
    _RULES, _MESH = {}, None


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical axes name (the
    identity without rules or on a plain tensor).  Axes whose mesh-shard
    count does not divide the dimension are dropped (e.g. vocab 51866 over
    16-way TP), as the reference keeps its constraints even."""
    if _MESH is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from ..sharding.rules import (PartitionSpec, axis_sizes, shard_count,
                                  to_placements)
    sizes = axis_sizes(_MESH)
    entries = []
    for dim, a in zip(x.shape, logical_axes):
        ax = _RULES.get(a) if a else None
        entries.append(ax if (ax and dim % shard_count(ax, sizes) == 0)
                       else None)
    return x.redistribute(_MESH, to_placements(PartitionSpec(*entries),
                                               _MESH))


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


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(cfg: ModelConfig, positions: torch.Tensor) -> Tuple:
    """YaRN's rotary tables for the ``qk_rope_head_dim`` rotated dimensions
    of a latent-attention config: positions (..., S) -> (cos, sin) of shape
    (..., S, qk_rope_head_dim // 2), in float32.

    The frequencies of the published YaRN (DeepSeek-V2's
    ``rope_scaling``): each is the base one where it turns more than
    ``yarn_beta_fast`` times over ``yarn_original_max_position`` positions,
    the base one over ``yarn_factor`` where it turns fewer than
    ``yarn_beta_slow`` times, and a linear ramp between, over the
    dimensions; the tables are scaled by the ratio of the two mscales
    (1 where they are equal, as published)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    orig, factor = cfg.yarn_original_max_position, cfg.yarn_factor

    def at(turns: float) -> float:         # the dimension of ``turns`` turns
        return dim * math.log(orig / (turns * 2 * math.pi)) \
            / (2 * math.log(base))

    low = max(math.floor(at(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(at(cfg.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    dev = positions.device
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=dev) - low) / (high - low), 0, 1)
    inv = inter * ramp + extra * (1.0 - ramp)
    ang = positions.float()[..., None] * inv
    m = _yarn_mscale(factor, cfg.yarn_mscale) \
        / _yarn_mscale(factor, cfg.yarn_mscale_all_dim)
    return torch.cos(ang) * m, torch.sin(ang) * m


def yarn_scale(cfg: ModelConfig) -> float:
    """Latent attention's score scale: 1/sqrt(q's width) times YaRN's
    ``mscale_all_dim`` factor squared."""
    m = _yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


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


def sinusoid_pos(seq: int, dim: int, offset: int = 0,
                 device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, D), float32: sin in the
    even columns, cos in the odd ones."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device) / dim)
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def on_mesh(x) -> bool:
    """Rules are installed and ``x`` is a DTensor."""
    if _MESH is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def keep_shards(x, dims) -> list:
    """``x``'s placements with every mesh axis that shards a dimension
    outside ``dims`` replicated: the placements under which an op that is
    independent over ``dims`` (batch, heads) runs on local slices."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(p.dim) if p.is_shard() and p.dim in dims else Replicate()
            for p in x.placements]


def per_device(fn, *args, like, dims=(0, 1), remap=None, n_out: int = 1):
    """``fn(*args)``; under rules with ``like`` a DTensor, ``fn`` on each
    device's local tensors (``local_map``), for an ``fn`` independent over
    ``dims`` (batch, heads): the mesh axes that shard those dimensions of
    ``like`` shard the same dimensions of every DTensor argument and of the
    ``n_out`` outputs, and every other axis is gathered first.
    ``remap[i]`` maps ``like``'s dimensions to argument ``i``'s where they
    differ (e.g. ``{1: 0}`` for a per-head parameter).  DTensor cannot
    propagate some of these ops on sharded operands, and one local call
    dispatches far fewer ops (``ROADMAP.md`` C.20)."""
    if not on_mesh(like):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = keep_shards(like, dims)

    def arg_pl(i, a):
        if not isinstance(a, DTensor):
            return None
        m = (remap or {}).get(i)
        if m is None:
            return pl
        return [Shard(m[p.dim]) if p.is_shard() and p.dim in m
                else Replicate() for p in pl]

    return local_map(
        fn, out_placements=pl if n_out == 1 else (pl,) * n_out,
        in_placements=tuple(arg_pl(i, a) for i, a in enumerate(args)),
        device_mesh=like.device_mesh, redistribute_inputs=True)(*args)


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """Under rules, a DTensor redistributed so that no mesh axis shards
    ``dims`` (the others keep their placements); else ``x``.  For views
    DTensor cannot take on a sharded dimension (``ROADMAP.md`` C.20)."""
    if not on_mesh(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.ndim for d in dims}
    placements = [Replicate() if p.is_shard() and p.dim in dims else p
                  for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def _embed_replicated(tokens, table):
    """``F.embedding`` on each device's tokens over the whole table: the
    table gathered to every device, the rows placed as the tokens are.  A
    device's gradient of the table covers its own tokens only: a partial
    sum over the axes that shard the tokens (``ROADMAP.md`` C.26)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rep = [Replicate()] * table.device_mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate()
            for p in tokens.placements]
    return local_map(F.embedding, out_placements=list(tokens.placements),
                     in_placements=(list(tokens.placements), rep),
                     in_grad_placements=(list(tokens.placements), grad),
                     device_mesh=table.device_mesh,
                     redistribute_inputs=True)(tokens, table)


def embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens`` (B, S) -> (B, S, D).  ``F.embedding`` gives
    the rows that indexing gives; its backward sums repeated tokens in a
    fixed order on the CPU and the card, where indexing's backward adds
    them with atomics on the CPU (a restarted training run then
    replays other bits).  Under rules, a table that takes gradients is
    gathered whole first: DTensor's masked lookup on a vocab-sharded table
    has no backward (``ROADMAP.md`` C.20).  In the ranges ``embed`` and
    ``embed.bwd``, whose input is the table."""
    with span("embed"):
        table, mark = bwd_span("embed", params["embed"])
        if _MESH is not None and table.requires_grad:
            x = _embed_replicated(tokens, table)
        else:
            x = F.embedding(tokens, table)
        if cfg.name.startswith("gemma"):
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return mark(constrain(x, "batch", "seq", "embed"))


class _GradLikeInput(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to the
    input's placements.  A tied table takes gradients from the lookup and
    from the head: placed alike they add locally, where DTensor may
    otherwise turn the lookup's shards into a partial sum, which some torch
    versions cannot do (``ROADMAP.md`` C.27)."""

    @staticmethod
    def forward(ctx, t):
        ctx.spec = (t.device_mesh, t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(*ctx.spec)


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The head in the model dtype, then the logits in f32."""
    if cfg.tie_embeddings:
        table = params["embed"]
        if _MESH is not None and table.requires_grad:
            table = _GradLikeInput.apply(table)
        logits = x @ table.T
    else:
        logits = x @ params["lm_head"]
    logits = softcap(logits.float(), cfg.logit_softcap)
    return constrain(logits, "batch", "seq", "vocab")
