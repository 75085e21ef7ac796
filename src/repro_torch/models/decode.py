"""Decode path, every family: cache construction + single-token serve step.

The port of ``repro.models.decode``.  The cache keeps the reference's
layout, stacked over groups: dense and moe ``{'lyr': {'k','v'}}`` of
(G, B, Hkv, L, dh) (gemma2: ``{'local','global'}``, the local one a ring of
``sliding_window`` slots), plus (G, B, Hkv, L, 1) float32 scales for an
int8 cache; ssm (RWKV6) ``{'lyr': {'wkv', 'shift_tm', 'shift_cm'}}`` of
(G, B, H, dh, dh) and (G, B, 1, D), no length axis; hybrid (zamba2)
``{'mamba': {'h', 'conv'}, 'attn': {'k','v'}}``, the Mamba states of
(G, n_mamba, B, nh, state, hd) and (G, n_mamba, B, K-1, CH) behind two
stacked axes, and the shared block's KV cache, one per group; vlm
``{'self': {'k','v'}, 'cross': {'k','v'}}``, the four self layers' caches
stacked behind the group axis (G, 4, B, Hkv, L, dh) and the cross K/V over
the patches (G, B, Hkv, P, dh); audio ``{'lyr': {'self', 'cross'}}``, the
decoder's self cache and the cross K/V over the encoder's frames
(G, B, Hkv, enc_seq, dh).  ``init_cache`` fills the cross K/V from a
``modality`` (for audio, after running the encoder) in the model dtype,
never int8; without one they stay zero, as the engine's are.  Where the
reference returns new caches, the port writes the cache in place and
returns it: :func:`serve_step`, the slot surgery and the per-group list
form of :class:`ProfiledServeStep` (views of one stacked cache) all mutate
the tensors they are given.  The recurrent states change dtype: RWKV6's
wkv state and Mamba's ``h`` are created in the model dtype and the
reference's step returns them in float32, so from the first step on the
port holds them in float32 too, a new leaf bound in place of the old one
(``ROADMAP.md`` C.13, C.14).  The moe step skips the router's auxiliary
losses, which the reference's jitted step computes and discards.  The
layer profiler's sliced step covers the dense, moe, ssm and hybrid
families, and refuses audio and vlm as the reference does.
:func:`cache_specs` gives each cache leaf's (shape, dtype) pair, a
:class:`LeafSpec`, for the dry run.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import full_f32
from . import attention as A
from . import mamba as M
from . import moe as MOE
from . import rwkv as R
from .common import embed, lm_logits, norm, per_device, sinusoid_pos, unshard
from .config import ModelConfig
from .mlp import mlp_block
from .transformer import encode_audio, group_params


def _kv_shape(cfg: ModelConfig, batch: int, max_len: int):
    return (batch, cfg.num_kv_heads, max_len, cfg.head_dim)


def _kv_entry(cfg: ModelConfig, batch: int, max_len: int):
    """Self-attention cache entry; int8 mode adds per-token scales."""
    kv = _kv_shape(cfg, batch, max_len)
    entry = {"k": kv, "v": kv}
    if cfg.kv_cache_dtype == "int8":
        entry["k_scale"] = (batch, cfg.num_kv_heads, max_len, 1)
        entry["v_scale"] = (batch, cfg.num_kv_heads, max_len, 1)
    return entry


def _map_shapes(fn, *trees):
    """Map ``fn`` over the shape tuples of same-structured shape trees."""
    if isinstance(trees[0], tuple):
        return fn(*trees)
    return {k: _map_shapes(fn, *(t[k] for t in trees)) for k in trees[0]}


def _stack_shapes(n: int, tree):
    return _map_shapes(lambda s: (n,) + s, tree)


# ---------------------------------------------------------------------------
# Cache shapes and init
# ---------------------------------------------------------------------------


class LatentCacheMissing(NotImplementedError):
    """Decoding a latent-attention config (``MLAConfig``): the port has no
    latent cache yet, only the training and prefill path."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__(
            f"{cfg.name}: latent attention decodes through a latent cache "
            "(c_kv and the shared rotary key), which the port does not "
            "have yet; train or prefill it instead")


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    if cfg.kv_lora_rank:
        raise LatentCacheMissing(cfg)
    if cfg.family == "vlm":
        n_self = cfg.cross_attn_every - 1
        cross_kv = (batch, cfg.num_kv_heads, cfg.num_patches, cfg.head_dim)
        per = {"self": _stack_shapes(n_self, _kv_entry(cfg, batch, max_len)),
               "cross": {"k": cross_kv, "v": cross_kv}}
    elif cfg.family == "audio":
        enc_kv = (batch, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)
        per = {"lyr": {"self": _kv_entry(cfg, batch, max_len),
                       "cross": {"k": enc_kv, "v": enc_kv}}}
    elif cfg.family == "ssm":
        per = {"lyr": R.rwkv_cache_shape(cfg, batch)}
    elif cfg.family == "hybrid":
        n_mamba = cfg.hybrid_attn_every - 1
        per = {"mamba": _stack_shapes(n_mamba, M.mamba_cache_shape(cfg, batch)),
               "attn": _kv_entry(cfg, batch, max_len)}
    elif cfg.local_global:
        local_len = min(max_len, cfg.sliding_window)
        per = {"local": _kv_entry(cfg, batch, local_len),
               "global": _kv_entry(cfg, batch, max_len)}
    else:
        per = {"lyr": _kv_entry(cfg, batch, max_len)}
    return _stack_shapes(cfg.num_groups, per)


def _cache_leaf_dtype(cfg: ModelConfig, path_key: str, shape, parent):
    """int8 only for self-attn k/v whose sibling scale entry exists; their
    scales in float32; everything else in the model dtype (the cross K/V
    too: ``_cross_decode`` reads them raw, C.18)."""
    if cfg.kv_cache_dtype == "int8":
        if path_key in ("k", "v") and f"{path_key}_scale" in parent:
            return torch.int8
        if path_key.endswith("_scale"):
            return torch.float32
    return getattr(torch, cfg.dtype)


def _map_cache(cfg: ModelConfig, tree, fn):
    """Map over cache leaves with their dict-key names + parent dict."""
    def walk(t, key="", parent=None):
        if isinstance(t, tuple):
            return fn(key, t, parent or {})
        return {k: walk(v, k, t) for k, v in t.items()}
    return walk(tree)


class LeafSpec(NamedTuple):
    """A cache leaf's shape and dtype (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The cache tree of :class:`LeafSpec` (shape, dtype) pairs."""
    return _map_cache(
        cfg, cache_shapes(cfg, batch, max_len),
        lambda key, s, par: LeafSpec(s, _cache_leaf_dtype(cfg, key, s, par)))


def init_cache(cfg: ModelConfig, params, batch: int, max_len: int,
               modality: Optional[torch.Tensor] = None):
    """A zeroed cache on the device that holds ``params``; with a
    ``modality`` (vlm: patch embeddings (B, P, D); audio: frame embeddings
    (B, enc_seq, D), run through the encoder first) each group's cross K/V
    are its projections of it, stored in the model dtype."""
    dev = params["embed"].device
    cache = _map_cache(
        cfg, cache_shapes(cfg, batch, max_len),
        lambda key, s, par: torch.zeros(
            s, dtype=_cache_leaf_dtype(cfg, key, s, par), device=dev))
    if modality is None or cfg.family not in ("vlm", "audio"):
        return cache
    with full_f32():
        if cfg.family == "audio":
            src, cross = encode_audio(cfg, params, modality), cache["lyr"]["cross"]
        else:
            src, cross = modality, cache["cross"]
        for i in range(cfg.num_groups):
            gp = group_params(params["blocks"], i)
            p = gp["lyr"]["cross"] if cfg.family == "audio" \
                else gp["cross"]["attn"]
            _, k, v = A.qkv_proj(cfg, p, src, kv_x=src)
            cross["k"][i] = k
            cross["v"][i] = v
    return cache


# ---------------------------------------------------------------------------
# Cross-attention against a precomputed cache (no causal mask)
# ---------------------------------------------------------------------------


def _cross_decode(cfg: ModelConfig, p, x1, kc, vc):
    """x1 (B, 1, D) against the raw cross K/V (B, Hkv, Sk, dh): float32
    scores, no rope, no mask; the output cast to x1's dtype before ``wo``."""
    b = x1.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    q = x1 @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    # the heads split into kv groups: gathered first, as attention.qkv_proj
    # does (ROADMAP.md C.20, C.25)
    qg = unshard(q, -1).reshape(b, 1, h, dh).transpose(1, 2) \
        .reshape(b, hkv, g, 1, dh)
    out = per_device(A.attend_cache, qg, kc, vc, like=kc)
    out = out.reshape(b, h, 1, dh).transpose(1, 2).reshape(b, 1, -1)
    return out.to(x1.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# Group decode steps
# ---------------------------------------------------------------------------


def _attn_half(cfg, p, x1, c, pos, window=0, ring=False):
    """A layer's attention half: ln1, attention against the cache (written
    in place), the post-norm where the layer has one, residual.  Also the
    moe layer's, which the reference writes without softcap or post-norm:
    no moe config has either."""
    h = norm(cfg, p["ln1"], x1)
    a, c_new = A.attn_decode(cfg, p["attn"], h, c, pos, window=window,
                             attn_softcap=cfg.attn_softcap, ring=ring)
    if "ln1_post" in p:
        a = norm(cfg, p["ln1_post"], a)
    return x1 + a, c_new


def _mlp_half(cfg, p, x1):
    h = norm(cfg, p["ln2"], x1)
    m = mlp_block(cfg, p["mlp"], h)
    if "ln2_post" in p:
        m = norm(cfg, p["ln2_post"], m)
    return x1 + m


def _dense_decode(cfg, p, x1, c, pos, window=0, ring=False):
    x1, c_new = _attn_half(cfg, p, x1, c, pos, window=window, ring=ring)
    return _mlp_half(cfg, p, x1), c_new


def _moe_ffn(cfg, p, x1):
    h = norm(cfg, p["ln2"], x1)
    y, _ = MOE.moe_block(cfg, p["moe"], h, aux=False)
    return x1 + y


def _write(c: Dict, new: Dict) -> None:
    """Write a group's new cache entries into its cache views, in place."""
    for key, val in new.items():
        c[key].copy_(val)


def _time_mix(cfg, p, x1, c):
    x1, new = R.rwkv_time_mix_step(cfg, p, x1, c)
    _write(c, new)
    return x1


def _channel_mix(cfg, p, x1, c):
    x1, new = R.rwkv_channel_mix_step(cfg, p, x1, c)
    _write(c, new)
    return x1


def _mamba_layers(cfg, lps, x1, lcs):
    """A hybrid group's Mamba layers, in order, each adding its output to
    the residual and writing its cache entries in place."""
    for j in range(cfg.hybrid_attn_every - 1):
        lc = group_params(lcs, j)
        delta, new = M.mamba_decode_step(cfg, group_params(lps, j), x1, lc)
        _write(lc, new)
        x1 = x1 + delta
    return x1


# the recurrent state each family's step returns in float32, by cache path
_F32_STATES = {"ssm": ("lyr", "wkv"), "hybrid": ("mamba", "h")}


def _states_to_f32(cfg: ModelConfig, cache) -> None:
    """C.13, C.14: the reference's step returns RWKV6's wkv state and
    Mamba's ``h`` in float32, whatever the cache's dtype, so after its first
    step the state is float32.  Bind a float32 copy in place of a state held
    in another dtype (the values are unchanged: the upcast is exact); the
    list form gets views of one stacked float32 tensor."""
    if cfg.family not in _F32_STATES:
        return
    part, key = _F32_STATES[cfg.family]
    if isinstance(cache, list):
        if cache[0][part][key].dtype != torch.float32:
            stacked = torch.stack([c[part][key] for c in cache]).float()
            for g, c in enumerate(cache):
                c[part][key] = stacked[g]
    elif cache[part][key].dtype != torch.float32:
        cache[part][key] = cache[part][key].float()


def _group_decode(cfg: ModelConfig, params, pos):
    if cfg.family == "vlm":
        def step(x1, gp, gc):
            for j in range(cfg.cross_attn_every - 1):
                x1, _ = _dense_decode(cfg, group_params(gp["self"], j), x1,
                                      group_params(gc["self"], j), pos)
            p = gp["cross"]
            h = norm(cfg, p["ln1"], x1)
            a = _cross_decode(cfg, p["attn"], h, gc["cross"]["k"],
                              gc["cross"]["v"])
            x1 = x1 + a * torch.tanh(p["gate_attn"]).to(a.dtype)
            h = norm(cfg, p["ln2"], x1)
            m = mlp_block(cfg, p["mlp"], h)
            return x1 + m * torch.tanh(p["gate_mlp"]).to(m.dtype), gc
    elif cfg.family == "audio":
        def step(x1, gp, gc):
            p, c = gp["lyr"], gc["lyr"]
            h = norm(cfg, p["ln1"], x1)
            a, _ = A.attn_decode(cfg, p["attn"], h, c["self"], pos)
            x1 = x1 + a
            h = norm(cfg, p["ln2"], x1)
            x1 = x1 + _cross_decode(cfg, p["cross"], h, c["cross"]["k"],
                                    c["cross"]["v"])
            h = norm(cfg, p["ln3"], x1)
            return x1 + mlp_block(cfg, p["mlp"], h), gc
    elif cfg.family == "ssm":
        def step(x1, gp, gc):
            x1, new = R.rwkv_decode_step(cfg, gp["lyr"], x1, gc["lyr"])
            _write(gc["lyr"], new)
            return x1, gc
    elif cfg.family == "moe":
        def step(x1, gp, gc):
            x1, _ = _attn_half(cfg, gp["lyr"], x1, gc["lyr"], pos)
            return _moe_ffn(cfg, gp["lyr"], x1), gc
    elif cfg.family == "hybrid":
        shared = params["shared_block"]

        def step(x1, gp, gc):
            x1 = _mamba_layers(cfg, gp["mamba"], x1, gc["mamba"])
            x1, _ = _dense_decode(cfg, shared, x1, gc["attn"], pos)
            return x1, gc
    elif cfg.local_global:
        def step(x1, gp, gc):
            x1, cl = _dense_decode(cfg, gp["local"], x1, gc["local"], pos,
                                   window=cfg.sliding_window, ring=True)
            x1, cg = _dense_decode(cfg, gp["global"], x1, gc["global"], pos)
            return x1, {"local": cl, "global": cg}
    else:
        def step(x1, gp, gc):
            x1, c = _dense_decode(cfg, gp["lyr"], x1, gc["lyr"], pos)
            return x1, {"lyr": c}
    return step


def serve_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor, pos
               ) -> Tuple[torch.Tensor, Any]:
    """tokens: (B, 1) int on the params' device; pos: int (next write
    position).  Runs where ``params`` lie (``init_params`` puts them on
    ``cuda`` unless told otherwise), float32 products without TF32.

    Returns (logits (B, 1, V) float32, the cache, updated in place).
    """
    if cfg.kv_lora_rank:
        raise LatentCacheMissing(cfg)
    pos = int(pos)
    _states_to_f32(cfg, cache)
    with full_f32():
        x1 = embed(cfg, params, tokens)
        if cfg.family == "audio":
            # row pos of a table of cache_max_len rows, the start clamped
            # into it as dynamic_slice_in_dim's is (C.16)
            row = min(max(pos, 0), cache_max_len(cfg, cache) - 1)
            pe = sinusoid_pos(1, cfg.d_model, offset=row, device=x1.device)
            x1 = x1 + pe[None].to(x1.dtype)
        step = _group_decode(cfg, params, pos)
        for i in range(cfg.num_groups):
            x1, _ = step(x1, group_params(params["blocks"], i),
                         group_params(cache, i))
        x1 = norm(cfg, params["final_norm"], x1)
        return lm_logits(cfg, params, x1), cache


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for g in tree for leaf in _leaves(g)]
    return [tree]


def cache_max_len(cfg: ModelConfig, cache) -> int:
    """Decoder self-attention cache length (the position-table size), as in
    the reference (C.17): for audio the self cache's length; otherwise the
    largest ``shape[-2]`` of a leaf with four axes or more.  For RWKV6,
    which has no length axis, that is the wkv state's ``head_dim``; for
    zamba2 it also reads the Mamba ``h`` leaf's ``ssm_state`` and the conv
    window's K-1, so it is ``max(max_len, ssm_state)``; for the VLM it reads
    the cross K/V's patch axis, so it is ``max(max_len, num_patches)``."""
    if cfg.family == "audio":
        return cache["lyr"]["self"]["k"].shape[-2]
    return max((l.shape[-2] for l in _leaves(cache) if l.ndim >= 4),
               default=1)


# ---------------------------------------------------------------------------
# Serving plumbing: shared step + per-step stats for observability
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_serve_step(cfg: ModelConfig):
    """:func:`serve_step` closed over ``cfg``, cached per config, so every
    engine and driver on one config shares one step function (a plain
    function: no compilation)."""
    return functools.partial(serve_step, cfg)


def cache_num_bytes(cache) -> int:
    """Total bytes held by the cache leaves (the serving-memory gauge)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(cache))


def step_stats(cfg: ModelConfig, cache) -> Dict[str, int]:
    """Static per-step facts the serving metrics export as gauges: cache
    footprint/length and the approximate FLOPs one decoded token costs
    (2 x active parameters — the standard decode estimate)."""
    from .params import count_params
    return {
        "cache_bytes": cache_num_bytes(cache),
        "cache_max_len": cache_max_len(cfg, cache),
        "approx_flops_per_token": 2 * count_params(cfg, active_only=True),
    }


# ---------------------------------------------------------------------------
# Per-slot cache surgery (quarantine + fault injection — ``launch.serve``)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cache_batch_axes(cfg: ModelConfig):
    """Tree (matching the fused cache structure) giving each cache leaf's
    batch-axis index, found by diffing shape templates at two batch sizes:
    the one differing dim per leaf is the batch axis."""
    def ax(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if len(diff) != 1:
            raise ValueError(f"ambiguous batch axis for cache leaf {a}")
        return diff[0]
    return _map_shapes(ax, cache_shapes(cfg, 2, 8), cache_shapes(cfg, 3, 8))


def _map_slot(cfg: ModelConfig, cache, fn) -> None:
    """Apply ``fn(leaf, batch_axis)`` across a fused cache tree or the
    per-group list form (``ProfiledServeStep``), where the sliced-off group
    axis shifts every batch axis down by one."""
    axes = cache_batch_axes(cfg)

    def walk(t, a, shift):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], a[k], shift)
        else:
            fn(t, a - shift)
    if isinstance(cache, list):
        for g in cache:
            walk(g, axes, 1)
    else:
        walk(cache, axes, 0)


def reset_cache_slot(cfg: ModelConfig, cache, slot: int):
    """Zero one batch slot across every cache leaf, in place (slot
    quarantine: the replacement request re-prefills from position 0, so
    stale or corrupted state must not survive).  Returns the cache."""
    _map_slot(cfg, cache, lambda leaf, ax: leaf.select(ax, slot).zero_())
    return cache


def corrupt_cache_slot(cfg: ModelConfig, cache, slot: int):
    """Silently poison one batch slot, in place: NaN into every floating
    cache leaf (int8 KV payloads cannot hold NaN; their float32 scales carry
    the poison instead).  Fault injection only; returns the cache."""
    def poison(leaf, ax):
        if leaf.is_floating_point():
            leaf.select(ax, slot).fill_(float("nan"))
    _map_slot(cfg, cache, poison)
    return cache


# ---------------------------------------------------------------------------
# Per-operator sliced serve step (layer profiling — ``obs.modelprof``)
# ---------------------------------------------------------------------------

# families with a sliced-segment decomposition; vlm/audio decode steps fold
# modality cross-attention into the group and are not sliced, as in the
# reference
PROFILED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def profile_ops(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """Ordered ``(op, group)`` decomposition of one serve_step.

    ``group`` is the group index (``-1`` for the embed/head segments outside
    the block stack).  The canonical op list the layer profiler, its
    validator and the analytic cost model share: one record per entry per
    engine step.
    """
    if cfg.family not in PROFILED_FAMILIES:
        raise NotImplementedError(
            f"layer profiling not implemented for family {cfg.family!r} "
            f"(supported: {PROFILED_FAMILIES})")
    ops = [("embed", -1)]
    for g in range(cfg.num_groups):
        if cfg.family == "ssm":
            ops += [("time_mix", g), ("channel_mix", g)]
        elif cfg.family == "moe":
            ops += [("attn", g), ("moe", g)]
        elif cfg.family == "hybrid":
            ops += [("scan", g), ("attn", g), ("mlp", g)]
        elif cfg.local_global:
            ops += [("attn_local", g), ("mlp_local", g),
                    ("attn_global", g), ("mlp_global", g)]
        else:
            ops += [("attn", g), ("mlp", g)]
    ops.append(("head", -1))
    return tuple(ops)


class ProfiledServeStep:
    """One decode step as a sequence of segments (embed / per-group attn and
    mlp, attn and moe, time_mix and channel_mix, or scan, attn and mlp /
    head), each synchronized (``torch.cuda.synchronize()`` on a card) and
    wall-stamped.  zamba2's attn and mlp segments run the one shared block.

    The same math as :func:`serve_step` in the same order, so logits and
    cache agree with the fused step bit for bit; it pays one sync per
    segment.  The cache travels as a list of per-group subtrees, views of
    one stacked cache (``init_cache``); ``stack_cache`` copies them back to
    the fused layout.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.ops = profile_ops(cfg)
        self._gps = None
        self._params_id = None
        self._aux = None            # head/embed/shared params

    # -- cache layout --------------------------------------------------------

    @staticmethod
    def init_cache(cfg: ModelConfig, params, batch: int, max_len: int):
        """Family cache in per-group list form (views of one stacked cache)."""
        c = init_cache(cfg, params, batch, max_len)
        return [group_params(c, g) for g in range(cfg.num_groups)]

    @staticmethod
    def stack_cache(groups):
        """Per-group list form back to the fused (stacked) layout."""
        def stack(*ts):
            if isinstance(ts[0], dict):
                return {k: stack(*(t[k] for t in ts)) for k in ts[0]}
            return torch.stack(ts)
        return stack(*groups)

    def _sliced(self, params):
        if self._params_id != id(params):
            cfg = self.cfg
            self._gps = [group_params(params["blocks"], g)
                         for g in range(cfg.num_groups)]
            head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
            self._aux = {"embed": params["embed"], "head_w": head,
                         "final_norm": params["final_norm"]}
            if cfg.family == "hybrid":
                self._aux["shared"] = params["shared_block"]
            self._params_id = id(params)
        return self._gps, self._aux

    # -- one profiled step ---------------------------------------------------

    def __call__(self, params, cache_groups, tokens, pos
                 ) -> Tuple[torch.Tensor, list, list]:
        """Returns ``(logits, cache_groups, walls)`` where ``walls`` aligns
        with :func:`profile_ops`: one post-sync wall-clock microsecond figure
        per segment."""
        cfg = self.cfg
        pos = int(pos)
        gps, aux = self._sliced(params)
        on_card = tokens.device.type == "cuda"
        walls: list = []

        def timed(fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(cfg, *args, **kw)
            if on_card:
                torch.cuda.synchronize(tokens.device)
            walls.append((time.perf_counter() - t0) * 1e6)
            return out

        def head(cfg, x1):
            x1 = norm(cfg, aux["final_norm"], x1)
            key = "embed" if cfg.tie_embeddings else "lm_head"
            return lm_logits(cfg, {key: aux["head_w"]}, x1)

        _states_to_f32(cfg, cache_groups)
        with full_f32():
            x1 = timed(embed, {"embed": aux["embed"]}, tokens)
            for g in range(cfg.num_groups):
                gp, gc = gps[g], cache_groups[g]
                if cfg.family == "ssm":
                    x1 = timed(_time_mix, gp["lyr"], x1, gc["lyr"])
                    x1 = timed(_channel_mix, gp["lyr"], x1, gc["lyr"])
                elif cfg.family == "moe":
                    x1, _ = timed(_attn_half, gp["lyr"], x1, gc["lyr"], pos)
                    x1 = timed(_moe_ffn, gp["lyr"], x1)
                elif cfg.family == "hybrid":
                    x1 = timed(_mamba_layers, gp["mamba"], x1, gc["mamba"])
                    x1, _ = timed(_attn_half, aux["shared"], x1, gc["attn"],
                                  pos)
                    x1 = timed(_mlp_half, aux["shared"], x1)
                elif cfg.local_global:
                    x1, _ = timed(_attn_half, gp["local"], x1, gc["local"],
                                  pos, window=cfg.sliding_window, ring=True)
                    x1 = timed(_mlp_half, gp["local"], x1)
                    x1, _ = timed(_attn_half, gp["global"], x1, gc["global"],
                                  pos)
                    x1 = timed(_mlp_half, gp["global"], x1)
                else:
                    x1, _ = timed(_attn_half, gp["lyr"], x1, gc["lyr"], pos)
                    x1 = timed(_mlp_half, gp["lyr"], x1)
            logits = timed(head, x1)
        return logits, cache_groups, walls


@functools.lru_cache(maxsize=None)
def make_profiled_serve_step(cfg: ModelConfig) -> ProfiledServeStep:
    """Per-config cached :class:`ProfiledServeStep` (the sharing contract of
    :func:`make_serve_step`)."""
    return ProfiledServeStep(cfg)
