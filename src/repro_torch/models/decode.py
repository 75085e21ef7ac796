"""Decode path, dense and ssm families: cache construction + single-token
serve step.

The port of ``repro.models.decode``.  The cache keeps the reference's
layout, stacked over groups: dense ``{'lyr': {'k','v'}}`` of
(G, B, Hkv, L, dh) (gemma2: ``{'local','global'}``, the local one a ring of
``sliding_window`` slots), plus (G, B, Hkv, L, 1) float32 scales for an
int8 cache; ssm (RWKV6) ``{'lyr': {'wkv', 'shift_tm', 'shift_cm'}}`` of
(G, B, H, dh, dh) and (G, B, 1, D), no length axis.  Where the reference
returns new caches, the port writes the cache in place and returns it:
:func:`serve_step`, the slot surgery and the per-group list form of
:class:`ProfiledServeStep` (views of one stacked cache) all mutate the
tensors they are given.  One leaf changes dtype: the wkv state is created
in the model dtype and the reference's step returns it in float32, so from
the first step on the port holds it in float32 too, a new leaf bound in
place of the old one (``ROADMAP.md`` C.13).  The other families raise
``NotImplementedError`` naming their ``ROADMAP.md`` item; ``cache_specs``
waits for the dry-run (item 20).
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Tuple

import torch

from ..device import full_f32
from . import attention as A
from . import rwkv as R
from .common import embed, lm_logits, norm
from .config import ModelConfig
from .mlp import mlp_block
from .transformer import group_params, require_ported


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


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    require_ported(cfg)
    if cfg.family == "ssm":
        per = {"lyr": R.rwkv_cache_shape(cfg, batch)}
    elif cfg.local_global:
        local_len = min(max_len, cfg.sliding_window)
        per = {"local": _kv_entry(cfg, batch, local_len),
               "global": _kv_entry(cfg, batch, max_len)}
    else:
        per = {"lyr": _kv_entry(cfg, batch, max_len)}
    return _stack_shapes(cfg.num_groups, per)


def _cache_leaf_dtype(cfg: ModelConfig, path_key: str, shape, parent):
    """int8 only for self-attn k/v whose sibling scale entry exists; their
    scales in float32; everything else in the model dtype."""
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


def init_cache(cfg: ModelConfig, params, batch: int, max_len: int):
    """An empty (zeroed) cache on the device that holds ``params``."""
    dev = params["embed"].device
    return _map_cache(
        cfg, cache_shapes(cfg, batch, max_len),
        lambda key, s, par: torch.zeros(
            s, dtype=_cache_leaf_dtype(cfg, key, s, par), device=dev))


# ---------------------------------------------------------------------------
# Group decode steps
# ---------------------------------------------------------------------------


def _dense_decode(cfg, p, x1, c, pos, window=0, ring=False):
    h = norm(cfg, p["ln1"], x1)
    a, c_new = A.attn_decode(cfg, p["attn"], h, c, pos, window=window,
                             attn_softcap=cfg.attn_softcap, ring=ring)
    if "ln1_post" in p:
        a = norm(cfg, p["ln1_post"], a)
    x1 = x1 + a
    h = norm(cfg, p["ln2"], x1)
    m = mlp_block(cfg, p["mlp"], h)
    if "ln2_post" in p:
        m = norm(cfg, p["ln2_post"], m)
    return x1 + m, c_new


def _write(c: Dict, new: Dict) -> None:
    """Write a group's new cache entries into its cache views, in place."""
    for key, val in new.items():
        c[key].copy_(val)


def _wkv_to_f32(cfg: ModelConfig, cache) -> None:
    """C.13: the reference's step returns the wkv state in float32, whatever
    the cache's dtype, so after its first step the state is float32.  Bind a
    float32 copy in place of a state held in another dtype (the values are
    unchanged: the upcast is exact); the list form gets views of one stacked
    float32 tensor."""
    if cfg.family != "ssm":
        return
    if isinstance(cache, list):
        if cache[0]["lyr"]["wkv"].dtype != torch.float32:
            stacked = torch.stack([c["lyr"]["wkv"] for c in cache]).float()
            for g, c in enumerate(cache):
                c["lyr"]["wkv"] = stacked[g]
    elif cache["lyr"]["wkv"].dtype != torch.float32:
        cache["lyr"]["wkv"] = cache["lyr"]["wkv"].float()


def _group_decode(cfg: ModelConfig, pos):
    require_ported(cfg)
    if cfg.family == "ssm":
        def step(x1, gp, gc):
            x1, new = R.rwkv_decode_step(cfg, gp["lyr"], x1, gc["lyr"])
            _write(gc["lyr"], new)
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
    pos = int(pos)
    _wkv_to_f32(cfg, cache)
    with full_f32():
        x1 = embed(cfg, params, tokens)
        step = _group_decode(cfg, pos)
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
    """Decoder self-attention cache length (the position-table size): the
    largest ``shape[-2]`` of a leaf with four axes or more.  For RWKV6 that
    is the wkv state's ``head_dim``, as in the reference, which has no
    length axis to read."""
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

# families with a sliced-segment decomposition in the port; the reference's
# moe and hybrid decompositions come with their families (ROADMAP.md A)
PROFILED_FAMILIES = ("dense", "ssm")


def profile_ops(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """Ordered ``(op, group)`` decomposition of one serve_step.

    ``group`` is the group index (``-1`` for the embed/head segments outside
    the block stack).  The canonical op list the layer profiler, its
    validator and the analytic cost model share: one record per entry per
    engine step.
    """
    require_ported(cfg)
    ops = [("embed", -1)]
    for g in range(cfg.num_groups):
        if cfg.family == "ssm":
            ops += [("time_mix", g), ("channel_mix", g)]
        elif cfg.local_global:
            ops += [("attn_local", g), ("mlp_local", g),
                    ("attn_global", g), ("mlp_global", g)]
        else:
            ops += [("attn", g), ("mlp", g)]
    ops.append(("head", -1))
    return tuple(ops)


class ProfiledServeStep:
    """One decode step as a sequence of segments (embed / per-group attn and
    mlp, or time_mix and channel_mix / head), each synchronized
    (``torch.cuda.synchronize()`` on a card) and wall-stamped.

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
        self._aux = None            # head/embed params

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

    # -- segments --------------------------------------------------------------

    def _attn(self, p, x1, c, pos, window=0, ring=False):
        cfg = self.cfg
        h = norm(cfg, p["ln1"], x1)
        a, c_new = A.attn_decode(cfg, p["attn"], h, c, pos, window=window,
                                 attn_softcap=cfg.attn_softcap, ring=ring)
        if "ln1_post" in p:
            a = norm(cfg, p["ln1_post"], a)
        return x1 + a, c_new

    def _mlp(self, p, x1):
        cfg = self.cfg
        h = norm(cfg, p["ln2"], x1)
        m = mlp_block(cfg, p["mlp"], h)
        if "ln2_post" in p:
            m = norm(cfg, p["ln2_post"], m)
        return x1 + m

    def _time_mix(self, p, x1, c):
        x1, new = R.rwkv_time_mix_step(self.cfg, p, x1, c)
        _write(c, new)
        return x1

    def _channel_mix(self, p, x1, c):
        x1, new = R.rwkv_channel_mix_step(self.cfg, p, x1, c)
        _write(c, new)
        return x1

    def _sliced(self, params):
        if self._params_id != id(params):
            cfg = self.cfg
            self._gps = [group_params(params["blocks"], g)
                         for g in range(cfg.num_groups)]
            head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
            self._aux = {"embed": params["embed"], "head_w": head,
                         "final_norm": params["final_norm"]}
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
            out = fn(*args, **kw)
            if on_card:
                torch.cuda.synchronize(tokens.device)
            walls.append((time.perf_counter() - t0) * 1e6)
            return out

        def head(x1):
            x1 = norm(cfg, aux["final_norm"], x1)
            key = "embed" if cfg.tie_embeddings else "lm_head"
            return lm_logits(cfg, {key: aux["head_w"]}, x1)

        _wkv_to_f32(cfg, cache_groups)
        with full_f32():
            x1 = timed(embed, cfg, {"embed": aux["embed"]}, tokens)
            for g in range(cfg.num_groups):
                gp, gc = gps[g], cache_groups[g]
                if cfg.family == "ssm":
                    x1 = timed(self._time_mix, gp["lyr"], x1, gc["lyr"])
                    x1 = timed(self._channel_mix, gp["lyr"], x1, gc["lyr"])
                elif cfg.local_global:
                    x1, _ = timed(self._attn, gp["local"], x1, gc["local"], pos,
                                  window=cfg.sliding_window, ring=True)
                    x1 = timed(self._mlp, gp["local"], x1)
                    x1, _ = timed(self._attn, gp["global"], x1, gc["global"],
                                  pos)
                    x1 = timed(self._mlp, gp["global"], x1)
                else:
                    x1, _ = timed(self._attn, gp["lyr"], x1, gc["lyr"], pos)
                    x1 = timed(self._mlp, gp["lyr"], x1)
            logits = timed(head, x1)
        return logits, cache_groups, walls


@functools.lru_cache(maxsize=None)
def make_profiled_serve_step(cfg: ModelConfig) -> ProfiledServeStep:
    """Per-config cached :class:`ProfiledServeStep` (the sharing contract of
    :func:`make_serve_step`)."""
    return ProfiledServeStep(cfg)
