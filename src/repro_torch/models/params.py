"""Parameter trees: shapes, initialization, counting, carrying weights over.

The port of ``repro.models.params``.  ``param_shapes`` builds a tree whose
leaves are (shape tuple, init kind), the single source of truth for every
family; ``init_params`` materializes it as torch tensors with the weights
the reference draws from the same seed, drawn leaf by leaf in pieces
straight to the device (``stream_params``: the whole tree never sits on
the host), and ``cast_params`` casts a tree leaf by leaf;
``init_numpy_params`` is the same draw as numpy arrays, and
``params_from_numpy`` carries the reference's own parameters (given as
numpy arrays) over.  The tree keeps the
reference's nested dicts, with the stacked group axis in front.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig

Leaf = Tuple[tuple, str]          # (shape, init_kind)


def _leaf(shape, kind="normal") -> Leaf:
    return (tuple(int(s) for s in shape), kind)


def _is_leaf(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and isinstance(x[1], str))


# ---------------------------------------------------------------------------
# Per-layer shape builders
# ---------------------------------------------------------------------------


def norm_shapes(cfg: ModelConfig) -> Dict[str, Leaf]:
    d = cfg.d_model
    if cfg.family in ("audio", "ssm"):
        return {"w": _leaf((d,), "ones"), "b": _leaf((d,), "zeros")}
    return {"w": _leaf((d,), "zeros" if cfg.name.startswith("gemma")
                       else "ones")}


def mla_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Latent attention's products (``attention.mla_block``) and the latent's
    norm."""
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq": _leaf((d, h * (dn + dr))), "wkv_a": _leaf((d, r + dr)),
            "kv_norm": {"w": _leaf((r,), "ones")},
            "wkv_b": _leaf((r, h * (dn + dv))), "wo": _leaf((h * dv, d))}


def attn_shapes(cfg: ModelConfig, cross: bool = False) -> Dict[str, Any]:
    if cfg.kv_lora_rank:
        return mla_shapes(cfg)
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s: Dict[str, Any] = {
        "wq": _leaf((d, h * dh)),
        "wk": _leaf((d, hkv * dh)),
        "wv": _leaf((d, hkv * dh)),
        "wo": _leaf((h * dh, d)),
    }
    if cfg.qkv_bias:
        s["bq"] = _leaf((h * dh,), "zeros")
        s["bk"] = _leaf((hkv * dh,), "zeros")
        s["bv"] = _leaf((hkv * dh,), "zeros")
    return s


def gated_mlp(cfg: ModelConfig) -> bool:
    return cfg.act == "silu" or cfg.name.startswith("gemma")


def mlp_shapes(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, Leaf]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {"wi": _leaf((d, f)), "wo": _leaf((f, d))}
    if gated_mlp(cfg):
        s["wg"] = _leaf((d, f))
    return s


def moe_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The router over ``routed_experts``, the ``num_experts`` held here and
    the shared experts, one MLP ``n_shared_experts * d_ff`` wide."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {"router": _leaf((d, cfg.routed_experts)),
         "w1": _leaf((e, d, f)), "w2": _leaf((e, f, d))}
    if gated_mlp(cfg):
        s["wg"] = _leaf((e, d, f))
    if cfg.n_shared_experts:
        s["shared"] = mlp_shapes(cfg, cfg.n_shared_experts * f)
    return s


def dense_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    s = {"ln1": norm_shapes(cfg), "attn": attn_shapes(cfg),
         "ln2": norm_shapes(cfg), "mlp": mlp_shapes(cfg)}
    if cfg.name.startswith("gemma"):
        s["ln1_post"] = norm_shapes(cfg)
        s["ln2_post"] = norm_shapes(cfg)
    return s


def moe_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": norm_shapes(cfg), "attn": attn_shapes(cfg),
            "ln2": norm_shapes(cfg), "moe": moe_shapes(cfg)}


def lead_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """A dense lead layer of an MoE stack: its MLP ``dense_d_ff`` wide."""
    return {"ln1": norm_shapes(cfg), "attn": attn_shapes(cfg),
            "ln2": norm_shapes(cfg), "mlp": mlp_shapes(cfg, cfg.dense_d_ff)}


def cross_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    s = {"ln1": norm_shapes(cfg), "attn": attn_shapes(cfg),
         "ln2": norm_shapes(cfg), "mlp": mlp_shapes(cfg),
         "gate_attn": _leaf((), "zeros"), "gate_mlp": _leaf((), "zeros")}
    return s


def mamba_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    d_inner = 2 * d
    nh = d_inner // cfg.ssm_head_dim
    st = cfg.ssm_state
    conv_ch = d_inner + 2 * st
    return {
        "ln": norm_shapes(cfg),
        "in_proj": _leaf((d, 2 * d_inner + 2 * st + nh)),
        "conv_w": _leaf((cfg.ssm_conv_width, conv_ch)),
        "conv_b": _leaf((conv_ch,), "zeros"),
        "A_log": _leaf((nh,), "a_log"),
        "D": _leaf((nh,), "ones"),
        "dt_bias": _leaf((nh,), "dt_bias"),
        "out_proj": _leaf((d_inner, d)),
    }


def rwkv_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    h, dh = cfg.num_heads, cfg.head_dim
    lora_w, lora_mix = 64, 32
    return {
        "ln1": {"w": _leaf((d,), "ones"), "b": _leaf((d,), "zeros")},
        "ln2": {"w": _leaf((d,), "ones"), "b": _leaf((d,), "zeros")},
        "tm": {
            "mu": _leaf((5, d), "half"),            # ddlerp bases (r,k,v,w,g)
            "mix_A": _leaf((d, 5 * lora_mix)),
            "mix_B": _leaf((5, lora_mix, d), "zeros"),
            "wr": _leaf((d, h * dh)), "wk": _leaf((d, h * dh)),
            "wv": _leaf((d, h * dh)), "wg": _leaf((d, h * dh)),
            "wo": _leaf((h * dh, d)),
            "w0": _leaf((d,), "decay_base"),
            "wlora_A": _leaf((d, lora_w)),
            "wlora_B": _leaf((lora_w, d), "zeros"),
            "u": _leaf((h, dh), "half"),
            "gn_w": _leaf((d,), "ones"), "gn_b": _leaf((d,), "zeros"),
        },
        "cm": {
            "mu_k": _leaf((d,), "half"), "mu_r": _leaf((d,), "half"),
            "wk": _leaf((d, f)), "wv": _leaf((f, d)), "wr": _leaf((d, d)),
        },
    }


def enc_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": norm_shapes(cfg), "attn": attn_shapes(cfg),
            "ln2": norm_shapes(cfg), "mlp": mlp_shapes(cfg)}


def dec_layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": norm_shapes(cfg), "attn": attn_shapes(cfg),
            "ln2": norm_shapes(cfg), "cross": attn_shapes(cfg, cross=True),
            "ln3": norm_shapes(cfg), "mlp": mlp_shapes(cfg)}


# ---------------------------------------------------------------------------
# Group / model assembly
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Group / model assembly
# ---------------------------------------------------------------------------


def _tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves in sorted-key order at every level, the
    order in which ``jax.tree.map`` walks a dict (``ROADMAP.md`` C.3)."""
    if _is_leaf(tree):
        return fn(tree)
    return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}


def _stack(n: int, tree):
    return _tree_map(lambda lf: ((n,) + lf[0], lf[1]), tree)


def group_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    fam = cfg.family
    if fam in ("dense",):
        if cfg.local_global:
            return {"local": dense_layer_shapes(cfg),
                    "global": dense_layer_shapes(cfg)}
        return {"lyr": dense_layer_shapes(cfg)}
    if fam == "moe":
        return {"lyr": moe_layer_shapes(cfg)}
    if fam == "vlm":
        n_self = cfg.cross_attn_every - 1
        return {"self": _stack(n_self, dense_layer_shapes(cfg)),
                "cross": cross_layer_shapes(cfg)}
    if fam == "hybrid":
        n_mamba = cfg.hybrid_attn_every - 1
        return {"mamba": _stack(n_mamba, mamba_layer_shapes(cfg))}
    if fam == "ssm":
        return {"lyr": rwkv_layer_shapes(cfg)}
    if fam == "audio":
        return {"lyr": dec_layer_shapes(cfg)}
    raise ValueError(fam)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {
        "embed": _leaf((v, d), "embed"),
        "blocks": _stack(cfg.num_groups, group_shapes(cfg)),
        "final_norm": norm_shapes(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = _leaf((d, v))
    if cfg.first_k_dense:
        tree["lead"] = _stack(cfg.first_k_dense, lead_layer_shapes(cfg))
    if cfg.family == "hybrid":
        tree["shared_block"] = dense_layer_shapes(cfg)
    if cfg.family == "audio":
        tree["encoder"] = _stack(cfg.encoder_layers, enc_layer_shapes(cfg))
        tree["enc_norm"] = norm_shapes(cfg)
    return tree


# ---------------------------------------------------------------------------
# Init / carry-over / counting
# ---------------------------------------------------------------------------


def _draw_leaf(rng: np.random.Generator, lf: Leaf, size=None):
    """One leaf as the reference draws it: numpy values, or a constant.
    ``size``: draw only that many of the leaf's values (the next ones of
    its flattened C order), at the leaf's own scale.

    The scale reads ``shape[0]``, which for a block weight is the stacked
    group count, not the layer's input width (``ROADMAP.md`` C.6)."""
    shape, kind = lf
    size = shape if size is None else size
    if kind == "zeros":
        return np.zeros(size, np.float32)
    if kind == "ones":
        return np.ones(size, np.float32)
    if kind == "half":
        return np.full(size, 0.5, np.float32)
    if kind == "a_log":
        return np.log(rng.uniform(1, 16, size))
    if kind == "dt_bias":
        return np.log(np.expm1(rng.uniform(1e-3, 0.1, size)))
    if kind == "decay_base":
        return rng.uniform(-7.0, -5.0, size)
    scale = 0.02 if kind == "embed" else 1.0 / math.sqrt(max(shape[0] if
                                                             shape else 1, 1))
    return rng.normal(0.0, scale, size).astype(np.float32)


def init_numpy_params(cfg: ModelConfig, seed: int = 0) -> Any:
    """The reference's ``init_params`` draw as numpy arrays, before the cast
    to the model dtype: one numpy generator walked in sorted-key order."""
    rng = np.random.default_rng(seed)
    return _tree_map(lambda lf: _draw_leaf(rng, lf), param_shapes(cfg))


def params_from_numpy(tree, device: DeviceLike, dtype) -> Any:
    """Carry a parameter tree of numpy arrays (the reference's parameters, or
    :func:`init_numpy_params`) onto ``device`` as ``dtype`` (a torch dtype or
    its name).  Each value is cast once, from the array's own dtype, rounding
    to nearest even as ``jnp.asarray(x, dtype)`` does.  ``device`` None
    means ``cuda``."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def carry(a):
        if isinstance(a, dict):
            return {k: carry(a[k]) for k in sorted(a)}
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:          # e.g. a view of a JAX array
            a = a.copy()
        return torch.from_numpy(a).to(dev).to(dt)
    return carry(tree)


def stream_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                  dtype="float32", piece: int = 1 << 24) -> Any:
    """The reference's weights for ``cfg`` and ``seed`` (the values of
    :func:`init_numpy_params`), drawn leaf by leaf straight to ``device``
    (``cuda`` unless named) as ``dtype``.

    One numpy generator walks the leaves in sorted-key order, as
    :func:`init_numpy_params` does; each leaf is drawn in pieces of at most
    ``piece`` numbers of its flattened C order, each carried over and cast
    as :func:`params_from_numpy` casts, so the host holds one piece at a
    time.  numpy fills a draw in C order from the generator's stream, so
    the pieces are the whole leaf's draw, bit for bit (tested)."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    rng = np.random.default_rng(seed)

    def leaf(lf: Leaf) -> torch.Tensor:
        out = torch.empty(lf[0], dtype=dt, device=dev)
        flat = out.view(-1)
        for lo in range(0, flat.numel(), piece):
            n = min(piece, flat.numel() - lo)
            a = _draw_leaf(rng, lf, size=(n,))
            flat[lo:lo + n].copy_(torch.from_numpy(a).to(dev).to(dt))
        return out
    return _tree_map(leaf, param_shapes(cfg))


def cast_params(tree, dtype) -> Any:
    """Cast ``tree``'s leaves to ``dtype`` one by one, each new leaf bound in
    place of the old one, so that a tree nobody else holds is never held
    twice.  A bf16 cast of a float32 tree has the bits of the bf16 tree
    :func:`params_from_numpy` makes from the same numpy values (every cast
    rounds to nearest even through float32), so one float32 draw serves
    both dtypes.  Returns ``tree``."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            cast_params(tree[k], dt)
        else:
            tree[k] = tree[k].to(dt)
    return tree


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Any:
    """The reference's weights for ``cfg`` and ``seed``, as tensors of the
    model dtype on ``device`` (``cuda`` unless the caller names another)."""
    return stream_params(cfg, seed, device, cfg.dtype)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = 0
    expert_frac = (cfg.experts_per_token / cfg.routed_experts
                   if cfg.num_experts else 1.0)

    def visit(tree, path=""):
        nonlocal total
        if _is_leaf(tree):
            n = 1
            for s in tree[0]:
                n *= s
            if active_only and "/moe/w" in path:
                n = int(n * expert_frac)
            total += n
            return
        for k, v in tree.items():
            visit(v, f"{path}/{k}")

    visit(param_shapes(cfg))
    return total
