"""Weights of a benchmark configuration, made on the device from the seed.

The tree has the layout the port reads (the stacked layer axis in front of
every block weight) and is written here from the configuration's sizes, so
that the harness and the reference depend on no code of the program; the
run checks it against the port's own parameter shapes.  One generator on
the device draws every leaf in sorted-key order, in the dtype the model is
served in: products normal at 1/sqrt(fan_in) (fan_in the second-last axis),
the embedding normal at the configuration's ``embed_std``, norm weights
one.  The same seed gives the same tensors, so the reference is handed
what the program was handed.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch


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
                "w1": ((n, e, d, f), "normal"),
                "wg": ((n, e, d, f), "normal"),
                "w2": ((n, e, f, d), "normal")},
    }
    tree: Dict[str, Any] = {"embed": ((v, d), "embed"),
                            "blocks": {"lyr": lyr},
                            "final_norm": {"w": ((d,), "ones")}}
    if not c["tie_embeddings"]:
        tree["lm_head"] = ((d, v), "normal")
    return tree


def _leaf(shape, kind, embed_std, gen, device, dtype) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(embed_std if kind == "embed" else 1.0 / math.sqrt(shape[-2]))


def make(c: Dict, seed: int, device, dtype: torch.dtype) -> Dict[str, Any]:
    """The weight tree for configuration ``c`` and ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return _leaf(t[0], t[1], c["embed_std"], gen, device, dtype)

    return walk(shapes(c))


def leaf_paths(tree, prefix: str = ""):
    """(path, tensor) of every leaf in sorted-key order."""
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from leaf_paths(tree[k], p)
        else:
            yield p, tree[k]
