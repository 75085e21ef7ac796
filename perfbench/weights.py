"""Weights of a benchmark configuration, made on the device from the seed.

The tree is the one that the configuration's reference module writes from
the configuration's sizes (``shapes``, the port's layout: the stacked layer
axis in front of every block weight), so that the harness and the reference
depend on no code of the program; the run checks it against the port's own
parameter shapes.  One generator on the device draws every leaf in
sorted-key order, in the dtype the model is served in: products (kinds
``normal`` and ``expert``) normal at 1/sqrt(fan_in) (fan_in the
second-last axis), the embedding normal at the configuration's
``embed_std``, norm weights one.  The same seed gives the same tensors, so
the reference is handed what the program was handed.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from perfbench import cells


def shapes(c: Dict) -> Dict[str, Any]:
    """{name: (shape, kind)} of configuration ``c``: its reference module's
    ``shapes`` (``perfbench/reference/common.py`` lists the kinds)."""
    return cells.reference(c).shapes(c)


# the kinds of leaf that a token multiplies (``counts.active_params``)
PRODUCTS = ("normal", "expert")


def _leaf(shape, kind, embed_std, gen, device, dtype) -> torch.Tensor:
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind != "embed" and kind not in PRODUCTS:
        raise ValueError(f"no leaf kind {kind!r}")
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
