"""Int8 error-feedback gradient compression for the data-parallel sync; the
port of ``repro.optim.compression``.

Each worker quantizes its local gradient to int8 with a per-tensor scale,
keeps the quantization residual as error feedback (added back before the
next step's quantization: EF-SGD), and the all-reduce moves a quarter of
the float32 bytes.  Exposed two ways:

  * ``ef_compress``/``ef_decompress``: pure functions over trees, bit-equal
    to the reference's (``torch.round`` and ``jnp.round`` both round half
    to even);
  * ``compressed_psum``: the gradient sync over a ``torch.distributed``
    group: int8 quantize, an int32 ``all_reduce`` of the quantized values
    and a sum of the scales, then a divide by the world size, as the
    reference's ``shard_map`` sync does.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .adamw import leaves, tree_map


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads: Any, errors: Any) -> Tuple[Any, Any, Any]:
    """(grads, errors) -> (q_tree, scales, new_errors)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = _quantize(corrected)
        return q, s, corrected - _dequantize(q, s)

    out = tree_map(one, grads, errors)
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def ef_decompress(q_tree: Any, scales: Any) -> Any:
    return tree_map(_dequantize, q_tree, scales)


def init_errors(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads: Any, errors: Any,
                    group: Optional[Any] = None) -> Tuple[Any, Any]:
    """Gradient sync over ``group`` (the default process group if None):
    int8 quantize -> all_reduce(int32) -> dequantize.

    Each rank passes its local gradients; returns (synced_grads,
    new_errors).  The all-reduce sums the int8 values in int32 (exact for
    up to 2**23 workers) and the float32 scales, and the average is
    ``sum(q) * (sum(scale) / n) / n``, in the reference's order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    q, s, new_e = ef_compress(grads, errors)
    summed = tree_map(lambda x: x.to(torch.int32), q)
    s_sum = tree_map(torch.clone, s)
    for t in leaves(summed) + leaves(s_sum):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    out = tree_map(lambda qs, sc: qs.float() * (sc / n) / n, summed, s_sum)
    return out, new_e
