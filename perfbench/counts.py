"""The yardstick's arithmetic: the chip's peaks, and the operations and bytes
that each measured layer needs, written from a configuration's shapes.

Every count is of what the inputs need, whatever implements the layer: each
input byte read once, each output byte written once, and the products the
mathematics asks for.  A roofline share is the least time these allow over
the device time the trace reads, so it cannot pass 100% unless a count is
too high or the device time misses part of the work.

A configuration here is the dict of ``perfbench/configs/<name>.json``.  The
parameters a token multiplies and the training step's FLOPs are taken from
the weight tree that its reference module writes (``weights.shapes``), so
they hold for any architecture whose tree marks its products; the serving
counts (``attn_decode_call``, ``moe_call``, ``serve_token_flops``) are
written for grouped-query attention and experts in every layer, and hold
only for such a configuration until a serving cell of another one comes.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from perfbench import weights

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at 700 W.
PEAKS = {
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
    "source": "NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16, "
              "3.35 TB/s HBM3, at a 700 W power limit",
}

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the compute bound
    and the memory bound."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def _es(c: Dict) -> int:
    return DTYPE_BYTES[c["dtype"]]


def attn_proj_params(c: Dict) -> int:
    """Weights of one layer's q, k, v and output projections."""
    d, h, hkv, dh = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return d * (h + 2 * hkv) * dh + h * dh * d


def expert_params(c: Dict) -> int:
    """Weights of one expert: the gated FFN's up, gate and down products."""
    return 3 * c["d_model"] * c["d_ff"]


def active_params(c: Dict) -> float:
    """Parameters a token multiplies, from the weight tree: every product
    leaf (kinds ``normal`` and ``expert``), an ``expert`` leaf at
    ``experts_per_token`` over the experts the router chooses among
    (``router_experts``, by default ``num_experts``: the file's share of
    the experts counts at its share); and the LM head, the embedding
    transposed where it is tied.  The embedding is a lookup and a norm a
    scale: neither multiplies."""
    dense = experts = 0
    for _, (shape, kind) in weights.leaf_paths(weights.shapes(c)):
        if kind == "normal":
            dense += math.prod(shape)
        elif kind == "expert":
            experts += math.prod(shape)
    if experts:
        experts = experts * c["experts_per_token"] \
            / c.get("router_experts", c["num_experts"])
    tied = c["d_model"] * c["vocab_size"] if c["tie_embeddings"] else 0
    return dense + experts + tied


def attn_decode_call(c: Dict, batch: int, pos: int) -> Dict[str, float]:
    """One layer's cached attention for ``batch`` new tokens at position
    ``pos``: the projections, attention over the ``pos`` cached positions
    and the new one, the new key and value written once."""
    d, h, hkv, dh = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    es = _es(c)
    live = pos + 1
    flops = 2 * batch * attn_proj_params(c) + 2 * 2 * batch * h * live * dh
    nbytes = es * (attn_proj_params(c)            # weights
                   + 2 * batch * d                # x in, output out
                   + 2 * batch * hkv * dh         # new k, v written
                   + 2 * batch * hkv * pos * dh)  # cached k, v read
    return {"flops": float(flops), "bytes": float(nbytes)}


def moe_call(c: Dict, tokens: int, kept: int, experts_hit: int
             ) -> Dict[str, float]:
    """One layer's MoE block: the router over ``tokens``, the ``kept``
    routed assignments through their expert's FFN, the weights of the
    ``experts_hit`` experts that some kept assignment reaches."""
    d, e = c["d_model"], c["num_experts"]
    es = _es(c)
    flops = 2 * tokens * d * e + 2 * kept * expert_params(c)
    nbytes = es * (experts_hit * expert_params(c) + d * e + 2 * tokens * d)
    return {"flops": float(flops), "bytes": float(nbytes)}


def serve_token_flops(c: Dict, context: int) -> float:
    """Model FLOPs of one fed token that attends over ``context`` positions
    of its own request (itself included): 2 FLOPs a multiplied parameter,
    and the scores and the weighted sum of every layer."""
    attn = 2 * 2 * c["num_heads"] * c["head_dim"] * context
    return 2.0 * active_params(c) + float(c["num_layers"] * attn)


def train_step_flops(c: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 a parameter a token, and causal
    attention's scores and weighted sum forward (a query at position i sees
    i + 1 keys) and twice that backward; nothing recomputed is counted.
    The scores are ``qk_head_dim`` wide and the values ``v_head_dim``, each
    ``head_dim`` by default, in ``attention_layers`` of the layers, by
    default all."""
    tokens = batch * seq
    width = c.get("qk_head_dim", c["head_dim"]) + c.get("v_head_dim", c["head_dim"])
    attn_fwd = 2 * batch * c["num_heads"] * width * (seq * (seq + 1) // 2)
    return 6.0 * active_params(c) * tokens \
        + 3.0 * c.get("attention_layers", c["num_layers"]) * attn_fwd


def capacity(c: Dict, tokens: int) -> int:
    """Slots each expert has for one dispatch of ``tokens`` tokens: the
    configuration's capacity factor over an even share, rounded up to
    ``capacity_multiple`` and at least that."""
    mult = c["capacity_multiple"]
    share = math.ceil(tokens * c["experts_per_token"]
                      * c["moe_capacity_factor"] / c["num_experts"])
    return max(mult, -(-share // mult) * mult)


def moe_routing(c: Dict, top_i, tokens: int) -> Dict[str, int]:
    """From one dispatch's routing (tokens, experts_per_token) of expert
    ids, in token order: the assignments each expert's capacity keeps and
    the experts that some kept assignment reaches."""
    eid = np.asarray(top_i).reshape(-1)
    rank = np.empty_like(eid)
    for e in np.unique(eid):
        at = np.nonzero(eid == e)[0]
        rank[at] = np.arange(at.size)
    kept = rank < capacity(c, tokens)
    return {"kept": int(kept.sum()), "hit": int(np.unique(eid[kept]).size)}
