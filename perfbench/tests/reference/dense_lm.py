"""Plain reference of the dense decoder LM as the port runs it (family
``dense``, every layer alike): the architecture that
``test_perfbench_architecture.py`` adds to a copy of the harness as new
files only, this module and a configuration file.

Written from the configuration file alone, in plain PyTorch and float32,
nothing of the program; what no layer of its own decides is in
``perfbench/reference/common.py``.  The model:

- token embedding; per layer, pre-norm RMSNorm, grouped-query attention
  with rotary embedding (``common.gqa_attention``); residual;
- pre-norm RMSNorm, the MLP: gelu (tanh form) of x Wi, then Wo; where
  ``act`` is ``silu``, silu(x Wg) * (x Wi), then Wo; residual;
- final RMSNorm and the LM head (the embedding transposed when tied).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import (gqa_attention, head_loss,
                                        layer_weights, mm, rms_norm)


def _gated(c: Dict) -> bool:
    return c["act"] == "silu"


def shapes(c: Dict) -> Dict[str, Any]:
    """{name: (shape, kind)} of the dense decoder LM, nested as the port
    nests it: ``blocks/lyr/{attn,ln1,ln2,mlp}`` stacked over the layers."""
    n, d, v = c["num_layers"], c["d_model"], c["vocab_size"]
    h, hkv, dh, f = c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    mlp = {"wi": ((n, d, f), "normal"), "wo": ((n, f, d), "normal")}
    if _gated(c):
        mlp["wg"] = ((n, d, f), "normal")
    lyr = {
        "attn": {"wq": ((n, d, h * dh), "normal"),
                 "wk": ((n, d, hkv * dh), "normal"),
                 "wv": ((n, d, hkv * dh), "normal"),
                 "wo": ((n, h * dh, d), "normal")},
        "ln1": {"w": ((n, d), "ones")},
        "ln2": {"w": ((n, d), "ones")},
        "mlp": mlp,
    }
    tree: Dict[str, Any] = {"embed": ((v, d), "embed"),
                            "blocks": {"lyr": lyr},
                            "final_norm": {"w": ((d,), "ones")}}
    if not c["tie_embeddings"]:
        tree["lm_head"] = ((d, v), "normal")
    return tree


def layer(c: Dict, p: Dict, x: torch.Tensor, positions: torch.Tensor,
          precision: Optional[str], seq_block: int) -> torch.Tensor:
    """One decoder layer on x (B, S, D)."""
    hn = rms_norm(x, p["ln1"]["w"], c["norm_eps"])
    x = x + gqa_attention(c, p["attn"], hn, positions, precision, seq_block)
    hn = rms_norm(x, p["ln2"]["w"], c["norm_eps"])
    m = p["mlp"]
    up = mm(hn, m["wi"], precision)
    if _gated(c):
        h = F.silu(mm(hn, m["wg"], precision)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return x + mm(h, m["wo"], precision)


def loss(c: Dict, w: Dict, tokens: torch.Tensor,
         precision: Optional[str] = None, ce_rows: int = 2048
         ) -> torch.Tensor:
    """Next-token cross entropy over every position but each row's last.
    Each layer and each block of rows of the head is recomputed in the
    backward pass."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = F.embedding(tokens, w["embed"])
    for i in range(c["num_layers"]):
        def body(x, i=i):
            return layer(c, layer_weights(w, i), x, positions, precision, 1)
        x = checkpoint(body, x, use_reentrant=False)
    return head_loss(c, w, x, tokens, precision, ce_rows)
