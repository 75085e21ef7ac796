"""Dense MLP (optionally gated); the port of ``repro.models.mlp``."""
from __future__ import annotations

import torch

from .common import activation, constrain
from .config import ModelConfig
from .params import gated_mlp


def mlp_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if gated_mlp(cfg):
        g = x @ p["wg"]
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    h = constrain(h, "batch", "seq", "mlp")
    out = h @ p["wo"]
    return constrain(out, "batch", "seq", "embed")
