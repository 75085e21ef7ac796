"""Zamba2-7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  81 layers = 27 groups of (2 Mamba2 + 1 shared-attn);
the attention weights are SHARED across all application points."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, hybrid_attn_every=3,
    rope_theta=1e4, act="silu",
))
