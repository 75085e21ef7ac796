"""Granite-3.0-1B-A400M — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=32, experts_per_token=8,
    rope_theta=1e4, act="silu", tie_embeddings=True,
))
