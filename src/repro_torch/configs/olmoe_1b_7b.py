"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    num_experts=64, experts_per_token=8,
    rope_theta=1e4, act="silu",
))
