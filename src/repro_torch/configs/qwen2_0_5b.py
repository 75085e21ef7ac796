"""Qwen2-0.5B — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, rope_theta=1e6, act="silu", tie_embeddings=True,
))
