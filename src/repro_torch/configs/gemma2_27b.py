"""Gemma2-27B — local/global alternating attention, logit softcap
[arXiv:2408.00118]."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    local_global=True, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    rope_theta=1e4, act="gelu", tie_embeddings=True,
))
