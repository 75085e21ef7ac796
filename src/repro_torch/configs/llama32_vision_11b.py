"""Llama-3.2-11B-Vision — cross-attn image layers every 5th layer
(32 self-attn + 8 cross-attn = 40L) [hf:meta-llama/Llama-3.2-11B-Vision].
Vision frontend is a patch-embedding STUB per the assignment."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    cross_attn_every=5, frontend="patch_stub", num_patches=1601,
    rope_theta=5e5, act="silu",
))
