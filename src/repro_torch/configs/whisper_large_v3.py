"""Whisper-large-v3 — encoder-decoder, conv frontend STUB
[arXiv:2212.04356].  32 encoder + 32 decoder layers; the stub provides
precomputed (B, 1500, d_model) frame embeddings."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, head_dim=64,
    encoder_layers=32, encoder_seq=1500, frontend="audio_stub",
    rope_theta=0.0, act="gelu", tie_embeddings=True,
))
