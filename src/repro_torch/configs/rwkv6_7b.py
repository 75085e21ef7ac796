"""RWKV6-7B "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892].  64 WKV heads of size 64."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    rope_theta=0.0, act="relu",
))
