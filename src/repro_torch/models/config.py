"""Model configuration for every assigned architecture.

One frozen dataclass covers the ten families; per-arch constructor modules
live in ``repro.configs.<id>`` and must reproduce the public-literature
numbers exactly.  ``reduced()`` derives the CPU-smoke-test variant of any
config (same family/topology, tiny widths).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e4
    logit_softcap: float = 0.0          # gemma2 final-logit softcap
    attn_softcap: float = 0.0           # gemma2 attention softcap
    sliding_window: int = 0             # local-attention window
    local_global: bool = False          # gemma2 alternating pattern

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "banked"        # banked (paper-style) | gather

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    hybrid_attn_every: int = 0          # zamba2: group = (n-1) mamba + 1 attn

    # enc-dec / modality frontends (stubs provide embeddings)
    encoder_layers: int = 0             # whisper encoder depth
    encoder_seq: int = 1500             # whisper frame count (stub)
    frontend: str = "none"              # none | audio_stub | patch_stub
    cross_attn_every: int = 0           # vlm: group = (n-1) self + 1 cross
    num_patches: int = 1601             # vlm stub patch count

    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # runtime knobs
    remat: bool = True
    scan_layers: bool = True
    use_flash_kernel: bool = False      # Pallas path (TPU); jnp ref on CPU
    kv_cache_dtype: str = ""            # "" = model dtype; "int8" quantized

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    # ---- derived ----------------------------------------------------------
    @property
    def group_size(self) -> int:
        """Layers per scanned group (heterogeneous stacks scan over groups)."""
        if self.family == "hybrid":
            return self.hybrid_attn_every
        if self.family == "vlm" and self.cross_attn_every:
            return self.cross_attn_every
        if self.local_global:
            return 2
        return 1

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, (
            self.name, self.num_layers, self.group_size)
        return self.num_layers // self.group_size

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM/hybrid) -> long_500k runs."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs decode (whisper via its decoder)

    def param_count(self) -> int:
        """Approximate total parameters (embedding included)."""
        from . import params as P
        return P.count_params(self)

    def active_param_count(self) -> int:
        from . import params as P
        return P.count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes: Dict = dict(
            num_layers=self.group_size * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4
                                    // max(self.num_heads, 1))),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            dtype="float32",
            scan_layers=True,
            remat=False,
        )
        if self.num_experts:
            changes.update(num_experts=4, experts_per_token=2)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16)
        if self.sliding_window:
            changes.update(sliding_window=16)
        if self.encoder_layers:
            changes.update(encoder_layers=2, encoder_seq=12)
        if self.frontend == "patch_stub":
            changes.update(num_patches=9)
        return dataclasses.replace(self, **changes)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_names():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib
    for mod in ("olmoe_1b_7b", "granite_moe_1b_a400m", "llama32_vision_11b",
                "gemma2_27b", "qwen2_0_5b", "starcoder2_7b", "qwen2_7b",
                "zamba2_7b", "whisper_large_v3", "rwkv6_7b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
