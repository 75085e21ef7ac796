"""Model configuration for every assigned architecture.

One frozen dataclass covers the ten families; per-arch constructor modules
live in ``repro.configs.<id>`` and must reproduce the public-literature
numbers exactly.  ``reduced()`` derives the CPU-smoke-test variant of any
config (same family/topology, tiny widths).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional


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

    # latent attention, shared experts, dense lead layers and a held share
    # of the experts are fields of :class:`MLAConfig` alone; on every other
    # config they read as these class constants, and its fields stay the
    # reference's
    kv_lora_rank: ClassVar[int] = 0
    n_shared_experts: ClassVar[int] = 0
    first_k_dense: ClassVar[int] = 0
    router_experts: ClassVar[int] = 0
    expert_offset: ClassVar[int] = 0
    norm_topk_prob: ClassVar[bool] = True

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
        """Stacked groups of ``params["blocks"]``, after the dense lead."""
        n = self.num_layers - self.first_k_dense
        assert n % self.group_size == 0, (self.name, n, self.group_size)
        return n // self.group_size

    @property
    def routed_experts(self) -> int:
        """Experts the router chooses among; ``num_experts`` of them, from
        ``expert_offset`` on, are held here."""
        return self.router_experts or self.num_experts

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


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A DeepSeek-V2 decoder: multi-head latent attention, ``first_k_dense``
    dense layers (a gated MLP of width ``dense_d_ff``), then MoE layers whose
    router chooses ``experts_per_token`` of ``router_experts`` experts by
    their softmax probabilities (renormalised only with
    ``norm_topk_prob``), of which this device holds ``num_experts`` from
    ``expert_offset`` on, plus ``n_shared_experts`` shared experts (one
    gated MLP ``n_shared_experts * d_ff`` wide) on every token.

    Latent attention: q is ``qk_nope_head_dim + qk_rope_head_dim`` wide a
    head; the latent ``[c_kv, k_pe] = x Wkv_a`` is ``kv_lora_rank`` +
    ``qk_rope_head_dim`` wide; ``c_kv`` is RMS-normed and ``Wkv_b`` gives
    each head's ``k_nope`` and ``v`` (``v_head_dim``); ``k_pe`` is one
    rotary key shared by every head.  Rotary embedding on the pe
    dimensions alone, with YaRN scaling (``yarn_*``, the published
    ``rope_scaling``)."""
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    router_experts: int = 0
    expert_offset: int = 0
    norm_topk_prob: bool = True
    yarn_factor: float = 1.0
    yarn_original_max_position: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def reduced(self) -> "MLAConfig":
        """Tiny, with every mechanism kept: latent attention with YaRN, the
        dense lead, the shared experts and the held share of the experts
        (the same fraction of twice as many as the base reduction)."""
        held = 16 * self.num_experts // self.routed_experts
        return dataclasses.replace(
            super().reduced(), num_layers=self.first_k_dense + 2,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, d_ff=32, dense_d_ff=128, router_experts=16,
            num_experts=held, expert_offset=0, experts_per_token=3)


_REGISTRY: Dict[str, ModelConfig] = {}
# configs of the port alone: ``get_config`` finds them, ``all_names`` does
# not list them, so the sweeps over the reference's configs stay its own
_PORT_ONLY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, port_only: bool = False) -> ModelConfig:
    (_PORT_ONLY if port_only else _REGISTRY)[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name in _PORT_ONLY:
        return _PORT_ONLY[name]
    return _REGISTRY[name]


def all_names():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib
    for mod in ("olmoe_1b_7b", "granite_moe_1b_a400m", "llama32_vision_11b",
                "gemma2_27b", "qwen2_0_5b", "starcoder2_7b", "qwen2_7b",
                "zamba2_7b", "whisper_large_v3", "rwkv6_7b",
                "deepseek_v2_lite"):
        importlib.import_module(f"repro_torch.configs.{mod}")
