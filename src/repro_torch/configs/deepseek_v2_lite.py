"""DeepSeek-V2-Lite — latent attention, 64 routed experts top-6 and 2 shared,
one dense lead layer [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite].

Port-only configs (``register(..., port_only=True)``): the reference
package has no latent attention.  ``deepseek-v2-lite-ep8`` is one device's
share of an 8-way expert-parallel deployment: experts 0-7 of the router's
64 and an eighth of the vocabulary (the embedding and the head split over
the same 8 devices), every layer and every width as published.
"""
import dataclasses

from repro_torch.models.config import MLAConfig, register

CONFIG = register(MLAConfig(
    name="deepseek-v2-lite", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    num_experts=64, experts_per_token=6,
    rope_theta=1e4, act="silu", norm_eps=1e-6, tie_embeddings=False,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, n_shared_experts=2, first_k_dense=1, dense_d_ff=10944,
    router_experts=64, norm_topk_prob=False,
    yarn_factor=40.0, yarn_original_max_position=4096, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
), port_only=True)

EP8 = register(dataclasses.replace(
    CONFIG, name="deepseek-v2-lite-ep8", num_experts=8, vocab_size=12800),
    port_only=True)
