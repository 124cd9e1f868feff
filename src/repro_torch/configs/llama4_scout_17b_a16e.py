"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 — 16 routed top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Early-fusion multimodality is the same token-level stub as pixtral
(the caller supplies patch embeddings)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128, norm="rmsnorm", mlp="swiglu",
    n_experts=16, n_shared_experts=1, top_k=1,
    frontend="vision_stub", n_patches=256,
)

SMOKE = ModelConfig(
    name="llama4-scout-17b-a16e-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=256, head_dim=16, norm="rmsnorm", mlp="swiglu",
    n_experts=4, n_shared_experts=1, top_k=1,
    frontend="vision_stub", n_patches=8,
    moe_capacity_factor=8.0,
)
