"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo [hf:mistralai/Pixtral-12B-2409;
unverified].

The vision frontend is a stub: the caller supplies precomputed patch
embeddings (B, patches, 5120), added at the sequence head
(``forward(patches=)``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=131072, head_dim=128, norm="rmsnorm", mlp="swiglu",
    frontend="vision_stub", n_patches=256,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, norm="rmsnorm", mlp="swiglu",
    frontend="vision_stub", n_patches=8,
)
