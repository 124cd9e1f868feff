"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained,
first layer dense [arXiv:2401.06066; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, head_dim=128, norm="rmsnorm", mlp="swiglu",
    n_experts=64, n_shared_experts=2, top_k=6, dense_prefix_layers=1,
)

# smoke: high capacity factor => dropless routing, so decode == prefill
# exactly (capacity-drop behaviour is covered by dedicated MoE tests)
SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=256, head_dim=16, norm="rmsnorm", mlp="swiglu",
    n_experts=8, n_shared_experts=2, top_k=2, dense_prefix_layers=1,
    moe_capacity_factor=8.0,
)
