"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab_size=49155, head_dim=128, norm="rmsnorm", mlp="swiglu",
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, norm="rmsnorm", mlp="swiglu",
)
