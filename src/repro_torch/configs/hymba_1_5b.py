"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].

Per the paper: three global-attention layers (first / middle / last), the
rest sliding-window (w=1024); every layer fuses the attention branch with a
parallel Mamba branch (mean of the normalized branch outputs)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64, norm="rmsnorm", mlp="swiglu",
    ssm_state=16, window=1024, global_layers=(0, 15, 31),
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, norm="rmsnorm", mlp="swiglu",
    ssm_state=4, window=16, global_layers=(0, 2),
)
