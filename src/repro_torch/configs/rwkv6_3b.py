"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
— Finch — data-dependent decay [arXiv:2404.05892; hf].

Attention-free; O(1)-state decode."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=8960,
    vocab_size=65536, head_dim=64, norm="layernorm", mlp="swiglu",
    rwkv=True, use_rope=False,
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, d_ff=448,
    vocab_size=256, head_dim=64, norm="layernorm", mlp="swiglu",
    rwkv=True, use_rope=False,
)
