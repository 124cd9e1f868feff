"""Model configuration schema: the port's own copy of the reference's
``repro/configs/base.py`` (which imports ``jax.numpy``).

The same field names and defaults; ``pdtype()`` and ``cdtype()`` return
``torch.dtype``.  ``attn_backend`` names a registry attention backend
(``"torch"`` | ``"cuda"``); None means the default for the tensors' device:
the CUDA kernels for CUDA tensors, the plain versions for CPU tensors (see
``repro_torch.models.attention.resolve_attention_backend``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact assigned dims live in
    configs/<id>.py)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 => attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0               # routed experts (0 => dense MLP)
    n_shared_experts: int = 0
    top_k: int = 0
    dense_prefix_layers: int = 0     # deepseek-moe: first layer(s) dense
    moe_capacity_factor: float = 1.25

    # --- hybrid / ssm ---
    ssm_state: int = 0               # mamba state per channel (hymba)
    window: int = 0                  # sliding-window size; 0 = full attention
    global_layers: Tuple[int, ...] = ()   # hymba full-attention layer ids
    rwkv: bool = False

    # --- encoder-decoder / multimodal frontends ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_frames: int = 1500
    frontend: str = "none"           # none | audio_stub | vision_stub
    n_patches: int = 0

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # embedding tables are padded to this multiple; padded logits are
    # masked before sampling
    vocab_pad_multiple: int = 256

    # --- the reference's performance levers (False => paper-faithful) ---
    attn_bf16_intermediates: bool = False
    zero1_weights: bool = False
    moe_stopgrad_dispatch: bool = False
    # norm elementwise path in the compute dtype (reductions stay fp32)
    norm_bf16_mul: bool = False

    # --- serving attention dispatch ---
    attn_backend: Optional[str] = None

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def attention_free(self) -> bool:
        return self.rwkv

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-SWA / linear attention)."""
        return self.rwkv or (self.window > 0)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def dense_ff(self) -> int:
        """Hidden size of dense (prefix) MLP layers for MoE archs."""
        if not self.is_moe:
            return self.d_ff
        return self.d_ff * (self.top_k + max(self.n_shared_experts, 1))

    def active_params(self) -> float:
        """Approximate active parameter count (for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> float:
        return _param_count(self, active_only=False)



@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

def _param_count(cfg: ModelConfig, active_only: bool) -> float:
    d, L = cfg.d_model, cfg.n_layers
    n = 0.0
    # embeddings (+ unembed)
    n += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.rwkv:
        # time-mix: r,k,v,g,o projections ~5 d^2 + decay lora; channel mix ~3*d*dff
        per_layer = 5 * d * d + 3 * d * cfg.d_ff + 2 * d * 96
    else:
        hd = cfg.head_dim
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
            + cfg.n_heads * hd * d
        if cfg.is_moe:
            e_active = (cfg.top_k + cfg.n_shared_experts) if active_only \
                else (cfg.n_experts + cfg.n_shared_experts)
            mult = 3 if cfg.mlp == "swiglu" else 2
            mlp = e_active * mult * d * cfg.d_ff + d * cfg.n_experts
        else:
            mult = 3 if cfg.mlp == "swiglu" else 2
            mlp = mult * d * cfg.d_ff
        per_layer = attn + mlp
        if cfg.ssm_state:  # hymba parallel ssm head
            d_in = cfg.n_heads * hd
            per_layer += d * d_in + d_in * (2 * cfg.ssm_state + 2) + d_in * d
    n += L * per_layer
    if cfg.is_encoder_decoder:
        # encoder layers + cross attention in decoder
        enc = cfg.n_encoder_layers * per_layer
        cross = L * (2 * d * cfg.n_kv_heads * cfg.head_dim
                     + 2 * d * cfg.n_heads * cfg.head_dim)
        n += enc + cross
    return n
