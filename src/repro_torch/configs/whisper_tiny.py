"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865
— enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

The conv frontend is a stub: the caller supplies precomputed frame
embeddings (B, frames, 384) (``forward(frames=)``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865, head_dim=64, norm="layernorm", mlp="gelu",
    use_rope=False, is_encoder_decoder=True, n_encoder_layers=4,
    encoder_frames=1500, frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16, norm="layernorm", mlp="gelu",
    use_rope=False, is_encoder_decoder=True, n_encoder_layers=2,
    encoder_frames=24, frontend="audio_stub",
)
