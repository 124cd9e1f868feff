"""Allocation-free input specs for every (arch x shape) cell.

The port of ``repro/launch/specs.py``: where the reference builds
``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``, the port builds the
same trees of tensors on the ``meta`` device, which carry a shape and a
dtype and no storage; the model's own ``init_params`` / ``init_caches`` /
``make_train_state`` make them, so a full-size 95-layer model costs
nothing.  The parameters are the reference's float32 (``cfg.pdtype()``),
cast to the compute dtype where each layer uses them; a train state holds
them as float32 masters with the AdamW moments.  Modality frontends are
stubs: ``frames`` / ``patches`` are precomputed embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import init_caches, init_params
from repro_torch.training.train_step import TrainConfig, make_train_state

__all__ = ["sds", "modality_specs", "train_batch_specs", "train_state_specs",
           "params_specs", "cache_specs", "prefill_input_specs",
           "decode_input_specs"]


def sds(shape, dtype) -> torch.Tensor:
    """The counterpart of ``jax.ShapeDtypeStruct``: a ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def modality_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        out["frames"] = sds((batch, cfg.encoder_frames, cfg.d_model),
                            cfg.cdtype())
    if cfg.frontend == "vision_stub":
        out["patches"] = sds((batch, cfg.n_patches, cfg.d_model),
                             cfg.cdtype())
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32),
             "targets": sds((b, s), torch.int32),
             "mask": sds((b, s), torch.float32)}
    batch.update(modality_specs(cfg, b))
    return batch


def params_specs(cfg: ModelConfig) -> Any:
    return init_params(cfg, torch.Generator().manual_seed(0), "meta",
                       dtype=cfg.pdtype())


def train_state_specs(cfg: ModelConfig, tcfg: TrainConfig) -> Dict[str, Any]:
    return make_train_state(params_specs(cfg), tcfg)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    return init_caches(cfg, batch, cache_len, "meta")


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": sds((b, s), torch.int32), **modality_specs(cfg, b)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, Any]:
    """One-new-token serve step with a KV cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": sds((b, 1), torch.int32),
             "positions": sds((b, 1), torch.int32),
             "caches": cache_specs(cfg, b, s)}
    if cfg.is_encoder_decoder:
        specs["memory"] = sds((b, cfg.encoder_frames, cfg.d_model),
                              cfg.cdtype())
    return specs
