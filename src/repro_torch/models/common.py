"""Shared building blocks: norms, RoPE, MLPs, initializers.

The port of ``repro/models/common.py``.  Params are plain dicts of tensors;
every module is an (init, apply) pair.  Norms accumulate in float32 whatever
the compute dtype, as the reference's do.  The init functions draw from an
explicit ``torch.Generator`` on an explicit device: the numbers differ from
``jax.random``'s, so tests carry the reference's weights across with
``repro_torch.models.transformer.params_from_jax`` instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device, scale: float = 1.0
               ) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def norm_init(d: int, kind: str, dtype: torch.dtype, device) -> Params:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6,
               bf16_mul: bool = False) -> torch.Tensor:
    """Norm with float32 reductions.  ``bf16_mul`` keeps the elementwise
    path in the compute dtype (only the statistics are float32)."""
    xf = x.float()
    if kind == "rmsnorm":
        rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        if bf16_mul:
            return x * rms.to(x.dtype) * p["scale"].to(x.dtype)
        out = xf * rms * p["scale"].float()
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        if bf16_mul:
            inv = torch.rsqrt(var + eps).to(x.dtype)
            return ((x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype)
                    + p["bias"].to(x.dtype))
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (GPT-NeoX half-rotation convention)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Computed
    in float32 and cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (Dh/2,)
    ang = positions[..., :, None, None].float() * freqs      # (..., S, 1, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str,
             dtype: torch.dtype, device, n_layers_scale: int = 1) -> Params:
    out_scale = 1.0 / math.sqrt(2 * n_layers_scale)
    if kind == "swiglu":
        return {"w_gate": dense_init(gen, d, d_ff, dtype, device),
                "w_up": dense_init(gen, d, d_ff, dtype, device),
                "w_down": dense_init(gen, d_ff, d, dtype, device, out_scale)}
    if kind == "gelu":
        return {"w_up": dense_init(gen, d, d_ff, dtype, device),
                "w_down": dense_init(gen, d_ff, d, dtype, device, out_scale)}
    raise ValueError(f"unknown mlp {kind!r}")


def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


def count_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return 0
