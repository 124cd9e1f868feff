"""Error-feedback int8 gradient compression.

The port of ``repro/optim/compression.py``: quantize (grad + residual) to
int8 with a per-tensor scale, hand on the dequantized value, and carry the
quantization error forward (EF-SGD).  Off by default; enabled by
``TrainConfig.compress_pod_grads``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so the int8 payloads are the reference's bit for bit.
The scale is per tensor, as there; the port's parameter tree holds a
tensor a layer where the reference stacks a segment's layers into one, so
a segment's layers get a scale each here.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import leaves, unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Returns (compressed-dequantized grads, new residual)."""

    def one(g, r):
        gf = g.float() + r
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def init_residual(params: Any) -> Any:
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for p in leaves(params)])
