"""Losses: causal-LM cross entropy with float32 logsumexp and z-loss.

The port of ``repro/training/losses.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, z_loss: float = 1e-4,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B, S, V) any float dtype; targets (B, S) integer.

    mask (B, S) float weights (1 = real token).  Returns (scalar, metrics):
    the mean of nll + z_loss * lse^2 over the mask, and its ``nll``,
    ``accuracy`` and ``z_loss`` parts (0-d float32 tensors, on the device:
    nothing is read back to the host).
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    zl = z_loss * torch.square(lse)
    per_tok = nll + zl
    if mask is None:
        mask = torch.ones(per_tok.shape, dtype=torch.float32,
                          device=per_tok.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / denom
    with torch.no_grad():
        hit = (lf.argmax(dim=-1) == targets).float()
        acc = (hit * mask).sum() / denom
    return loss, {"nll": (nll * mask).sum() / denom, "accuracy": acc,
                  "z_loss": (zl * mask).sum() / denom}
