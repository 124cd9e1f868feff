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
    # the target's logit as a masked sum over the vocab, not a gather: the
    # same bits (one term and exact zeros), and a vocab-sharded DTensor
    # sums it locally, where its gather rule fails
    vocab = torch.arange(lf.shape[-1], dtype=torch.int32, device=lf.device)
    is_gold = vocab == targets.long()[..., None]
    gold = lf.masked_fill(~is_gold, 0.0).sum(dim=-1)
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
        # argmax as the first index that holds the max: two reductions a
        # vocab-sharded DTensor combines with small all-reduces
        top = lf.amax(dim=-1, keepdim=True)
        first = torch.where(lf == top, vocab, lf.shape[-1]).amin(dim=-1)
        hit = (first == targets).float()
        acc = (hit * mask).sum() / denom
    return loss, {"nll": (nll * mask).sum() / denom, "accuracy": acc,
                  "z_loss": (zl * mask).sum() / denom}
