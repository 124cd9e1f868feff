"""Plain PyTorch versions of the prefill and decode attention kernels.

``attend_torch`` is the port of the reference's ``models/attention.py::
attend_xla`` (the registry oracle of both attention kernels there):
position-masked GQA attention with float32 logits, a ``-1e30`` fill for
refused keys, and the probabilities rounded to v's dtype before P.V, as
``_gqa_combine`` does.  The reference's chunked branch for long sequences
(``models/chunked_attention.py``) only saves memory in the oracle; it is
not ported (ROADMAP).

Layouts, as the reference's ``kernels/flash_attention/ref.py``:
  * ``flash_ref`` (prefill): q (B, H, S, Dh), k/v (B, Kv, T, Dh); positions
    default to index-aligned (token i at position i), or (B, S)/(B, T)
    arrays with -1 = empty/pad;
  * ``decode_ref`` (serving decode): the model-native layout, q (B, 1, H, Dh),
    k/v (B, T, Kv, Dh) ring-buffer cache, q_pos (B, 1), k_pos (B, T).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def admitted(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
             window: int = 0) -> torch.Tensor:
    """(B, S, T) mask of the (query, key) pairs attention admits: the key
    slot is filled (``k_pos >= 0``), not after the query when causal, and
    within ``window`` positions when ``window > 0``."""
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & ((qp - kp) < window)
    return mask


def attend_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                 n_kv_heads: int, causal: bool,
                 window: int = 0) -> torch.Tensor:
    """q (B, S, H, Dh), k/v (B, T, Kv, Dh), q_pos (B, S), k_pos (B, T)
    -> (B, S, H, Dh) in q's dtype.  A query row that admits no key gets the
    uniform average of v, as the reference's oracle does."""
    b, s, h, dh = q.shape
    g = h // n_kv_heads
    qg = q.reshape(b, s, n_kv_heads, g, dh).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    logits = logits * (1.0 / math.sqrt(dh))
    mask = admitted(q_pos, k_pos, causal=causal, window=window)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    weights = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", weights.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def _index_positions(b: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(b, n)


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: Optional[torch.Tensor] = None,
              k_pos: Optional[torch.Tensor] = None, *, causal: bool = True,
              window: int = 0, k_index_aligned: bool = True) -> torch.Tensor:
    """q (B, H, S, Dh), k/v (B, Kv, T, Dh) -> (B, H, S, Dh).

    ``k_index_aligned`` only tells the kernel which blocks it may skip; the
    plain version visits every key, so it ignores it."""
    b, _, s, _ = q.shape
    t = k.shape[2]
    if (q_pos is None) != (k_pos is None):
        raise ValueError("pass both q_pos and k_pos, or neither")
    if q_pos is None:
        q_pos = _index_positions(b, s, q.device)
        k_pos = _index_positions(b, t, q.device)
    out = attend_torch(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), q_pos, k_pos,
                       n_kv_heads=k.shape[1], causal=causal, window=window)
    return out.transpose(1, 2)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor, *,
               window: int = 0) -> torch.Tensor:
    """q (B, 1, H, Dh), k/v (B, T, Kv, Dh), q_pos (B, 1), k_pos (B, T)
    -> like q."""
    return attend_torch(q, k, v, q_pos, k_pos, n_kv_heads=k.shape[2],
                        causal=True, window=window)
