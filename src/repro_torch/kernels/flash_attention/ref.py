"""Plain PyTorch versions of the prefill and decode attention kernels.

``attend_torch`` is the port of the reference's ``models/attention.py::
attend_xla`` (the registry oracle of both attention kernels there):
position-masked GQA attention with float32 logits, a ``-1e30`` fill for
refused keys, and the probabilities rounded to v's dtype before P.V, as
``_gqa_combine`` does.  It is the kernels' plain version at every length:
the reference's chunked branch for long sequences is the model's
(``repro_torch/models/chunked_attention.py``, which ``models/attention.py``
dispatches to on its ``torch`` route), not the kernels' oracle.

Layouts, as the reference's ``kernels/flash_attention/ref.py``:
  * ``flash_ref`` (prefill): q (B, H, S, Dh), k/v (B, Kv, T, Dh); positions
    default to index-aligned (token i at position i), or (B, S)/(B, T)
    arrays with -1 = empty/pad;
  * ``decode_ref`` (serving decode): the model-native layout, q (B, 1, H, Dh),
    k/v (B, T, Kv, Dh) ring-buffer cache, q_pos (B, 1), k_pos (B, T).

``decode_split`` mirrors the decode kernel's decomposition in plain
PyTorch (the cache cut into chunks of ``bkv`` slots, an empty chunk skipped,
the partials combined in chunk order), so that the CPU tests show the
algorithm right, not only the kernel.
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


def keyless(v: torch.Tensor) -> torch.Tensor:
    """v (B, Kv, T, Dh) -> (B, Kv, Dh) float32: what ``attend_torch`` gives
    a query row that admits no key.  Every logit of such a row is the same
    ``NEG_INF`` fill, so the softmax weighs each of the T slots 1 / T,
    rounded to v's dtype like every probability, empty slots included."""
    w = torch.tensor(1.0 / v.shape[2]).to(v.dtype).float()
    return v.float().sum(2) * w


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


def decode_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                 window: int = 0, bkv: int = 128) -> torch.Tensor:
    """``decode_ref``'s function as the decode kernel computes it.

    Each chunk of ``bkv`` cache slots (its boundaries depend on T alone)
    gives a partial (m, l, acc) of each query head: the max of its admitted
    logits, the sum of their exps and the exps (rounded to v's dtype) times
    v.  A chunk that admits no key of a row gives m = -1e30, l = 0 and no
    acc.  The combine takes the chunks in order, skips the empty ones and
    rescales the rest to the overall max.  A row that admits no key gets
    ``keyless``, as the kernel writes it."""
    b, _, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, dh).float()
    mask = admitted(q_pos, k_pos, causal=True, window=window)[:, 0]  # (B, T)
    scale = 1.0 / math.sqrt(dh)
    parts = []
    for t0 in range(0, t, bkv):
        part = slice(t0, min(t0 + bkv, t))
        ok = mask[:, part]
        logits = torch.einsum("bkgd,btkd->bkgt", qg, k[:, part].float())
        logits = (logits * scale).masked_fill(~ok[:, None, None],
                                              float("-inf"))
        m = logits.amax(-1).clamp_min(NEG_INF)             # (B, Kv, G)
        e = torch.exp(logits - m[..., None])               # refused: 0
        acc = torch.einsum("bkgt,btkd->bkgd", e.to(v.dtype).float(),
                           v[:, part].float())
        parts.append((ok.any(-1)[:, None, None], m, e.sum(-1), acc))
    mx = torch.stack([m for _, m, _, _ in parts]).amax(0)
    l_sum = torch.zeros_like(mx)
    out = torch.zeros(b, kv, g, dh, dtype=torch.float32, device=q.device)
    for live, m, l_part, acc in parts:
        w = torch.exp(m - mx)
        l_sum = torch.where(live, l_sum + l_part * w, l_sum)
        out = torch.where(live[..., None], out + acc * w[..., None], out)
    out = torch.where(l_sum[..., None] > 0,
                      out / l_sum.clamp_min(1e-30)[..., None],
                      keyless(v.transpose(1, 2))[:, :, None])
    return out.reshape(b, 1, h, dh).to(q.dtype)
