"""Flash-style chunked attention in plain PyTorch (differentiable).

The port of ``repro/models/chunked_attention.py``: the training path for
every sequence of 2048 tokens or more (``models/attention.py`` dispatches
here on its ``torch`` route, under the reference's condition).  A Python
loop over query chunks, each running an inner loop over exactly the key
chunks its causal or window mask can reach (the reference's static ranges,
so the work matches the true triangular cost), with online-softmax
accumulation: peak memory O(q_chunk x k_chunk) a head.  Autograd
differentiates it as it stands; there is no hand-made backward.

Assumption (true for training and prefill): token i of the q/k tensors
holds position base + i, so a key chunk is skipped by its index.  The
caller takes this path only when ``k_index_aligned`` says so.

``attend_chunked.calls`` counts the calls (a layer recomputed by
activation checkpointing calls it again).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   n_kv_heads: int, causal: bool, window: int = 0,
                   q_chunk: int = 1024, k_chunk: int = 1024,
                   bf16_intermediates: bool = False) -> torch.Tensor:
    """Same contract as ``attention.attend``: q (B, S, H, Dh), k/v
    (B, T, Kv, Dh), q_pos (B, S), k_pos (B, T) -> (B, S, H, Dh) in q's
    dtype.

    The tiles are float32; ``bf16_intermediates`` keeps q, k, v and the
    probability tiles in bfloat16 with float32 accumulation (the products
    of bfloat16 values are exact in float32, as the reference's
    ``preferred_element_type=float32`` contractions are).
    """
    attend_chunked.calls += 1
    b, s, h, dh = q.shape
    t = k.shape[1]
    kv = n_kv_heads
    g = h // kv
    q_chunk = min(q_chunk, s)
    k_chunk = min(k_chunk, t)
    if s % q_chunk or t % k_chunk:
        raise ValueError(f"seq {s}/{t} not divisible by chunks "
                         f"{q_chunk}/{k_chunk}")
    nq, nk = s // q_chunk, t // k_chunk
    scale = 1.0 / math.sqrt(dh)
    io_dtype = torch.bfloat16 if bf16_intermediates else torch.float32
    kf, vf = k.to(io_dtype), v.to(io_dtype)

    outs = []
    for qi in range(nq):
        q_lo = qi * q_chunk
        qc = q[:, q_lo:q_lo + q_chunk].to(io_dtype) \
            .reshape(b, q_chunk, kv, g, dh)
        qp = q_pos[:, q_lo:q_lo + q_chunk]

        # the key-chunk range this query chunk can reach
        hi = min(nk, (q_lo + q_chunk + k_chunk - 1) // k_chunk) if causal \
            else nk
        lo = max(0, (q_lo - (window - 1)) // k_chunk) if window else 0

        m = torch.full((b, q_chunk, kv, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, q_chunk, kv, g), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, q_chunk, kv, g, dh), dtype=torch.float32,
                          device=q.device)
        for ki in range(lo, hi):
            start = ki * k_chunk
            kb = kf[:, start:start + k_chunk]
            vb = vf[:, start:start + k_chunk]
            kp = k_pos[:, start:start + k_chunk]
            logits = torch.einsum("bqkgd,btkd->bqkgt", qc.float(),
                                  kb.float()) * scale
            pm = kp[:, None, :] >= 0
            if causal:
                pm = pm & (kp[:, None, :] <= qp[:, :, None])
            if window:
                pm = pm & ((qp[:, :, None] - kp[:, None, :]) < window)
            logits = logits.masked_fill(~pm[:, :, None, None, :], NEG_INF)

            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None]).to(io_dtype)
            l = l * corr + p.sum(dim=-1, dtype=torch.float32)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgt,btkd->bqkgd", p.float(), vb.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.reshape(b, q_chunk, h, dh))

    return torch.cat(outs, dim=1).to(q.dtype)


attend_chunked.calls = 0
