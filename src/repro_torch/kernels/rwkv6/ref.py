"""Plain PyTorch versions of the RWKV6 WKV: the port of the reference's
``models/rwkv.py::wkv_serial`` and ``::wkv_chunked``.

Recurrence per head (state S in R^{Dh x Dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = S_{t-1}^T r_t + (r_t . (u ⊙ k_t)) v_t
with w_t = exp(w_logdecay_t), w_logdecay = -exp(w_raw) <= 0 data-dependent,
and u a learned per-channel bonus.

  * ``wkv_serial``  — the exact per-token recurrence: the oracle, and the
                      model's one-token decode step on CPU tensors;
  * ``wkv_chunked`` — the chunked form the CUDA kernel computes: the
                      intra-chunk strict lower triangle by the direct
                      (C, C, Dh) contraction ``exp(lw_before[t] - lw_cum[s])``
                      (every valid exponent <= 0, the masked ones clamped to
                      0 so they cannot overflow), the state carried across
                      chunks.

Shapes: r, k, v and w_logdecay (B, H, S, Dh) float32 (any strides), u
(H, Dh), the state (B, H, Dh, Dv) float32.  Both return
``(y (B, H, S, Dv), final_state)`` and leave their inputs unchanged.

One difference from the reference: ``wkv_chunked`` takes any S >= 1.  A
ragged last chunk is padded with tokens whose r, k, v and log-decay are 0,
which change neither y nor the state, as the kernel masks them; the
reference raises unless S is a multiple of the chunk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _zero_state(r: torch.Tensor, dv: int) -> torch.Tensor:
    b, h, _, dh = r.shape
    return torch.zeros(b, h, dh, dv, dtype=torch.float32, device=r.device)


def wkv_serial(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w_logdecay: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact recurrence, one token at a time."""
    if state is None:
        state = _zero_state(r, v.shape[-1])
    bonus = u[None]                                    # (1, H, Dh)
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
        y = torch.einsum("bhd,bhdv->bhv", rt, state) \
            + (rt * (bonus * kt)).sum(-1)[..., None] * vt
        state = torch.exp(w_logdecay[:, :, t])[..., None] * state \
            + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    return torch.stack(ys, dim=2), state


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w_logdecay: torch.Tensor, u: torch.Tensor,
                state: Optional[torch.Tensor] = None, chunk: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked form: O(S C) intra-chunk + O(S / C Dh Dv) inter-chunk work,
    one chunk at a time, so the largest intermediate is one chunk's
    (B, H, C, C, Dh) decay factor."""
    b, h, s, dh = r.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    if state is None:
        state = _zero_state(r, v.shape[-1])
    if pad:
        r, k, v, w_logdecay = (F.pad(a, (0, 0, 0, pad))
                               for a in (r, k, v, w_logdecay))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.float32,
                                device=r.device), -1)
    bonus = u[None, :, None, :]                        # (1, H, 1, Dh)
    ys = []
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        rc, kc, vc, lwc = (a[:, :, part] for a in (r, k, v, w_logdecay))
        lw_cum = torch.cumsum(lwc, dim=2)              # (B, H, C, Dh)
        lw_before = lw_cum - lwc                       # sum over s < t
        cw = lw_cum[:, :, -1:, :]                      # chunk total decay

        # intra-chunk strict lower triangle; the masked s >= t exponents
        # are positive and would overflow to inf (inf * 0 = NaN), so clamp
        expdiff = torch.exp(torch.clamp_max(
            lw_before[:, :, :, None, :] - lw_cum[:, :, None, :, :], 0.0))
        a = torch.einsum("bhtd,bhsd,bhtsd->bhts", rc, kc, expdiff) * tri
        diag = torch.einsum("bhtd,bhtd->bht", rc, bonus * kc)
        y = torch.einsum("bhts,bhsv->bhtv", a, vc) + diag[..., None] * vc

        # inter-chunk: the state decayed to each token, then carried on
        y = y + torch.einsum("bhtd,bhdv->bhtv", rc * torch.exp(lw_before),
                             state)
        k_dec = kc * torch.exp(cw - lw_cum)            # decay to chunk end
        state = torch.exp(cw[:, :, 0, :])[..., None] * state \
            + torch.einsum("bhsd,bhsv->bhdv", k_dec, vc)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :s], state
