"""Plain PyTorch versions of the RWKV6 WKV: the port of the reference's
``models/rwkv.py::wkv_serial`` and ``::wkv_chunked``.

Recurrence per head (state S in R^{Dh x Dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = S_{t-1}^T r_t + (r_t . (u ⊙ k_t)) v_t
with w_t = exp(w_logdecay_t), w_logdecay = -exp(w_raw) <= 0 data-dependent,
and u a learned per-channel bonus.

  * ``wkv_serial``  — the exact per-token recurrence: the oracle, and the
                      model's one-token decode step on CPU tensors;
  * ``wkv_chunked`` — the chunked form: the intra-chunk strict lower
                      triangle by the direct (C, C, Dh) contraction
                      ``exp(lw_before[t] - lw_cum[s])`` (every valid
                      exponent <= 0, the masked ones clamped to 0 so they
                      cannot overflow), the state carried across chunks
                      one chunk at a time: the CPU path of ``kernel.wkv``;
  * ``wkv_step``, ``wkv_chunk_parallel`` — plain mirrors of the CUDA
                      kernels' arithmetic (S == 1, and S > 1 in three
                      phases with the triangle factored at sub-chunk
                      edges), so that the CPU tests show the decomposition
                      right, not only the kernel.

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


#: tokens of a sub-chunk of the chunk kernels' triangle (``csrc/rwkv6.cu``)
SUB = 8


def wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w_logdecay: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token (S == 1) as ``wkv_step_kernel`` computes it:
    y[j] = sum_d r[d] (S[d, j] + u[d] k[d] v[j]),
    S[d, j] <- exp(w[d]) S[d, j] + k[d] v[j]."""
    if r.shape[2] != 1:
        raise ValueError(f"wkv_step takes one token, not {r.shape[2]}")
    if state is None:
        state = _zero_state(r, v.shape[-1])
    rt, kt, vt, wt = (a[:, :, 0] for a in (r, k, v, w_logdecay))
    bonus = rt * (u[None] * kt)                        # (B, H, Dh)
    y = (rt[..., None] * state
         + bonus[..., None] * vt[:, :, None, :]).sum(2)
    state = torch.exp(wt)[..., None] * state + kt[..., None] * vt[:, :, None]
    return y[:, :, None], state


def wkv_chunk_parallel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w_logdecay: torch.Tensor, u: torch.Tensor,
                       state: Optional[torch.Tensor] = None, chunk: int = 64,
                       sub: int = SUB) -> Tuple[torch.Tensor, torch.Tensor]:
    """S > 1 as the three chunk kernels compute it.

    1. every chunk's state increment dS_c = (k exp(cw - lw_cum))^T v and
       exp(cw), all chunks at once;
    2. the scan S_c+1 = diag(exp(cw_c)) S_c + dS_c, keeping each S_c;
    3. every chunk's y = A v + diag(r . (u k)) v + r exp(lw_before) S_c,
       the triangle A cut into sub-chunks of ``sub`` tokens: a diagonal
       block in the direct form, an off-diagonal block (s in J before t's
       I) as r~ diag(exp(B_I - E_J)) k~^T with r~ = r exp(lw_before - B_I)
       and k~ = k exp(E_J - lw_cum), where E_J is lw_cum at J's last token
       and B_I = E_(I-1) (0 for I = 0): every exponent <= 0.
    """
    b, h, s, dh = r.shape
    dv = v.shape[-1]
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a multiple of {sub}")
    n, ns = -(-s // chunk), chunk // sub
    if state is None:
        state = _zero_state(r, dv)
    pad = n * chunk - s
    rc, kc, vc, lwc = (F.pad(a, (0, 0, 0, pad)).reshape(b, h, n, chunk, -1)
                       for a in (r, k, v, w_logdecay))
    lc = torch.cumsum(lwc, dim=3)                      # (B, H, n, C, Dh)
    lb = lc - lwc
    cw = lc[:, :, :, -1]                               # (B, H, n, Dh)

    delta = torch.einsum("bhnsd,bhnsv->bhndv",
                         kc * torch.exp(cw[:, :, :, None] - lc), vc)
    starts = []
    for c in range(n):
        starts.append(state)
        state = torch.exp(cw[:, :, c])[..., None] * state + delta[:, :, c]
    s_c = torch.stack(starts, dim=2)                   # (B, H, n, Dh, Dv)

    edge = lc[:, :, :, sub - 1::sub]                   # E_J: (B, H, n, ns, Dh)
    start = F.pad(edge[:, :, :, :-1], (0, 0, 1, 0))    # B_I, B_0 = 0
    r_t = rc * torch.exp(lb - start.repeat_interleave(sub, dim=3))
    k_t = kc * torch.exp(edge.repeat_interleave(sub, dim=3) - lc)
    a = rc.new_zeros(b, h, n, chunk, chunk)
    tri = torch.tril(torch.ones(sub, sub, dtype=r.dtype, device=r.device), -1)
    for i in range(ns):
        rows = slice(i * sub, (i + 1) * sub)
        for j in range(i):
            cols = slice(j * sub, (j + 1) * sub)
            x = torch.exp(start[:, :, :, i] - edge[:, :, :, j])
            a[..., rows, cols] = torch.einsum(
                "bhntd,bhnd,bhnsd->bhnts", r_t[..., rows, :], x,
                k_t[..., cols, :])
        expdiff = torch.exp(torch.clamp_max(
            lb[..., rows, None, :] - lc[..., None, rows, :], 0.0))
        a[..., rows, rows] = torch.einsum(
            "bhntd,bhnsd,bhntsd->bhnts", rc[..., rows, :], kc[..., rows, :],
            expdiff) * tri
    diag = torch.einsum("bhntd,bhntd->bhnt", rc, u[None, :, None, None] * kc)
    y = torch.einsum("bhnts,bhnsv->bhntv", a, vc) + diag[..., None] * vc
    y = y + torch.einsum(
        "bhntd,bhndv->bhntv",
        r_t * torch.exp(start).repeat_interleave(sub, dim=3), s_c)
    return y.reshape(b, h, n * chunk, dv)[:, :, :s], state


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
