"""Mamba-style selective SSM head (hymba's parallel-to-attention branch).

The port of ``repro/models/ssm.py``:

    h_t = exp(dt_t * A) ⊙ h_{t-1} + (dt_t * B_t) * x_t    (N states a channel)
    y_t = C_t · h_t + D ⊙ x_t
    out = y * silu(z)

A causal depthwise conv (width 4) precedes the SSM, as in Mamba.  The
reference's prefill runs ``jax.lax.associative_scan``; PyTorch has none, so
the scan here is a log-depth doubling scan (Hillis-Steele over S) in
float32, plain PyTorch, with no host sync.  Its summation order differs
from JAX's tree, so the two agree to float32 rounding, not bit for bit.
Decode (S = 1) is the O(1) update: the incoming state folded into the one
element is the whole scan.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init

CONV_WIDTH = 4


def ssm_init(gen: torch.Generator, d_model: int, d_inner: int, n_state: int,
             dtype: torch.dtype, device, n_layers_scale: int = 1) -> Params:
    dt_rank = max(d_model // 16, 8)
    out_scale = 1.0 / math.sqrt(2 * n_layers_scale)
    conv = torch.randn(CONV_WIDTH, d_inner, generator=gen, device=device,
                       dtype=torch.float32) * 0.2
    a = torch.arange(1, n_state + 1, dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, d_model, 2 * d_inner, dtype, device),
        "conv": conv.to(dtype),
        "w_bc": dense_init(gen, d_inner, 2 * n_state, dtype, device),
        "w_dt1": dense_init(gen, d_inner, dt_rank, dtype, device),
        "w_dt2": dense_init(gen, dt_rank, d_inner, dtype, device),
        # softplus^-1(0.01)
        "dt_bias": torch.full((d_inner,), -4.6, dtype=dtype, device=device),
        "a_log": torch.log(a).repeat(d_inner, 1).to(dtype),    # (Di, N)
        "d_skip": torch.ones(d_inner, dtype=dtype, device=device),
        "w_out": dense_init(gen, d_inner, d_model, dtype, device, out_scale),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise conv, width CONV_WIDTH.  x (B, S, Di); state (B, W-1, Di).
    Returns (out, the last W-1 inputs: the next call's state)."""
    b, s, di = x.shape
    if conv_state is None:
        conv_state = torch.zeros(b, CONV_WIDTH - 1, di, dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, CONV_WIDTH):      # the reference's order of the sum
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -(CONV_WIDTH - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, for every t:
    ceil(log2 S) doubling passes, each combining element t with t - d
    as ``(a_{t-d} a_t, a_t b_{t-d} + b_t)``."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:       # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def ssm_apply(p: Params, x: torch.Tensor, *,
              state: Optional[torch.Tensor] = None,
              conv_state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, S, D) -> (out (B, S, D), (ssm_state (B, Di, N) float32,
    conv_state (B, W-1, Di)))."""
    xz = x @ p["w_in"]
    xs, z = xz.chunk(2, dim=-1)                         # (B, S, Di) each
    xs, new_conv = causal_conv(xs, p["conv"], conv_state)
    xs = F.silu(xs)

    bc = xs @ p["w_bc"]
    b_t, c_t = bc.float().chunk(2, dim=-1)              # (B, S, N)
    # jax.nn.softplus is log(1 + e^x) with no linear threshold
    dt_in = (xs @ p["w_dt1"]) @ p["w_dt2"] + p["dt_bias"]
    dt = torch.logaddexp(dt_in.float(), torch.zeros((), device=x.device))
    dt = dt.to(x.dtype).float()
    a_mat = -torch.exp(p["a_log"].float())              # (Di, N)

    # scan elements: h_t = a_t ⊙ h_{t-1} + b_t
    a = torch.exp(dt[..., None] * a_mat)                # (B, S, Di, N)
    bmat = (dt * xs.float())[..., None] * b_t[:, :, None, :]
    if state is not None:
        # fold the incoming state into the first element
        bmat = torch.cat([bmat[:, :1] + a[:, :1] * state[:, None],
                          bmat[:, 1:]], dim=1)
    h = linear_scan(a, bmat)
    y = torch.einsum("bsdn,bsn->bsd", h, c_t) \
        + xs.float() * p["d_skip"].float()
    out = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return out, (h[:, -1], new_conv)
