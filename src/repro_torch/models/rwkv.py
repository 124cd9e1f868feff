"""RWKV6 ("Finch") block: data-dependent-decay linear attention.

The port of ``repro/models/rwkv.py``'s layer: ``rwkv_layer_init``,
``time_mix_apply`` (the WKV) and ``channel_mix_apply``.  The WKV itself has
three forms, all computing the same recurrence (``kernels/rwkv6/ref.py``
says it):

  * ``ref.wkv_serial``  — the exact per-token recurrence;
  * ``ref.wkv_chunked`` — the chunked form, the plain version of the kernel;
  * ``kernel.wkv``      — the CUDA C++ kernel of the chunked form.

Which one runs follows ``resolve_wkv_backend``: on CUDA tensors the kernel,
at every S (a prompt, a ragged prompt and the one-token decode step alike),
with the state read from and written into the caller's state tensor in
place; on CPU tensors the plain versions, with the reference's choice
(chunked for ``S % chunk == 0 and S > 1``, serial otherwise).  ``"torch"``
asks for the plain versions on any device, ``"cuda"`` on CPU tensors raises
``BackendUnavailableError``: nothing falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

import repro_torch.kernels.rwkv6.ops  # noqa: F401  (registers rwkv6.wkv)
from repro_torch.core.portable import (BackendUnavailableError, get_kernel,
                                       kernel_call)
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ref
from repro_torch.models.common import (Params, apply_norm, dense_init,
                                       norm_init)

W_RAW_CLAMP = (-8.0, 1.0)   # log-log decay clamp, keeps exp() sane
LORA_RANK = 32
DECAY_LORA_RANK = 64
WKV_BACKENDS = ("torch", "cuda")


def rwkv_layer_init(gen: torch.Generator, d: int, d_ff: int, n_heads: int,
                    dtype: torch.dtype, device,
                    n_layers_scale: int = 1) -> Params:
    hd = d // n_heads
    out_scale = 1.0 / math.sqrt(2 * n_layers_scale)

    def small(*shape):
        w = torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def dense(d_in, d_out, scale=1.0):
        return dense_init(gen, d_in, d_out, dtype, device, scale)

    return {
        "tm": {  # time mix
            "mu": small(5, d),                         # r,k,v,g,w lerps
            "lora_a": small(d, 5 * LORA_RANK),
            "lora_b": small(5, LORA_RANK, d),
            "w0": torch.full((d,), -1.5, dtype=dtype, device=device),
            "w_a": small(d, DECAY_LORA_RANK),
            "w_b": small(DECAY_LORA_RANK, d),
            "u": small(n_heads, hd),                   # bonus
            "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
            "wg": dense(d, d), "wo": dense(d, d, out_scale),
            "ln_x": norm_init(hd, "layernorm", dtype, device),  # per head
        },
        "cm": {  # channel mix
            "mu_k": small(d),
            "mu_r": small(d),
            "wk": dense(d, d_ff),
            "wv": dense(d_ff, d, out_scale),
            "wr": dense(d, d),
        },
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """prev-token x; ``last`` (B, 1, D) is the final token of the previous
    call."""
    return torch.cat([last, x[:, :-1]], dim=1)


def resolve_wkv_backend(backend: Optional[str], device) -> str:
    """The WKV backend for tensors on ``device``: ``backend`` when given,
    else the kernel (``"cuda"``) for CUDA tensors and the plain versions
    (``"torch"``) otherwise.  An unknown name raises ``KeyError``; the
    kernel where it cannot run (CPU tensors, no CUDA device, no nvcc)
    raises ``BackendUnavailableError``."""
    on_cuda = torch.device(device).type == "cuda"
    req = backend or ("cuda" if on_cuda else "torch")
    if req not in WKV_BACKENDS:
        raise KeyError(f"unknown WKV backend {req!r}; have {WKV_BACKENDS}")
    if req == "torch":
        return req
    if not on_cuda:
        raise BackendUnavailableError(
            f"the WKV backend 'cuda' runs on CUDA tensors, not on {device}; "
            f"ask for 'torch' to run the plain version")
    reason = get_kernel("rwkv6.wkv").backend("cuda").unavailable_reason()
    if reason is not None:
        raise BackendUnavailableError(
            f"the WKV backend 'cuda' is not available: {reason}")
    return req


def time_mix_apply(p: Params, x: torch.Tensor, n_heads: int, *,
                   state: Optional[torch.Tensor] = None,
                   last_x: Optional[torch.Tensor] = None, chunk: int = 64,
                   use_chunked: bool = True,
                   wkv_backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """x (B, S, D); state (B, H, Dh, Dv) float32 or None (zeros); last_x
    (B, 1, D) or None (zeros).  Returns (out, (new_state, new_last_x)).

    On the kernel's path ``new_state`` is ``state`` itself, updated in
    place (a new tensor when ``state`` is None); the plain versions return
    a new tensor and leave ``state`` as it was.  ``use_chunked`` and
    ``chunk`` choose among the plain versions as the reference does;
    the kernel takes ``chunk`` as its chunk at every S.
    """
    b, s, d = x.shape
    hd = d // n_heads
    backend = resolve_wkv_backend(wkv_backend, x.device)
    if last_x is None:
        last_x = torch.zeros(b, 1, d, dtype=x.dtype, device=x.device)
    xx = _token_shift(x, last_x) - x

    base = x + xx * 0.5
    lor = torch.tanh(base @ p["lora_a"]).reshape(b, s, 5, LORA_RANK)
    mus = p["mu"][None, None] + torch.einsum("bsir,ird->bsid", lor,
                                             p["lora_b"])
    xr, xk, xv, xg, xw = [x + xx * mus[:, :, i] for i in range(5)]

    r = (xr @ p["wr"]).reshape(b, s, n_heads, hd)
    k = (xk @ p["wk"]).reshape(b, s, n_heads, hd)
    v = (xv @ p["wv"]).reshape(b, s, n_heads, hd)
    g = F.silu(xg @ p["wg"])

    w_raw = p["w0"][None, None] + torch.tanh(xw @ p["w_a"]) @ p["w_b"]
    w_raw = torch.clamp(w_raw.float(), *W_RAW_CLAMP)
    w_logdecay = -torch.exp(w_raw).reshape(b, s, n_heads, hd)

    # (B, S, H, Dh) -> (B, H, S, Dh) views: the kernel reads them as they lie
    rf, kf, vf, lw = (a.float().movedim(2, 1) for a in (r, k, v, w_logdecay))
    u = p["u"].float()

    def plain(r, k, v, w, u, state, chunk):
        if use_chunked and s % chunk == 0 and s > 1:
            return ref.wkv_chunked(r, k, v, w, u, state, chunk)
        return ref.wkv_serial(r, k, v, w, u, state)

    fn = wkv_kernel.wkv if backend == "cuda" else plain
    y, new_state = kernel_call("rwkv6.wkv", fn, plain, rf, kf, vf, lw, u,
                               state, chunk=chunk)

    y = y.movedim(1, 2)                                # (B, S, H, Dv)
    y = apply_norm(p["ln_x"], y.to(x.dtype), "layernorm")
    y = y.reshape(b, s, d) * g
    return y @ p["wo"], (new_state, x[:, -1:])


def channel_mix_apply(p: Params, x: torch.Tensor, *,
                      last_x: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    if last_x is None:
        last_x = torch.zeros(b, 1, d, dtype=x.dtype, device=x.device)
    xx = _token_shift(x, last_x) - x
    xk = x + xx * p["mu_k"][None, None]
    xr = x + xx * p["mu_r"][None, None]
    kk = torch.square(F.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    return out, x[:, -1:]
