"""GQA attention: prefill + ring-buffer decode, dispatched to the kernels.

The port of ``repro/models/attention.py`` for self-attention.  Masks are
position-based: the KV cache carries the absolute position of every slot
(-1 = empty), so full caches and sliding-window ring buffers share one code
path.  ``attend`` routes single-query causal calls to ``attention.decode``
and prefill-shaped calls to ``attention.flash`` on the backend that
``resolve_attention_backend`` picks.

Two deliberate differences from the reference:

  * no fallback.  The reference falls back to XLA when a requested backend
    is unavailable, when S/T do not divide the kernel's blocks, and for a
    causal prefill against a wrapped ring.  Here the default for CUDA
    tensors is the ``cuda`` kernel, the plain version (``"torch"``) runs
    only when asked for (or on CPU tensors), an unavailable backend raises
    ``BackendUnavailableError``, and the kernels take ragged S/T and a
    wrapped ring themselves (``k_index_aligned=False`` turns the prefill's
    index-based block skip off);
  * the cache is written in place (``index_put_``): a cache dict passed in
    is the one returned, updated.

Cross-attention memory, dispatch records and telemetry events wait for
later slices (ROADMAP).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch

import repro_torch.kernels.flash_attention.ops  # noqa: F401  (registers)
from repro_torch.core.portable import BackendUnavailableError, get_kernel
from repro_torch.kernels.flash_attention.ref import attend_torch
from repro_torch.models.common import Params, apply_rope, dense_init

ATTN_BACKEND_ENV = "REPRO_ATTN_BACKEND"

#: dispatcher kind -> registry kernel name
ATTN_KERNELS = {"prefill": "attention.flash", "decode": "attention.decode"}


def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   device, n_layers_scale: int = 1) -> Params:
    out_scale = 1.0 / math.sqrt(2 * n_layers_scale)
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device,
                         out_scale),
    }


def init_cache(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
               dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros(batch, cache_len, n_kv_heads, head_dim, dtype=dtype,
                         device=device),
        "v": torch.zeros(batch, cache_len, n_kv_heads, head_dim, dtype=dtype,
                         device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def resolve_attention_backend(kind: str, backend: Optional[str] = None,
                              device=None) -> str:
    """The attention backend for one dispatch kind on tensors on ``device``.

    Precedence: ``REPRO_ATTN_BACKEND`` env var > explicit ``backend`` >
    the default, which is the kernel's hand-written backend (``"cuda"``) for
    CUDA tensors and the plain version (``"torch"``) otherwise.  ``None``,
    ``""`` and ``"auto"`` request nothing.  An unknown name raises
    ``KeyError``; a hand-written backend that cannot run here (no CUDA
    device, no nvcc, or CPU tensors) raises ``BackendUnavailableError``.
    """
    if kind not in ATTN_KERNELS:
        raise KeyError(f"unknown attention dispatch kind {kind!r}; "
                       f"have {sorted(ATTN_KERNELS)}")
    kernel = get_kernel(ATTN_KERNELS[kind])
    on_cuda = device is not None and torch.device(device).type == "cuda"
    env = os.environ.get(ATTN_BACKEND_ENV, "").strip()
    if env and env.lower() != "auto":
        req = env
    elif backend not in (None, "", "auto"):
        req = backend
    else:
        req = kernel.native if on_cuda else kernel.oracle
    if req not in kernel.backends:
        raise KeyError(f"unknown attention backend {req!r} for "
                       f"{kernel.name!r}; have {sorted(kernel.backends)}")
    if req == kernel.oracle:
        return req
    if not on_cuda:
        raise BackendUnavailableError(
            f"{kernel.name!r} backend {req!r} runs on CUDA tensors, not on "
            f"{device}; ask for 'torch' to run the plain version")
    reason = kernel.backend(req).unavailable_reason()
    if reason is not None:
        raise BackendUnavailableError(
            f"{kernel.name!r} backend {req!r} is not available: {reason}")
    return req


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *, n_kv_heads: int,
           causal: bool, window: int = 0, backend: Optional[str] = None,
           k_index_aligned: bool = True) -> torch.Tensor:
    """Position-masked GQA attention through the kernel registry.

    q (B, S, H, Dh), k/v (B, T, Kv, Dh), q_pos (B, S), k_pos (B, T);
    ``k_pos == -1`` marks empty slots, ``window > 0`` restricts to
    ``q_pos - k_pos < window``.  Single-query causal calls go to
    ``attention.decode``, the rest to ``attention.flash`` (on transposed
    views: no copy).  ``k_index_aligned=False`` says the keys' slots do not
    follow their positions (a wrapped ring), so the prefill kernel may not
    skip blocks by index.
    """
    s = q.shape[1]
    kind = "decode" if (causal and s == 1) else "prefill"
    name = resolve_attention_backend(kind, backend, q.device)
    if name == "torch":
        return attend_torch(q, k, v, q_pos, k_pos, n_kv_heads=n_kv_heads,
                            causal=causal, window=window)
    kernel = get_kernel(ATTN_KERNELS[kind])
    if kind == "decode":
        return kernel(q, k, v, q_pos, k_pos, backend=name, window=window)
    out = kernel(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 q_pos, k_pos, backend=name, causal=causal, window=window,
                 k_index_aligned=k_index_aligned)
    return out.transpose(1, 2)


def _write_cache(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor) -> None:
    """Write the new tokens' K/V/positions into the ring buffer in place.

    A token at position p goes to slot p % cache_len; pad tokens (position
    -1) are dropped by a mask, as the reference's ``mode="drop"`` scatter
    drops them.  Neither branch synchronises with the host.  A single-token
    step writes every row (a pad row writes its slot's own contents back).
    A multi-token prefill keeps only the last ``cache_len`` positions of
    each row (on a ring shorter than the prompt), maps each slot to the
    column that writes it, and rewrites the cache through that map, so
    every slot is written once, by its latest token.
    """
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    b, s = positions.shape
    cache_len = ck.shape[1]
    keep = positions >= 0
    if s == 1:
        rows = torch.arange(b, device=positions.device)
        slots = torch.where(keep, positions % cache_len, 0)[:, 0]
        kk = keep[:, 0]
        ck[rows, slots] = torch.where(kk[:, None, None], k[:, 0],
                                      ck[rows, slots])
        cv[rows, slots] = torch.where(kk[:, None, None], v[:, 0],
                                      cv[rows, slots])
        cpos[rows, slots] = torch.where(kk, positions[:, 0], cpos[rows, slots])
        return
    last = positions.amax(dim=1, keepdim=True)
    keep &= positions > last - cache_len
    # the kept positions of a row are distinct mod cache_len, so at most one
    # column writes a slot; dropped tokens go to a spare slot past the end
    slots = torch.where(keep, positions % cache_len, cache_len).long()
    cols = torch.arange(s, device=positions.device).expand(b, s)
    writer = torch.full((b, cache_len + 1), -1, dtype=torch.long,
                        device=positions.device)
    writer.scatter_reduce_(1, slots, torch.where(keep, cols, -1),
                           reduce="amax")
    writer = writer[:, :cache_len]
    written = writer >= 0
    src = writer.clamp(min=0)
    idx = src[:, :, None, None].expand(b, cache_len, *k.shape[2:])
    ck.copy_(torch.where(written[..., None, None], k.gather(1, idx), ck))
    cv.copy_(torch.where(written[..., None, None], v.gather(1, idx), cv))
    cpos.copy_(torch.where(written, positions.gather(1, src), cpos))


def attention_apply(p: Params, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, head_dim: int, positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    use_rope: bool = True, rope_theta: float = 1e4,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    backend: Optional[str] = None,
                    ) -> Tuple[torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]:
    """One self-attention sublayer.

    * training / prefill without a cache: full-sequence self-attention;
    * with a cache (K/V/pos ring buffer): the new tokens are written into
      it in place, then attend to the whole cache; x is (B, S, D).
    ``backend`` selects the registry attention backend (see ``attend``).
    Returns (output, cache).
    """
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_pos, k_index_aligned = positions, True
    if cache is not None:
        _write_cache(cache, k, v, positions)
        k, v, k_pos = cache["k"], cache["v"], cache["pos"]
        # a multi-token prefill against a ring shorter than the padded
        # length wraps: slot index no longer tracks position
        k_index_aligned = s == 1 or k.shape[1] >= s
    out = attend(q, k, v, positions, k_pos, n_kv_heads=n_kv_heads,
                 causal=causal, window=window, backend=backend,
                 k_index_aligned=k_index_aligned)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"], cache
