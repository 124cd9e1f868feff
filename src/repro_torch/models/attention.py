"""GQA attention: prefill + ring-buffer decode, dispatched to the kernels.

The port of ``repro/models/attention.py`` for self-attention.  Masks are
position-based: the KV cache carries the absolute position of every slot
(-1 = empty), so full caches and sliding-window ring buffers share one code
path.  ``attend`` routes single-query causal calls to ``attention.decode``
and prefill-shaped calls to ``attention.flash`` on the backend that
``resolve_attention_backend`` picks.

On the ``torch`` route, long sequences take the reference's chunked path
(``models/chunked_attention.py``) under the reference's own condition
(``CHUNKED_THRESHOLD``): it is the training path, differentiable by
autograd.  The hand-written kernels have no backward: called with a tensor
that requires grad, in grad mode, they raise (``core/portable.py::
no_grad_kernel``), so training asks for ``torch``.

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

Each routing decision lands in a bounded dispatch stream
(``reset_dispatch_log`` / ``dispatch_log`` for the last decision per kind,
``dispatch_records`` for the history) and, with telemetry on, as an
``attn.dispatch`` event and a per-backend counter.  On the ``cuda`` route
``attend`` injects the tuned block sizes of the exact call from the tuning
cache (``core/tuning.py``; ``bq``/``bk`` for flash, ``bkv`` for decode) and
records their provenance (``exhaustive``, ``coordinate`` or
``miss-default``); the ``torch`` route records ``tuning="n/a"``.  With no
fallback there is no ``fallback`` field.  A decode step captured as a CUDA
graph looks its params up while it is captured, so a replay runs the
tuned ``bkv`` and no Python; an eager prefill looks up per call, through
a per-process memo, so a repeated shape costs one dict lookup.

Cross-attention (an encoder-decoder's decoder) takes the encoder memory's
K/V from ``cross_kv`` through ``attention_apply(memory_kv=, memory_pos=)``:
non-causal, so even its one-query decode calls route to the prefill kernel,
as the reference's do.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

import repro_torch.kernels.flash_attention.ops  # noqa: F401  (registers)
from repro_torch.core import telemetry as tel
from repro_torch.core import tuning
from repro_torch.core.portable import (BackendUnavailableError,
                                       PortableKernel, get_kernel,
                                       kernel_call)
from repro_torch.kernels.flash_attention.ref import attend_torch
from repro_torch.models.chunked_attention import attend_chunked
from repro_torch.models.common import Params, apply_rope, dense_init

ATTN_BACKEND_ENV = "REPRO_ATTN_BACKEND"

#: dispatcher kind -> registry kernel name
ATTN_KERNELS = {"prefill": "attention.flash", "decode": "attention.decode"}

#: the ``torch`` route takes the chunked path from S, T >= this (with
#: S % 512 == 0 and T % 1024 == 0), as the reference's ``attend_xla`` does
CHUNKED_THRESHOLD = 2048


def takes_chunked(s: int, t: int, k_index_aligned: bool = True) -> bool:
    """Whether the ``torch`` route runs S queries against T keys through
    ``attend_chunked``: the reference's condition, and keys whose slots
    follow their positions (the chunked path skips key chunks by index)."""
    return (k_index_aligned and s >= CHUNKED_THRESHOLD
            and t >= CHUNKED_THRESHOLD and s % 512 == 0 and t % 1024 == 0)


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


# --------------------------------------------------------------------------
# dispatch records and tuned params
# --------------------------------------------------------------------------
#: how many routing decisions the bounded dispatch stream retains (oldest
#: evicted first)
DISPATCH_LOG_CAP = 256

_DISPATCH_RECORDS = tel.RingLog(capacity=DISPATCH_LOG_CAP)
#: the last decision per kind, apart from the ring: an eager prefill logs a
#: decision a layer, so 40-layer prefills evict a captured decode step's
#: records from the ring within a few calls
_LAST: Dict[str, Dict[str, Any]] = {}


def reset_dispatch_log() -> None:
    """Clear the routing record (call before the run whose dispatch you
    want to observe)."""
    _DISPATCH_RECORDS.clear()
    _LAST.clear()


def dispatch_log() -> Dict[str, Dict[str, Any]]:
    """The *last* routing decision per dispatch kind (``"prefill"`` /
    ``"decode"``): resolved backend, kernel, tuning provenance
    (``"exhaustive"`` / ``"coordinate"`` / ``"miss-default"``, ``"n/a"`` on
    the ``torch`` route) and the injected params.  Every eager call
    records one; a graph's replay records none (the capture did)."""
    return {kind: dict(fields) for kind, fields in list(_LAST.items())}


def dispatch_records() -> List[Dict[str, Any]]:
    """The full bounded dispatch stream, oldest first: each record carries
    ``kind`` plus the fields of :func:`dispatch_log` (up to
    ``DISPATCH_LOG_CAP``)."""
    return _DISPATCH_RECORDS.records()


def _log(kind: str, **fields: Any) -> None:
    _DISPATCH_RECORDS.append({"kind": kind, **fields})
    _LAST[kind] = fields
    tel.instant("attn.dispatch", proc="dispatch", kind=kind, **fields)
    tel.counter(f"attn.dispatch.{kind}.{fields.get('backend', '?')}",
                proc="dispatch")


#: (cache path setting, cache writes, kernel, backend, the call's shapes,
#: dtypes, devices and kwargs) -> (params, provenance)
_TUNED: Dict[Tuple[Any, ...], Tuple[Dict[str, Any], str]] = {}


def _tuned_params(kernel: PortableKernel, *args: Any, backend: str,
                  **kwargs: Any) -> Tuple[Dict[str, Any], str]:
    """(params, provenance) for this exact call from the default tuning
    cache; a miss gives ({}, ``"miss-default"``), the declared defaults.
    Memoised per shape in the process; a write to any tuning cache or a
    new cache path starts over."""
    memo = (os.environ.get(tuning.CACHE_ENV), tuning.writes(), kernel.name,
            backend,
            *[(a.shape, a.dtype, a.get_device()) for a in args],
            *sorted(kwargs.items()))
    hit = _TUNED.get(memo)
    if hit is None:
        entry = tuning.cached_entry(kernel, *args, backend=backend, **kwargs)
        hit = _TUNED[memo] = (
            ({}, "miss-default") if entry is None else
            (tuning.params_from_cache(entry["params"]),
             entry.get("search", "exhaustive")))
    return dict(hit[0]), hit[1]


def kernel_args(kind: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                *, causal: bool, window: int = 0,
                k_index_aligned: bool = True
                ) -> Tuple[Tuple[torch.Tensor, ...], Dict[str, Any]]:
    """The (args, kwargs) that ``attend`` hands the ``kind`` kernel for
    model-layout q (B, S, H, Dh), k/v (B, T, Kv, Dh): the same call, and so
    the same tuning key, as a sweep that tunes the kernel for the model
    (flash takes transposed views, no copy)."""
    if kind == "decode":
        return (q, k, v, q_pos, k_pos), {"window": window}
    return ((q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             q_pos, k_pos),
            {"causal": causal, "window": window,
             "k_index_aligned": k_index_aligned})


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *, n_kv_heads: int,
           causal: bool, window: int = 0, bf16_intermediates: bool = False,
           backend: Optional[str] = None,
           k_index_aligned: bool = True) -> torch.Tensor:
    """Position-masked GQA attention through the kernel registry.

    q (B, S, H, Dh), k/v (B, T, Kv, Dh), q_pos (B, S), k_pos (B, T);
    ``k_pos == -1`` marks empty slots, ``window > 0`` restricts to
    ``q_pos - k_pos < window``.  Single-query causal calls go to
    ``attention.decode``, the rest to ``attention.flash`` (on transposed
    views: no copy).  ``k_index_aligned=False`` says the keys' slots do not
    follow their positions (a wrapped ring), so the prefill kernel may not
    skip blocks by index, and the ``torch`` route does not take the chunked
    path.  ``bf16_intermediates`` reaches the chunked path only.
    """
    s, t = q.shape[1], k.shape[1]
    kind = "decode" if (causal and s == 1) else "prefill"
    name = resolve_attention_backend(kind, backend, q.device)
    kernel = get_kernel(ATTN_KERNELS[kind])

    def plain(q, k, v, q_pos, k_pos, **kw):
        """The ``torch`` route.  The kv heads are k's: ``n_kv_heads``, or a
        head-sharded rank's share of them."""
        if takes_chunked(s, t, k_index_aligned):
            return attend_chunked(q, k, v, q_pos, k_pos,
                                  n_kv_heads=k.shape[2], causal=causal,
                                  window=window,
                                  bf16_intermediates=bf16_intermediates)
        return attend_torch(q, k, v, q_pos, k_pos, n_kv_heads=k.shape[2],
                            causal=causal, window=window)

    if name == kernel.oracle:
        _log(kind, backend=name, kernel=kernel.name, tuning="n/a", params={})
        fn = plain
    else:
        args, kwargs = kernel_args(kind, q, k, v, q_pos, k_pos,
                                   causal=causal, window=window,
                                   k_index_aligned=k_index_aligned)
        params, prov = _tuned_params(kernel, *args, backend=name, **kwargs)
        _log(kind, backend=name, kernel=kernel.name, tuning=prov,
             params=params)

        def fn(q, k, v, q_pos, k_pos, **kw):
            a, kwa = kernel_args(kind, q, k, v, q_pos, k_pos, causal=causal,
                                 window=window,
                                 k_index_aligned=k_index_aligned)
            out = kernel(*a, backend=name, **kwa, **params)
            return out if kind == "decode" else out.transpose(1, 2)
    return kernel_call(kernel.name, fn, plain, q, k, v, q_pos, k_pos,
                       causal=causal, window=window)


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
        # each row's slot along dim 1, read and written by gather/scatter:
        # no op indexes the batch dim, so a row-sharded cache stays local
        slots = torch.where(keep, positions % cache_len, 0).long()  # (B, 1)
        idx = slots[:, :, None, None].expand(b, 1, *k.shape[2:])
        kk = keep[:, :, None, None]
        ck.scatter_(1, idx, torch.where(kk, k, ck.gather(1, idx)))
        cv.scatter_(1, idx, torch.where(kk, v, cv.gather(1, idx)))
        # the positions through a mask over the slots: (B, T) int32 is
        # small, and a sharding policy may split it along T
        hit = keep & (torch.arange(cache_len, device=positions.device)
                      == slots)
        cpos.copy_(torch.where(hit, positions, cpos))
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
                    memory_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                    memory_pos: Optional[torch.Tensor] = None,
                    bf16_intermediates: bool = False,
                    backend: Optional[str] = None,
                    ) -> Tuple[torch.Tensor,
                               Optional[Dict[str, torch.Tensor]]]:
    """One attention sublayer.

    * training / prefill without a cache: full-sequence self-attention;
    * with a cache (K/V/pos ring buffer): the new tokens are written into
      it in place, then attend to the whole cache; x is (B, S, D);
    * cross-attention: ``memory_kv`` = (k, v) from ``cross_kv`` over the
      encoder's output, at positions ``memory_pos`` (B, T); ``causal``
      must be False, and the cache is neither read nor written.
    ``backend`` selects the registry attention backend and
    ``bf16_intermediates`` the chunked path's tiles (see ``attend``).
    Returns (output, cache).
    """
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
    if memory_kv is not None:
        (k, v), k_pos = memory_kv, memory_pos
        k_index_aligned = False      # encoder memory: arbitrary positions
    else:
        k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
        v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
        if use_rope:
            k = apply_rope(k, positions, rope_theta)
        k_pos, k_index_aligned = positions, True
        if cache is not None:
            _write_cache(cache, k, v, positions)
            k, v, k_pos = cache["k"], cache["v"], cache["pos"]
            # a multi-token prefill against a ring shorter than the padded
            # length wraps: slot index no longer tracks position
            k_index_aligned = s == 1 or k.shape[1] >= s
    out = attend(q, k, v, positions, k_pos, n_kv_heads=n_kv_heads,
                 causal=causal, window=window,
                 bf16_intermediates=bf16_intermediates, backend=backend,
                 k_index_aligned=k_index_aligned)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"], cache


def cross_kv(p: Params, memory: torch.Tensor, n_kv_heads: int,
             head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from encoder memory (B, T, D)."""
    b, t, _ = memory.shape
    k = (memory @ p["wk"]).reshape(b, t, n_kv_heads, head_dim)
    v = (memory @ p["wv"]).reshape(b, t, n_kv_heads, head_dim)
    return k, v
