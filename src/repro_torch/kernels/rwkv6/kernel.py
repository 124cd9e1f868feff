"""The RWKV6 WKV: the wrapper of the CUDA C++ kernels ``csrc/rwkv6.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6/kernel.py::
wkv_chunked_pallas`` and computes what the model's WKV computes
(``repro/models/rwkv.py::wkv_chunked``): it takes an initial state and
returns the final one, and any S >= 1 (a ragged last chunk is masked in the
kernel), so a 2047-token prompt and the one-token decode step both run it.
One token runs ``wkv_step_kernel``; more run three kernels parallel over
the chunks (each chunk's state increment, the scan over the chunks, each
chunk's output) through a float32 scratch of B H ceil(S / chunk) Dh Dv
floats that the wrapper allocates.  ``ref.wkv_step`` and
``ref.wkv_chunk_parallel`` mirror that arithmetic in plain PyTorch.  The
note at the top of the CUDA source says what bounds it on the H100 and what
its design does about it.

One deliberate difference from the JAX package: the state is updated in
place.  Where the reference returns a new final state, ``wkv`` writes it
into the ``state`` tensor it was given (in serving, the layer's slice of
the cache, so nothing is copied back) and returns that tensor; with
``state=None`` it starts from zeros, as the Pallas kernel does, into a new
tensor.

The kernel is compiled by ``nvcc`` at the first launch (``repro_torch._build``)
and called through ``ctypes`` on PyTorch's current stream.  CPU tensors run
the plain version (``ref.wkv_chunked``); CUDA tensors launch the kernel, or
raise.  ``wkv.launches`` counts the calls that launched the kernels, not
the CUDA launches: a call of S > 1 is three of them and counts once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import _build
from repro_torch.kernels.rwkv6 import ref

#: declared tunable of the ``cuda`` backend (ops.py registers it): the
#: tokens of a chunk, as the reference declares it (``ops.py:146-149``)
CHUNK_GRID = (16, 32, 64)
CHUNK = 64
HEAD_DIMS = (32, 64)

#: the ``csrc/`` sources this module loads (the tuning cache's code hash
#: reads them: no Python name reaches a ``.cu``)
CUDA_SOURCES = ("rwkv6",)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(CUDA_SOURCES[0])
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    lib.rwkv6_wkv_fwd.argtypes = ([c_int] * 2 + [c_void_p] * 11
                                  + [c_int] * 3 + [c_void_p])
    lib.rwkv6_wkv_fwd.restype = c_int
    lib.rwkv6_error_string.argtypes = [c_int]
    lib.rwkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, w_logdecay, u, state) -> None:
    if any(x.dim() != 4 for x in (r, k, v, w_logdecay)) or \
            not r.shape == k.shape == v.shape == w_logdecay.shape:
        shapes = [tuple(x.shape) for x in (r, k, v, w_logdecay)]
        raise ValueError(f"wkv takes r, k, v and w_logdecay of one shape "
                         f"(B, H, S, Dh) with Dv == Dh, got {shapes}")
    b, h, s, dh = r.shape
    if s < 1:
        raise ValueError("wkv takes at least one token")
    if tuple(u.shape) != (h, dh):
        raise ValueError(f"wkv: u {tuple(u.shape)}, expected {(h, dh)}")
    if state is not None and tuple(state.shape) != (b, h, dh, dh):
        raise ValueError(f"wkv: state {tuple(state.shape)}, expected "
                         f"{(b, h, dh, dh)}")
    devices = {x.device for x in (r, k, v, w_logdecay, u, state)
               if x is not None}
    if len(devices) != 1:
        raise ValueError(f"wkv takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv runs on CUDA or CPU tensors, not {device}")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        w_logdecay: torch.Tensor, u: torch.Tensor,
        state: Optional[torch.Tensor] = None, *, chunk: int = CHUNK
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w_logdecay (B, H, S, Dh) float32, u (H, Dh), state
    (B, H, Dh, Dh) float32 or None (zeros) -> (y (B, H, S, Dh), state).

    r, k, v and w_logdecay are read through their strides (rows 16-byte
    aligned, a contiguous last dimension): the model passes ``movedim``
    views of its (B, S, H, Dh) tensors.  y is allocated (B, S, H, Dh) and
    returned as its (B, H, S, Dh) view, so the model's ``movedim`` back
    is free.  The final state is written into ``state`` in place (a new
    tensor when ``state`` is None) and returned.
    """
    _check(r, k, v, w_logdecay, u, state)
    if chunk not in CHUNK_GRID:
        raise ValueError(f"bad chunk={chunk}: one of {CHUNK_GRID}")
    if r.device.type == "cpu":
        y, final = ref.wkv_chunked(r, k, v, w_logdecay, u, state, chunk)
        if state is None:
            return y, final
        return y, state.copy_(final)
    b, h, s, dh = r.shape
    if any(x.dtype != torch.float32 for x in (r, k, v, w_logdecay, u)) or \
            (state is not None and state.dtype != torch.float32):
        raise TypeError("the wkv kernel takes float32 r, k, v, w_logdecay, "
                        "u and state")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes head_dim in {HEAD_DIMS}, "
                         f"not {dh}")
    if any(x.stride(-1) != 1 or x.data_ptr() % 16
           or any(st % 4 for st in x.stride()[:3])
           for x in (r, k, v, w_logdecay)):
        raise ValueError("the wkv kernel reads r, k, v and w_logdecay 16 "
                         "bytes at a time: a contiguous last dimension, a "
                         "16-byte aligned base and strides")
    if not u.is_contiguous() or state is not None and (
            not state.is_contiguous() or state.data_ptr() % 16):
        raise ValueError("the wkv kernel takes a contiguous u and a "
                         "contiguous, 16-byte aligned state")
    y = torch.empty(b, s, h, dh, dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    out = state if state is not None else torch.empty(
        b, h, dh, dh, dtype=torch.float32, device=r.device)
    # the chunk kernels' scratch: each chunk's state increment, overwritten
    # by the state at the chunk's start, and exp of its total decay
    n = -(-s // chunk)
    scratch = (None, None) if s == 1 else (
        torch.empty(b * h * n * dh * dh, dtype=torch.float32,
                    device=r.device),
        torch.empty(b * h * n * dh, dtype=torch.float32, device=r.device))
    strides = (ctypes.c_longlong * 15)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *w_logdecay.stride()[:3], *y.stride()[:3])
    lib = _library()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_wkv_fwd(
            chunk, dh, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w_logdecay.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(),
            y.data_ptr(),
            *(None if x is None else x.data_ptr() for x in scratch),
            strides, b, h, s,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wkv kernel launch failed: error {err} "
                           f"({lib.rwkv6_error_string(err).decode()})")
    wkv.launches += 1
    return y, out


wkv.launches = 0
