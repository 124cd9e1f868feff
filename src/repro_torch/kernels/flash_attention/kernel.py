"""Prefill and decode attention: the wrappers of ``csrc/flash_attention.cu``.

``flash`` replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
kernel.py::flash_attention`` and ``decode`` replaces ``::decode_attention``;
the note at the top of the CUDA source says what bounds each on the H100
and what its design does about it.  Both take float32 or bfloat16 (q, k
and v of one dtype), accumulate in float32 and return q's dtype.

The kernels are compiled by ``nvcc`` at the first launch
(``repro_torch._build``) and called through ``ctypes`` on PyTorch's current
stream.  CPU tensors run the plain versions in ``ref.py``; CUDA tensors
launch the kernel, or raise.  ``flash.launches`` and ``decode.launches``
count the calls that launched a kernel (a decode call is two launches, the
split pass and the combine pass, and counts once).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch import _build
from repro_torch.kernels.flash_attention import ref

#: declared tunables of the ``cuda`` backends (ops.py registers them): the
#: prefill's q and k tile rows (each pair has its own instantiation) and the
#: cache slots a decode block takes
BQ_GRID = (32, 64)
BK_GRID = (32, 64)
BKV_GRID = (64, 128, 256, 512)
# 64 x 64 tiles give each of 256 threads a 4 x 4 piece of S (16 FMAs per
# 8 shared-memory loads) in 83 KB of shared memory at Dh 128, two blocks
# an SM; 128-slot decode chunks make 32 splits of a 4096-slot cache, 2048
# blocks at 8 rows x 8 kv heads.  Both are the fastest points of their
# grids at granite-3-8b's serving shapes on an H100 SXM (700 W): prefill
# 1.60 ms against 1.79-2.52 ms, decode 0.044 ms against 0.051 (64), 0.059
# (256) and 0.089 ms (512), timed as CUDA graphs by chip_smoke.py
BQ, BK, BKV = 64, 64, 128
HEAD_DIMS = (16, 32, 64, 128)
#: query heads per kv head the decode kernel holds (its register tile)
MAX_GROUP = 8
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("flash_attention")
    c_int, c_ll, c_void_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = (
        [c_int] * 4 + [c_void_p] * 7 + [c_ll, c_ll] + [c_int] * 8
        + [ctypes.c_float, c_void_p])
    lib.flash_attention_fwd.restype = c_int
    lib.decode_attention_fwd.argtypes = (
        [c_int] * 2 + [c_void_p] * 10 + [c_ll] + [c_int] * 6
        + [ctypes.c_float, c_void_p])
    lib.decode_attention_fwd.restype = c_int
    lib.attention_error_string.argtypes = [c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(name: str, err: int) -> None:
    if err:
        msg = _library().attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {err} ({msg})")


def _one_device(name: str, tensors: Sequence[Optional[torch.Tensor]]):
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {device}")
    return device


def _check_kernel_inputs(name: str, q, k, v, dh: int) -> None:
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the {name} kernel takes float32 or bfloat16 q, k "
                        f"and v of one dtype, not "
                        f"{[q.dtype, k.dtype, v.dtype]}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the {name} kernel takes head_dim in {HEAD_DIMS}, "
                         f"not {dh}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(f"the {name} kernel takes q, k and v whose last "
                         f"dimension is contiguous")


def _positions(pos: torch.Tensor) -> torch.Tensor:
    return pos.to(torch.int32).contiguous()


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: Optional[torch.Tensor] = None,
          k_pos: Optional[torch.Tensor] = None, *, causal: bool = True,
          window: int = 0, k_index_aligned: bool = True, bq: int = BQ,
          bk: int = BK) -> torch.Tensor:
    """q (B, H, S, Dh), k/v (B, Kv, T, Dh) -> (B, H, S, Dh).

    Any strides with a contiguous last dimension (the model passes
    ``transpose(1, 2)`` views of its (B, S, H, Dh) tensors); the output has
    q's strides.  ``q_pos`` (B, S) / ``k_pos`` (B, T) are absolute positions
    (pass both or neither; -1 marks an empty or pad slot), else token i is
    at position i.  ``k_index_aligned`` says that key slot j holds position
    j or -1, or that positions are index-aligned up to a left-pad offset:
    then a causal q tile skips the k tiles after its last row.  Tiles whose
    keys the mask refuses for every query are skipped either way.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash takes q (B, H, S, Dh) and k, v (B, Kv, T, "
                         f"Dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % kv:
        raise ValueError(f"flash: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (heads must be a multiple of "
                         f"kv heads)")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("pass both q_pos and k_pos, or neither")
    if q_pos is not None and (tuple(q_pos.shape) != (b, s)
                              or tuple(k_pos.shape) != (b, t)):
        raise ValueError(f"flash: positions {tuple(q_pos.shape)}, "
                         f"{tuple(k_pos.shape)}, expected {(b, s)}, {(b, t)}")
    device = _one_device("flash", (q, k, v, q_pos, k_pos))
    if device.type == "cpu":
        return ref.flash_ref(q, k, v, q_pos, k_pos, causal=causal,
                             window=window)
    _check_kernel_inputs("flash", q, k, v, dh)
    if bq not in BQ_GRID or bk not in BK_GRID:
        raise ValueError(f"bad tiles bq={bq} bk={bk}: bq in {BQ_GRID}, bk "
                         f"in {BK_GRID}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if q_pos is not None:
        q_pos, k_pos = _positions(q_pos), _positions(k_pos)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _library()
    with torch.cuda.device(device):
        err = lib.flash_attention_fwd(
            DTYPE_CODES[q.dtype], dh, bq, bk, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), strides,
            s, t, b, h, kv, s, t, int(causal), int(window),
            int(k_index_aligned), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    _check_launch("flash", err)
    flash.launches += 1
    return out


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *, window: int = 0,
           bkv: int = BKV) -> torch.Tensor:
    """q (B, 1, H, Dh), k/v (B, T, Kv, Dh), q_pos (B, 1), k_pos (B, T)
    -> (B, 1, H, Dh).

    One query a row against a position-annotated cache in the model's own
    layout: slot order is arbitrary (a wrapped ring arrives as stored), -1
    marks an empty slot, ``window > 0`` keeps ``q_pos - k_pos < window``.
    k and v are read through their strides (rows 16-byte aligned, as views
    of a cache tensor are); q must be contiguous.
    """
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode takes q (B, 1, H, Dh) and k, v (B, T, Kv, "
                         f"Dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % kv:
        raise ValueError(f"decode: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (heads must be a multiple of "
                         f"kv heads)")
    if tuple(q_pos.shape) != (b, 1) or tuple(k_pos.shape) != (b, t):
        raise ValueError(f"decode: positions {tuple(q_pos.shape)}, "
                         f"{tuple(k_pos.shape)}, expected {(b, 1)}, {(b, t)}")
    device = _one_device("decode", (q, k, v, q_pos, k_pos))
    if device.type == "cpu":
        return ref.decode_ref(q, k, v, q_pos, k_pos, window=window)
    _check_kernel_inputs("decode", q, k, v, dh)
    if h // kv > MAX_GROUP:
        raise ValueError(f"the decode kernel takes at most {MAX_GROUP} query "
                         f"heads per kv head, not {h // kv}")
    if bkv not in BKV_GRID:
        raise ValueError(f"bad bkv={bkv}: one of {BKV_GRID}")
    if not q.is_contiguous():
        raise ValueError("the decode kernel takes a contiguous q")
    vec = 16 // q.element_size()   # elements in the kernel's 16-byte loads
    if any(x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3])
           for x in (k, v)):
        raise ValueError("the decode kernel reads k and v rows 16 bytes at a "
                         "time: their base and strides must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if t == 0 or b == 0:
        return out.zero_()
    nsplit = -(-t // bkv)
    g = h // kv
    part = torch.empty(2 * b * kv * nsplit * g, dtype=torch.float32,
                       device=device)
    acc = torch.empty(b * kv * nsplit * g * dh, dtype=torch.float32,
                      device=device)
    q_pos, k_pos = _positions(q_pos), _positions(k_pos)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    lib = _library()
    with torch.cuda.device(device):
        err = lib.decode_attention_fwd(
            DTYPE_CODES[q.dtype], dh, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
            part.data_ptr(), part[b * kv * nsplit * g:].data_ptr(),
            acc.data_ptr(), strides, k_pos.stride(0), b, h, kv, t, bkv,
            int(window), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    _check_launch("decode", err)
    decode.launches += 1
    return out


flash.launches = 0
decode.launches = 0
