"""Prefill and decode attention: the wrappers of ``csrc/flash_attention.cu``.

``flash`` replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
kernel.py::flash_attention`` and ``decode`` replaces ``::decode_attention``;
the note at the top of the CUDA source says what bounds each on the H100
and what its design does about it.  Both take float32 or bfloat16 (q, k
and v of one dtype), accumulate in float32 and return q's dtype.  ``flash``
has one kernel a dtype: bfloat16 (the model's) on the tensor cores
(wgmma), float32 (the conformance dtype) on the FMA pipes.

The kernels are compiled by ``nvcc`` at the first launch
(``repro_torch._build``) and called through ``ctypes`` on PyTorch's current
stream.  CPU tensors run the plain versions in ``ref.py``; CUDA tensors
launch the kernel, or raise.  ``flash.launches`` and ``decode.launches``
count the calls that launched a kernel; each call is one CUDA launch.

``decode`` keeps the port's one piece of state that persists across calls:
an int32 arrival counter per (row, kv head) on each device (``_arrivals``),
0 between calls, with which the decode kernel's last block of a pair finds
itself and combines the pair's partials.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import _build
from repro_torch.kernels.flash_attention import ref

#: declared tunables of the ``cuda`` backends (ops.py registers them): the
#: prefill's q and k tile rows and the cache slots a decode block takes.
#: Each prefill dtype has its own kernel, instantiated for its own tiles
#: (``tiles_fit`` is the registry's constraint): float32 the FMA kernel at
#: 32 or 64 rows, bfloat16 the wgmma kernel at 64 or 128 (a warpgroup's 64
#: query rows, or two warpgroups; wgmma's N for the keys)
FLASH_TILES = {torch.float32: (32, 64), torch.bfloat16: (64, 128)}
BQ_GRID = BK_GRID = (32, 64, 128)
BKV_GRID = (64, 128, 256, 512)
# Defaults, each the fastest point of its grid at granite-3-8b's serving
# shapes on an H100 SXM (700 W), timed as CUDA graphs by chip_smoke.py:
# bfloat16 prefill 128 x 128, two warpgroups a block (0.139 ms against
# 0.158 (128 x 64), 0.158 (64 x 64) and 0.224 ms (64 x 128)); float32
# prefill 64 x 64 (1.60 ms against 1.79-2.52 ms, timed in bf16 when bf16
# ran the FMA kernel too); decode 128-slot chunks, 32 splits of a
# 4096-slot cache, two a block: 1024 blocks at 8 rows x 8 kv heads (0.0237
# ms against 0.0301 (64), 0.0295 (256) and 0.0436 ms (512))
FLASH_DEFAULT = {torch.float32: (64, 64), torch.bfloat16: (128, 128)}
BKV = 128
HEAD_DIMS = (16, 32, 64, 128)
#: query heads per kv head the decode kernel holds (its register tile)
MAX_GROUP = 8
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the decode kernel's arrival counters, one buffer a device index
_ARRIVALS: Dict[int, torch.Tensor] = {}
#: buffers outgrown: kept, since a captured CUDA graph may still use one
_OUTGROWN: List[torch.Tensor] = []

#: the ``csrc/`` sources this module loads (the tuning cache's code hash
#: reads them: no Python name reaches a ``.cu``)
CUDA_SOURCES = ("flash_attention",)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(CUDA_SOURCES[0])
    c_int, c_ll, c_void_p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = (
        [c_int] * 4 + [c_void_p] * 7 + [c_ll, c_ll] + [c_int] * 8
        + [ctypes.c_float, c_void_p])
    lib.flash_attention_fwd.restype = c_int
    lib.decode_attention_fwd.argtypes = (
        [c_int] * 2 + [c_void_p] * 11 + [c_ll] + [c_int] * 6
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


def tiles_fit(point, q, *args, **kwargs) -> bool:
    """The flash tunables' constraint: the tiles q's dtype is built for."""
    allowed = FLASH_TILES.get(q.dtype, ())
    return point["bq"] in allowed and point["bk"] in allowed


def _aligned16(tensors: Sequence[torch.Tensor]) -> bool:
    """Base and dims 0-2 strides 16-byte aligned: rows read 16 bytes at a
    time."""
    return not any(x.data_ptr() % 16 or any(
        st * x.element_size() % 16 for st in x.stride()[:3]) for x in tensors)


def _positions(pos: torch.Tensor) -> torch.Tensor:
    return pos.to(torch.int32).contiguous()


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: Optional[torch.Tensor] = None,
          k_pos: Optional[torch.Tensor] = None, *, causal: bool = True,
          window: int = 0, k_index_aligned: bool = True,
          bq: Optional[int] = None, bk: Optional[int] = None
          ) -> torch.Tensor:
    """q (B, H, S, Dh), k/v (B, Kv, T, Dh) -> (B, H, S, Dh).

    Any strides with a contiguous last dimension (the model passes
    ``transpose(1, 2)`` views of its (B, S, H, Dh) tensors); the output has
    q's strides.  ``q_pos`` (B, S) / ``k_pos`` (B, T) are absolute positions
    (pass both or neither; -1 marks an empty or pad slot), else token i is
    at position i.  ``k_index_aligned`` says that key slot j holds position
    j or -1, or that positions are index-aligned up to a left-pad offset:
    then a causal q tile skips the k tiles after its last row.  Tiles whose
    keys the mask refuses for every query are skipped either way.
    ``bq``/``bk`` default to ``FLASH_DEFAULT`` of q's dtype.  bfloat16 runs
    the tensor-core kernel, which copies rows 16 bytes at a time: q, k and
    v need 16-byte aligned bases and row, head and batch strides.
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
    bq = FLASH_DEFAULT[q.dtype][0] if bq is None else bq
    bk = FLASH_DEFAULT[q.dtype][1] if bk is None else bk
    if not tiles_fit({"bq": bq, "bk": bk}, q):
        raise ValueError(f"bad tiles bq={bq} bk={bk} for {q.dtype}: each "
                         f"in {FLASH_TILES[q.dtype]}")
    if q.dtype == torch.bfloat16 and not _aligned16((q, k, v)):
        raise ValueError("the bfloat16 flash kernel copies q, k and v rows "
                         "16 bytes at a time: their base and strides must "
                         "be 16-byte aligned")
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


def _arrivals(device: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` int32 arrival counters on ``device``, all 0.

    The decode kernel counts each (row, kv head)'s split blocks in as they
    finish, and the last one sets its counter back to 0, so the buffer is 0
    between calls and is made (zeroed) once per device.  It grows only
    outside a CUDA graph capture (a capture may not allocate state that
    outlives it); an outgrown buffer is kept, not freed, because a graph
    captured earlier still points at it.  A launch that faults midway may
    leave counters nonzero: the wrapper raises, and a process that caught
    that error must not call ``decode`` again on that device.  Decode calls
    on one device must not overlap on two streams: they share the buffer.
    """
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    buf = _ARRIVALS.get(index)
    if buf is None or buf.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"decode needs {count} arrival counters on {device} and "
                f"cannot allocate them while a CUDA graph is captured: "
                f"call decode once at this batch size and kv heads first")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = _ARRIVALS[index] = torch.zeros(
            max(count, 1024), dtype=torch.int32, device=device)
    return buf


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, *, window: int = 0,
           bkv: int = BKV) -> torch.Tensor:
    """q (B, 1, H, Dh), k/v (B, T, Kv, Dh), q_pos (B, 1), k_pos (B, T)
    -> (B, 1, H, Dh).

    One query a row against a position-annotated cache in the model's own
    layout: slot order is arbitrary (a wrapped ring arrives as stored), -1
    marks an empty slot, ``window > 0`` keeps ``q_pos - k_pos < window``.
    k and v are read through their strides (rows 16-byte aligned, as views
    of a cache tensor are); q must be contiguous.  One CUDA launch: the
    cache is split into chunks of ``bkv`` slots, and the last block of each
    (row, kv head) combines the chunks' partials in order, found through
    the arrival counters of ``_arrivals``.
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
    if not _aligned16((k, v)):
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
    arrivals = _arrivals(device, b * kv)
    q_pos, k_pos = _positions(q_pos), _positions(k_pos)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    lib = _library()
    with torch.cuda.device(device):
        err = lib.decode_attention_fwd(
            DTYPE_CODES[q.dtype], dh, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
            part.data_ptr(), part[b * kv * nsplit * g:].data_ptr(),
            acc.data_ptr(), arrivals.data_ptr(), strides, k_pos.stride(0),
            b, h, kv, t, bkv,
            int(window), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    _check_launch("decode", err)
    decode.launches += 1
    return out


flash.launches = 0
decode.launches = 0
