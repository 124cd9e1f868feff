"""Seven-point stencil: the wrapper of the CUDA C++ kernel ``csrc/stencil7.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/stencil7/kernel.py::
laplacian_3d``.  Bound on the H100 by bytes (one read and one write per
cell); the kernel marches each (x, y) column along z with the z neighbours
in registers and lets L1/L2 serve the x/y neighbours — see the note at the
top of ``csrc/stencil7.cu``.

The kernel is compiled by ``nvcc`` at the first launch (``repro_torch._build``)
and called through ``ctypes`` on PyTorch's current stream.  CPU tensors run
the plain version in ``ref.py``; CUDA tensors launch the kernel, or raise.
``laplacian.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.stencil7 import ref

#: declared tunables of the ``cuda`` backend (ops.py registers them)
BLOCK_X_GRID = (32, 64, 128)
BLOCK_Y_GRID = (2, 4, 8)
ZCHUNK_GRID = (16, 64, 256)
BLOCK_X, BLOCK_Y, ZCHUNK = 32, 8, 64

#: the ``csrc/`` sources this module loads (the tuning cache's code hash
#: reads them: no Python name reaches a ``.cu``)
CUDA_SOURCES = ("stencil7",)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(CUDA_SOURCES[0])
    c_int, c_float, c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.stencil7_f32.argtypes = [c_void_p, c_void_p, c_int, c_int, c_int,
                                 c_float, c_float, c_float, c_float,
                                 c_int, c_int, c_int, c_void_p]
    lib.stencil7_f32.restype = c_int
    lib.stencil7_error_string.argtypes = [c_int]
    lib.stencil7_error_string.restype = ctypes.c_char_p
    return lib


def laplacian(u: torch.Tensor, invhx2: float = 1.0, invhy2: float = 1.0,
              invhz2: float = 1.0, invhxyz2: float = -6.0, *,
              block_x: int = BLOCK_X, block_y: int = BLOCK_Y,
              zchunk: int = ZCHUNK) -> torch.Tensor:
    """Seven-point Laplacian of a (nz, ny, nx) volume, 0 on the boundary."""
    if u.dim() != 3 or min(u.shape) < 3:
        raise ValueError(f"stencil7 takes a (nz, ny, nx) volume with every "
                         f"extent >= 3, got shape {tuple(u.shape)}")
    if u.device.type == "cpu":
        return ref.laplacian(u, invhx2, invhy2, invhz2, invhxyz2)
    if u.device.type != "cuda":
        raise ValueError(f"stencil7 runs on CUDA or CPU tensors, not "
                         f"{u.device}")
    if u.dtype != torch.float32:
        raise TypeError(f"the stencil7 kernel takes float32, not {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("the stencil7 kernel takes a contiguous volume")
    if block_x * block_y > 1024 or block_x % 32 or zchunk < 1:
        raise ValueError(f"bad launch shape block=({block_x}, {block_y}) "
                         f"zchunk={zchunk}")
    nz, ny, nx = u.shape
    f = torch.empty_like(u)
    lib = _library()
    with torch.cuda.device(u.device):
        err = lib.stencil7_f32(
            u.data_ptr(), f.data_ptr(), nz, ny, nx, float(invhx2),
            float(invhy2), float(invhz2), float(invhxyz2), block_x, block_y,
            zchunk, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stencil7 kernel launch failed: cudaError {err} "
                           f"({lib.stencil7_error_string(err).decode()})")
    laplacian.launches += 1
    return f


laplacian.launches = 0
