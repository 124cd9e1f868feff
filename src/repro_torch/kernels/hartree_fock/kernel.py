"""Hartree-Fock Fock build: the wrappers of the CUDA C++ kernel
``csrc/hartree_fock.cu``.

``twoel`` replaces the Pallas TPU kernel ``repro/kernels/hartree_fock/
kernel.py::twoel_tiled`` and ``twoel_slab`` replaces ``::twoel_slab_tiled``
(the same build with ``l`` limited to a slab ``[l0, l0 + nl)``); one CUDA
kernel serves both.  Bound on the H100 by operations (two ssss integrals,
each with exp, erf, sqrt and about ten divisions, per primitive quartet);
a team of ``team`` threads gathers each F[i,j] and reduces in a fixed
order, with no atomics — see the note at the top of
``csrc/hartree_fock.cu``.

The kernel is compiled by ``nvcc`` at the first launch (``repro_torch._build``)
and called through ``ctypes`` on PyTorch's current stream.  CPU tensors run
the plain versions in ``ref.py``; CUDA tensors launch the kernel, or raise.
``twoel.launches`` and ``twoel_slab.launches`` count the launches each
wrapper makes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import _build
from repro_torch.kernels.hartree_fock import ref

#: declared tunables of the ``cuda`` backend (ops.py registers them):
#: threads gathering one F[i,j] (whole warps) and threads per block
TEAM_GRID = (32, 64, 128)
BLOCK_GRID = (128, 256)
# a warp per F[i,j]: 4096 warps at N = 64 (31 on each of 132 SMs)
TEAM, BLOCK = 32, 128
#: the basis sizes the kernel is instantiated for (the reference's sto_basis)
NGAUSS = (3, 6)
#: shared memory a block may use on Hopper
MAX_SHARED_BYTES = 227 * 1024
# the reference's float32 constant, exactly
_TWO_PI_POW_2_5 = float(np.float32(ref.TWO_PI_POW_2_5))


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("hartree_fock")
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    lib.twoel_f32.argtypes = ([c_void_p] * 4 + [c_int] * 6
                              + [ctypes.c_float, c_void_p])
    lib.twoel_f32.restype = c_int
    lib.twoel_error_string.argtypes = [c_int]
    lib.twoel_error_string.restype = ctypes.c_char_p
    return lib


def pad4(positions: torch.Tensor) -> torch.Tensor:
    """(N, 3) positions -> (N, 4), a zero column appended."""
    return torch.cat([positions, positions.new_zeros(positions.shape[0], 1)],
                     dim=1)


def _check(positions4, density, basis, l0, nl):
    n = positions4.shape[0]
    if positions4.dim() != 2 or positions4.shape[1] != 4:
        raise ValueError(f"twoel takes (N, 4) positions, got "
                         f"{tuple(positions4.shape)}")
    if tuple(density.shape) != (n, n):
        raise ValueError(f"twoel takes an (N, N) density with N = {n}, got "
                         f"{tuple(density.shape)}")
    if not 0 <= l0 < l0 + nl <= n:
        raise ValueError(f"slab l in [{l0}, {l0 + nl}) outside [0, {n})")
    tensors = (positions4, density, basis.exponents, basis.coefficients)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"twoel takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    return tensors


def _launch(positions4, density, basis, l0, nl, team, block):
    """Launch the kernel over the slab; the caller counts the launch."""
    tensors = _check(positions4, density, basis, l0, nl)
    device = positions4.device
    if device.type != "cuda":
        raise ValueError(f"twoel runs on CUDA or CPU tensors, not {device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the twoel kernel takes float32, not "
                        f"{[t.dtype for t in tensors]}")
    if not (positions4.is_contiguous() and density.is_contiguous()):
        raise ValueError("the twoel kernel takes contiguous positions and "
                         "density")
    n, g = positions4.shape[0], basis.ngauss
    if g not in NGAUSS:
        raise ValueError(f"the twoel kernel is built for ngauss in {NGAUSS}, "
                         f"not {g}")
    if team % 32 or block % team or not 32 <= block <= 1024:
        raise ValueError(f"bad launch shape team={team} block={block}")
    if n * nl * g ** 4 >= 2 ** 31:
        raise ValueError(f"N={n}, nl={nl}, ngauss={g}: N * nl * G^4 terms "
                         f"do not fit the kernel's 32-bit loop index")
    shared = 16 * n + 4 * (2 * g + 2) + 8 * (block // 32)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"N={n} positions do not fit in a block's shared "
                         f"memory")
    zc = torch.stack([basis.exponents, basis.coefficients])  # (2, G)
    fock = torch.empty((n, n), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.twoel_f32(
            positions4.data_ptr(), density.data_ptr(), zc.data_ptr(),
            fock.data_ptr(), n, g, l0, nl, team, block, _TWO_PI_POW_2_5,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"twoel kernel launch failed: error {err} "
                           f"({lib.twoel_error_string(err).decode()})")
    return fock


def twoel(positions4: torch.Tensor, density: torch.Tensor, basis: ref.Basis,
          *, team: int = TEAM, block: int = BLOCK) -> torch.Tensor:
    """positions4 (N, 4) [xyz + pad], density (N, N) -> Fock (N, N)."""
    n = positions4.shape[0]
    if positions4.device.type == "cpu":
        _check(positions4, density, basis, 0, n)
        return ref.fock_build(positions4[:, :3], density, basis)
    fock = _launch(positions4, density, basis, 0, n, team, block)
    twoel.launches += 1
    return fock


def twoel_slab(positions4: torch.Tensor, density: torch.Tensor,
               basis: ref.Basis, l0: int, nl: int, *, team: int = TEAM,
               block: int = BLOCK) -> torch.Tensor:
    """Partial Fock build over the quartets with ``l in [l0, l0 + nl)``.

    Summing the slabs of a disjoint cover of ``[0, N)`` gives ``twoel``'s
    result up to the order of summation.
    """
    l0, nl = int(l0), int(nl)
    if positions4.device.type == "cpu":
        _check(positions4, density, basis, l0, nl)
        return ref.fock_build_slab(positions4[:, :3], density, basis, l0, nl)
    fock = _launch(positions4, density, basis, l0, nl, team, block)
    twoel_slab.launches += 1
    return fock


twoel.launches = 0
twoel_slab.launches = 0
