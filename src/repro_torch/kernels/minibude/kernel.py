"""miniBUDE ``fasten``: the wrapper of the CUDA C++ kernel ``csrc/minibude.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/minibude/kernel.py::
fasten_tiled``.  Bound on the H100 by operations (~30 flops, a precise
sqrt and a dozen selects per ligand-atom x protein-atom x pose); each
thread keeps ``ppwi`` poses in registers and the block stages the deck in
shared memory — see the note at the top of ``csrc/minibude.cu``.

The kernel is compiled by ``nvcc`` at the first launch (``repro_torch._build``)
and called through ``ctypes`` on PyTorch's current stream.  CPU tensors run
the plain version in ``ref.py``; CUDA tensors launch the kernel, or raise.
``fasten.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.minibude import ref

#: declared tunables of the ``cuda`` backend (ops.py registers them): poses
#: per thread (each has its own instantiation in the source) and threads
#: per block
PPWI_GRID = (1, 2, 4, 8)
BLOCK_GRID = (64, 128, 256)
# bm1's 65536 poses give 65536/ppwi threads: ppwi = 1 keeps 15.5 warps on
# each of the H100's 132 SMs (ppwi = 2 would leave 7.8); 128-thread blocks
# with the 30 KB deck fit four to an SM, so all 512 blocks are resident
PPWI, BLOCK = 1, 128
#: shared memory a block may use on Hopper
MAX_SHARED_BYTES = 227 * 1024


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("minibude")
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    lib.fasten_f32.argtypes = [c_void_p] * 6 + [c_int] * 5 + [c_void_p]
    lib.fasten_f32.restype = c_int
    lib.fasten_error_string.argtypes = [c_int]
    lib.fasten_error_string.restype = ctypes.c_char_p
    return lib


def fasten(protein_pos: torch.Tensor, protein_par: torch.Tensor,
           ligand_pos: torch.Tensor, ligand_par: torch.Tensor,
           poses: torch.Tensor, *, ppwi: int = PPWI,
           block: int = BLOCK) -> torch.Tensor:
    """BUDE energy of every pose: (6, P) poses -> (P,) energies."""
    deck = (protein_pos, protein_par, ligand_pos, ligand_par, poses)
    natpro, natlig = protein_pos.shape[0], ligand_pos.shape[0]
    shapes = [tuple(t.shape) for t in deck]
    if (any(t.dim() != 2 for t in deck)
            or shapes[:4] != [(natpro, 4), (natpro, 4), (natlig, 4),
                              (natlig, 4)]
            or poses.shape[0] != 6):
        raise ValueError(f"fasten takes (natpro, 4), (natpro, 4), (natlig, "
                         f"4), (natlig, 4) and (6, P) tensors, got {shapes}")
    devices = {t.device for t in deck}
    if len(devices) != 1:
        raise ValueError(f"fasten takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    if poses.device.type == "cpu":
        return ref.fasten(*deck)
    if poses.device.type != "cuda":
        raise ValueError(f"fasten runs on CUDA or CPU tensors, not "
                         f"{poses.device}")
    if any(t.dtype != torch.float32 for t in deck):
        raise TypeError(f"the fasten kernel takes float32, not "
                        f"{[t.dtype for t in deck]}")
    if not all(t.is_contiguous() for t in deck):
        raise ValueError("the fasten kernel takes contiguous tensors")
    if ppwi not in PPWI_GRID or block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"bad launch shape ppwi={ppwi} block={block}")
    shared = 2 * (natpro + natlig) * 16
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"the deck ({natpro} protein + {natlig} ligand "
                         f"atoms, {shared} bytes) does not fit in a block's "
                         f"{MAX_SHARED_BYTES} bytes of shared memory")
    nposes = poses.shape[1]
    out = torch.empty(nposes, dtype=torch.float32, device=poses.device)
    if nposes == 0:
        return out
    lib = _library()
    with torch.cuda.device(poses.device):
        err = lib.fasten_f32(
            *(t.data_ptr() for t in deck), out.data_ptr(), natpro, natlig,
            nposes, ppwi, block, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fasten kernel launch failed: error {err} "
                           f"({lib.fasten_error_string(err).decode()})")
    fasten.launches += 1
    return out


fasten.launches = 0
