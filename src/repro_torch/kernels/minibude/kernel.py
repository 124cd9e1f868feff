"""miniBUDE ``fasten``: the wrapper of the CUDA C++ kernels ``csrc/minibude.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/minibude/kernel.py::
fasten_tiled``.  Bound on the H100 by operations (a distance with a precise
sqrt and the three energy terms per ligand-atom x protein-atom x pose).
The pose-independent pair constants are computed once a call, by
``bude_pair_kernel`` into a workspace from PyTorch's caching allocator;
``fasten_kernel`` gives a block ``32 * ppwi`` poses and ``split`` warps,
each over a slice of the protein, and adds the slices in warp order — see
the note at the top of ``csrc/minibude.cu``.

The kernels are compiled by ``nvcc`` at the first launch (``repro_torch._build``)
and called through ``ctypes`` on PyTorch's current stream.  CPU tensors run
the plain version in ``ref.py``; CUDA tensors launch the kernels, or raise.
``fasten.launches`` counts the calls that launched them.  ``launch_plan``
mirrors the launcher's arithmetic (``csrc/minibude.cu``, ``fasten_f32`` and
``launch``) for the static auditor, which calls the wrapper on ``meta``
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.core.portable import (Launch, Tile, launch_observed,
                                       no_grad_kernel)
from repro_torch.kernels.minibude import ref

#: declared tunables of the ``cuda`` backend (ops.py registers them): poses
#: per lane (each has its own instantiation in the source) and warps per
#: block, each over its own protein slice
PPWI_GRID = (1, 2, 4, 8, 16)
SPLIT_GRID = (1, 2, 4, 8)
# bm1's 65536 poses make 65536 / (32 ppwi) blocks of `split` warps:
# ppwi 4 x split 8 is 512 blocks of 256 threads, 31 warps on each of the
# H100's 132 SMs (four blocks fit on one), each pair row read for 4 poses a
# lane; the fastest point of the sweep at bm1 and at 16 x its poses
# (PERF.md)
PPWI, SPLIT = 4, 8
#: the pair table's workspace (32 bytes a pair) above which a deck is
#: refused
MAX_TABLE_BYTES = 8 << 30
_INT32_MAX = 2 ** 31 - 1
#: csrc's constants: the pair kernel's block and the pair rows an energy
#: block stages at a time
PAIR_THREADS, STAGE = 256, 1024


def check_deck(natpro: int, natlig: int, nposes: int) -> None:
    """``ValueError`` for a deck the kernels cannot run: one whose offsets
    pass 32 bits (they index the poses up to ``6 * nposes`` and the atoms'
    rows up to ``4 * natpro`` and ``4 * natlig`` as int), or whose pair
    table needs more than ``MAX_TABLE_BYTES`` of workspace."""
    if max(6 * nposes, 4 * natpro, 4 * natlig) > _INT32_MAX:
        raise ValueError(f"the deck ({natpro} protein atoms, {natlig} ligand "
                         f"atoms, {nposes} poses) is above the kernel's "
                         f"32-bit offsets")
    need = 32 * natpro * natlig
    if need > MAX_TABLE_BYTES:
        raise ValueError(f"the pair table of {natlig} x {natpro} pairs "
                         f"({need} bytes) is above {MAX_TABLE_BYTES} bytes")

#: the ``csrc/`` sources this module loads (the tuning cache's code hash
#: reads them: no Python name reaches a ``.cu``)
CUDA_SOURCES = ("minibude",)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(CUDA_SOURCES[0])
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    lib.fasten_f32.argtypes = [c_void_p] * 7 + [c_int] * 5 + [c_void_p]
    lib.fasten_f32.restype = c_int
    lib.fasten_error_string.argtypes = [c_int]
    lib.fasten_error_string.restype = ctypes.c_char_p
    return lib


def _whole(*xyz):
    return (0, 0)


def launch_plan(protein_pos, protein_par, ligand_pos, ligand_par, poses, *,
                ppwi: int = PPWI, split: int = SPLIT):
    """The two launches of ``fasten``: the pair table, a thread a pair
    (protein atom fastest), then the energies, a block of ``32 ppwi``
    poses and ``split`` warps.  Every energy block reads the whole pair
    table and the protein positions (staged through shared memory): the
    re-reads the census counts.  The small parameter rows are read once."""
    from repro_torch.kernels.minibude import ops
    natpro, natlig = protein_pos.shape[0], ligand_pos.shape[0]
    nposes = poses.shape[1]
    if nposes == 0:
        return []
    pairs = natpro * natlig
    kposes = 32 * ppwi
    slice_ = -(-natpro // split)
    chunk = max(1, min(slice_, STAGE // split))
    smem = 16 * 3 * split * chunk + 4 * (12 + split) * kposes
    table = (natlig * natpro * 2, 4)

    def first(x, y, z):
        return (0, 0) if x == 0 else None

    plan = []
    if pairs:
        plan.append(Launch(
            "bude_pair_kernel", (-(-pairs // PAIR_THREADS), 1, 1),
            (PAIR_THREADS, 1, 1),
            outputs=(Tile("table", table, (2 * PAIR_THREADS, 4),
                          lambda x, y, z: (x, 0)),),
            inputs=(Tile("protein_par", (natpro, 4), (natpro, 4), first),
                    Tile("ligand_par", (natlig, 4), (natlig, 4), first)),
            flops=float(ops.PAIR_FLOPS * pairs)))
    plan.append(Launch(
        f"fasten_kernel<{ppwi}>", (-(-nposes // kposes), 1, 1),
        (32 * split, 1, 1),
        outputs=(Tile("energies", (nposes,), (kposes,),
                      lambda x, y, z: (x,)),),
        inputs=(Tile("poses", (6, nposes), (6, kposes),
                     lambda x, y, z: (0, x)),
                Tile("table", table, table, _whole),
                Tile("protein_pos", (natpro, 4), (natpro, 4), _whole),
                Tile("ligand_pos", (natlig, 4), (natlig, 4), _whole)),
        smem=smem,
        flops=float(ops.INTERACTION_FLOPS * pairs * nposes
                    + ops.LIGAND_FLOPS * natlig * nposes
                    + ops.POSE_FLOPS * nposes)))
    return plan


def fasten(protein_pos: torch.Tensor, protein_par: torch.Tensor,
           ligand_pos: torch.Tensor, ligand_par: torch.Tensor,
           poses: torch.Tensor, *, ppwi: int = PPWI,
           split: int = SPLIT) -> torch.Tensor:
    """BUDE energy of every pose: (6, P) poses -> (P,) energies."""
    deck = (protein_pos, protein_par, ligand_pos, ligand_par, poses)
    no_grad_kernel("minibude.fasten", *deck)
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
    if poses.device.type not in ("cuda", "meta"):
        raise ValueError(f"fasten runs on CUDA or CPU tensors, not "
                         f"{poses.device}")
    if any(t.dtype != torch.float32 for t in deck):
        raise TypeError(f"the fasten kernel takes float32, not "
                        f"{[t.dtype for t in deck]}")
    if not all(t.is_contiguous() for t in deck):
        raise ValueError("the fasten kernel takes contiguous tensors")
    if ppwi not in PPWI_GRID or split not in SPLIT_GRID:
        raise ValueError(f"bad launch shape ppwi={ppwi} split={split}")
    nposes = poses.shape[1]
    check_deck(natpro, natlig, nposes)
    out = torch.empty(nposes, dtype=torch.float32, device=poses.device)
    if nposes == 0:
        return out
    # the pair table, from the caching allocator on the current stream
    work = torch.empty((natlig, natpro, 8), dtype=torch.float32,
                       device=poses.device)
    if launch_observed("minibude.fasten", poses.device, launch_plan, *deck,
                       ppwi=ppwi, split=split):
        return out
    lib = _library()
    with torch.cuda.device(poses.device):
        err = lib.fasten_f32(
            *(t.data_ptr() for t in deck),
            work.data_ptr(), out.data_ptr(),
            natpro, natlig, nposes, ppwi, split,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fasten kernel launch failed: error {err} "
                           f"({lib.fasten_error_string(err).decode()})")
    fasten.launches += 1
    return out


fasten.launches = 0
