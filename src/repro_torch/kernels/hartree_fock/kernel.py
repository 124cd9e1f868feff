"""Hartree-Fock Fock build: the wrappers of the CUDA C++ kernels
``csrc/hartree_fock.cu``.

``twoel`` replaces the Pallas TPU kernel ``repro/kernels/hartree_fock/
kernel.py::twoel_tiled`` and ``twoel_slab`` replaces ``::twoel_slab_tiled``
(the same build with ``l`` limited to a slab ``[l0, l0 + nl)``); one CUDA
source serves both.  A build is three kernel launches: the pair tables,
every distinct integral once into a scratch ``E`` of (N, N, N, nl) floats
(each written to its images with the last index in the slab), and a
fixed-order gather of F from ``E`` — no float atomics, so repeats give the
same bits; see the note at the top of ``csrc/hartree_fock.cu``.  Bound on
the H100 by operations: ~2.8·10⁹ primitive terms, each with an erf, a sqrt
and a division, at N = 128 STO-3G.  A full build whose scratch would pass
``MAX_SCRATCH_BYTES`` runs as the slab builds of ``slab_plan``, summed in
order.

The kernels are compiled by ``nvcc`` at the first launch
(``repro_torch._build``) and called through ``ctypes`` on PyTorch's current
stream.  CPU tensors run the plain versions in ``ref.py``; CUDA tensors
launch the kernels, or raise.  ``twoel.launches`` and
``twoel_slab.launches`` count the builds each wrapper makes: one per call,
of three kernel launches for each slab it runs.  ``build_plan`` (one slab)
and ``launch_plan`` (``twoel``'s slabs) mirror the launcher's arithmetic
(``csrc/hartree_fock.cu``, ``twoel_f32``) for the static auditor, which
calls the wrappers on ``meta`` tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import _build
from repro_torch.core.portable import (Launch, Tile, launch_observed,
                                       no_grad_kernel)
from repro_torch.kernels.hartree_fock import ref

#: the declared tunable of the ``cuda`` backend (ops.py registers it): the
#: threads gathering one F[i,j] (whole warps of a 256-thread block)
TEAM_GRID = (32, 64, 128)
TEAM = 128
#: the edge of a bra-pair x ket-pair tile of integrals (csrc's kTile)
TILE = 32
#: the basis sizes the kernel is instantiated for (the reference's sto_basis)
NGAUSS = (3, 6)
#: every kernel's block (csrc's kThreads)
THREADS = 256
#: the largest integral scratch a slab build allocates: 4 N^3 nl bytes
#: (1.07 GB for the whole of N = 128); a full build fits it up to N = 215
MAX_SCRATCH_BYTES = 8 << 30
# the reference's float32 constant, exactly
_TWO_PI_POW_2_5 = float(np.float32(ref.TWO_PI_POW_2_5))

#: the ``csrc/`` sources this module loads (the tuning cache's code hash
#: reads them: no Python name reaches a ``.cu``)
CUDA_SOURCES = ("hartree_fock",)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(CUDA_SOURCES[0])
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    lib.twoel_f32.argtypes = ([c_void_p] * 8 + [c_int] * 9
                              + [ctypes.c_float, c_void_p])
    lib.twoel_f32.restype = c_int
    lib.twoel_error_string.argtypes = [c_int]
    lib.twoel_error_string.restype = ctypes.c_char_p
    return lib


def pad4(positions: torch.Tensor) -> torch.Tensor:
    """(N, 3) positions -> (N, 4), a zero column appended."""
    return torch.cat([positions, positions.new_zeros(positions.shape[0], 1)],
                     dim=1)


def scratch_bytes(natoms: int, nl: Optional[int] = None) -> int:
    """Bytes of the integral scratch ``E`` a build over a slab of ``nl``
    (every ``l`` by default) allocates: 4 N^3 nl."""
    return 4 * natoms ** 3 * (natoms if nl is None else nl)


def slab_plan(natoms: int) -> List[Tuple[int, int]]:
    """The ``(l0, nl)`` slabs a full build runs as: the whole of
    ``[0, N)`` while its scratch fits ``MAX_SCRATCH_BYTES``, else slabs of
    the widest ``nl`` that fits, in order."""
    width = min(natoms, MAX_SCRATCH_BYTES // scratch_bytes(natoms, 1))
    if width < 1:
        raise ValueError(f"N={natoms}: a slab of one l takes "
                         f"{scratch_bytes(natoms, 1)} bytes of integral "
                         f"scratch, above the {MAX_SCRATCH_BYTES} byte limit")
    return [(l0, min(width, natoms - l0)) for l0 in range(0, natoms, width)]


class Tiling(NamedTuple):
    """The integral kernel's launch over a slab: the canonical pairs in
    ``ref.pair_order``'s rank order, the ``s`` of them that hold a slab
    index ranked first, and the grid of TILE x TILE pair tiles,
    ``ubs = ceil(m / TILE)`` bra by ``vbs = ceil(s / TILE)`` ket tiles, of
    which the blocks with bra tile >= ket tile compute."""

    i: torch.Tensor
    j: torch.Tensor
    s: int
    ubs: int
    vbs: int

    @property
    def m(self) -> int:
        return self.i.shape[0]


def tiling(natoms: int, l0: int = 0, nl: Optional[int] = None) -> Tiling:
    i, j, s = ref.pair_order(natoms, l0, nl)
    return Tiling(i, j, s, math.ceil(i.shape[0] / TILE), math.ceil(s / TILE))


@functools.lru_cache(maxsize=None)
def _plan(natoms: int, l0: int, nl: int, device: torch.device):
    # the tiling, its pairs packed as i << 16 | j on the device; made once
    # per slab and device
    t = tiling(natoms, l0, nl)
    return t, ((t.i << 16) | t.j).to(device=device, dtype=torch.int32)


def _eri_images(i: int, j: int, k: int, l: int, l0: int, nl: int):
    """The slots of E that ``eri_kernel`` writes (ij|kl) to: its images
    whose last index lies in the slab, as E indices (a, b, c, d - l0)."""
    out = []
    for a, b, c, d in ((i, j, k, l), (j, i, k, l), (i, j, l, k),
                       (j, i, l, k), (k, l, i, j), (l, k, i, j),
                       (k, l, j, i), (l, k, j, i)):
        if l0 <= d < l0 + nl:
            out.append((a, b, c, d - l0))
    return out


def build_plan(positions4, density, basis, l0, nl, *, team: int = TEAM):
    """The three launches of one build over the slab ``[l0, l0 + nl)``:
    the pair tables, a thread a (pair, primitive pair) row; the integrals,
    a block a bra x ket tile of ``TILE`` pairs whose bra tile is not below
    its ket tile, each integral written to every image in E whose last
    index is in the slab (so every slot of E exactly once); the gather, a
    team of threads an F[i, j], reading E[i, j, :, :] and E[i, :, j, :]."""
    from repro_torch.kernels.hartree_fock import ops
    n, g = positions4.shape[0], basis.ngauss
    g2 = g * g
    t = tiling(n, l0, nl)
    m, s_ = t.m, t.s
    pi, pj = t.i.tolist(), t.j.tolist()
    work = max(m * g2, g2 * g2)

    def first(x, y, z):
        return (0, 0) if x == 0 else None

    def rows(limit):
        return lambda x, y, z: (x, 0) if x * THREADS < limit else None

    def eri_writes(ub, vb, z):
        if ub < vb:
            return None                  # below the diagonal: returns
        out = set()
        for u in range(ub * TILE, min((ub + 1) * TILE, m)):
            for v in range(vb * TILE, min((vb + 1) * TILE, s_, u + 1)):
                out.update(_eri_images(pi[u], pj[u], pi[v], pj[v], l0, nl))
        return sorted(out)

    per_block = THREADS // team

    def fock_tiles(x, y, z):
        return (x,)

    def e_rows(x, y, z):
        outs = range(x * per_block, min((x + 1) * per_block, n * n))
        return [(o // n, o % n, 0, 0) for o in outs]

    def e_columns(x, y, z):
        outs = range(x * per_block, min((x + 1) * per_block, n * n))
        return [(o // n, 0, o % n, 0) for o in outs]

    table = Tile("table", (m * g2, 4), (THREADS, 4), rows(m * g2))
    eri = (n, n, n, nl)
    smem = 16 * g2 * TILE + 8 * g2 * g2
    return [
        Launch("pair_table_kernel", (-(-work // THREADS), 1, 1),
               (THREADS, 1, 1),
               outputs=(table, Tile("pp", (g2 * g2, 2), (THREADS, 2),
                                    rows(g2 * g2))),
               inputs=(Tile("positions4", (n, 4), (n, 4), first),
                       Tile("basis", (2, g), (2, g), first),
                       Tile("pairs", (m, 1), (m, 1), first)),
               flops=float(ops.table_flops(n, g))),
        Launch(f"eri_kernel<{g}>", (t.ubs, t.vbs, 1), (THREADS, 1, 1),
               outputs=(Tile("E", eri, (1, 1, 1, 1), eri_writes),),
               inputs=(Tile("table bra", (m * g2, 4), (TILE * g2, 4),
                            lambda ub, vb, z: (ub, 0) if ub >= vb else None),
                       Tile("table ket", (m * g2, 4), (TILE * g2, 4),
                            lambda ub, vb, z: (vb, 0) if ub >= vb else None),
                       Tile("pp", (g2 * g2, 2), (g2 * g2, 2),
                            lambda ub, vb, z: (0, 0) if ub >= vb else None)),
               smem=smem,
               flops=float(ops.computed_integrals(n, l0, nl)
                           * ops.TERM_FLOPS * g2 * g2)),
        Launch("fock_gather_kernel", (-(-n * n // per_block), 1, 1),
               (THREADS, 1, 1),
               outputs=(Tile("fock", (n * n,), (per_block,), fock_tiles),),
               inputs=(Tile("E rows", eri, (1, 1, n, nl), e_rows),
                       Tile("E columns", eri, (1, n, 1, nl), e_columns),
                       Tile("density", (n, n), (n, n), first)),
               flops=3.0 * n * n * n * nl, flops_dtype="float64"),
    ]


def launch_plan(positions4, density, basis, *, team: int = TEAM):
    """``twoel``'s launches: ``build_plan`` for each slab of
    ``slab_plan(N)``, in order (raises where ``slab_plan`` does)."""
    return [launch for l0, nl in slab_plan(positions4.shape[0])
            for launch in build_plan(positions4, density, basis, l0, nl,
                                     team=team)]


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


def _launch(positions4, density, basis, l0, nl, team):
    """One build over the slab (three kernel launches): (F, whether it
    launched; False when the static auditor took its plan).  The caller
    counts it."""
    tensors = _check(positions4, density, basis, l0, nl)
    device = positions4.device
    if device.type not in ("cuda", "meta"):
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
    if team not in TEAM_GRID:
        raise ValueError(f"bad launch shape team={team}: team in "
                         f"{TEAM_GRID}")
    scratch = scratch_bytes(n, nl)
    if scratch > MAX_SCRATCH_BYTES:
        raise ValueError(f"N={n}, nl={nl}: the integral scratch takes "
                         f"{scratch} bytes, above the {MAX_SCRATCH_BYTES} "
                         f"byte limit; split the build into smaller slabs "
                         f"(slab_plan)")
    fock = torch.empty((n, n), dtype=torch.float32, device=device)
    if launch_observed("hartree_fock.twoel", device, build_plan, positions4,
                       density, basis, l0, nl, team=team):
        return fock, False
    t, pairs = _plan(n, l0, nl, device)
    m = t.m
    zc = torch.stack([basis.exponents, basis.coefficients])  # (2, G)
    table = torch.empty((m, g * g, 4), dtype=torch.float32, device=device)
    pp = torch.empty((g ** 4, 2), dtype=torch.float32, device=device)
    eri = torch.empty(scratch // 4, dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.twoel_f32(
            positions4.data_ptr(), density.data_ptr(), zc.data_ptr(),
            pairs.data_ptr(), table.data_ptr(), pp.data_ptr(),
            eri.data_ptr(), fock.data_ptr(), n, g, l0, nl, m, t.s, t.ubs,
            t.vbs, team, _TWO_PI_POW_2_5,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"twoel kernel launch failed: error {err} "
                           f"({lib.twoel_error_string(err).decode()})")
    return fock, True


def twoel(positions4: torch.Tensor, density: torch.Tensor, basis: ref.Basis,
          *, team: int = TEAM) -> torch.Tensor:
    """positions4 (N, 4) [xyz + pad], density (N, N) -> Fock (N, N).

    On CUDA tensors one build of the slabs of ``slab_plan(N)``: a single
    slab up to N = 215, past it the partial builds summed in order, so
    repeats still give the same bits."""
    no_grad_kernel("hartree_fock.twoel", positions4, density)
    n = positions4.shape[0]
    if positions4.device.type == "cpu":
        _check(positions4, density, basis, 0, n)
        return ref.fock_build(positions4[:, :3], density, basis)
    fock, launched = None, False
    for l0, nl in slab_plan(n):
        part, launched = _launch(positions4, density, basis, l0, nl, team)
        fock = part if fock is None else fock + part
    twoel.launches += launched
    return fock


def twoel_slab(positions4: torch.Tensor, density: torch.Tensor,
               basis: ref.Basis, l0: int, nl: int, *,
               team: int = TEAM) -> torch.Tensor:
    """Partial Fock build over the quartets with ``l in [l0, l0 + nl)``.

    Summing the slabs of a disjoint cover of ``[0, N)`` gives ``twoel``'s
    result up to the order of summation.
    """
    no_grad_kernel("hartree_fock.twoel_slab", positions4, density)
    l0, nl = int(l0), int(nl)
    if positions4.device.type == "cpu":
        _check(positions4, density, basis, l0, nl)
        return ref.fock_build_slab(positions4[:, :3], density, basis, l0, nl)
    fock, launched = _launch(positions4, density, basis, l0, nl, team)
    twoel_slab.launches += launched
    return fock


twoel.launches = 0
twoel_slab.launches = 0
