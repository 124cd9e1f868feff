"""Composite sharded backends: the hand-written kernels once per shard.

The port of ``repro.distributed.shard_pallas``.  The paper's portability
claim (Eq. 4) rests on the *same* kernel source serving every tier; here
each science family's hand-written Hopper kernel runs *unchanged* once per
shard of the meshes ``domain.py`` decomposes over, through the same
decomposition code as ``torch_shard`` (``domain.stencil_decomposed`` and
its siblings, given the kernel's wrapper as the per-shard callable), so the
shard grid composes with the kernel's own tile tunables in one
``TunableSpace``:

  * **stencil7** (``shard_cuda``, ``csrc/stencil7.cu``) — the halo exchange
    fills each shard's padded block and the unchanged kernel computes it;
    the halo planes and columns are sliced away.  Every kept cell is
    computed by the kernel on exact neighbour values, with the same
    instructions whatever its place in the block, so the sharded field is
    **bitwise identical to the single-device ``cuda`` backend** at the same
    tile point — including the one-plane-per-shard edge, where the whole
    padded block but its middle plane is halo;
  * **babelstream** (``shard_triton``, ``kernels/babelstream/kernel.py``) —
    the block partition feeds the Triton stream kernels (bitwise); ``dot``
    reduces each block with the two-pass Triton reduction and one ``psum``
    adds the partials (fp-reduction tolerance);
  * **minibude.fasten** (``shard_cuda``, ``csrc/minibude.cu``) — pose slabs
    through the kernel; a pose's energy is summed in the same order
    whatever the number of poses in the call, so the composite is bitwise;
  * **hartree_fock.twoel** (``shard_cuda``, ``csrc/hartree_fock.cu``) —
    each shard runs the l-slab build ``kernels/hartree_fock/kernel.py::
    twoel_slab`` over its range of ``l``, and one ``psum`` adds the partial
    Fock matrices (fp-reduction tolerance).

**Dead columns.**  The reference's pencil pads the y-padded width up to a
multiple of its Pallas ``by`` tile with dead zero columns
(``shard_pallas.py::_pencil_local_pallas``).  The port's stencil kernel
masks its ragged tiles and takes any ``ny``, so the padded block has none.

**Launch plans.**  A composite's plan is its shards' plans in shard
order: each shard's call reaches its kernel's wrapper, which hands the
static auditor its own ``launch_plan`` (``portable.launch_observed``), so
the trace of a composite holds every shard's launches as the card runs
them.

Like the reference's ``shard_pallas``, the composites have no overlap
variant.  Availability is the family's hand-written probe (``cuda_probe``
or ``triton_probe``) and nothing more.  **No fallback**: a composite whose
kernel cannot build or launch raises; it never runs the plain version
(a wrapper runs its plain version only for a tensor that lies on the CPU,
which the tests use to drive this code path there).  Per-shard work is
enqueued on its device's current stream, with no side streams, so a
composite on one card is captured as one CUDA graph by ``time_graph``.
"""

from __future__ import annotations

import functools
from typing import Optional

from repro_torch.core.portable import cuda_probe, get_kernel, triton_probe
from repro_torch.distributed.domain import (NO_COLLECTIVES, ONE_PSUM,
                                            SHARD_GRID, STENCIL_DECOMPS,
                                            STENCIL_SHARD_GRIDS, _places,
                                            _shard_ok, _stencil_point_ok,
                                            fasten_decomposed,
                                            fock_decomposed,
                                            mesh_device_count,
                                            resolve_num_shards,
                                            stencil_decomposed, stencil_grid,
                                            stream_call)
from repro_torch.kernels.babelstream import kernel as stream_K
from repro_torch.kernels.hartree_fock import kernel as hf_K
from repro_torch.kernels.hartree_fock import ops as hf_ops
from repro_torch.kernels.minibude import kernel as mb_K
from repro_torch.kernels.stencil7 import kernel as s7_K

__all__ = [
    "CUDA_SHARD_BACKEND",
    "TRITON_SHARD_BACKEND",
    "laplacian_shard_cuda",
    "stream_shard_triton_fns",
    "fasten_shard_cuda",
    "fock_shard_cuda",
    "stencil_kernels_comm_contract",
    "register_shard_kernel_backends",
]

#: registry backend names: the sharded composition of the CUDA C++ and the
#: Triton kernels
CUDA_SHARD_BACKEND = "shard_cuda"
TRITON_SHARD_BACKEND = "shard_triton"


# --------------------------------------------------------------------------
# stencil7: halo-padded blocks through the unchanged CUDA kernel
# --------------------------------------------------------------------------
def laplacian_shard_cuda(u, invhx2=1.0, invhy2=1.0, invhz2=1.0,
                         invhxyz2=-6.0, *, num_shards: Optional[int] = None,
                         decomp: str = "slab", shard_grid=None,
                         block_x: int = s7_K.BLOCK_X,
                         block_y: int = s7_K.BLOCK_Y,
                         zchunk: int = s7_K.ZCHUNK):
    """Domain-decomposed seven-point stencil on ``csrc/stencil7.cu``.

    The shard grid resolves exactly like ``domain.laplacian_shard`` (slab
    splits z, pencil splits z and y); ``block_x``/``block_y``/``zchunk``
    launch the kernel on each shard's padded block.  Bitwise identical to
    the single-device ``cuda`` backend at the same tile point.
    """
    sz, sy = stencil_grid(u, num_shards, decomp, shard_grid)
    local = functools.partial(s7_K.laplacian, invhx2=invhx2, invhy2=invhy2,
                              invhz2=invhz2, invhxyz2=invhxyz2,
                              block_x=block_x, block_y=block_y,
                              zchunk=zchunk)
    return stencil_decomposed(u, local, sz, sy)


# --------------------------------------------------------------------------
# BabelStream: block partition through the Triton stream kernels
# --------------------------------------------------------------------------
#: op -> (array arguments, takes a scalar)
_STREAM_ARGS = {"copy": (1, False), "mul": (1, True), "add": (2, False),
                "triad": (2, True), "dot": (2, False)}


def _make_stream_shard_triton(op, nargs, takes_scalar):
    kernel = getattr(stream_K, op)

    def run(*args, scalar: Optional[float] = None,
            num_shards: Optional[int] = None, block: int = stream_K.BLOCK,
            num_warps: int = stream_K.NUM_WARPS):
        local = functools.partial(kernel, block=block, num_warps=num_warps)
        return stream_call(op, args, nargs, takes_scalar, scalar,
                           num_shards, local)
    run.__name__ = f"{op}_shard_triton"
    return run


def stream_shard_triton_fns():
    """op name -> sharded-Triton backend fn (the oracle's signatures plus
    ``num_shards``, ``block`` and ``num_warps``)."""
    return {op: _make_stream_shard_triton(op, nargs, takes_scalar)
            for op, (nargs, takes_scalar) in _STREAM_ARGS.items()}


# --------------------------------------------------------------------------
# miniBUDE: pose slabs through the fasten kernels
# --------------------------------------------------------------------------
def fasten_shard_cuda(protein_pos, protein_par, ligand_pos, ligand_par,
                      poses, *, num_shards: Optional[int] = None,
                      ppwi: int = mb_K.PPWI, split: int = mb_K.SPLIT):
    """Pose-parallel miniBUDE energies on ``csrc/minibude.cu``."""
    s = resolve_num_shards(poses.shape[1], num_shards,
                           mesh_device_count(poses.device))
    local = functools.partial(mb_K.fasten, ppwi=ppwi, split=split)
    return fasten_decomposed(
        (protein_pos, protein_par, ligand_pos, ligand_par, poses), local, s)


# --------------------------------------------------------------------------
# Hartree-Fock: l-slab builds, psum Fock accumulation
# --------------------------------------------------------------------------
def fock_shard_cuda(positions, density, *, ngauss: int = 3,
                    num_shards: Optional[int] = None, team: int = hf_K.TEAM):
    """Distributed two-electron Fock build on ``csrc/hartree_fock.cu``:
    each shard's ``twoel_slab`` over its range of ``l``, one ``psum``."""
    s = resolve_num_shards(positions.shape[0], num_shards,
                           mesh_device_count(positions.device))

    def local(p, d, l0, nl):
        return hf_K.twoel_slab(hf_K.pad4(p), d,
                               hf_ops._basis(ngauss, p.dtype, p.device),
                               l0, nl, team=team)
    return fock_decomposed(positions, density, local, s)


# --------------------------------------------------------------------------
# registration: plug into the existing PortableKernel registry
# --------------------------------------------------------------------------
def stencil_kernels_comm_contract(u, *args):
    """The composite stencil's collectives: the halo exchange of
    ``torch_shard`` (slab: 2 ppermutes, pencil: 4); no overlap variants, as
    the composite has no overlap knob."""
    return [
        ({"decomp": "slab"}, {**NO_COLLECTIVES, "ppermute": 2}),
        ({"decomp": "pencil"}, {**NO_COLLECTIVES, "ppermute": 4}),
    ]


def register_shard_kernel_backends() -> None:
    """Attach the ``shard_cuda``/``shard_triton`` backends + composite tile
    x shard tunables to every science family.  Idempotent."""
    k = get_kernel("stencil7")
    if CUDA_SHARD_BACKEND not in k.backends:
        k.add_backend(CUDA_SHARD_BACKEND, laplacian_shard_cuda,
                      probe=cuda_probe)
        # the kernel takes any block shape of the grid on any padded
        # block, so only the shard grid constrains the space
        k.declare_tunables(
            CUDA_SHARD_BACKEND, decomp=STENCIL_DECOMPS,
            shard_grid=STENCIL_SHARD_GRIDS, block_x=s7_K.BLOCK_X_GRID,
            block_y=s7_K.BLOCK_Y_GRID, zchunk=s7_K.ZCHUNK_GRID,
            constraint=lambda p, u, *a, device_count=None, **kw:
                _stencil_point_ok(p, u.shape[0], u.shape[1],
                                  _places(u, device_count)))
        k.declare_comm_contract(CUDA_SHARD_BACKEND,
                                stencil_kernels_comm_contract)
        k.declare_roofline_contract(CUDA_SHARD_BACKEND, bound="memory")

    for op, fn in stream_shard_triton_fns().items():
        k = get_kernel(f"babelstream.{op}")
        if TRITON_SHARD_BACKEND in k.backends:
            continue
        k.add_backend(TRITON_SHARD_BACKEND, fn, probe=triton_probe)
        # the tail is masked, so every tile point is valid for every block
        k.declare_tunables(
            TRITON_SHARD_BACKEND, num_shards=SHARD_GRID,
            block=stream_K.BLOCK_GRID, num_warps=stream_K.NUM_WARPS_GRID,
            constraint=lambda p, *arrays, device_count=None, **kw:
                _shard_ok(p["num_shards"], arrays[0].shape[0],
                          _places(arrays[0], device_count)))
        k.declare_comm_contract(
            TRITON_SHARD_BACKEND, ONE_PSUM if op == "dot" else NO_COLLECTIVES)
        # streaming AI is shard-invariant: memory-bound
        k.declare_roofline_contract(TRITON_SHARD_BACKEND, bound="memory")

    k = get_kernel("minibude.fasten")
    if CUDA_SHARD_BACKEND not in k.backends:
        k.add_backend(CUDA_SHARD_BACKEND, fasten_shard_cuda, probe=cuda_probe)
        k.declare_tunables(
            CUDA_SHARD_BACKEND, num_shards=SHARD_GRID, ppwi=mb_K.PPWI_GRID,
            split=mb_K.SPLIT_GRID,
            constraint=lambda p, *deck, device_count=None, **kw:
                _shard_ok(p["num_shards"], deck[4].shape[1],
                          _places(deck[4], device_count)))
        k.declare_comm_contract(CUDA_SHARD_BACKEND, NO_COLLECTIVES)
        # no pinned bound (the reference's shard_pallas pins none either):
        # every shard builds its own pair table, which at the conformance
        # deck (64 poses a shard) moves more bytes than its poses' work
        # needs, and bm1's deck is compute-bound again

    k = get_kernel("hartree_fock.twoel")
    if CUDA_SHARD_BACKEND not in k.backends:
        k.add_backend(CUDA_SHARD_BACKEND, fock_shard_cuda, probe=cuda_probe)
        k.declare_tunables(
            CUDA_SHARD_BACKEND, num_shards=SHARD_GRID, team=hf_K.TEAM_GRID,
            constraint=lambda p, positions, *a, device_count=None, **kw:
                _shard_ok(p["num_shards"], positions.shape[0],
                          _places(positions, device_count)))
        k.declare_comm_contract(CUDA_SHARD_BACKEND, ONE_PSUM)
        # each shard's slab build has its own integral scratch and pair
        # tables (the cuda backend's note in hartree_fock/ops.py), and the
        # psum's partials come on top: 382x the floor over 8 shards at
        # the conformance case (N = 8)
        k.declare_roofline_contract(CUDA_SHARD_BACKEND, bound="compute",
                                    traffic_inflation_limit=512.0)


register_shard_kernel_backends()
