"""Domain decomposition: the science kernels as sharded registry backends.

The port of ``repro.distributed.domain``.  The paper measures portability
across compiler backends on one GPU; the Eq.-4 methodology generalises to
the device-count axis, and this module supplies it: each science-kernel
family gains a ``torch_shard`` backend (``xla_shard`` in the reference)
that runs the port's plain ``torch`` functions once per shard of a mesh —

  * **stencil7** — 1-D z slabs or 2-D ``(sz, sy)`` pencils, a halo exchange
    per decomposed axis (``collectives.halo_exchange`` /
    ``halo_exchange_nd``) and an ``overlap=True`` variant that computes the
    halo-free interior from the raw block and patches only the O(surface)
    boundary planes from the halos; every variant applies the unchanged
    plain arithmetic, so the sharded field is *bitwise identical* to the
    single-device result;
  * **babelstream** — block-partitioned 1-D arrays; copy/mul/add/triad are
    embarrassingly parallel (bitwise identical), ``dot`` reduces each block
    in the accumulation dtype and combines the partials with one ``psum``;
  * **minibude.fasten** — pose-parallel: poses shard, the protein/ligand
    decks replicate, per-pose energies are independent (bitwise identical);
  * **hartree_fock.twoel** — each shard builds the partial Fock matrix of
    its range of the quartet index ``l``, and one ``psum`` adds them.

Each family's decomposition is written once, over a per-shard callable
(``stencil_decomposed``, ``stream_decomposed``, ``fasten_decomposed``,
``fock_decomposed``): ``torch_shard`` passes the plain functions, and
``shard_kernels.py`` the hand-written kernels' wrappers (``shard_cuda``,
``shard_triton``), so both run one code path.

**The mesh.**  The port is single-controller: a mesh is a list of shard
*places*, shard ``i`` on ``devices[i % len(devices)]``, where ``devices``
are the visible CUDA devices for CUDA tensors and the CPU for CPU tensors.
The mesh holds as many places as there are cards where there are two or
more; otherwise ``PLACES_ON_ONE_DEVICE`` (8) places share the one device,
the counterpart of the reference's ``selftest --devices 8`` on forced host
devices.  So the sharded backends run on a single H100, where the
reference's need two or more devices.  **Each shard owns its own buffer**,
allocated for it even when shards share a card, never a view into a
neighbour's block: a halo exchange on one card copies the bytes it would
copy between cards.  The stencil keeps each shard's block in a padded
buffer whose halo planes the exchange fills, so the per-shard kernel reads
one contiguous block (``StencilShards``).

The phases of a call are apart, so that a caller can time the resident
step alone: ``distribute_stencil`` (the volume into per-shard buffers),
``stencil_step`` (halo exchange + per-shard compute on buffers that are
already sharded) and ``collect_stencil`` (the kept blocks into one
volume).  Per-shard work is enqueued on its device's current stream, with
no side streams, so a composite on one card can be captured as one CUDA
graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core.portable import get_kernel
from repro_torch.distributed import collectives

# the kernel families' modules are imported at the bottom: importing any of
# them runs repro_torch.kernels' __init__, which imports this module and
# then shard_kernels.py, which needs the names defined above it

__all__ = [
    "AXIS",
    "AXIS_Z",
    "AXIS_Y",
    "SHARD_BACKEND",
    "SHARD_GRID",
    "STENCIL_DECOMPS",
    "STENCIL_SHARD_GRIDS",
    "OVERLAP_GRID",
    "PLACES_ON_ONE_DEVICE",
    "placement",
    "mesh_devices",
    "mesh_device_count",
    "shard_mesh",
    "shard_mesh2d",
    "resolve_num_shards",
    "balanced_pencil_grid",
    "resolve_shard_grid",
    "StencilShards",
    "stencil_grid",
    "distribute_stencil",
    "stencil_step",
    "collect_stencil",
    "stencil_decomposed",
    "stream_decomposed",
    "stream_call",
    "fasten_decomposed",
    "fock_decomposed",
    "laplacian_shard",
    "stream_shard_fns",
    "fasten_shard",
    "fock_shard",
    "NO_COLLECTIVES",
    "ONE_PSUM",
    "stencil_comm_contract",
    "register_sharded_backends",
]

#: mesh axis every 1-D sharded kernel maps over (the reference's names; the
#: port's meshes are lists, and these label them in messages and docs)
AXIS = "shards"
#: named axes of the 2-D pencil mesh (z outermost, matching array layout)
AXIS_Z = "shards_z"
AXIS_Y = "shards_y"
#: registry backend name (the plain torch arithmetic, sharded)
SHARD_BACKEND = "torch_shard"
#: num_shards grid declared to the autotuner (1-D decompositions)
SHARD_GRID = (2, 4, 8)
#: stencil7 decomposition tunables: the shape of the shard grid is a
#: tunable, not a hard-coded choice (slab = (s, 1); pencil splits z AND y)
STENCIL_DECOMPS = ("slab", "pencil")
STENCIL_SHARD_GRIDS = ((2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (2, 4))
OVERLAP_GRID = (False, True)
#: shard places of a mesh on one device (one card, or the CPU)
PLACES_ON_ONE_DEVICE = 8

_PLACED: List[Optional[List[torch.device]]] = [None]


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
@contextlib.contextmanager
def placement(devices: Sequence[Any]) -> Iterator[None]:
    """Inside the block, meshes of CUDA tensors place their shards on
    ``devices`` (e.g. ``[cuda:0]`` keeps every shard on one card of a
    host with several) instead of on every visible card."""
    before = _PLACED[0]
    _PLACED[0] = [torch.device(d) for d in devices]
    try:
        yield
    finally:
        _PLACED[0] = before


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def mesh_devices(device: Any = None) -> List[torch.device]:
    """The devices a mesh for tensors on ``device`` spreads over: the
    visible CUDA devices (or ``placement``'s) for a CUDA device, else the
    one device.  ``None`` reads the live host: CUDA when there is a card."""
    if device is None:
        device = "cuda" if _cuda_count() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    if _PLACED[0] is not None:
        return list(_PLACED[0])
    return [torch.device("cuda", i) for i in range(_cuda_count())]


def mesh_device_count(device: Any = None) -> int:
    """Shard places of a mesh on ``device``: its devices where there are
    two or more, else ``PLACES_ON_ONE_DEVICE`` on the one device."""
    n = len(mesh_devices(device))
    return n if n >= 2 else PLACES_ON_ONE_DEVICE


def shard_mesh(num_shards: int, device: Any = None) -> List[torch.device]:
    """The 1-D mesh: shard ``i``'s device, ``devices[i % len(devices)]``."""
    devices = mesh_devices(device)
    places = mesh_device_count(device)
    if num_shards > places:
        raise ValueError(
            f"num_shards={num_shards} exceeds the {places} shard place(s)")
    return [devices[i % len(devices)] for i in range(num_shards)]


def shard_mesh2d(sz: int, sy: int,
                 device: Any = None) -> List[List[torch.device]]:
    """The 2-D ``(shards_z, shards_y)`` mesh, z-major: shard ``(iz, iy)``
    is place ``iz * sy + iy``."""
    if sz * sy > mesh_device_count(device):
        raise ValueError(
            f"shard grid ({sz}, {sy}) needs {sz * sy} devices, have "
            f"{mesh_device_count(device)}")
    flat = shard_mesh(sz * sy, device)
    return [flat[iz * sy:(iz + 1) * sy] for iz in range(sz)]


def resolve_num_shards(extent: int, num_shards: Optional[int] = None,
                       device_count: Optional[int] = None) -> int:
    """Validate an explicit shard count, or pick the largest usable one.

    ``extent`` is the decomposed axis length; a valid count divides it, is
    at least 2, and does not exceed the device count (the mesh's shard
    places; ``None`` reads the live host).  ``num_shards=None`` chooses the
    largest valid count (deterministic), raising when even 2 shards cannot
    be used.
    """
    if device_count is None:
        device_count = mesh_device_count()
    if num_shards is not None:
        if num_shards < 2:
            raise ValueError(f"num_shards must be >= 2, got {num_shards}")
        if num_shards > device_count:
            raise ValueError(
                f"num_shards={num_shards} exceeds device_count="
                f"{device_count}")
        if extent % num_shards:
            raise ValueError(
                f"num_shards={num_shards} does not divide the decomposed "
                f"extent {extent}")
        return num_shards
    for s in range(min(device_count, extent), 1, -1):
        if extent % s == 0:
            return s
    raise ValueError(
        f"no valid shard count for extent {extent} on {device_count} "
        f"device(s)")


def _shard_ok(num_shards: int, extent: int,
              device_count: Optional[int] = None) -> bool:
    """Tunable-space constraint twin of ``resolve_num_shards``.

    ``device_count=None`` reads the live host; tests (and any caller
    reasoning about a hypothetical host) inject an explicit count.
    """
    if device_count is None:
        device_count = mesh_device_count()
    return (num_shards >= 2 and num_shards <= device_count
            and extent % num_shards == 0)


def balanced_pencil_grid(total: int, nz: Optional[int] = None,
                         ny: Optional[int] = None):
    """Deterministic most-balanced ``(sz, sy)`` with ``sz * sy == total``
    and both factors >= 2, optionally constrained to divide the ``nz``/
    ``ny`` extents.  ``None`` when no such grid exists (e.g. total=2 has
    no true 2-D grid).  Every factorization is considered (a short z axis
    may only admit ``sy > sz``); ties prefer the z-major grid."""
    pairs = [(total // sy, sy) for sy in range(2, total // 2 + 1)
             if total % sy == 0 and total // sy >= 2]
    pairs.sort(key=lambda p: (abs(p[0] - p[1]), p[0] < p[1]))
    for sz, sy in pairs:
        if nz is not None and nz % sz:
            continue
        if ny is not None and ny % sy:
            continue
        return sz, sy
    return None


def resolve_shard_grid(nz: int, ny: int, *, decomp: str = "slab",
                       shard_grid=None, num_shards: Optional[int] = None,
                       device_count: Optional[int] = None):
    """Validate or pick the ``(sz, sy)`` shard grid for the stencil.

    ``decomp="slab"`` decomposes z only (``sy == 1``; ``num_shards`` is the
    alias for ``sz``); ``decomp="pencil"`` splits z *and* y (``sz, sy >=
    2``).  A valid grid divides both decomposed extents and fits in the
    device count.  With no explicit grid, slab reuses
    ``resolve_num_shards`` and pencil deterministically picks the largest
    total shard count, most-balanced grid first.
    """
    if decomp not in STENCIL_DECOMPS:
        raise ValueError(
            f"unknown decomp {decomp!r}; expected one of {STENCIL_DECOMPS}")
    if device_count is None:
        device_count = mesh_device_count()
    if shard_grid is None:
        if decomp == "slab":
            return resolve_num_shards(nz, num_shards, device_count), 1
        totals = ([num_shards] if num_shards is not None
                  else range(device_count, 3, -1))
        for total in totals:
            if total > device_count:
                break
            grid = balanced_pencil_grid(total, nz, ny)
            if grid is not None:
                return grid
        raise ValueError(
            f"no valid pencil grid for extents ({nz}, {ny}) on "
            f"{device_count} device(s)"
            + (f" with num_shards={num_shards}" if num_shards else ""))
    sz, sy = (int(shard_grid[0]), int(shard_grid[1]))
    if num_shards is not None and num_shards != sz * sy:
        raise ValueError(
            f"num_shards={num_shards} contradicts shard_grid=({sz}, {sy})")
    if decomp == "slab" and sy != 1:
        raise ValueError(f"slab decomposition needs sy=1, got sy={sy}")
    if decomp == "pencil" and (sz < 2 or sy < 2):
        raise ValueError(
            f"pencil decomposition needs sz, sy >= 2, got ({sz}, {sy})")
    if sz * sy < 2:
        raise ValueError(f"shard grid ({sz}, {sy}) has fewer than 2 shards")
    if sz * sy > device_count:
        raise ValueError(
            f"shard grid ({sz}, {sy}) needs {sz * sy} devices, have "
            f"{device_count}")
    if nz % sz or ny % sy:
        raise ValueError(
            f"shard grid ({sz}, {sy}) does not divide extents ({nz}, {ny})")
    return sz, sy


def _stencil_point_ok(p, nz: int, ny: int,
                      device_count: Optional[int] = None) -> bool:
    """Tunable-space constraint twin of ``resolve_shard_grid``."""
    if device_count is None:
        device_count = mesh_device_count()
    try:
        sz, sy = (int(x) for x in p["shard_grid"])
    except (KeyError, TypeError, ValueError):
        return False
    if sz * sy < 2 or sz * sy > device_count:
        return False
    if nz % sz or ny % sy:
        return False
    if p.get("decomp") == "pencil":
        return sz >= 2 and sy >= 2
    return sy == 1 and sz >= 2


def _places(x: torch.Tensor, device_count: Optional[int]) -> int:
    """The device count a constraint checks a call against: the injected
    one, else the mesh of the call's own tensor."""
    return mesh_device_count(x.device) if device_count is None \
        else device_count


def _copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A shard's own contiguous buffer on ``device`` holding ``x``."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(
        x, non_blocking=True)


# --------------------------------------------------------------------------
# stencil7: slab / pencil decomposition + (optionally overlapped) halo
# exchange
# --------------------------------------------------------------------------
#: a per-shard stencil: a padded block in, the same-shape field out (its
#: faces are never kept)
StencilLocal = Callable[[torch.Tensor], torch.Tensor]


def _boundary_keep(extent: int, idx: int, n_shards: int) -> List[bool]:
    """Per-plane keep flags along one decomposed axis: the first/last local
    plane is dropped (zeroed) on the shards owning the *global* boundary
    (the oracle fixes boundary cells to 0; with one plane per shard the two
    edges are the same plane and both conditions AND together).  Plain
    bools: the shard index is known on the host."""
    keep = [True] * extent
    keep[0] = keep[0] and idx != 0
    keep[-1] = keep[-1] and idx != n_shards - 1
    return keep


def _zero_dropped(out: torch.Tensor, axis: int, keep: List[bool]) -> None:
    """Zero, in place, the planes of ``out`` along ``axis`` whose keep flag
    is False (at most two planes: no pass over the block)."""
    for plane in {0, len(keep) - 1}:
        if not keep[plane]:
            out.select(axis, plane).zero_()


@dataclasses.dataclass
class StencilShards:
    """A (nz, ny, nx) volume distributed over an ``(sz, sy)`` shard grid.

    ``bufs[iz][iy]`` is shard ``(iz, iy)``'s own padded buffer on its place:
    its ``(nz/sz, ny/sy, nx)`` block with one halo plane on each side of
    each decomposed axis — ``(nz/sz + 2, ny, nx)`` for a slab,
    ``(nz/sz + 2, ny/sy + 2, nx)`` for a pencil.  The halo cells start at 0
    (the open ends' zero boundary; a pencil's corner cells stay 0, as no
    kept cell reads them) and ``stencil_step`` fills them.
    """

    bufs: List[List[torch.Tensor]]
    shape: Tuple[int, int, int]
    device: torch.device

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.bufs), len(self.bufs[0])


def _interior(buf: torch.Tensor, pencil: bool) -> torch.Tensor:
    """The owned block of a padded buffer (a view)."""
    return buf[1:-1, 1:-1] if pencil else buf[1:-1]


def distribute_stencil(u: torch.Tensor, sz: int, sy: int) -> StencilShards:
    """Copy each shard's block of ``u`` into its own padded buffer on its
    place of the ``(sz, sy)`` mesh on ``u``'s device."""
    nz, ny, nx = u.shape
    zl, yl = nz // sz, ny // sy
    pencil = sy > 1
    mesh = shard_mesh2d(sz, sy, u.device) if pencil else \
        [[d] for d in shard_mesh(sz, u.device)]
    bufs = []
    for iz, row in enumerate(mesh):
        bufs.append([])
        for iy, dev in enumerate(row):
            buf = torch.empty((zl + 2, yl + (2 if pencil else 0), nx),
                              dtype=u.dtype, device=dev)
            # the halo planes (and a pencil's halo columns) start at 0; the
            # owned block is copied in, never zeroed first
            buf[0].zero_()
            buf[-1].zero_()
            if pencil:
                buf[:, 0].zero_()
                buf[:, -1].zero_()
            _interior(buf, pencil).copy_(
                u[iz * zl:(iz + 1) * zl, iy * yl:(iy + 1) * yl],
                non_blocking=True)
            bufs[-1].append(buf)
    return StencilShards(bufs, (nz, ny, nx), u.device)


def _exchange(shards: StencilShards) -> List[List[Tuple[Any, ...]]]:
    """Issue the halo collectives on the owned blocks: 2 ``ppermute``s for
    a slab, 4 for a pencil.  Returns each shard's halos ``(lo_z, hi_z)``,
    plus ``(lo_y, hi_y)`` for a pencil, not yet in its buffer."""
    sz, sy = shards.grid
    pencil = sy > 1
    blocks = [[_interior(b, pencil) for b in row] for row in shards.bufs]
    if not pencil:
        lo, hi = collectives.halo_exchange([row[0] for row in blocks],
                                           axis=0)
        return [[(lo[iz], hi[iz])] for iz in range(sz)]
    (lo_z, hi_z), (lo_y, hi_y) = collectives.halo_exchange_nd(
        blocks, axes=(0, 1))
    return [[(lo_z[iz][iy], hi_z[iz][iy], lo_y[iz][iy], hi_y[iz][iy])
             for iy in range(sy)] for iz in range(sz)]


def _fill(buf: torch.Tensor, halos: Tuple[Any, ...]) -> None:
    """Copy one shard's exchanged halos into its buffer's halo planes."""
    pencil = len(halos) == 4
    inner = slice(1, -1) if pencil else slice(None)
    buf[:1, inner].copy_(halos[0], non_blocking=True)
    buf[-1:, inner].copy_(halos[1], non_blocking=True)
    if pencil:
        buf[1:-1, :1].copy_(halos[2], non_blocking=True)
        buf[1:-1, -1:].copy_(halos[3], non_blocking=True)


def _overlapped(buf: torch.Tensor, halos: Tuple[Any, ...],
                local: StencilLocal) -> torch.Tensor:
    """One shard's kept field with halo/compute overlap: the interior from
    the raw block (no dependency on the halos), then the halos land and
    thin O(surface) slabs patch the boundary planes.  Same per-cell
    expression on the same values, so bitwise equal to the plain
    exchange."""
    pencil = len(halos) == 4
    out = local(_interior(buf, pencil))
    _fill(buf, halos)
    if pencil:
        # z-boundary planes: 3-plane slabs of the padded buffer (the outer
        # planes' y-halo cells are stencil-dead for the middle plane)
        out[:1] = local(buf[0:3])[1:2, 1:-1]
        out[-1:] = local(buf[-3:])[1:2, 1:-1]
        # y-boundary rows: 3-column slabs, the middle column's z-halos
        # attached; corner cells appear in both a z- and a y-patch, and both
        # compute the identical expression on identical values
        out[:, :1] = local(buf[:, 0:3])[1:-1, 1:2]
        out[:, -1:] = local(buf[:, -3:])[1:-1, 1:2]
    else:
        out[:1] = local(buf[0:3])[1:2]
        out[-1:] = local(buf[-3:])[1:2]
    return out


def stencil_step(shards: StencilShards, local: StencilLocal, *,
                 overlap: bool = False) -> List[List[torch.Tensor]]:
    """The resident step on buffers that are already sharded: the halo
    exchange, then ``local`` once per shard on its padded buffer; returns
    each shard's kept block (a view of its field) with the global boundary
    planes zeroed.  ``overlap=True`` computes each interior before the
    halos land (``_overlapped``) where every local extent is at least 2;
    the one-plane-per-shard edge has no halo-free interior and takes the
    plain exchange."""
    sz, sy = shards.grid
    pencil = sy > 1
    overlap = (overlap and shards.shape[0] // sz >= 2
               and (not pencil or shards.shape[1] // sy >= 2))
    halos = _exchange(shards)
    kept = []
    for iz, row in enumerate(shards.bufs):
        kept.append([])
        for iy, buf in enumerate(row):
            if overlap:
                out = _overlapped(buf, halos[iz][iy], local)
            else:
                _fill(buf, halos[iz][iy])
                out = _interior(local(buf), pencil)
            _zero_dropped(out, 0, _boundary_keep(out.shape[0], iz, sz))
            if pencil:
                _zero_dropped(out, 1, _boundary_keep(out.shape[1], iy, sy))
            kept[-1].append(out)
    return kept


def collect_stencil(shards: StencilShards,
                    kept: List[List[torch.Tensor]]) -> torch.Tensor:
    """The kept blocks into one (nz, ny, nx) volume on the input's device
    (the reference's ``out_specs`` concatenation)."""
    nz, ny, nx = shards.shape
    sz, sy = shards.grid
    zl, yl = nz // sz, ny // sy
    first = kept[0][0]
    f = torch.empty((nz, ny, nx), dtype=first.dtype, device=shards.device)
    for iz, row in enumerate(kept):
        for iy, out in enumerate(row):
            f[iz * zl:(iz + 1) * zl, iy * yl:(iy + 1) * yl].copy_(
                out, non_blocking=True)
    return f


def stencil_decomposed(u: torch.Tensor, local: StencilLocal, sz: int,
                       sy: int, *, overlap: bool = False) -> torch.Tensor:
    """A whole sharded stencil call: distribute, the resident step,
    collect."""
    shards = distribute_stencil(u, sz, sy)
    return collect_stencil(shards, stencil_step(shards, local,
                                                overlap=overlap))


def stencil_grid(u: torch.Tensor, num_shards: Optional[int], decomp: str,
                 shard_grid) -> Tuple[int, int]:
    """``resolve_shard_grid`` against the mesh of ``u``'s device."""
    return resolve_shard_grid(u.shape[0], u.shape[1], decomp=decomp,
                              shard_grid=shard_grid, num_shards=num_shards,
                              device_count=mesh_device_count(u.device))


def laplacian_shard(u, invhx2=1.0, invhy2=1.0, invhz2=1.0, invhxyz2=-6.0,
                    *, num_shards: Optional[int] = None,
                    decomp: str = "slab", shard_grid=None,
                    overlap: bool = False):
    """Domain-decomposed seven-point stencil on the plain arithmetic.

    ``decomp="slab"`` splits z across ``num_shards`` places;
    ``decomp="pencil"`` splits z and y across a ``shard_grid=(sz, sy)``
    mesh.  ``overlap=True`` computes each shard's halo-free interior before
    its halos land, then patches the boundary planes — every variant is
    bitwise equal to the single-device ``torch`` backend.
    """
    sz, sy = stencil_grid(u, num_shards, decomp, shard_grid)
    local = functools.partial(s7_ref.laplacian, invhx2=invhx2, invhy2=invhy2,
                              invhz2=invhz2, invhxyz2=invhxyz2)
    return stencil_decomposed(u, local, sz, sy, overlap=bool(overlap))


# --------------------------------------------------------------------------
# BabelStream: block-partitioned arrays, psum dot
# --------------------------------------------------------------------------
def stream_decomposed(arrays: Sequence[torch.Tensor],
                      local: Callable[..., Any], num_shards: int, *,
                      reduce: bool = False) -> torch.Tensor:
    """``local`` once per block of ``num_shards`` equal blocks, each on its
    place in its own buffers.  Elementwise: the blocks' results in order,
    on the input's device.  ``reduce=True`` (``dot``): each ``local``
    returns a 0-d partial, and one ``psum`` adds them in shard order; the
    sum, as 0-d on the input's device."""
    a = arrays[0]
    n = a.shape[0]
    step = n // num_shards
    outs = [local(*(_copy_to(x[i * step:(i + 1) * step], dev)
                    for x in arrays))
            for i, dev in enumerate(shard_mesh(num_shards, a.device))]
    if reduce:
        return collectives.psum(outs)[0].to(a.device)
    out = torch.empty(n, dtype=outs[0].dtype, device=a.device)
    for i, o in enumerate(outs):
        out[i * step:(i + 1) * step].copy_(o, non_blocking=True)
    return out


def _dot_local(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # the partials stay in the accumulation dtype across the psum (the
    # oracle only downcasts once, at the very end)
    acc = stream_ref.accumulator_dtype(a.dtype)
    return (a.to(acc) * b.to(acc)).sum()


def stream_call(op: str, args: Sequence[Any], nargs: int, takes_scalar: bool,
                scalar: Optional[float], num_shards: Optional[int],
                local: Callable[..., Any]) -> torch.Tensor:
    """One sharded stream op, as the registry calls it: the arrays (and a
    positional scalar) from ``args``, the shard count resolved against the
    mesh of the arrays' device, ``local`` per block (given the scalar when
    the op takes one)."""
    arrays, rest = args[:nargs], args[nargs:]
    if takes_scalar:
        if rest:
            scalar = rest[0]
        elif scalar is None:
            scalar = stream_ref.START_SCALAR
        local = functools.partial(local, scalar=scalar)
    elif rest or scalar is not None:
        raise TypeError(f"babelstream.{op} takes no scalar")
    a = arrays[0]
    s = resolve_num_shards(a.shape[0], num_shards,
                           mesh_device_count(a.device))
    out = stream_decomposed(arrays, local, s, reduce=op == "dot")
    return out.to(a.dtype) if op == "dot" else out


def _make_stream_shard(op, nargs, takes_scalar):
    body = _STREAM_LOCAL[op][0]

    def run(*args, scalar: Optional[float] = None,
            num_shards: Optional[int] = None):
        return stream_call(op, args, nargs, takes_scalar, scalar,
                           num_shards, body)
    run.__name__ = f"{op}_shard"
    return run


def stream_shard_fns():
    """op name -> sharded backend fn, signatures matching the oracle."""
    return {op: _make_stream_shard(op, nargs, takes_scalar)
            for op, (_, nargs, takes_scalar) in _STREAM_LOCAL.items()}


# --------------------------------------------------------------------------
# miniBUDE: pose-parallel
# --------------------------------------------------------------------------
def fasten_decomposed(deck: Sequence[torch.Tensor], local: Callable[..., Any],
                      num_shards: int) -> torch.Tensor:
    """Poses (6, P) shard along P, the four protein/ligand tensors
    replicate (a copy on each shard's place); per-pose energies are
    independent, so the blocks' energies in order are the exact result."""
    *atoms, poses = deck
    step = poses.shape[1] // num_shards
    outs = [local(*(_copy_to(t, dev) for t in atoms),
                  _copy_to(poses[:, i * step:(i + 1) * step], dev))
            for i, dev in enumerate(shard_mesh(num_shards, poses.device))]
    out = torch.empty(poses.shape[1], dtype=outs[0].dtype,
                      device=poses.device)
    for i, o in enumerate(outs):
        out[i * step:(i + 1) * step].copy_(o, non_blocking=True)
    return out


def fasten_shard(protein_pos, protein_par, ligand_pos, ligand_par, poses,
                 *, num_shards: Optional[int] = None):
    """Pose-parallel miniBUDE energy evaluation on the plain arithmetic."""
    s = resolve_num_shards(poses.shape[1], num_shards,
                           mesh_device_count(poses.device))
    return fasten_decomposed(
        (protein_pos, protein_par, ligand_pos, ligand_par, poses),
        mb_ref.fasten, s)


# --------------------------------------------------------------------------
# Hartree-Fock: l-slab quartet decomposition, psum Fock accumulation
# --------------------------------------------------------------------------
def fock_decomposed(positions: torch.Tensor, density: torch.Tensor,
                    local: Callable[..., torch.Tensor],
                    num_shards: int) -> torch.Tensor:
    """Shard ``i`` builds, from its own copies of the positions and the
    density, the partial Fock matrix of the quartets with ``l`` in its
    slab, ``local(positions, density, l0, nl)``; one ``psum`` adds the
    partials in shard order — the distributed form of the paper's atomic
    scatter-adds, without the contention."""
    nl = positions.shape[0] // num_shards
    parts = [local(_copy_to(positions, dev), _copy_to(density, dev),
                   i * nl, nl)
             for i, dev in enumerate(shard_mesh(num_shards,
                                                positions.device))]
    return collectives.psum(parts)[0].to(positions.device)


def fock_shard(positions, density, *, ngauss: int = 3,
               num_shards: Optional[int] = None):
    """Distributed two-electron Fock build (quartets sharded over l) on the
    plain arithmetic."""
    s = resolve_num_shards(positions.shape[0], num_shards,
                           mesh_device_count(positions.device))

    def local(p, d, l0, nl):
        return hf_ref.fock_build_slab(
            p, d, hf_ops._basis(ngauss, p.dtype, p.device), l0, nl)
    return fock_decomposed(positions, density, local, s)


# --------------------------------------------------------------------------
# registration: plug into the existing PortableKernel registry
# --------------------------------------------------------------------------
#: collective traffic of the 1-D sharded families (the comm contracts)
NO_COLLECTIVES = {"ppermute": 0, "psum": 0, "all_gather": 0}
ONE_PSUM = {"ppermute": 0, "psum": 1, "all_gather": 0}


def stencil_comm_contract(u, *args):
    """Audited variants of the sharded stencil: a slab step exchanges two
    halos (one ppermute each way), a pencil step four (two axes); the
    overlap variants pin a shard grid leaving >= 2 local planes (the
    one-plane-per-shard edge legitimately takes the plain exchange).  The
    reference's ``overlap_shape`` (an interior compute with no data
    dependency on the halos) is its jaxpr's to check; the port's eager
    audit counts the collectives and carries it as metadata."""
    nz, ny, nx = u.shape
    variants = [
        ({"decomp": "slab"}, {**NO_COLLECTIVES, "ppermute": 2}),
        ({"decomp": "pencil"}, {**NO_COLLECTIVES, "ppermute": 4}),
    ]
    for sz in (4, 2):
        if nz % sz == 0 and nz // sz >= 2:
            variants.append((
                {"decomp": "slab", "shard_grid": (sz, 1), "overlap": True},
                {**NO_COLLECTIVES, "ppermute": 2,
                 "overlap_shape": (nz // sz, ny, nx)}))
            break
    if nz % 2 == 0 and ny % 2 == 0 and nz // 2 >= 2 and ny // 2 >= 2:
        variants.append((
            {"decomp": "pencil", "shard_grid": (2, 2), "overlap": True},
            {**NO_COLLECTIVES, "ppermute": 4,
             "overlap_shape": (nz // 2, ny // 2, nx)}))
    return variants


def register_sharded_backends() -> None:
    """Attach ``torch_shard`` backends + shard tunables to every
    science-kernel family already in the registry.  Idempotent.  Every
    mesh has at least two places, so the backends run on any host."""
    k = get_kernel("stencil7")
    if SHARD_BACKEND not in k.backends:
        k.add_backend(SHARD_BACKEND, laplacian_shard)
        # the decomposition *shape* is a tunable, not a hard-coded choice:
        # the sweep walks slab vs pencil grids and halo/compute overlap
        k.declare_tunables(
            SHARD_BACKEND, decomp=STENCIL_DECOMPS,
            shard_grid=STENCIL_SHARD_GRIDS, overlap=OVERLAP_GRID,
            constraint=lambda p, u, *a, device_count=None, **kw:
                _stencil_point_ok(p, u.shape[0], u.shape[1],
                                  _places(u, device_count)))
        k.declare_comm_contract(SHARD_BACKEND, stencil_comm_contract)
        k.declare_roofline_contract(SHARD_BACKEND, bound="memory")

    for op, fn in stream_shard_fns().items():
        k = get_kernel(f"babelstream.{op}")
        if SHARD_BACKEND in k.backends:
            continue
        k.add_backend(SHARD_BACKEND, fn)
        k.declare_tunables(
            SHARD_BACKEND, num_shards=SHARD_GRID,
            constraint=lambda p, *arrays, device_count=None, **kw:
                _shard_ok(p["num_shards"], arrays[0].shape[0],
                          _places(arrays[0], device_count)))
        # dot combines per-block partials with one psum; the elementwise
        # ops are embarrassingly parallel
        k.declare_comm_contract(
            SHARD_BACKEND, ONE_PSUM if op == "dot" else NO_COLLECTIVES)
        # sharding does not change the streaming AI: still memory-bound
        k.declare_roofline_contract(SHARD_BACKEND, bound="memory")

    k = get_kernel("minibude.fasten")
    if SHARD_BACKEND not in k.backends:
        k.add_backend(SHARD_BACKEND, fasten_shard)
        k.declare_tunables(
            SHARD_BACKEND, num_shards=SHARD_GRID,
            constraint=lambda p, *deck, device_count=None, **kw:
                _shard_ok(p["num_shards"], deck[4].shape[1],
                          _places(deck[4], device_count)))
        k.declare_comm_contract(SHARD_BACKEND, NO_COLLECTIVES)
        k.declare_roofline_contract(SHARD_BACKEND, bound="compute")

    k = get_kernel("hartree_fock.twoel")
    if SHARD_BACKEND not in k.backends:
        k.add_backend(SHARD_BACKEND, fock_shard)
        k.declare_tunables(
            SHARD_BACKEND, num_shards=SHARD_GRID,
            constraint=lambda p, positions, *a, device_count=None, **kw:
                _shard_ok(p["num_shards"], positions.shape[0],
                          _places(positions, device_count)))
        # per-shard Fock partials accumulate with exactly one psum
        k.declare_comm_contract(SHARD_BACKEND, ONE_PSUM)
        # O(N^4) work dwarfs the one Fock psum: compute-bound everywhere
        k.declare_roofline_contract(SHARD_BACKEND, bound="compute")


# importing the ops modules registers the base kernels; the sharded
# backends then attach on top
import repro_torch.kernels.babelstream.ops  # noqa: E402,F401
import repro_torch.kernels.minibude.ops  # noqa: E402,F401
import repro_torch.kernels.stencil7.ops  # noqa: E402,F401
from repro_torch.kernels.babelstream import ref as stream_ref  # noqa: E402
from repro_torch.kernels.hartree_fock import ops as hf_ops  # noqa: E402
from repro_torch.kernels.hartree_fock import ref as hf_ref  # noqa: E402
from repro_torch.kernels.minibude import ref as mb_ref  # noqa: E402
from repro_torch.kernels.stencil7 import ref as s7_ref  # noqa: E402

#: op -> (per-shard plain function, array arguments, takes a scalar)
_STREAM_LOCAL = {
    "copy": (stream_ref.copy, 1, False),
    "mul": (stream_ref.mul, 1, True),
    "add": (stream_ref.add, 2, False),
    "triad": (stream_ref.triad, 2, True),
    "dot": (_dot_local, 2, False),
}

register_sharded_backends()
