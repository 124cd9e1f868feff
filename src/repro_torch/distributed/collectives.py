"""Thin collective helpers for the domain-decomposition subsystem.

The port of ``repro.distributed.collectives``.  The reference runs inside
``shard_map`` against a named mesh axis; the port is single-controller, as
JAX is: each helper takes the **list of per-shard tensors** along one mesh
axis (shard ``i`` at index ``i``, each on its own device) and returns a
list in the same order:

  * ``ring_perm(n, offset, wrap)`` builds the (src, dst) pairs of a shift
    along a ring of ``n`` shards (the reference's, unchanged).  Shards
    without a source receive zeros, as ``lax.ppermute`` fills them: the
    zero Dirichlet halo the stencil oracle assumes.  ``wrap=True`` closes
    the ring (periodic boundaries);
  * ``shift(xs, offset, wrap)`` moves each shard's block ``offset``
    positions along the ring, into a new tensor on the destination shard's
    device: shards that share a card still copy, so an exchange on one
    card moves the bytes it would move between cards;
  * ``halo_exchange(xs, axis=, halo=)`` swaps ``halo``-thick boundary slabs
    with both neighbours and returns ``(from_prev, from_next)``;
  * ``halo_exchange_nd(grid, axes=)`` runs one exchange per *mesh* axis of
    an N-D grid of shards (nested lists, e.g. ``grid[iz][iy]`` for the 2-D
    pencil), every ring of that mesh axis at once — one ``ppermute`` each
    way per mesh axis, as the reference's named-axis ``ppermute`` is;
  * ``psum(xs)`` sums the shards' partials in a fixed order (shard 0
    first) on shard 0's device and gives every shard a copy of the sum.

**Every collective counts itself**: inside ``with counting() as c:`` each
``shift`` adds one to ``c["ppermute"]`` (a halo exchange is two, one each
way) and each ``psum`` one to ``c["psum"]``.  This is the port's
counterpart of the reference's jaxpr collective census, which its comm
contracts are audited against (``core/portable.py::audit_comm_contract``).
Inside ``with observing(fn):`` each collective also calls ``fn(kind, n,
moved, received)`` with the blocks it moved and the tensors it gave the
shards: the static auditor (``core/analysis/trace.py``) costs the bytes and
follows what the received data feeds.
Copies between devices go through ``Tensor.copy_``, which orders them
after the source's stream and before the destination's with CUDA events,
never a host sync.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ring_perm", "shift", "halo_exchange", "halo_exchange_nd", "psum",
           "counting", "observing", "COLLECTIVES"]

#: the collectives a counter counts (the reference's contract keys)
COLLECTIVES = ("ppermute", "psum", "all_gather")

_local = threading.local()


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """Count the collectives this thread issues inside the block.

    Yields ``{"ppermute": n, "psum": n, "all_gather": n}``, filled as the
    block runs; counters nest (an outer block counts what an inner one
    does)."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(counts)
    try:
        yield counts
    finally:
        stack.remove(counts)


@contextlib.contextmanager
def observing(fn: Any) -> Iterator[None]:
    """Call ``fn(kind, n, moved, received)`` for each collective this
    thread issues inside the block: ``n`` as ``counting`` counts it, the
    blocks it moved between shards and the tensors the shards received."""
    observers = _local.__dict__.setdefault("observers", [])
    observers.append(fn)
    try:
        yield
    finally:
        observers.remove(fn)


def _count(kind: str, n: int = 1, moved: Sequence[torch.Tensor] = (),
           received: Sequence[torch.Tensor] = ()) -> None:
    for counts in getattr(_local, "stack", ()):
        counts[kind] += n
    for fn in getattr(_local, "observers", ()):
        fn(kind, n, moved, received)


def ring_perm(n: int, offset: int = 1,
              wrap: bool = False) -> List[Tuple[int, int]]:
    """(source, destination) pairs shifting data ``offset`` shards forward.

    ``wrap=False`` drops pairs that would cross the ends: the shards there
    receive zeros (the non-periodic boundary).  Offsets beyond the ring are
    valid and simply address fewer pairs.
    """
    if n < 1:
        raise ValueError(f"ring needs at least one shard, got n={n}")
    pairs = []
    for src in range(n):
        dst = src + offset
        if wrap:
            pairs.append((src, dst % n))
        elif 0 <= dst < n:
            pairs.append((src, dst))
    return pairs


def _copy_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A new tensor on ``like``'s device holding ``x`` (a copy even on the
    same device)."""
    return torch.empty(x.shape, dtype=x.dtype, device=like.device).copy_(
        x, non_blocking=True)


def _permute(xs: Sequence[torch.Tensor], offset: int,
             wrap: bool) -> List[torch.Tensor]:
    out: List[Any] = [None] * len(xs)
    for src, dst in ring_perm(len(xs), offset, wrap):
        out[dst] = _copy_to(xs[src], xs[dst])
    return [torch.zeros(xs[i].shape, dtype=xs[i].dtype, device=xs[i].device)
            if o is None else o for i, o in enumerate(out)]


def _moved(xs: Sequence[torch.Tensor], offset: int,
           wrap: bool) -> List[torch.Tensor]:
    return [xs[src] for src, _ in ring_perm(len(xs), offset, wrap)]


def shift(xs: Sequence[torch.Tensor], offset: int = 1,
          wrap: bool = False) -> List[torch.Tensor]:
    """Each shard receives the block of the shard ``offset`` positions
    *before* it, on its own device (zeros at the open ends when
    ``wrap=False``).  The blocks have one shape, as ``ppermute``'s do."""
    out = _permute(xs, offset, wrap)
    _count("ppermute", moved=_moved(xs, offset, wrap), received=out)
    return out


def _slabs(xs: Sequence[torch.Tensor], axis: int, halo: int):
    extent = xs[0].shape[axis]
    if halo > extent:
        raise ValueError(
            f"halo={halo} exceeds local extent {extent} along axis {axis}")
    leading = [x.narrow(axis, 0, halo) for x in xs]
    trailing = [x.narrow(axis, extent - halo, halo) for x in xs]
    return leading, trailing


def halo_exchange(xs: Sequence[torch.Tensor], *, axis: int = 0,
                  halo: int = 1, wrap: bool = False
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Exchange ``halo``-thick boundary slabs with both ring neighbours.

    Returns ``(from_prev, from_next)``: for each shard, the previous
    shard's trailing slab and the next shard's leading slab along ``axis``.
    At the open ends the missing neighbour's halo is zeros, the stencil
    oracle's zero boundary.  Two ``ppermute``s.
    """
    leading, trailing = _slabs(xs, axis, halo)
    return (shift(trailing, 1, wrap), shift(leading, -1, wrap))


def _grid_shape(grid: Any) -> Tuple[int, ...]:
    shape, g = [], grid
    while isinstance(g, (list, tuple)):
        shape.append(len(g))
        g = g[0]
    return tuple(shape)


def halo_exchange_nd(grid: Any, *, axes: Sequence[int] = (0, 1),
                     halo: int = 1, wrap: bool = False
                     ) -> Tuple[Tuple[Any, Any], ...]:
    """One independent halo exchange per mesh axis of an N-D shard grid.

    ``grid`` nests one list level per mesh axis (``grid[iz][iy]`` for the
    pencil); mesh axis ``m`` decomposes array axis ``axes[m]``.  Returns,
    per mesh axis in order, ``(from_prev, from_next)`` as grids of the same
    nesting.  Every exchange reads the *same* input blocks, so halos do not
    include each other's corners: fine for face-coupled stencils like the
    seven-point Laplacian, which never reads diagonal neighbours.  Two
    ``ppermute``s per mesh axis, each moving every ring of that axis.
    """
    shape = _grid_shape(grid)
    if len(shape) != len(axes):
        raise ValueError(
            f"the shard grid's {len(shape)} mesh axes and axes={tuple(axes)} "
            f"must align")
    blocks = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        g = grid
        for i in idx:
            g = g[i]
        blocks[idx] = g
    out = []
    for m, axis in enumerate(axes):
        prev = np.empty(shape, dtype=object)
        nxt = np.empty(shape, dtype=object)
        rings = np.moveaxis(blocks, m, -1).reshape(-1, shape[m])
        prev_rings = np.moveaxis(prev, m, -1)
        next_rings = np.moveaxis(nxt, m, -1)
        moved, received = [], []
        for r, ring in enumerate(rings):
            leading, trailing = _slabs(list(ring), axis, halo)
            at = np.unravel_index(r, prev_rings.shape[:-1])
            got = (_permute(trailing, 1, wrap), _permute(leading, -1, wrap))
            for k, (p, q) in enumerate(zip(*got)):
                prev_rings[at + (k,)] = p
                next_rings[at + (k,)] = q
            moved += _moved(trailing, 1, wrap) + _moved(leading, -1, wrap)
            received += got[0] + got[1]
        _count("ppermute", 2, moved=moved, received=received)
        out.append((prev.tolist(), nxt.tolist()))
    return tuple(out)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of every shard's partial, added in shard order (shard 0
    first) on shard 0's device, and a copy of it on each shard's device:
    the same bits on every run and for every placement."""
    total = xs[0].clone()
    for x in xs[1:]:
        total += x.to(total.device, non_blocking=True)
    out = [total] + [_copy_to(total, x) for x in xs[1:]]
    _count("psum", moved=xs, received=out)
    return out

