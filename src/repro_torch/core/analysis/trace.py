"""The op trace: the port's counterpart of ``jax.make_jaxpr``.

The reference audits a closed jaxpr.  Eager PyTorch has no program to read,
so ``trace(fn, args, kwargs)`` runs a backend's ``fn`` once on ``meta``
twins of its inputs (``core/op_cost.py::meta_twin``: shapes, strides and
dtypes, no data, nothing executes on a device) under a
``TorchDispatchMode``, and records, in order:

  * every ATen op: its name, its inputs' and outputs' dtypes and shapes,
    the records whose outputs feed it, and its flops and bytes as the
    op-cost walker counts them (``OpCostMode._charge_op``);
  * every collective of ``distributed/collectives.py`` (through its
    ``observing`` hook): kind, count as ``counting`` counts it, and the
    bytes it moved; the tensors the shards received are its outputs;
  * every launch of a hand-written kernel (through
    ``portable.launch_observed``): the wrapper's launch plan, one
    ``portable.Launch`` per CUDA or Triton kernel, instead of a launch.

Data flow follows storages: an op's sources are the last writers of the
storages it reads (a traced input's writer is ``INPUT``), an op writes its
outputs' storages and the arguments its schema marks as written (``copy_``
into a halo plane, an in-place add), and a view writes nothing.  Two flags
ride along: *derived* (the op depends on a traced input) and *tainted* (it
depends on data a collective delivered) — the overlap witness reads them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import portable
from repro_torch.core.op_cost import OpCostMode, _base_name, _nbytes, \
    _tensors, meta_twin
from repro_torch.distributed import collectives as coll

__all__ = ["Op", "Trace", "trace", "as_meta", "COLLECTIVE_KINDS",
           "count_collectives", "independent_compute_exists", "grid_points",
           "tile_visits", "INPUT"]

#: the collective kinds of a census (the reference's three)
COLLECTIVE_KINDS = coll.COLLECTIVES
#: the writer of a traced input's storage
INPUT = -1


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype)[len("torch."):]


@dataclasses.dataclass
class Op:
    """One record of a trace."""

    index: int
    kind: str                          # "aten" | "collective" | "launch"
    name: str                          # ATen op, collective kind or kernel
    in_dtypes: Tuple[str, ...] = ()
    in_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_dtypes: Tuple[str, ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    sources: Tuple[int, ...] = ()      # records feeding it (INPUT: an input)
    flops: float = 0.0
    hbm_bytes: float = 0.0             # eager bytes, as op_cost counts them
    count: int = 0                     # a collective's count
    moved_bytes: float = 0.0           # a collective's payload
    launches: Tuple[portable.Launch, ...] = ()
    derived: bool = False
    tainted: bool = False


@dataclasses.dataclass
class Trace:
    """A traced call: its records, and the bytes of its boundary (every
    tensor it was given and every tensor it returned: the compulsory
    floor)."""

    ops: List[Op]
    input_bytes: float
    output_bytes: float

    def of(self, kind: str) -> List[Op]:
        return [op for op in self.ops if op.kind == kind]

    @property
    def launches(self) -> List[Tuple[str, portable.Launch]]:
        """(wrapper name, launch) of every planned launch, in order."""
        return [(op.name, launch) for op in self.of("launch")
                for launch in op.launches]


def as_meta(tree: Any) -> Any:
    """numpy arrays and tensors of ``tree`` as ``meta`` tensors of their
    shapes, strides and dtypes; anything else as it is."""
    def tensor(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x))
        return x
    if isinstance(tree, (tuple, list)):
        return meta_twin(type(tree)(tensor(x) for x in tree))
    if isinstance(tree, dict):
        return meta_twin({k: tensor(v) for k, v in tree.items()})
    return meta_twin(tensor(tree))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class TraceMode(OpCostMode):
    """Record the ops, collectives and planned launches run inside the
    block (see the module's docstring)."""

    def __init__(self, inputs: Any = ()):
        super().__init__()
        self.ops: List[Op] = []
        self._writer: Dict[int, int] = {}
        self._alive: List[Any] = []    # storages held: no key is reused
        for t in _tensors(inputs):
            self._writer[_key(t)] = INPUT
            self._alive.append(t.untyped_storage())

    def __enter__(self):
        portable.launch_observers.append(self._launch)
        self._observing = coll.observing(self._collective)
        self._observing.__enter__()
        return super(OpCostMode, self).__enter__()

    def __exit__(self, *exc):
        portable.launch_observers.remove(self._launch)
        self._observing.__exit__(*exc)
        return super(OpCostMode, self).__exit__(*exc)

    # ---- data flow -----------------------------------------------------
    def _sources(self, tensors) -> Tuple[int, ...]:
        found = []
        for t in tensors:
            w = self._writer.get(_key(t))
            if w is not None and w not in found:
                found.append(w)
        return tuple(found)

    def _append(self, op: Op, written) -> None:
        op.derived = any(s == INPUT or self.ops[s].derived
                         for s in op.sources)
        op.tainted = op.kind == "collective" or any(
            s != INPUT and self.ops[s].tainted for s in op.sources)
        self.ops.append(op)
        for t in written:
            self._writer[_key(t)] = op.index
            self._alive.append(t.untyped_storage())

    # ---- ATen ops ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = list(_tensors((args, kwargs))), list(_tensors(out))
        flops, nbytes = self.cost.flops, self.cost.hbm_bytes
        self._charge_op(func, args, kwargs, out, ins, outs)
        schema = func._schema
        written = [a for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        mutated = []
        for a in written:
            i = schema.arguments.index(a)
            v = args[i] if i < len(args) else kwargs.get(a.name)
            mutated += list(_tensors(v))
        views = getattr(func, "is_view", False)
        self._append(Op(
            index=len(self.ops), kind="aten", name=_base_name(func),
            in_dtypes=tuple(_dtype(t) for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            out_dtypes=tuple(_dtype(t) for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            sources=self._sources(ins),
            flops=self.cost.flops - flops,
            hbm_bytes=self.cost.hbm_bytes - nbytes),
            mutated + ([] if views else outs))
        return out

    # ---- collectives and launches --------------------------------------
    def _collective(self, kind, n, moved, received) -> None:
        self._append(Op(
            index=len(self.ops), kind="collective", name=kind,
            in_dtypes=tuple(_dtype(t) for t in moved),
            in_shapes=tuple(tuple(t.shape) for t in moved),
            out_dtypes=tuple(_dtype(t) for t in received),
            out_shapes=tuple(tuple(t.shape) for t in received),
            sources=self._sources(moved), count=n,
            moved_bytes=float(sum(_nbytes(t) for t in moved))), received)

    def _launch(self, name: str, plan) -> None:
        self._append(Op(index=len(self.ops), kind="launch", name=name,
                        launches=tuple(plan)), ())


def trace(fn: Callable[..., Any], args: tuple, kwargs: dict) -> Trace:
    """``fn(*args, **kwargs)`` run once on ``meta`` twins of its tensor
    (and numpy) arguments under ``TraceMode``: nothing is built, launched
    or computed."""
    margs, mkwargs = as_meta(tuple(args)), as_meta(dict(kwargs))
    mode = TraceMode((margs, mkwargs))
    with mode:
        out = fn(*margs, **mkwargs)
    return Trace(ops=mode.ops,
                 input_bytes=float(sum(_nbytes(t)
                                       for t in _tensors((margs, mkwargs)))),
                 output_bytes=float(sum(_nbytes(t) for t in _tensors(out))))


def count_collectives(tr: Trace) -> Dict[str, int]:
    """The collective census: ppermute / psum / all_gather, each counted
    as ``distributed.collectives.counting`` counts it."""
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for op in tr.of("collective"):
        counts[op.name] += op.count
    return counts


def independent_compute_exists(tr: Trace, shape: Tuple[int, ...]) -> bool:
    """True when an ATen op issued after the first collective yields an
    output of ``shape``, depends on a traced input and on no data a
    collective delivered: the witness that a shard's interior is computed
    while its halos are in flight (``distributed/domain.py::_overlapped``).
    A plain exchange fills the halos first, so every later op of that
    shape reads a halo-tainted buffer."""
    first = next((op.index for op in tr.ops if op.kind == "collective"),
                 None)
    if first is None:
        return False
    return any(op.kind == "aten" and op.index > first and op.derived
               and not op.tainted and tuple(shape) in op.out_shapes
               for op in tr.ops)


def grid_points(grid: Tuple[int, ...]) -> Iterator[Tuple[int, int, int]]:
    """Every program id ``(x, y, z)`` of a launch grid."""
    g = tuple(int(v) for v in grid) + (1,) * (3 - len(grid))
    for z, y, x in itertools.product(range(g[2]), range(g[1]), range(g[0])):
        yield x, y, z


def _indices(tile: portable.Tile, pid) -> List[Tuple[int, ...]]:
    got = tile.index(*pid)
    if got is None:
        return []
    if isinstance(got, list):
        return [tuple(int(i) for i in g) for g in got]
    return [tuple(int(i) for i in got)]


def tile_visits(tile: portable.Tile, grid: Tuple[int, ...],
                cap: int) -> Optional[Dict[Tuple[int, ...], int]]:
    """Tile index -> the programs of ``grid`` that touch it (a program
    counts once however often its map names a tile), or None when the
    enumeration would pass ``cap`` tile visits."""
    visits: Dict[Tuple[int, ...], int] = {}
    seen = 0
    for pid in grid_points(grid):
        for idx in set(_indices(tile, pid)):
            visits[idx] = visits.get(idx, 0) + 1
            seen += 1
            if seen > cap:
                return None
    return visits
