"""Op-cost walker: the flops, HBM bytes and collectives of one step, per rank.

The counterpart of ``repro/core/hlo_cost.py``, which walks the compiled
(post-SPMD, post-fusion) HLO of a step.  Eager PyTorch has no such program,
so the walker is a ``TorchDispatchMode`` around one run of the step: every
ATen op that runs is costed once, on the tensors one rank holds (a
DTensor's local blocks), as the reference costs the per-partition program.

  flops        ``mm``/``bmm``/``addmm``/``baddbmm``/convolutions count
               2·M·N·K from shapes (``torch.utils.flop_counter``'s
               formulas); an elementwise op counts its output's elements,
               over the reference's set (``hlo_cost.py:57-65``), with the
               transcendentals counted apart; an op that XLA would expand
               into several (``silu``, ``gelu``, softmax, their backwards)
               counts the elementwise ops of that expansion; a reduction
               counts its input's elements.
  hbm bytes    each op's inputs plus its outputs: in eager mode the op
               boundary is the fusion boundary.  The reference's special
               cases (``hlo_cost.py:262-283``): views and metadata ops cost
               nothing; gathers and index reads cost twice their result;
               in-place and scatter updates twice their update.
  collectives  bytes and counts by kind from the result of each
               ``_c10d_functional`` op (all-gather, all-reduce,
               reduce-scatter, all-to-all; DTensor issues them when it
               redistributes), each counted once; ``wait_tensor`` is not
               counted (``hlo_analysis.py:113-136``).

**Registry kernels.**  A ctypes launch is invisible to a dispatch mode, so
the walker takes over ``core/portable.py::kernel_call``, where the models
run ``attention.flash``, ``attention.decode`` and ``rwkv6.wkv`` on whichever
route they chose.  With ``kernel_adjusted=True`` (the counterpart of
``KERNEL_VMEM_SCOPES``, ``hlo_cost.py:224-260``) such a call counts the
kernel's own ``least_flops`` (``kernels/*/ops.py``) and the bytes of its
inputs and outputs, whatever ran it; the backward of a plain version under
autograd, which no kernel has, is counted op by op.  Otherwise (baseline)
the call is costed by tracing its plain version on ``meta`` tensors of the
same shapes.  So both modes read the same numbers on ``meta``, on the CPU
and on the card.  On ``meta`` a position tensor has no values: the flops
then count the pairs of index positions (query ``i`` at position ``i``, key
slot ``j`` at ``j``; a decode step's every slot filled), which is what a
prompt without padding, and a decode step on a full cache, admit.

**DTensors.**  The walker sees the local ops that DTensor runs on each
rank's blocks and the collectives it issues.  A registry call on DTensors
keeps its inputs' batch sharding, and their head sharding where queries
and keys agree on it; every other dim is redistributed to ``Replicate``
(pending partial sums are reduced first), and the call runs on the local
blocks.  An op that DTensor fails on (no sharding rule, or a view of a
strided block) runs otherwise: a gather or scatter along a dim its target
does not shard on the aligned local blocks; any other op on contiguous
blocks, or else on inputs replicated on as few mesh dims as will do (an
in-place op's result is copied back into its own blocks).
``OpCost.fallbacks`` names each with the most times one trace took it.

**Multiplicity.**  ``with_multiplicity`` costs a step whose repeated units
(a segment's layers) are traced at depth 1 and, one unit at a time, at
depth 2: the difference is one more layer of that unit, forward, backward
and optimizer alike, multiplied by the remaining count — the counterpart of
the reference's trip counts over scan-over-layers (``hlo_cost.py:299-320``).
``OpCost.unknown_trip_loops`` counts the units whose difference was not a
cost (a second layer that costs less than none), which are counted once.

``peak_bytes`` is the high-water mark of live storage that the ops of the
step allocated (tracked through the tensors that hold it), above the
arguments.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.core import portable

__all__ = ["OpCost", "OpCostMode", "measure", "with_multiplicity",
           "arithmetic_intensity", "meta_twin"]


# --------------------------------------------------------------------------
# the cost record
# --------------------------------------------------------------------------
@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    matmul_flops: float = 0.0        # of them, the matmuls' and convolutions'
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unknown_trip_loops: int = 0
    peak_bytes: float = 0.0
    output_bytes: float = 0.0
    ops: float = 0.0
    kernel_calls: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    # ops DTensor failed on, by how each ran: the most in any one trace
    # (not multiplied), and each with its inputs' shapes
    fallbacks: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    fallback_shapes: set = dataclasses.field(default_factory=set)

    _SCALARS = ("flops", "matmul_flops", "transcendentals", "hbm_bytes", "collective_bytes",
                "peak_bytes", "output_bytes", "ops")
    _MAPS = ("collective_bytes_by_kind", "collective_count_by_kind",
             "kernel_calls")

    def add(self, other: "OpCost", mult: float = 1.0) -> None:
        for f in self._SCALARS:
            setattr(self, f, getattr(self, f) + getattr(other, f) * mult)
        for f in self._MAPS:
            mine = getattr(self, f)
            for k, v in getattr(other, f).items():
                mine[k] = mine.get(k, 0.0) + v * mult
        self.unknown_trip_loops += other.unknown_trip_loops
        for k, v in other.fallbacks.items():
            self.fallbacks[k] = max(self.fallbacks.get(k, 0.0), v)
        self.fallback_shapes |= other.fallback_shapes

    def copy(self) -> "OpCost":
        out = OpCost()
        out.add(self)
        return out

    def to_json(self) -> Dict[str, Any]:
        out = {f: getattr(self, f) for f in self._SCALARS}
        out.update({f: {k: v for k, v in sorted(getattr(self, f).items())}
                    for f in self._MAPS})
        out["unknown_trip_loops"] = self.unknown_trip_loops
        out["fallbacks"] = dict(sorted(self.fallbacks.items()))
        out["fallback_shapes"] = sorted(self.fallback_shapes)
        return out


def arithmetic_intensity(cost: OpCost) -> float:
    """FLOP per HBM byte of a costed step (the roofline x-axis); guards
    the zero-traffic case."""
    return cost.flops / max(cost.hbm_bytes, 1.0)


# --------------------------------------------------------------------------
# op classes
# --------------------------------------------------------------------------
# (flops, transcendentals) per output element: the reference's elementwise
# set, and the ops eager ATen runs as one that XLA expands into several
_ELEMENTWISE: Dict[str, Tuple[float, float]] = {
    **{n: (1.0, 0.0) for n in (
        "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs",
        "neg", "floor", "ceil", "round", "sign", "where", "eq", "ne", "lt",
        "le", "gt", "ge", "logical_and", "logical_or", "logical_xor",
        "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
        "bitwise_not", "clamp", "clamp_min", "clamp_max", "atan2",
        "reciprocal", "masked_fill", "fmax", "fmin", "lerp")},
    **{n: (1.0, 1.0) for n in (
        "exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "sin",
        "cos", "erf", "expm1", "log1p")},
    "silu": (2.0, 1.0),               # logistic(x) * x
    "gelu": (9.0, 1.0),               # the tanh form, as jax.nn.gelu
    "_softmax": (5.0, 1.0),           # max, sub, exp, sum, div
    "_log_softmax": (5.0, 1.0),
    "native_layer_norm": (8.0, 1.0),
    "silu_backward": (5.0, 1.0),
    "gelu_backward": (13.0, 1.0),
    "tanh_backward": (3.0, 0.0),
    "sigmoid_backward": (3.0, 0.0),
    "threshold_backward": (1.0, 0.0),
    "_softmax_backward_data": (4.0, 0.0),
    "_log_softmax_backward_data": (4.0, 1.0),
    "native_layer_norm_backward": (12.0, 1.0),
}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "logsumexp", "cumsum", "cumprod", "norm",
               "linalg_vector_norm", "var", "std", "all", "any", "var_mean",
               "std_mean", "nansum"}

# no data moves: views, metadata and allocation without a write (names
# without the trailing underscore of an in-place form)
_FREE = {"detach", "alias", "lift_fresh", "_wrap_tensor_autograd",
         "wait_tensor", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "view", "_reshape_alias",
         "set", "resize", "record_stream", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type", "_local_scalar_dense",
         "squeeze", "unsqueeze", "t", "transpose", "as_strided"}

# reads that copy a selection: twice their result
_READS = {"index", "_unsafe_index", "index_select", "gather", "embedding",
          "take", "masked_select"}

# updates into a buffer: twice their update (the argument named here)
_UPDATES = {"index_put", "_index_put_impl", "scatter", "scatter_add",
            "scatter_reduce", "index_copy", "index_add", "slice_scatter",
            "select_scatter", "masked_scatter", "copy",
            "embedding_dense_backward", "index_fill", "fill"}
_UPDATE_ARGS = ("values", "src", "source", "grad_output", "value")

# gathers and scatters along one dim, which run on aligned local blocks
_ALIGNED = {"gather", "scatter", "scatter_add", "scatter_reduce"}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _base_name(func: Any) -> str:
    return func._overloadpacket.__name__.rstrip("_")


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of an op's arguments or results (tuples, lists and dicts
    of them), in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _dtensor_type() -> Any:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                               # no distributed build
        return None
    return DTensor


# --------------------------------------------------------------------------
# registry kernels: their least flops, and the dims a call may keep sharded
# --------------------------------------------------------------------------
def _index_pairs(s: int, t: int, causal: bool, window: int) -> float:
    """(query, key) pairs a row admits at index positions: query i at
    position i, key slot j holding position j (a prompt written into a
    cache from slot 0; a later slot is empty or in the future)."""
    qp = np.arange(s, dtype=np.int64)
    if not causal:
        if not window:
            return float(s) * t
        lo = np.maximum(qp - window + 1, 0)
        return float(np.clip(t - lo, 0, None).sum())
    reach = np.minimum(qp + 1, t)
    if window:
        reach = np.minimum(reach, window)
    return float(reach.sum())


def _flash_flops(args: Tuple[Any, ...], kwargs: Mapping[str, Any]) -> float:
    from repro_torch.kernels.flash_attention import ops
    q, k, _, q_pos, k_pos = args[:5]
    b, s, h, dh = q.shape
    causal, window = kwargs.get("causal", True), kwargs.get("window", 0)
    if q_pos.is_meta or k_pos.is_meta:
        return 4.0 * dh * h * b * _index_pairs(s, k.shape[1], causal, window)
    return ops.least_flops(q_pos, k_pos, h, dh, causal=causal, window=window)


def _decode_flops(args: Tuple[Any, ...], kwargs: Mapping[str, Any]) -> float:
    from repro_torch.kernels.flash_attention import ops
    q, k, _, q_pos, k_pos = args[:5]
    b, _, h, dh = q.shape
    window = kwargs.get("window", 0)
    if q_pos.is_meta or k_pos.is_meta:
        t = k.shape[1]
        return 4.0 * dh * h * b * (min(t, window) if window else t)
    return ops.decode_least_flops(q_pos, k_pos, h, dh, window=window)


def _wkv_flops(args: Tuple[Any, ...], kwargs: Mapping[str, Any]) -> float:
    from repro_torch.kernels.rwkv6 import ops
    r, _, v = args[:3]
    return ops.least_flops(*r.shape, v.shape[-1])


_KERNEL_FLOPS: Dict[str, Callable[..., float]] = {
    "attention.flash": _flash_flops,
    "attention.decode": _decode_flops,
    "rwkv6.wkv": _wkv_flops,
}

#: the dims of a registry call that may stay sharded, by role: "b" the
#: batch, "h" the heads (queries and keys alike), "d" the head dim (a
#: contraction: the scores' partial sums are all-reduced), "t" the cached
#: keys of a decode step (the partial outputs are combined).  Per kernel:
#: each positional argument's {role: dim}, then each output's.
KERNEL_DIMS: Dict[str, Tuple[Tuple[Dict[str, int], ...],
                             Tuple[Dict[str, int], ...]]] = {
    "attention.flash": (
        ({"b": 0, "h": 2, "d": 3},) * 3 + ({"b": 0},) * 2,
        ({"b": 0, "h": 2, "d": 3},)),
    "attention.decode": (
        ({"b": 0, "h": 2, "d": 3},) + ({"b": 0, "h": 2, "d": 3, "t": 1},) * 2
        + ({"b": 0}, {"b": 0, "t": 1}),
        ({"b": 0, "h": 2, "d": 3},)),
    "rwkv6.wkv": (
        ({"b": 0, "h": 1},) * 4 + ({"h": 0}, {"b": 0, "h": 1}),
        ({"b": 0, "h": 1},) * 2),
}
_ROLES = ("b", "h", "d", "t")


def _combine_bytes(name: str, role: str, local: Tuple[Any, ...]) -> float:
    """The bytes a registry call all-reduces when a mesh dim shards its
    ``role`` "d" (the float32 scores) or "t" (the float32 partial outputs
    and their softmax max and sum), on each rank's blocks."""
    b, s, h, dh = local[0].shape
    return 4.0 * b * h * s * (local[1].shape[1] if role == "d" else dh + 2)


def meta_twin(tree: Any) -> Any:
    """``tree`` with every tensor replaced by one of its shape, strides and
    dtype on ``meta``: a step's twin, which the walker costs as it costs
    the step."""
    def twin(x):
        if isinstance(x, torch.Tensor) and not x.is_meta:
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device="meta")
        return x
    return tree_map(twin, tree)


# --------------------------------------------------------------------------
# the walker
# --------------------------------------------------------------------------
class OpCostMode(TorchDispatchMode):
    """Cost every op run inside ``with OpCostMode(...) as m:`` into
    ``m.cost`` (see the module's docstring).  ``external`` is a tree of
    tensors whose storage the step did not allocate (its arguments)."""

    def __init__(self, kernel_adjusted: bool = False, external: Any = None):
        super().__init__()
        self.kernel_adjusted = kernel_adjusted
        self.cost = OpCost()
        self._paused = 0
        self._dtensor_inside = False
        self._live: Dict[int, list] = {}       # storage -> [bytes, refs]
        self._live_bytes = 0
        self._external = set()
        DTensor = _dtensor_type()
        for t in _tensors(external):
            if DTensor is not None and isinstance(t, DTensor):
                t = t.to_local()
            self._external.add(t.untyped_storage()._cdata)

    # ---- entering ------------------------------------------------------
    def __enter__(self):
        portable.call_observers.append(self._kernel_call)
        return super().__enter__()

    def __exit__(self, *exc):
        portable.call_observers.remove(self._kernel_call)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Run ops without costing them (the mode stays on)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ---- one op --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        DTensor = _dtensor_type()
        if DTensor is not None and any(issubclass(t, DTensor)
                                       for t in types):
            if self._dtensor_inside:
                return NotImplemented   # DTensor runs it, this mode on
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ins, outs = list(_tensors((args, kwargs))), list(_tensors(out))
        # DTensor's sharding propagation runs ops on fake tensors
        if any(_is_fake(t) for t in ins + outs):
            return out
        self._charge_op(func, args, kwargs, out, ins, outs)
        self._track(ins, outs)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """A DTensor op: DTensor runs it with this mode on, so its local
        ops and collectives are costed; where it fails, ``_fallback``."""
        self._dtensor_inside = True
        try:
            with self:
                try:
                    return func(*args, **kwargs)
                except Exception as err:            # no sharding rule
                    return self._fallback(func, args, kwargs, err)
        finally:
            self._dtensor_inside = False

    def _fallback(self, func, args, kwargs, err):
        """Run an op that DTensor failed on, trying in turn: its inputs'
        local blocks made contiguous (a view of a block that an exchange
        left strided), then its inputs replicated on the last mesh dim,
        the last two, ..., all of them.  An in-place op runs its functional
        form and copies the result back into its own blocks.  The first
        that works is named, with its count, in ``OpCost.fallbacks``."""
        from torch.distributed.tensor import DTensor, Replicate
        schema = func._schema
        mutates = bool(schema.arguments) and \
            schema.arguments[0].alias_info is not None and \
            schema.arguments[0].alias_info.is_write
        mesh = next(a.device_mesh for a in _tensors((args, kwargs))
                    if isinstance(a, DTensor))
        aligned = self._aligned(func, args, kwargs)
        if aligned is not None:
            return aligned
        ways = [("contiguous blocks", lambda a: a.contiguous())]
        for m in reversed(range(mesh.ndim)):
            names = mesh.mesh_dim_names or tuple(map(str, range(mesh.ndim)))
            ways.append((f"replicated on {'+'.join(names[m:])}",
                         lambda a, m=m: a.redistribute(a.device_mesh, [
                             Replicate() if i >= m else p
                             for i, p in enumerate(a.placements)])
                         .contiguous()))

        def run(change):
            cargs, ckwargs = tree_map(
                lambda a: change(a) if isinstance(a, DTensor) else a,
                (args, kwargs))
            if not mutates:
                return func(*cargs, **ckwargs)
            target = args[0]
            if not isinstance(target, DTensor):
                raise TypeError("an in-place op on a plain tensor")
            functional = getattr(getattr(torch.ops.aten, _base_name(func)),
                                 func._overloadname)
            res = functional(*cargs, **ckwargs)
            res = res.redistribute(target.device_mesh, target.placements)
            target.to_local().copy_(res.to_local())
            return target

        tried = []
        for how, change in ways:
            before = self.cost.copy()
            try:
                out = run(change)
            except Exception as again:          # undo what it counted
                self.cost = before
                tried.append(f"{how}: {again}")
                continue
            self.cost.fallbacks[f"{func}: {how}"] += 1
            self.cost.fallback_shapes.add(
                f"{func} {[tuple(t.shape) for t in _tensors(args)]}: {how}")
            return out
        raise RuntimeError(f"{func}: DTensor has no sharding rule for it "
                           f"({err}), and every fallback fails ({tried})")

    def _aligned(self, func, args, kwargs):
        """A gather or scatter along a dim its first argument does not
        shard, with every tensor argument the first's size on the sharded
        dims, runs on the local blocks, each argument placed as the first
        (what a newer DTensor's rule for them does); None where it does
        not apply."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if _base_name(func) not in _ALIGNED or kwargs or \
                not isinstance(args[0], DTensor) or len(args) < 3:
            return None
        first, dim = args[0], args[1]
        dim = dim % first.ndim
        sharded = {p.dim for p in first.placements if isinstance(p, Shard)}
        if dim in sharded or not all(isinstance(p, (Shard, Replicate))
                                     for p in first.placements):
            return None
        tensors = [a for a in args[2:] if isinstance(a, torch.Tensor)]
        if any(a.ndim != first.ndim or any(a.shape[d] != first.shape[d]
                                           for d in sharded)
               for a in tensors):
            return None
        mesh, place = first.device_mesh, first.placements

        def local(a):
            if not isinstance(a, torch.Tensor):
                return a
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return a.redistribute(mesh, place).to_local()
        out = func(first.to_local(), *(local(a) for a in args[1:]))
        self.cost.fallbacks[f"{func}: local blocks"] += 1
        self.cost.fallback_shapes.add(
            f"{func} {[tuple(t.shape) for t in _tensors(args)]}: "
            f"local blocks")
        if out is first.to_local() or _base_name(func) + "_" == \
                func._overloadpacket.__name__:
            return first
        return DTensor.from_local(out, mesh, place, run_check=False)

    # ---- costs ---------------------------------------------------------
    def _charge_op(self, func, args, kwargs, out, ins, outs) -> None:
        """Cost one op: ``ins`` and ``outs`` are its argument and result
        tensors."""
        c = self.cost
        name = _base_name(func)
        c.ops += 1
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return                               # wait_tensor, wraps
            nb = sum(_nbytes(t) for t in outs)
            c.collective_bytes += nb
            c.collective_bytes_by_kind[kind] += nb
            c.collective_count_by_kind[kind] += 1
            c.hbm_bytes += nb + sum(_nbytes(t) for t in ins)
            return
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        out_elems = sum(t.numel() for t in outs)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            c.matmul_flops += f
        elif name in _REDUCTIONS and not (name in ("max", "min")
                                          and len(ins) > 1):
            c.flops += float(ins[0].numel()) if ins else 0.0
        elif name in _ELEMENTWISE:
            f, tr = _ELEMENTWISE[name]
            c.flops += f * out_elems
            c.transcendentals += tr * out_elems
        # bytes
        if name in _FREE or getattr(func, "is_view", False):
            return
        if name in _READS:
            c.hbm_bytes += 2 * sum(_nbytes(t) for t in outs)
            return
        if name in _UPDATES:
            upd = None
            for i, a in enumerate(func._schema.arguments):
                if a.name in _UPDATE_ARGS:
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    if isinstance(v, torch.Tensor):
                        upd = v
                        break
            c.hbm_bytes += 2 * (_nbytes(upd) if upd is not None
                                else sum(_nbytes(t) for t in outs))
            return
        c.hbm_bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)

    # ---- live storage --------------------------------------------------
    def _track(self, ins, outs) -> None:
        """Count the storage a result holds that no argument held."""
        inputs = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key in self._external:
                continue
            entry = self._live.get(key)
            if entry is None:
                if key in inputs:         # aliases an untracked input
                    continue
                entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
                self._live_bytes += entry[0]
                self.cost.peak_bytes = max(self.cost.peak_bytes,
                                           self._live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    # ---- registry kernels ----------------------------------------------
    def _kernel_call(self, name, fn, plain, args, kwargs):
        DTensor = _dtensor_type()
        lead = next((a for a in args if DTensor is not None
                     and isinstance(a, DTensor)), None)
        if lead is None:
            return self._run_kernel(name, fn, plain, args, kwargs)
        return self._sharded_kernel(name, fn, plain, args, kwargs, lead)

    def _run_kernel(self, name, fn, plain, args, kwargs):
        self.cost.kernel_calls[name] += 1
        if self._paused:
            return fn(*args, **kwargs)
        if self.kernel_adjusted:
            with self.paused():
                out = fn(*args, **kwargs)
                flops = _KERNEL_FLOPS[name](args, kwargs)
            c = self.cost
            c.flops += flops
            c.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(out))
            return out
        if fn is plain and all(t.is_meta for t in _tensors(args)):
            return plain(*args, **kwargs)            # costed op by op
        with self.paused():
            out = fn(*args, **kwargs)
        plain(*meta_twin(args), **kwargs)
        return out

    def _sharded_kernel(self, name, fn, plain, args, kwargs, lead):
        """A registry call on DTensors: each mesh dim keeps the role
        (``KERNEL_DIMS``) that moves the fewest bytes, the rest is
        replicated; the call runs on the local blocks, and its outputs are
        wrapped back."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        mesh = lead.device_mesh
        in_dims, out_dims = KERNEL_DIMS[name]

        def as_dtensor(a):
            if isinstance(a, DTensor) or not isinstance(a, torch.Tensor):
                return a
            return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        args = tuple(as_dtensor(a) for a in args)
        sharded = [isinstance(a, DTensor) for a in args]
        factor = [dict() for _ in args]      # arg -> {dim: shards so far}
        roles = []
        for m in range(mesh.ndim):
            size = mesh.size(m)

            def target(i, role):
                d = in_dims[i].get(role) if role else None
                return Replicate() if d is None else Shard(d)

            def valid(role):
                if role is None:
                    return True
                for i, a in enumerate(args):
                    d = in_dims[i].get(role)
                    if not sharded[i] or d is None:
                        continue
                    if a.shape[d] % (factor[i].get(d, 1) * size):
                        return False
                return any(role in in_dims[i] for i in range(len(args))
                           if sharded[i])

            def moved(role):
                total = 0.0
                for i, a in enumerate(args):
                    if not sharded[i]:
                        continue
                    p, t = a.placements[m], target(i, role)
                    if p == t or isinstance(p, (Replicate, Partial)):
                        continue
                    local = a.to_local()
                    total += _nbytes(local) * (size if isinstance(
                        t, Replicate) else 1)
                if role in ("d", "t"):      # the partial results' reduce
                    total += _combine_bytes(name, role, tuple(
                        a.to_local() if isinstance(a, DTensor) else a
                        for a in args))
                return total
            best = min([r for r in _ROLES if valid(r)] + [None],
                       key=lambda r: (moved(r), (_ROLES + (None,)).index(r)))
            roles.append(best)
            for i in range(len(args)):
                d = in_dims[i].get(best) if best else None
                if d is not None:
                    factor[i][d] = factor[i].get(d, 1) * size

        def placements(dims):
            return [Replicate() if r is None or dims.get(r) is None
                    else Shard(dims[r]) for r in roles]

        local = tuple(
            a.redistribute(mesh, placements(dims)).to_local()
            if isinstance(a, DTensor) else a
            for a, dims in zip(args, in_dims))
        out = self._run_kernel(name, fn, plain, local, kwargs)
        if not self._paused:
            for r in roles:
                if r in ("d", "t"):
                    nb = _combine_bytes(name, r, local)
                    c = self.cost
                    c.collective_bytes += nb
                    c.collective_bytes_by_kind["all-reduce"] += nb
                    c.collective_count_by_kind["all-reduce"] += 1
        outs = out if isinstance(out, tuple) else (out,)
        wrapped = tuple(
            DTensor.from_local(o, mesh, placements(
                {k: v for k, v in dims.items() if k != "t"}),
                run_check=False)
            for o, dims in zip(outs, out_dims))
        return wrapped if isinstance(out, tuple) else wrapped[0]


def measure(fn: Callable[..., Any], *args: Any,
            kernel_adjusted: bool = False, **kwargs: Any
            ) -> Tuple[Any, OpCost]:
    """(``fn(*args, **kwargs)``, its cost) — one run under the walker."""
    mode = OpCostMode(kernel_adjusted=kernel_adjusted,
                      external=(args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.cost


def with_multiplicity(trace: Callable[[Dict[str, int]], OpCost],
                      repeats: Mapping[str, int],
                      base_depths: Optional[Mapping[str, int]] = None
                      ) -> Tuple[OpCost, OpCost]:
    """(the cost of a step whose repeated units have ``repeats`` layers,
    the cost of its first trace, every unit at its base depth).

    ``trace(depths)`` costs the step with unit ``u`` cut to ``depths[u]``
    layers.  Every unit starts at its base depth (``base_depths``, 1 by
    default); each unit with more is traced once more at one deeper, and
    the difference, one more layer, is added for each layer left."""
    start = {u: (base_depths or {}).get(u, 1) for u in repeats}
    base = trace(start)
    total = base.copy()
    for u, n in repeats.items():
        if n <= start[u]:
            continue
        deeper = trace({**start, u: start[u] + 1})
        one_more = deeper.copy()
        one_more.add(base, -1.0)
        if one_more.flops < 0 or one_more.hbm_bytes < 0:
            total.unknown_trip_loops += 1
            continue
        total.add(one_more, float(n - start[u]))
    return total, base
