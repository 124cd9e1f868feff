"""Divisibility-aware sharding policy: DP / FSDP(ZeRO) / TP / EP / SP.

The port of ``repro/distributed/sharding.py``.  The rule engine is the
reference's, rule for rule, and returns the reference's spec as a tuple of
mesh axis names (``None``, ``"model"``, ``"data"`` or a tuple of axes such
as ``("pod", "data")`` for one tensor dim):

  * parameters: largest dim divisible by `model` -> TP; largest remaining
    dim divisible by `data` -> FSDP/ZeRO.  Stacked-layer leading dims and
    expert dims get dedicated handling (scan unit / EP).
  * the `pod` axis is pure DP: batch + gradient all-reduce; parameters are
    replicated across pods.
  * activations: batch over (pod, data); if batch is unshardable (long-
    context batch=1 cells) the *sequence* dim shards over (pod, data) — SP.
  * KV caches: batch -> DP when divisible, else sequence -> SP; kv-heads ->
    TP when divisible, else head_dim -> TP.

Where the reference applies a spec with ``NamedSharding`` and
``with_sharding_constraint``, the port makes DTensors on a
``torch.distributed`` ``DeviceMesh``: ``placements(spec, ndim)`` turns a
spec into one placement a mesh dim (a tensor dim over ``("pod", "data")``
is ``Shard(d)`` on both mesh dims), ``tree_shardings`` / ``batch_shardings``
/ ``cache_shardings`` distribute a tree of tensors (``meta`` or real) by
the specs, and ``hints()`` gives the model's four sharding points, which
redistribute a DTensor to the spec's placements and pass a plain tensor
through unchanged.

The port keeps a segment's layers apart (``models/transformer.py``: a list
of per-layer dicts, where the reference stacks them on a leading axis).  A
leaf under ``segments/<seg>/<layer>/...`` or ``encoder/layers/<layer>/...``
gets the reference's spec of the stacked leaf without its leading ``None``
(the scan unit is never sharded); a path without the layer index is read as
the reference's stacked path, its shape with the leading layer dim.  Caches
stay stacked in both packages.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator, List, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import ShardingHints

__all__ = ["ShardingPolicy", "Spec", "tree_paths", "tree_map_with_path",
           "reference_path"]

#: one entry a tensor dim: None, a mesh axis name, or a tuple of them
Spec = Tuple[Any, ...]

# a layer index inside a segment or the encoder's layers (unstacked leaves)
_LAYER_INDEX = re.compile(r"^(.*?(?:segments/\d+|encoder/layers))/\d+(/.*)?$")


def reference_path(path: str) -> Tuple[str, bool]:
    """(the reference's path of a port leaf, whether the port's leaf is one
    layer of a leaf the reference stacks): ``segments/0/3/attn/wq`` ->
    (``segments/0/attn/wq``, True)."""
    m = _LAYER_INDEX.match(path)
    if m is None:
        return path, False
    return m.group(1) + (m.group(2) or ""), True


def _key(k: Any) -> str:
    return str(k)


def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(the '/'-joined path, leaf) of every leaf of a tree of dicts, lists,
    tuples and named tuples, in ``jax.tree``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{_key(k)}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from tree_paths(getattr(tree, name), f"{prefix}{name}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``fn(path, leaf)`` on every leaf; the tree's structure (named tuples
    included) is kept, and None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{_key(k)}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, n),
                                               f"{prefix}{n}/")
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def _spec(spec: Sequence[Any]) -> Spec:
    """A spec as ``PartitionSpec`` keeps it: a one-axis tuple is its
    axis."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def _axis_size(mesh: Any, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Any            # torch.distributed.device_mesh.DeviceMesh
    cfg: ModelConfig

    # ------------------------------------------------------------------
    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if "pod" in (self.mesh.mesh_dim_names or ()) \
            else ("data",)

    @property
    def dp_size(self) -> int:
        out = 1
        for a in self.dp_axes:
            out *= _axis_size(self.mesh, a)
        return out

    @property
    def tp_size(self) -> int:
        return _axis_size(self.mesh, "model")

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_spec(self, path: str, shape: Sequence[int]) -> Spec:
        """Generic rule engine; `path` is the '/'-joined tree path."""
        ref, unstacked = reference_path(path)
        if unstacked:
            return self._param_rule(ref, (1, *shape))[1:]
        return self._param_rule(path, tuple(shape))

    def _param_rule(self, path: str, shape: Tuple[int, ...]) -> Spec:
        rank = len(shape)
        spec: list = [None] * rank
        if rank == 0:
            return ()
        start = 0
        stacked = ("segments/" in path or path.startswith("segments")
                   or "encoder/layers" in path)
        if stacked:
            start = 1  # leading n_layers dim is the scan unit — never shard

        dims = list(range(start, rank))
        # embedding table: shard ONLY the (padded) vocab dim
        if path == "embed" or path.endswith("/embed"):
            spec = [None] * rank
            if shape[0] % self.tp_size == 0:
                spec[0] = "model"
            return _spec(spec)

        # EP override: expert banks (L?, E, d_in, d_out) — expert dim -> model
        if "experts/" in path or "shared/" in path:
            e_dim = start
            if e_dim < rank and shape[e_dim] % self.tp_size == 0 \
                    and shape[e_dim] >= self.tp_size:
                spec[e_dim] = "model"
                dims.remove(e_dim)
            # FSDP on the largest remaining divisible dim
            self._assign(spec, shape, dims, "data",
                         _axis_size(self.mesh, "data"))
            return _spec(spec)

        if rank - start == 1:
            return _spec(spec)  # 1-D (norm scales, biases): replicate

        self._assign(spec, shape, dims, "model", self.tp_size)
        self._assign(spec, shape, dims, "data",
                     _axis_size(self.mesh, "data"))
        return _spec(spec)

    @staticmethod
    def _assign(spec, shape, dims, axis_name, axis_size):
        if axis_size <= 1:
            return
        for d in sorted(dims, key=lambda i: -shape[i]):
            if shape[d] % axis_size == 0 and shape[d] >= axis_size:
                spec[d] = axis_name
                dims.remove(d)
                return

    # ------------------------------------------------------------------
    # batches / activations
    # ------------------------------------------------------------------
    def batch_spec(self, shape: Sequence[int]) -> Spec:
        """Input batches (tokens/targets/mask (B,S), frames/patches (B,T,D))."""
        rank = len(shape)
        b = shape[0]
        spec: list = [None] * rank
        if b % self.dp_size == 0:
            spec[0] = self.dp_axes
        elif rank >= 2 and shape[1] % self.dp_size == 0:
            spec[1] = self.dp_axes          # SP fallback (batch=1 cells)
        return _spec(spec)

    # ------------------------------------------------------------------
    # KV caches / decode state
    # ------------------------------------------------------------------
    def cache_spec(self, path: str, shape: Sequence[int]) -> Spec:
        rank = len(shape)
        spec: list = [None] * rank
        start = 0
        if "segments/" in path or path.startswith("segments"):
            start = 1                        # stacked layer dim
        dims = list(range(start, rank))
        if not dims:
            return _spec(spec)
        # batch is the first dim after stacking
        b_dim = start
        if shape[b_dim] % self.dp_size == 0 and shape[b_dim] >= self.dp_size:
            spec[b_dim] = self.dp_axes
            dims.remove(b_dim)
        elif rank > b_dim + 1 and shape[b_dim + 1] % self.dp_size == 0 \
                and shape[b_dim + 1] >= self.dp_size:
            spec[b_dim + 1] = self.dp_axes   # SP over cache length
            dims.remove(b_dim + 1)
        # TP: try kv-heads (dim -2) then head_dim (dim -1)
        for d in (rank - 2, rank - 1):
            if d in dims and shape[d] % self.tp_size == 0 \
                    and shape[d] >= self.tp_size:
                spec[d] = "model"
                dims.remove(d)
                break
        return _spec(spec)

    # ------------------------------------------------------------------
    # specs -> DTensors
    # ------------------------------------------------------------------
    def placements(self, spec: Spec, ndim: int) -> Tuple[Any, ...]:
        """DTensor placements, one a mesh dim, of a tensor of ``ndim`` dims
        with ``spec``: ``Shard(d)`` on every mesh dim that spec entry ``d``
        names, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        out: List[Any] = []
        for name in self.mesh.mesh_dim_names:
            dim = next((d for d, ax in enumerate(spec)
                        if ax == name or (isinstance(ax, tuple)
                                          and name in ax)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def replicated(self) -> Tuple[Any, ...]:
        """The placements of a fully replicated tensor."""
        return self.placements((), 0)

    def distribute(self, t: torch.Tensor, spec: Spec) -> Any:
        """``t`` (on ``meta`` or a real device) as a DTensor placed by
        ``spec``: each rank keeps its own block, nothing is communicated."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements(spec, t.ndim))
        out = distribute_tensor(t.detach(), self.mesh,
                                self.placements(spec, t.ndim),
                                src_data_rank=None)
        return out.requires_grad_(t.requires_grad)

    def tree_shardings(self, tree: Any) -> Any:
        """``tree`` (parameters or a train state) distributed by
        ``param_spec`` leaf by leaf."""
        return tree_map_with_path(
            lambda p, t: self.distribute(t, self.param_spec(p, t.shape)),
            tree)

    def batch_shardings(self, batch: Any) -> Any:
        return tree_map_with_path(
            lambda p, t: self.distribute(t, self.batch_spec(t.shape)), batch)

    def cache_shardings(self, caches: Any) -> Any:
        return tree_map_with_path(
            lambda p, t: self.distribute(t, self.cache_spec(p, t.shape)),
            caches)

    # ------------------------------------------------------------------
    # activation hints
    # ------------------------------------------------------------------
    def _constrain(self, x: Any, spec: Spec) -> Any:
        """The counterpart of ``with_sharding_constraint``: a DTensor is
        redistributed to ``spec``'s placements, anything else passes."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        want = self.placements(spec, x.ndim)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def hints(self) -> ShardingHints:
        dp_axes, dp, tp = self.dp_axes, self.dp_size, self.tp_size
        policy = self

        def moe_constraint(x, kind):
            spec: list = [None] * x.ndim
            if x.shape[0] % dp == 0 and x.shape[0] >= dp:
                spec[0] = dp_axes                 # token groups -> DP
            if kind == "gecd" and x.shape[1] % tp == 0 \
                    and x.shape[1] >= tp:
                spec[1] = "model"                 # expert dim -> EP
            return policy._constrain(x, tuple(spec))

        def params_compute(tree):
            def strip(path, leaf):
                spec = policy.param_spec(path, leaf.shape)
                return policy._constrain(
                    leaf, tuple(ax if ax == "model" else None
                                for ax in spec))
            return tree_map_with_path(strip, tree)

        def act(x):
            if x.ndim < 2:
                return x
            spec: list = [None] * x.ndim
            if x.shape[0] % dp == 0 and x.shape[0] >= dp:
                spec[0] = dp_axes
            elif x.shape[1] % dp == 0:
                spec[1] = dp_axes            # SP
            return policy._constrain(x, tuple(spec))

        def logits(x):
            spec: list = [None] * x.ndim
            if x.shape[0] % dp == 0 and x.shape[0] >= dp:
                spec[0] = dp_axes
            elif x.ndim >= 2 and x.shape[1] % dp == 0:
                spec[1] = dp_axes
            if x.shape[-1] % tp == 0:
                spec[-1] = "model"           # vocab-sharded logits
            return policy._constrain(x, tuple(spec))

        return ShardingHints(activation=act, logits=logits,
                             params_compute=params_compute,
                             moe_constraint=moe_constraint)


def local_bytes(t: Any) -> int:
    """The bytes one rank holds of ``t``: its local block for a DTensor,
    all of it otherwise."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()


def tree_local_bytes(tree: Any) -> int:
    return sum(local_bytes(t) for _, t in tree_paths(tree))
