"""``repro_torch.distributed.sharding.ShardingPolicy`` against the
reference's: ``param_spec`` leaf by leaf over every arch's full-size
parameter tree, ``cache_spec`` and ``batch_spec`` at every shape cell, on
16x16, 2x16x16, 4x2 and 1x1 meshes (exact: the same rules); the
reference's invariants (``tests/test_sharding_policy.py:43-75``), ported;
the placements, the DTensors the policy builds and its hints.

The reference reads a mesh's names and sizes only, so an ``AbstractMesh``
serves it; the port's rules read the same two things of a ``DeviceMesh``,
and a stand-in with them serves here, while the DTensor cases run on a
fake world that each test ends."""

import functools
import os
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.distributed.sharding import ShardingPolicy as RefPolicy
from repro.distributed.sharding import _key_str
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import (ShardingPolicy, reference_path,
                                              tree_local_bytes, tree_paths)
from repro_torch.launch import specs as S
from repro_torch.launch.hostsim import close_fake_world

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _stand_in(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(shape=shape, mesh_dim_names=names)


def _policies(arch, mesh):
    shape, names = MESHES[mesh]
    return (ShardingPolicy(_stand_in(mesh), get_config(arch)),
            RefPolicy(AbstractMesh(shape, names), ref_config(arch)))


def _reference_launch(name):
    """``repro.launch.<name>``, imported without the 512 forced host
    devices that its package puts into ``XLA_FLAGS`` reaching the jax of
    this process."""
    import importlib
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key_str(k) for k in path): tuple(leaf.shape)
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    RS = _reference_launch("specs")
    return _ref_leaves(RS.params_specs(ref_config(arch)))


@functools.lru_cache(maxsize=None)
def _ref_caches(arch, batch, seq):
    RS = _reference_launch("specs")
    return _ref_leaves(RS.cache_specs(ref_config(arch), batch, seq))


@pytest.fixture
def fake_world():
    yield
    close_fake_world()


# --------------------------------------------------------------------------
# equal to the reference, leaf by leaf
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_equals_the_references_leaf_by_leaf(arch, mesh):
    ours, theirs = _policies(arch, mesh)
    ref = _ref_params(arch)
    seen = set()
    for path, leaf in tree_paths(S.params_specs(get_config(arch))):
        ref_path, unstacked = reference_path(path)
        ref_shape = ref[ref_path]
        want = tuple(theirs.param_spec(ref_path, ref_shape))
        if unstacked:
            assert tuple(leaf.shape) == ref_shape[1:], path
            want = want[1:]
        else:
            assert tuple(leaf.shape) == ref_shape, path
        assert ours.param_spec(path, tuple(leaf.shape)) == want, path
        # the reference's own path and stacked shape give its spec whole
        assert ours.param_spec(ref_path, ref_shape) == \
            tuple(theirs.param_spec(ref_path, ref_shape)), ref_path
        seen.add(ref_path)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_references(arch, mesh):
    ours, theirs = _policies(arch, mesh)
    cfg = get_config(arch)
    for cell in SHAPES.values():
        b, s = cell.global_batch, cell.seq_len
        ref = _ref_caches(arch, b, s)
        got = dict(tree_paths(S.cache_specs(cfg, b, s)))
        assert set(got) == set(ref)
        for path, leaf in got.items():
            assert tuple(leaf.shape) == ref[path], path
            assert ours.cache_spec(path, ref[path]) == \
                tuple(theirs.cache_spec(path, ref[path])), path
        inputs = [*S.train_batch_specs(cfg, cell).values(),
                  *S.prefill_input_specs(cfg, cell).values()]
        dec = S.decode_input_specs(cfg, cell)
        dec.pop("caches")
        for t in [*inputs, *dec.values()]:
            assert ours.batch_spec(t.shape) == \
                tuple(theirs.batch_spec(t.shape)), (cell.name, t.shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_axis_sizes_equal_the_references(mesh):
    ours, theirs = _policies("granite-3-8b", mesh)
    assert ours.dp_axes == theirs.dp_axes
    assert (ours.dp_size, ours.tp_size) == (theirs.dp_size, theirs.tp_size)


# --------------------------------------------------------------------------
# the reference's invariants (tests/test_sharding_policy.py:43-75)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def policy():
    return ShardingPolicy(_stand_in("4x2"),
                          get_config("granite-3-8b", smoke=True))


def _divisible(spec, shape, mesh) -> bool:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = int(np.prod([sizes[a] for a in axes]))
        if dim % size:
            return False
    return True


@settings(max_examples=200, deadline=None)
@given(shape=st.lists(st.integers(1, 4096), min_size=0, max_size=4),
       path=st.sampled_from([
           "embed", "segments/0/attn/wq", "segments/0/moe/experts/w_up",
           "eager/0/mlp/w_down", "final_norm/scale", "unembed",
           "encoder/layers/attn/wk", "segments/0/3/attn/wq",
           "encoder/layers/2/mlp/w_up"]))
def test_param_spec_always_divisible(policy, shape, path):
    """THE invariant: the policy never requests an indivisible sharding."""
    spec = policy.param_spec(path, shape)
    assert _divisible(spec, shape, policy.mesh)


@settings(max_examples=100, deadline=None)
@given(shape=st.lists(st.integers(1, 2048), min_size=1, max_size=5))
def test_batch_and_cache_specs_divisible(policy, shape):
    assert _divisible(policy.batch_spec(shape), shape, policy.mesh)
    assert _divisible(policy.cache_spec("segments/0/self/k", shape), shape,
                      policy.mesh)


def test_stacked_layer_dim_never_sharded(policy):
    spec = policy.param_spec("segments/0/attn/wq", (48, 4096, 4096))
    assert spec[0] is None   # 48 divides 4 but is the scan unit
    # the port's layer of that stack: the same spec without its leading dim
    assert policy.param_spec("segments/0/7/attn/wq", (4096, 4096)) == \
        spec[1:]


def test_expert_dim_on_model_axis():
    pol = ShardingPolicy(_stand_in("4x2"),
                         get_config("deepseek-moe-16b", smoke=True))
    spec = pol.param_spec("segments/0/moe/experts/w_up", (27, 64, 2048, 1408))
    assert spec[1] == "model"
    assert pol.param_spec("segments/0/5/moe/experts/w_up",
                          (64, 2048, 1408))[0] == "model"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_state_shardings_build(arch, fake_world):
    """DTensors construct for every arch's full-size state (on meta)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.train_step import TrainConfig
    cfg = get_config(arch)
    pol = ShardingPolicy(make_mesh((1, 1), ("data", "model")), cfg)
    state = S.train_state_specs(cfg, TrainConfig(microbatches=1))
    sh = pol.tree_shardings(state)
    leaves = [t for _, t in tree_paths(sh)]
    assert leaves and all(t.device_mesh is pol.mesh for t in leaves)
    assert tree_local_bytes(sh) == tree_local_bytes(state)


# --------------------------------------------------------------------------
# placements, DTensors, hints
# --------------------------------------------------------------------------
def test_placements_of_specs(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    pol = ShardingPolicy(make_mesh((2, 2, 2), ("pod", "data", "model")),
                         get_config("granite-3-8b", smoke=True))
    assert pol.placements((("pod", "data"), None, "model"), 3) == \
        (Shard(0), Shard(0), Shard(2))
    assert pol.placements(("model",), 2) == \
        (Replicate(), Replicate(), Shard(0))
    assert pol.replicated() == (Replicate(),) * 3
    x = pol.distribute(torch.empty(8, 6, 4, device="meta"),
                       (("pod", "data"), None, "model"))
    assert x.to_local().shape == (2, 6, 2) and x.shape == (8, 6, 4)


def test_hints_redistribute_dtensors_and_pass_plain_tensors(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"))
    pol = ShardingPolicy(mesh, get_config("granite-3-8b", smoke=True))
    h = pol.hints()
    plain = torch.randn(8, 4, 16)
    assert h.activation(plain) is plain and h.logits(plain) is plain
    assert h.moe_constraint(plain, "gecd") is plain
    x = distribute_tensor(torch.empty(8, 4, 16, device="meta"), mesh,
                          (Replicate(), Replicate()), src_data_rank=None)
    assert h.activation(x).placements == (Shard(0), Replicate())
    assert h.logits(x).placements == (Shard(0), Shard(2))
    e = distribute_tensor(torch.empty(4, 8, 3, 16, device="meta"), mesh,
                          (Replicate(), Replicate()), src_data_rank=None)
    assert h.moe_constraint(e, "gecd").placements == (Shard(0), Shard(1))
    assert h.moe_constraint(e, "gtec").placements == (Shard(0), Replicate())
    # long-context batch=1: the sequence shards (SP)
    sp = distribute_tensor(torch.empty(1, 8, 16, device="meta"), mesh,
                           (Replicate(), Replicate()), src_data_rank=None)
    assert h.activation(sp).placements == (Shard(1), Replicate())
    params = pol.tree_shardings({"eager": {"0": {"attn": {
        "wq": torch.empty(64, 64, device="meta")}}}})
    stripped = h.params_compute(params)["eager"]["0"]["attn"]["wq"]
    assert "data" not in [mesh.mesh_dim_names[i] for i, p in
                          enumerate(stripped.placements)
                          if isinstance(p, Shard)]
