"""The dry-run path (``repro_torch.launch``): smoke cells on a fake 4x2
world build, run under the op-cost walker and write a record with the
reference's keys; one rank's argument bytes equal the reference's
``memory_analysis().argument_size_in_bytes`` on the same smoke cells
(exact); a 1x1 mesh moves no collective bytes; ``long_500k`` is refused for
full-attention archs; the simulated world (``hostsim``); and the rewrites
the DTensor path asked of the models, bit for bit on the CPU: ``NO_HINTS``
against hints left out, the loss's masked sum against the gather, the
decode cache write's gather/scatter against advanced indexing."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import ShardingPolicy, tree_paths
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.hostsim import (close_fake_world, ensure_fake_world,
                                        fake_world_plan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's smoke cells (tests/test_dryrun_integration.py:22-23)
SMALL_TRAIN = ShapeConfig("train_small", 64, 4, "train")
SMALL_DECODE = ShapeConfig("decode_small", 64, 4, "decode")

REFERENCE_KEYS = {"arch", "shape", "mesh", "variant", "kind", "status",
                  "reason", "n_chips", "lower_s", "compile_s", "per_chip",
                  "roofline_s", "dominant", "bound_s", "collectives",
                  "model_flops_total", "useful_flops_ratio",
                  "tokens_per_step", "fits_hbm"}
PER_CHIP_KEYS = {"flops", "hbm_bytes", "collective_bytes", "argument_bytes",
                 "output_bytes", "temp_bytes", "peak_bytes",
                 "xla_flops_flat", "xla_bytes_flat", "unknown_trip_loops"}


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


@pytest.fixture
def mesh_4x2():
    from repro_torch.launch.mesh import make_mesh
    yield make_mesh((4, 2), ("data", "model"))
    close_fake_world()


@pytest.fixture
def mesh_1x1():
    from repro_torch.launch.mesh import make_mesh
    yield make_mesh((1, 1), ("data", "model"))
    close_fake_world()


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", SMALL_TRAIN), ("stablelm-1.6b", SMALL_DECODE),
    ("deepseek-moe-16b", SMALL_TRAIN), ("rwkv6-3b", SMALL_DECODE),
    ("hymba-1.5b", SMALL_DECODE), ("whisper-tiny", SMALL_DECODE),
    ("granite-3-8b", ShapeConfig("prefill_small", 64, 8, "prefill"))])
def test_smoke_cells_build_run_and_write_a_record(arch, shape, mesh_4x2,
                                                  tmp_path):
    cfg = get_config(arch, smoke=True)
    rec = D.run_cell(arch, shape.name, False, str(tmp_path),
                     mesh=mesh_4x2, cfg=cfg, shape=shape)
    assert rec["status"] == "ok", rec
    assert REFERENCE_KEYS <= set(rec) and PER_CHIP_KEYS <= set(rec["per_chip"])
    on_disk = json.loads((tmp_path / f"{arch}__{shape.name}.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    pc = rec["per_chip"]
    assert rec["n_chips"] == 8 and rec["mesh"] == "4x2"
    assert pc["flops"] > 0 and pc["hbm_bytes"] > 0
    assert pc["collective_bytes"] > 0 and rec["collectives"]
    assert pc["peak_bytes"] >= pc["argument_bytes"] > 0
    assert pc["unknown_trip_loops"] == 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert np.isfinite(rec["bound_s"]) and rec["bound_s"] > 0


def _reference_argument_bytes():
    """The reference's per-device argument bytes of the two smoke cells of
    stablelm-1.6b, compiled on a 4x2 mesh of 8 forced host devices."""
    code = r"""
import json, jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import ShardingPolicy
from repro.launch.dryrun import build_cell
from repro.launch.mesh import _make_mesh
out = {}
mesh = _make_mesh((4, 2), ("data", "model"))
cfg = get_config("stablelm-1.6b", smoke=True)
for shape in (ShapeConfig("train_small", 64, 4, "train"),
              ShapeConfig("decode_small", 64, 4, "decode")):
    policy = ShardingPolicy(mesh, cfg)
    fn, args, in_sh, out_sh, donate, _ = build_cell(cfg, shape, mesh, policy)
    kw = {"in_shardings": in_sh}
    if out_sh is not None:
        kw["out_shardings"] = out_sh
    if donate:
        kw["donate_argnums"] = donate
    with mesh:
        c = jax.jit(fn, **kw).lower(*args).compile()
    out[shape.kind] = int(c.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""
    merged_xla_flags = _reference_launch("hostsim").merged_xla_flags
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=merged_xla_flags(8, {}))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_argument_bytes_equal_the_references(mesh_4x2):
    want = _reference_argument_bytes()
    cfg = get_config("stablelm-1.6b", smoke=True)
    policy = ShardingPolicy(mesh_4x2, cfg)
    for shape in (SMALL_TRAIN, SMALL_DECODE):
        from repro_torch.distributed.sharding import tree_local_bytes
        _, args, _ = D.build_cell(cfg, shape, policy)
        assert tree_local_bytes(args) == want[shape.kind], shape.kind


def test_one_rank_mesh_moves_no_collective_bytes(mesh_1x1, tmp_path):
    cfg = get_config("stablelm-1.6b", smoke=True)
    for shape in (SMALL_TRAIN, SMALL_DECODE):
        rec = D.run_cell("stablelm-1.6b", shape.name, False, str(tmp_path),
                         mesh=mesh_1x1, cfg=cfg, shape=shape)
        assert rec["per_chip"]["collective_bytes"] == 0
        assert rec["collectives"] == {}
        assert rec["n_chips"] == 1


@pytest.mark.parametrize("arch", ["granite-3-8b", "stablelm-1.6b",
                                  "deepseek-67b", "whisper-tiny"])
def test_long_500k_is_refused_for_full_attention_archs(arch, tmp_path):
    rec = D.run_cell(arch, "long_500k", False, str(tmp_path))
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]
    assert json.loads((tmp_path / f"{arch}__long_500k.json").read_text()) \
        == rec


def test_cell_applicable_equals_the_references():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_applicable as ref_applicable
    from repro.configs import get_config as ref_config
    from repro_torch.configs import ARCH_IDS, cell_applicable
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert cell_applicable(get_config(arch), SHAPES[name]) == \
                ref_applicable(ref_config(arch), REF_SHAPES[name])
            assert SHAPES[name].__dict__ == REF_SHAPES[name].__dict__


def test_tcfg_and_units_follow_the_reference():
    ref_tcfg = _reference_launch("dryrun").tcfg_for
    from repro.configs import get_config as ref_config
    from repro.configs import SHAPES as REF_SHAPES
    for arch in ("granite-3-8b", "deepseek-67b", "deepseek-moe-16b",
                 "hymba-1.5b"):
        for dp in (16, 32):
            got = D.tcfg_for(get_config(arch), SHAPES["train_4k"], dp)
            want = ref_tcfg(ref_config(arch), REF_SHAPES["train_4k"], dp)
            assert (got.microbatches, got.remat) == (want.microbatches,
                                                     want.remat)
    cfg = get_config("hymba-1.5b")
    units = D.repeat_units(cfg, SHAPES["decode_32k"])
    assert sum(units.values()) + len(cfg.global_layers) == cfg.n_layers


def test_cut_layers_cuts_segments_encoders_and_caches():
    cfg = get_config("whisper-tiny", smoke=True)
    params = S.params_specs(cfg)
    cut = D.cut_layers(params, {"segments/0": 1, "encoder": 1})
    assert len(cut["segments"][0]) == 1 and len(cut["encoder"]["layers"]) == 1
    caches = D.cut_layers(S.cache_specs(cfg, 2, 16), {"segments/0": 1})
    assert all(t.shape[0] == 1 for _, t in tree_paths(caches["segments"]))


# --------------------------------------------------------------------------
# the simulated world
# --------------------------------------------------------------------------
def test_fake_world_plan_is_pure():
    assert fake_world_plan(4)["action"] == "start"
    assert fake_world_plan(4, {"backend": "fake", "world_size": 4})[
        "action"] == "keep"
    assert fake_world_plan(8, {"backend": "fake", "world_size": 4})[
        "action"] == "replace"
    plan = fake_world_plan(8, {"backend": "nccl", "world_size": 2})
    assert plan["action"] == "refuse" and "nccl" in plan["reason"]
    with pytest.raises(ValueError):
        fake_world_plan(0)


def test_ensure_fake_world_starts_replaces_and_refuses_a_real_group():
    import torch.distributed as dist
    try:
        assert ensure_fake_world(4) == 4 and dist.get_world_size() == 4
        assert ensure_fake_world(4) == 4
        assert ensure_fake_world(8) == 8 and dist.get_world_size() == 8
        close_fake_world()
        assert not dist.is_initialized()
        dist.init_process_group("gloo", rank=0, world_size=1,
                                store=dist.HashStore())
        with pytest.raises(RuntimeError, match="real 'gloo'"):
            ensure_fake_world(4)
        close_fake_world()                  # never ends a real group
        assert dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_meshes_of_the_fake_world():
    from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                         make_production_mesh)
    try:
        host = make_host_mesh()
        assert tuple(host.shape) == (1, 1)
        assert host.mesh_dim_names == ("data", "model")
        pod = make_production_mesh()
        assert tuple(pod.shape) == (16, 16) and pod.size() == 256
        multi = make_production_mesh(multi_pod=True)
        assert tuple(multi.shape) == (2, 16, 16)
        assert multi.mesh_dim_names == ("pod", "data", "model")
        assert tuple(make_mesh((4, 2), ("data", "model")).shape) == (4, 2)
    finally:
        close_fake_world()


def test_specs_are_meta_and_the_references_dtypes():
    cfg = get_config("granite-3-8b")
    from repro_torch.training.train_step import TrainConfig
    state = S.train_state_specs(cfg, TrainConfig())
    leaves = [t for _, t in tree_paths(state)]
    assert all(t.is_meta for t in leaves)
    assert {t.dtype for _, t in tree_paths(state["params"])} == \
        {torch.float32}
    dec = S.decode_input_specs(cfg, SHAPES["decode_32k"])
    assert dec["tokens"].shape == (128, 1) and dec["tokens"].is_meta
    assert S.modality_specs(get_config("pixtral-12b"), 2)["patches"].shape \
        == (2, get_config("pixtral-12b").n_patches,
            get_config("pixtral-12b").d_model)


# --------------------------------------------------------------------------
# bit for bit on the CPU
# --------------------------------------------------------------------------
def _smoke(arch="stablelm-1.6b", dtype=None):
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch, smoke=True)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            dtype=dtype)


def test_no_hints_gives_the_bits_of_hints_left_out():
    from repro_torch.models.transformer import (NO_HINTS, ShardingHints,
                                                forward, init_caches)
    from repro_torch.training import serve_step, train_step as TS
    cfg, params = _smoke()
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    for hints in (NO_HINTS, ShardingHints()):
        a = forward(params, cfg, tok)[0]
        b = forward(params, cfg, tok, hints=hints)[0]
        assert torch.equal(a, b)
    caches_a = init_caches(cfg, 2, 32, "cpu")
    caches_b = init_caches(cfg, 2, 32, "cpu")
    pos = torch.full((2, 1), 3, dtype=torch.int32)
    la, _ = serve_step.decode_step(params, cfg, tok[:, :1], pos, caches_a)
    lb, _ = serve_step.decode_step(params, cfg, tok[:, :1], pos, caches_b,
                                   hints=NO_HINTS)
    assert torch.equal(la, lb)
    _, masters = _smoke(dtype=torch.float32)
    tcfg = TS.TrainConfig(microbatches=2)
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1),
             "mask": torch.ones(2, 24)}
    sa, ma = TS.train_step(TS.make_train_state(masters, tcfg), batch,
                           cfg=cfg, tcfg=tcfg)
    sb, mb = TS.train_step(TS.make_train_state(masters, tcfg), batch,
                           cfg=cfg, tcfg=tcfg, hints=NO_HINTS)
    for (_, x), (_, y) in zip(tree_paths(sa), tree_paths(sb)):
        assert torch.equal(x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def _xent_by_gather(logits, targets, mask=None, z_loss=1e-4):
    """The loss as it was written before: gather and argmax."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    zl = z_loss * torch.square(lse)
    per_tok = nll + zl
    if mask is None:
        mask = torch.ones(per_tok.shape, dtype=torch.float32)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / denom
    hit = (lf.argmax(dim=-1) == targets).float()
    return loss, {"nll": (nll * mask).sum() / denom,
                  "accuracy": (hit * mask).sum() / denom,
                  "z_loss": (zl * mask).sum() / denom}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vocab", [7, 256, 1000])
def test_loss_masked_sum_equals_the_gather_bit_for_bit(dtype, vocab):
    from repro_torch.training.losses import softmax_xent
    g = torch.Generator().manual_seed(vocab)
    x = (torch.randn(3, 17, vocab, generator=g) * 3).to(dtype)
    x[0, 0, :] = 1.0                          # a row of ties
    x[1, 2, 5 % vocab] = x[1, 2].max()        # a tie at the max
    t = torch.randint(0, vocab, (3, 17), generator=g)
    t[0, 0] = 3 % vocab
    m = (torch.rand(3, 17, generator=g) > 0.2).float()
    for mask in (None, m):
        a = x.clone().requires_grad_()
        b = x.clone().requires_grad_()
        la, ma = softmax_xent(a, t, mask)
        lb, mb = _xent_by_gather(b, t, mask)
        la.backward()
        lb.backward()
        assert torch.equal(la, lb)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
        assert torch.equal(a.grad, b.grad)


def test_decode_cache_write_equals_advanced_indexing_bit_for_bit():
    from repro_torch.models.attention import _write_cache, init_cache
    g = torch.Generator().manual_seed(3)
    b, t, kv, dh = 5, 12, 2, 4
    for dtype in (torch.float32, torch.bfloat16):
        cache = init_cache(b, t, kv, dh, dtype, "cpu")
        for name in ("k", "v"):
            cache[name].copy_(torch.randn(b, t, kv, dh, generator=g))
        cache["pos"].copy_(torch.randint(-1, 30, (b, t), generator=g))
        want = {k: v.clone() for k, v in cache.items()}
        k = torch.randn(b, 1, kv, dh, generator=g).to(dtype)
        v = torch.randn(b, 1, kv, dh, generator=g).to(dtype)
        pos = torch.tensor([[0], [13], [-1], [25], [11]], dtype=torch.int32)
        _write_cache(cache, k, v, pos)
        # as it was written: rows and slots by advanced indexing
        rows = torch.arange(b)
        keep = pos >= 0
        slots = torch.where(keep, pos % t, 0)[:, 0]
        kk = keep[:, 0]
        want["k"][rows, slots] = torch.where(kk[:, None, None], k[:, 0],
                                             want["k"][rows, slots])
        want["v"][rows, slots] = torch.where(kk[:, None, None], v[:, 0],
                                             want["v"][rows, slots])
        want["pos"][rows, slots] = torch.where(kk, pos[:, 0],
                                               want["pos"][rows, slots])
        for name in want:
            assert torch.equal(cache[name], want[name]), name
