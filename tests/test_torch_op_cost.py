"""The op-cost walker (``repro_torch.core.op_cost``): its counts on known
ops, free views, collectives counted once, layer multiplicity, the registry
kernels' costing, and stablelm-1.6b's SMOKE train and decode cells against
the reference's ``analyze_hlo`` on one device: the matmul flops within 1%
(they agree exactly today) and the total within 15% (0.6% and 0.4% today;
no op needs naming for a larger gap).  The fake world the DTensor cases
start is process-global, so each test that starts one ends it."""

import math
import os

import numpy as np
import pytest
import torch

from repro_torch.core import op_cost
from repro_torch.core.op_cost import OpCost, measure, with_multiplicity
from repro_torch.launch.hostsim import close_fake_world


@pytest.fixture
def fake_world():
    yield
    close_fake_world()


def _cost(fn, *args, **kw):
    return measure(fn, *args, **kw)[1]


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


# --------------------------------------------------------------------------
# known ops
# --------------------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_flops_are_2mnk(device):
    a = torch.empty(32, 48, device=device)
    b = torch.empty(48, 16, device=device)
    c = _cost(torch.mm, a, b)
    assert c.flops == c.matmul_flops == 2 * 32 * 48 * 16
    assert c.hbm_bytes == 4 * (32 * 48 + 48 * 16 + 32 * 16)
    x = torch.empty(3, 8, 5, device=device)
    y = torch.empty(3, 5, 7, device=device)
    assert _cost(torch.bmm, x, y).flops == 2 * 3 * 8 * 5 * 7
    bias = torch.empty(16, device=device)
    assert _cost(torch.addmm, bias, a, b).matmul_flops == 2 * 32 * 48 * 16


def test_elementwise_transcendental_and_reduction_counts():
    x = torch.randn(4, 10)
    c = _cost(lambda t: t + 1.0, x)
    assert (c.flops, c.transcendentals) == (40, 0)
    c = _cost(torch.exp, x)
    assert (c.flops, c.transcendentals) == (40, 40)
    c = _cost(lambda t: t.sum(dim=-1), x)
    assert c.flops == 40 and c.hbm_bytes == 4 * (40 + 4)
    c = _cost(lambda t: torch.softmax(t, -1), x)
    assert (c.flops, c.transcendentals) == (5 * 40, 40)


def test_views_and_metadata_are_free():
    x = torch.randn(6, 8)
    c = _cost(lambda t: t.view(8, 6).transpose(0, 1).unsqueeze(0)
              .expand(3, 6, 8)[:, 1:4], x)
    assert c.hbm_bytes == 0 and c.flops == 0 and c.ops > 0


def test_reads_and_updates_cost_twice_their_payload():
    table = torch.randn(100, 8)
    idx = torch.tensor([3, 7, 9])
    c = _cost(lambda t, i: t[i], table, idx)
    assert c.hbm_bytes == 2 * 3 * 8 * 4
    c = _cost(lambda t, i: torch.gather(t, 0, i[:, None].expand(3, 8)),
              table, idx)
    assert c.hbm_bytes == 2 * 3 * 8 * 4
    buf = torch.zeros(100, 8)
    upd = torch.randn(3, 8)
    c = _cost(lambda b, i, u: b.index_put_((i,), u), buf, idx, upd)
    assert c.hbm_bytes == 2 * 3 * 8 * 4
    c = _cost(lambda b, u: b[:3].copy_(u), buf, upd)
    assert c.hbm_bytes == 2 * 3 * 8 * 4


def test_peak_bytes_tracks_live_storage():
    x = torch.randn(1024)

    def step(t):
        a = t * 2          # 4 KiB live
        b = a * 3          # 8 KiB live
        del a
        c = b + 1          # 8 KiB live (a freed)
        return c.sum()     # b, c and the 4-byte sum
    c = _cost(step, x)
    assert c.peak_bytes == 2 * 4096 + 4


# --------------------------------------------------------------------------
# collectives (DTensor on a fake world)
# --------------------------------------------------------------------------
def test_a_collective_is_counted_once_by_its_result(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"))
    a = distribute_tensor(torch.empty(16, 6, device="meta"), mesh,
                          (Shard(0), Replicate()), src_data_rank=None)
    c = _cost(lambda t: t.redistribute(mesh, (Replicate(), Replicate())), a)
    assert dict(c.collective_count_by_kind) == {"all-gather": 1}
    assert dict(c.collective_bytes_by_kind) == {"all-gather": 16 * 6 * 4}
    assert c.collective_bytes == 16 * 6 * 4
    p = distribute_tensor(torch.empty(8, 4, device="meta"), mesh,
                          (Replicate(), Shard(1)), src_data_rank=None)
    q = distribute_tensor(torch.empty(4, 8, device="meta"), mesh,
                          (Replicate(), Shard(0)), src_data_rank=None)

    def mm_then_sum(x, y):
        return (x @ y).redistribute(mesh, (Replicate(), Replicate()))
    c = _cost(mm_then_sum, p, q)
    assert dict(c.collective_count_by_kind) == {"all-reduce": 1}
    # each rank multiplies its (8, 2) by (2, 8) block
    assert c.matmul_flops == 2 * 8 * 2 * 8


def test_one_rank_mesh_has_no_collectives(fake_world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    a = distribute_tensor(torch.empty(16, 6, device="meta"), mesh,
                          (Shard(0), Shard(1)), src_data_rank=None)
    c = _cost(lambda t: (t @ t.T).redistribute(
        mesh, (Replicate(), Replicate())), a)
    assert c.collective_bytes == 0 and c.matmul_flops == 2 * 16 * 6 * 16


# --------------------------------------------------------------------------
# multiplicity
# --------------------------------------------------------------------------
def _chain(depths):
    """A step of d[u] layers of each unit, and a fixed head and tail."""
    x = torch.empty(8, 32, device="meta")
    w = {"a": torch.empty(32, 32, device="meta"),
         "b": torch.empty(32, 32, device="meta")}

    def step():
        h = x * 2
        for u in ("a", "b"):
            for _ in range(depths[u]):
                h = torch.tanh(h @ w[u])
        return h.sum()
    return _cost(step)


@pytest.mark.parametrize("na,nb", [(1, 1), (5, 1), (3, 7), (24, 2)])
def test_layer_multiplicity_equals_the_whole_trace(na, nb):
    total, base = with_multiplicity(_chain, {"a": na, "b": nb})
    whole = _chain({"a": na, "b": nb})
    assert total.flops == whole.flops
    assert total.hbm_bytes == whole.hbm_bytes
    assert total.ops == whole.ops
    assert base.flops == _chain({"a": 1, "b": 1}).flops
    assert total.unknown_trip_loops == 0
    total2, _ = with_multiplicity(_chain, {"a": na, "b": nb},
                                  base_depths={"b": min(nb, 2)})
    assert total2.flops == whole.flops


def test_a_unit_that_shrinks_is_counted_once():
    def odd(depths):
        c = OpCost(flops=10.0 if depths["a"] == 1 else 4.0, hbm_bytes=1.0)
        return c
    total, _ = with_multiplicity(odd, {"a": 5})
    assert total.flops == 10.0 and total.unknown_trip_loops == 1


# --------------------------------------------------------------------------
# registry kernels
# --------------------------------------------------------------------------
def _prefill_inputs(device, b=2, s=48, h=4, kv=2, dh=16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, dh, generator=g)
    k = torch.randn(b, s, kv, dh, generator=g)
    v = torch.randn(b, s, kv, dh, generator=g)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    return tuple(t.to(device) for t in (q, k, v, pos))


@pytest.mark.parametrize("window", [0, 20])
def test_kernel_adjusted_counts_least_flops_and_reads_the_same_on_meta(
        window):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import attend

    def call(q, k, v, pos):
        return attend(q, k, v, pos, pos, n_kv_heads=2, causal=True,
                      window=window, backend="torch")
    cpu = _cost(call, *_prefill_inputs("cpu"), kernel_adjusted=True)
    meta = _cost(call, *_prefill_inputs("meta"), kernel_adjusted=True)
    q, k, v, pos = _prefill_inputs("cpu")
    least = ops.least_flops(pos, pos, 4, 16, causal=True, window=window)
    assert cpu.flops == meta.flops == least
    assert dict(cpu.kernel_calls) == {"attention.flash": 1}
    io = sum(t.numel() * t.element_size() for t in (q, k, v, pos, pos)) \
        + q.numel() * 4
    assert cpu.hbm_bytes == meta.hbm_bytes == io
    # baseline: the plain version traced op by op, the same on both
    cpu_b = _cost(call, *_prefill_inputs("cpu"))
    meta_b = _cost(call, *_prefill_inputs("meta"))
    assert cpu_b.flops == meta_b.flops > least
    assert cpu_b.hbm_bytes == meta_b.hbm_bytes


def test_decode_kernel_adjusted_flops_count_filled_slots():
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import attend
    g = torch.Generator().manual_seed(1)
    b, t, h, kv, dh = 3, 40, 4, 2, 8
    q = torch.randn(b, 1, h, dh, generator=g)
    k = torch.randn(b, t, kv, dh, generator=g)
    v = torch.randn(b, t, kv, dh, generator=g)
    kpos = torch.arange(t, dtype=torch.int32).expand(b, t).clone()
    kpos[1, 30:] = -1                           # empty slots
    qpos = torch.full((b, 1), t - 1, dtype=torch.int32)
    c = _cost(lambda *a: attend(*a, n_kv_heads=kv, causal=True,
                                backend="torch"),
              q, k, v, qpos, kpos, kernel_adjusted=True)
    assert c.flops == ops.decode_least_flops(qpos, kpos, h, dh) \
        == 4.0 * dh * h * (t + 30 + t)
    full = kpos.clone()
    full[1] = torch.arange(t)
    twins = [t_.to("meta") for t_ in (q, k, v, qpos, full)]
    cm = _cost(lambda *a: attend(*a, n_kv_heads=kv, causal=True,
                                 backend="torch"), *twins,
               kernel_adjusted=True)
    assert cm.flops == ops.decode_least_flops(qpos, full, h, dh)


def test_wkv_kernel_adjusted_flops():
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models import rwkv
    g = torch.Generator().manual_seed(2)
    d, s = 128, 64
    p = rwkv.rwkv_layer_init(g, d, 256, d // 64, torch.float32, "cpu", 2)
    x = torch.randn(2, s, d, generator=g)
    c = _cost(lambda x_: rwkv.time_mix_apply(p["tm"], x_, d // 64,
                                             wkv_backend="torch"), x,
              kernel_adjusted=True)
    assert dict(c.kernel_calls) == {"rwkv6.wkv": 1}
    base = _cost(lambda x_: rwkv.time_mix_apply(p["tm"], x_, d // 64,
                                                wkv_backend="torch"), x)
    # the rest of the layer is the same ops in both modes
    wkv_least = ops.least_flops(2, d // 64, s, 64, 64)
    assert c.flops - wkv_least == pytest.approx(
        base.flops - _wkv_plain_flops(2, d // 64, s), rel=0, abs=0)


def _wkv_plain_flops(b, h, s):
    from repro_torch.kernels.rwkv6 import ref
    args = [torch.empty(b, h, s, 64, device="meta") for _ in range(4)]
    u = torch.empty(h, 64, device="meta")
    return _cost(lambda *a: ref.wkv_chunked(*a, u, None, 64), *args).flops


# --------------------------------------------------------------------------
# against the reference's analyze_hlo
# --------------------------------------------------------------------------
def _reference_flops(shape):
    import jax
    from repro.configs import get_config
    from repro.core import hlo_cost as hc
    from repro.distributed.sharding import ShardingPolicy
    build_cell = _reference_launch("dryrun").build_cell
    make_host_mesh = _reference_launch("mesh").make_host_mesh

    class DotOnly(hc._Module):
        def instr_cost(self, ins, comp, in_fusion, symbols, vmem_scopes=()):
            c = hc.HloCost()
            if ins.opcode == "dot":
                c.flops += self._dot_flops(ins, symbols)
            assert ins.opcode != "convolution"
            return c

    cfg = get_config("stablelm-1.6b", smoke=True)
    mesh = make_host_mesh()
    policy = ShardingPolicy(mesh, cfg)
    fn, args, in_sh, out_sh, donate, _ = build_cell(cfg, shape, mesh,
                                                    policy)
    kw = {"in_shardings": in_sh}
    if out_sh is not None:
        kw["out_shardings"] = out_sh
    if donate:
        kw["donate_argnums"] = donate
    with mesh:
        text = jax.jit(fn, **kw).lower(*args).compile().as_text()
    mod = DotOnly(text)
    return hc.analyze_hlo(text).flops, mod.comp_cost(mod.entry).flops


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_stablelm_smoke_flops_against_the_reference(kind, fake_world):
    from repro.configs.base import ShapeConfig as RefShape
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.dryrun import cost_cell
    from repro_torch.launch.mesh import make_mesh
    # the reference's SMALL_TRAIN and SMALL_DECODE
    # (tests/test_dryrun_integration.py:22-23)
    name = "train_small" if kind == "train" else "decode_small"
    ref_total, ref_dots = _reference_flops(RefShape(name, 64, 4, kind))
    cfg = get_config("stablelm-1.6b", smoke=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    c = cost_cell(cfg, ShapeConfig(name, 64, 4, kind),
                  ShardingPolicy(mesh, cfg))
    total = c["total"]
    assert total.matmul_flops == pytest.approx(ref_dots, rel=0.01)
    assert total.flops == pytest.approx(ref_total, rel=0.15)
    assert total.collective_bytes == 0
    assert math.isfinite(total.hbm_bytes) and total.hbm_bytes > 0
    assert np.isfinite(total.peak_bytes) and total.peak_bytes > 0


# --------------------------------------------------------------------------
# a real step and its meta twin (the gate of chip_smoke.py's phase 12)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel_adjusted", [True, False])
@pytest.mark.parametrize("arch", ["granite-3-8b", "rwkv6-3b",
                                  "deepseek-moe-16b"])
def test_real_steps_count_the_flops_of_their_meta_twins(arch,
                                                        kernel_adjusted):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_caches, init_params
    from repro_torch.training import serve_step
    from repro_torch.training import train_step as TS
    cfg = get_config(arch, smoke=True)
    g = torch.Generator().manual_seed(5)
    params = init_params(cfg, g, "cpu")
    rows, cache_len = 2, 32
    caches = init_caches(cfg, rows, cache_len, "cpu")
    for tree in [*caches["eager"].values(), *caches["segments"]]:
        if "self" in tree:       # every slot filled, positions 0..T-1
            tree["self"]["pos"].copy_(torch.arange(cache_len))
    tok = torch.randint(0, cfg.vocab_size, (rows, 1), generator=g)
    pos = torch.full((rows, 1), cache_len, dtype=torch.int32)

    def decode(p, c, t, q):
        return serve_step.decode_step(p, cfg, t, q, c)[0]

    def fill(p, t):
        return serve_step.prefill(p, cfg, t, cache_len=cache_len)[0]

    prompt = torch.randint(0, cfg.vocab_size, (rows, 16), generator=g)
    masters = init_params(cfg, g, "cpu", dtype=torch.float32)
    tcfg = TS.TrainConfig(microbatches=2)
    batch = {"tokens": prompt, "targets": torch.roll(prompt, -1, 1),
             "mask": torch.ones(rows, 16)}
    state = TS.make_train_state(masters, tcfg)

    def train(st, b):
        return TS.train_step(st, b, cfg=cfg, tcfg=tcfg)[1]["loss"]

    for fn, args in ((decode, (params, caches, tok, pos)),
                     (fill, (params, prompt)), (train, (state, batch))):
        real = _cost(fn, *args, kernel_adjusted=kernel_adjusted)
        twin = _cost(fn, *op_cost.meta_twin(args),
                     kernel_adjusted=kernel_adjusted)
        assert real.flops == twin.flops > 0, fn.__name__
        assert real.matmul_flops == twin.matmul_flops
        assert dict(real.kernel_calls) == dict(twin.kernel_calls)


@pytest.mark.parametrize("op", ["gather", "scatter_"])
def test_a_gather_or_scatter_on_aligned_blocks_runs_locally(op, fake_world):
    """The fallback for a PyTorch whose DTensor has no rule for a gather or
    scatter along a dim the first argument does not shard: the local
    blocks, the values those of the whole op, no collective of the cache."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
    g = torch.Generator().manual_seed(7)
    cache = torch.randn(8, 16, 4, 6, generator=g)
    idx = torch.randint(0, 16, (8, 1, 4, 6), generator=g)
    src = torch.randn(8, 1, 4, 6, generator=g)
    place = (Shard(0), Shard(3))
    c = distribute_tensor(cache.clone(), mesh, place, src_data_rank=None)
    i = distribute_tensor(idx, mesh, (Shard(0), Replicate()),
                          src_data_rank=None)
    s = distribute_tensor(src, mesh, (Shard(0), Replicate()),
                          src_data_rank=None)
    mode = op_cost.OpCostMode()
    with mode:
        if op == "gather":
            out = mode._aligned(torch.ops.aten.gather.default, (c, 1, i), {})
            want = torch.gather(cache, 1, idx)
        else:
            out = mode._aligned(torch.ops.aten.scatter_.src, (c, 1, i, s), {})
            want = cache.clone().scatter_(1, idx, src)
    assert out is not None and out.placements == place
    # rank 0's block: rows 0-1, head-dim columns 0-2
    assert torch.equal(out.to_local(), want[0:2, ..., 0:3])
    assert mode.cost.collective_bytes == 0
    assert dict(mode.cost.fallbacks) == {
        str(torch.ops.aten.gather.default if op == "gather"
            else torch.ops.aten.scatter_.src) + ": local blocks": 1}
    if op == "scatter_":
        assert out is c
