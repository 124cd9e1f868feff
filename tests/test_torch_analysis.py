"""The port's static auditor (``repro_torch.core.analysis``) on the CPU.

Two directions, as the reference's ``tests/test_static_analysis.py`` and
``tests/test_cost_model.py``:

  * the *clean* direction: every cell of the live registry (38 today, the
    serving engine left out) audits with no finding, the hand-written
    cells through the launch plans their wrappers hand to the trace, on
    ``meta`` tensors, with nothing built or launched;
  * the *dirty* direction: a planted defect per check proves it fires — a
    write race, a declared accumulator, a hole, an out-of-bounds tile, a
    float64 op, a bfloat16 accumulation, an undeclared all_gather, a
    contract mismatch, a planted cell end to end — and the cost model's
    arithmetic (the floor, matmul flops, repeated ops, a plan's halo
    re-reads, collective bytes, the verdicts, the drift gate, the ranking,
    the pruning and ``tune(search="model")``).

The numbers held against the JAX package's own are in
``tests/test_torch_analysis_reference.py``.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro_torch.core import analysis, conformance, tuning
from repro_torch.core.analysis import (collectives_audit, cost, dtypes, grid,
                                       trace as T)
from repro_torch.core.portable import (Backend, Launch, PortableKernel, Tile,
                                       launch_observed, registry)
from repro_torch.core.roofline import CPU_HOST, NVIDIA_H100
from repro_torch.distributed import collectives
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.stencil7 import kernel as s7_kernel

SRC = Path(__file__).resolve().parents[1] / "src"
PAIRS = analysis.audit_pairs()
HAND_WRITTEN = ("cuda", "triton", "shard_cuda", "shard_triton")


# ---------------------------------------------------------------------------
# clean direction: the live registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,backend", PAIRS,
                         ids=[f"{k}-{b}" for k, b in PAIRS])
def test_registry_cell_audits_clean(kernel, backend):
    """Every cell, every constraint-valid tunable point: no finding, no
    skip; a hand-written cell runs grid, traffic and roofline from its
    launch plans."""
    res = analysis.audit_cell(kernel, backend)
    assert res.errors == [], [f.to_json() for f in res.errors]
    assert res.skips == [], [s.to_json() for s in res.skips]
    assert set(res.passes_run) == set(analysis.PASSES) - {"drift"}
    if backend in HAND_WRITTEN:
        assert res.cost["launches"], "a hand-written cell planned nothing"
        assert res.cost["traffic"]["launches"] == len(res.cost["launches"])


def test_audit_matrix_derives_from_live_registry():
    """38 cells: conformance_pairs() without the untraceable serving engine;
    registering a backend adds its cell with no edit here."""
    assert len(PAIRS) == 38
    assert registry.get("serving.engine").traceable is False
    assert any(k == "serving.engine"
               for k, _ in conformance.conformance_pairs())
    assert not any(k == "serving.engine" for k, _ in PAIRS)
    k = registry.get("stencil7")
    k.add_backend("tmp_audit_backend", k.backends["torch"].fn)
    try:
        assert ("stencil7", "tmp_audit_backend") in analysis.audit_pairs()
        assert analysis.audit_cell("stencil7", "tmp_audit_backend",
                                   smoke=True).errors == []
    finally:
        del k.backends["tmp_audit_backend"]


def test_cli_smoke_writes_a_clean_report(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.analysis", "--smoke",
         "--out", str(out), "--tuning-cache", str(tmp_path / "none.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["schema"] == analysis.SCHEMA == "repro_torch.analysis/v1"
    assert sorted(map(tuple, report["matrix"])) == \
        sorted(analysis.audit_pairs(smoke=True))
    assert report["summary"]["findings"] == report["summary"]["skips"] == 0


def test_report_schema_and_waiver_visibility(tmp_path):
    report = analysis.audit_registry(smoke=True,
                                     tuning_cache=tmp_path / "none.json")
    assert report["schema"] == "repro_torch.analysis/v1"
    assert report["passes"] == list(analysis.PASSES)
    assert report["summary"]["cells"] == report["summary"]["audited"] == 14
    assert report["summary"]["findings"] == 0
    assert {w["code"] for w in report["waived"]} <= {"scalar-cache-key"}
    stencil = report["cost"]["stencil7[cuda]"]
    assert stencil["launches"] == [{
        "wrapper": "stencil7", "symbol": "stencil7_kernel",
        "grid": [4, 8, 1], "block": [32, 8, 1], "smem": 0}]


def test_meta_tensors_never_launch_outside_the_auditor():
    """A wrapper given meta tensors hands its plan to the auditor; with no
    auditor listening it raises, and it never counts a launch."""
    u = torch.empty((8, 16, 32), device="meta")
    before = s7_kernel.laplacian.launches
    with pytest.raises(ValueError, match="meta tensors cannot launch a"):
        s7_kernel.laplacian(u)
    tr = T.trace(s7_kernel.laplacian, (u,), {})
    assert [l.symbol for _, l in tr.launches] == ["stencil7_kernel"]
    assert s7_kernel.laplacian.launches == before
    assert launch_observed("x", torch.device("cpu"), None) is False


def _package_tree(root: Path, prefix: str = ""):
    """Every package under ``root`` with an ``__init__.py``, found as
    ``pkgutil.iter_modules`` finds them (nothing is imported)."""
    out = []
    for m in pkgutil.iter_modules([str(root)]):
        if m.ispkg:
            out.append(prefix + m.name)
            out += _package_tree(root / m.name, prefix + m.name + ".")
    return sorted(out)


def test_package_tree_equals_the_reference():
    """Every package of the JAX package has its port (benchmarks, a later
    round's, lives outside both)."""
    ours = _package_tree(Path(repro_torch.__file__).parent)
    theirs = _package_tree(SRC / "repro")
    assert "benchmarks" not in theirs
    assert ours == theirs
    assert {"checkpoint", "data", "models", "optim", "training",
            "core.analysis"} <= set(ours)


# ---------------------------------------------------------------------------
# planted fixtures: the grid pass
# ---------------------------------------------------------------------------
def _copy_plan(out_index, grid_=(4,), n=128, tile=32):
    return Launch("planted_kernel", tuple(grid_) + (1,) * (3 - len(grid_)),
                  (128, 1, 1),
                  outputs=(Tile("out", (n,), (tile,), out_index),),
                  inputs=(Tile("x", (n,), (tile,), lambda x, y, z: (x,)),))


def _grid_codes(launch, accum=()):
    findings = grid.audit_launch("planted", "cuda", launch, accum)
    return {f.code for f in findings}, findings


@pytest.mark.parametrize("name,index,grid_,n,accum,codes,detail", [
    # every program writes the one tile: a race unless declared
    ("write race", lambda x, y, z: (0,), (4,), 32, (), {"write-race"},
     ("revisited", [[0]])),
    ("declared accumulator", lambda x, y, z: (0,), (4,), 32, (0,), set(),
     None),
    # 4 tiles, 2 programs: tiles 2 and 3 never written
    ("hole", lambda x, y, z: (x,), (2,), 128, (), {"coverage-hole"},
     ("holes", [[2], [3]])),
    # tile x + 1 of a 4-tile space at program 3: out of bounds (and a hole)
    ("out of bounds", lambda x, y, z: (x + 1,), (4,), 128, (),
     {"out-of-bounds-tile", "coverage-hole"}, ("oob", [[4]])),
])
def test_planted_grid_defects_fire(name, index, grid_, n, accum, codes,
                                   detail):
    got, findings = _grid_codes(_copy_plan(index, grid_, n), accum)
    assert got == codes
    if detail is not None:
        key, want = detail
        assert next(f for f in findings
                    if key in f.detail).detail[key] == want


def _racy(x):
    """A planted hand-written wrapper: every program writes tile 0."""
    out = torch.empty(32, device=x.device)
    launch_observed("planted.racy", x.device,
                    lambda: [_copy_plan(lambda p, y, z: (0,), (4,), 32)])
    return out


def test_planted_cell_end_to_end():
    """A registered kernel whose plan races comes back from audit_cell with
    exactly the planted finding; declaring the accumulator clears it."""
    name = "planted.racy"
    k = PortableKernel(name=name, doc="planted auditor fixture")
    k.add_backend("torch", lambda x: x[:32].clone())
    k.add_backend("cuda", _racy)
    registry._kernels[name] = k
    conformance.CASES[name] = lambda: ((torch.ones(128).numpy(),), {})
    try:
        res = analysis.audit_cell(name, "cuda", smoke=True)
        assert {f.code for f in res.errors} == {"write-race"}
        k.declare_grid_contract("cuda", accumulator_outputs=(0,))
        assert analysis.audit_cell(name, "cuda", smoke=True).errors == []
    finally:
        del registry._kernels[name]
        del conformance.CASES[name]


def test_every_plan_covers_its_outputs_at_other_shapes():
    """The hand-written plans at shapes the conformance cases do not take:
    several stencil chunks, a ragged stream tail, a decode cache of three
    splits (the combine's block the last of the pair), one WKV token with a
    state, a Hartree-Fock slab, and bfloat16 flash (the wgmma grid)."""
    g = torch.Generator().manual_seed(0)
    cases = [
        (s7_kernel.laplacian, (torch.empty(70, 20, 40),),
         {"block_x": 32, "block_y": 4, "zchunk": 16}),
        (registry.get("babelstream.triad").backend("triton").fn,
         (torch.empty(5000), torch.empty(5000)), {"block": 1024}),
        (registry.get("babelstream.dot").backend("triton").fn,
         (torch.empty(9000), torch.empty(9000)), {"block": 2048}),
        (registry.get("attention.decode").backend("cuda").fn,
         (torch.empty(3, 1, 8, 64), torch.empty(3, 300, 2, 64),
          torch.empty(3, 300, 2, 64), torch.zeros(3, 1, dtype=torch.int32),
          torch.zeros(3, 300, dtype=torch.int32)), {"bkv": 64}),
        (wkv_kernel.wkv, tuple(torch.empty(2, 3, 1, 64) for _ in range(4))
         + (torch.empty(3, 64), torch.empty(2, 3, 64, 64)), {}),
        (registry.get("rwkv6.wkv").backend("cuda").fn,
         tuple(torch.empty(1, 2, 100, 32) for _ in range(4))
         + (torch.empty(2, 32),), {"chunk": 16}),
        (registry.get("attention.flash").backend("cuda").fn,
         tuple(torch.randn(2, 4, 200, 64, generator=g).to(torch.bfloat16)
               for _ in range(3)), {"bq": 64, "bk": 128}),
    ]
    from repro_torch.kernels.hartree_fock import kernel as hf
    from repro_torch.kernels.hartree_fock import ref as hf_ref
    cases.append((hf.twoel_slab, (torch.empty(6, 4), torch.empty(6, 6),
                                  hf_ref.sto_basis(3, device="meta"), 2, 3),
                  {}))
    for fn, args, kwargs in cases:
        tr = T.trace(fn, args, kwargs)
        assert tr.launches, fn
        findings, n = grid.run("planted", "cuda", tr, ())
        assert n == len(tr.launches) and findings == [], \
            [f.message for f in findings]


@pytest.mark.parametrize("decomp,grid_,block", [
    ("slab", (4, 1), (6, 16, 32)), ("pencil", (2, 2), (10, 10, 32))])
def test_composite_plan_is_its_shards_plans(decomp, grid_, block):
    """stencil7's shard_cuda: one wrapper plan a shard, on the shard's
    halo-padded block, in shard order."""
    fn = registry.get("stencil7").backend("shard_cuda").fn
    tr = T.trace(fn, (torch.empty(16, 16, 32),),
                 {"decomp": decomp, "shard_grid": grid_})
    one = s7_kernel.launch_plan(torch.empty(block, device="meta"))
    assert [(l.symbol, l.grid, l.block) for _, l in tr.launches] == \
        [(l.symbol, l.grid, l.block) for l in one] * 4


# ---------------------------------------------------------------------------
# planted fixtures: dtypes and collectives
# ---------------------------------------------------------------------------
def test_planted_f64_promotion_fires():
    """A factory op in float64 (no wide input) widens the working dtype."""
    def bad(x):
        return torch.arange(8, dtype=torch.float64, device=x.device) * x

    def good(x):
        return torch.arange(8, dtype=x.dtype, device=x.device) * x

    x = torch.ones(8)
    found = dtypes.run_f64_lint("planted", "torch", T.trace(bad, (x,), {}))
    assert [(f.code, f.detail["op"]) for f in found] == \
        [("f64-promotion", "arange")]
    assert dtypes.run_f64_lint("planted", "torch",
                               T.trace(good, (x,), {})) == []


def test_planted_accum_downgrade_fires():
    a = torch.ones(8, 8, dtype=torch.bfloat16)
    found = dtypes.run_accum_check(
        "planted", "torch", T.trace(torch.mm, (a, a), {}), "float32")
    assert [(f.code, f.detail["dtype"]) for f in found] == \
        [("accum-downgrade", "bfloat16")]
    assert dtypes.run_accum_check(
        "planted", "torch",
        T.trace(lambda x, y: torch.mm(x.float(), y.float()), (a, a), {}),
        "float32") == []
    # a launch plan that accumulates in bfloat16
    narrow = Launch("planted_kernel", (1, 1, 1), (32, 1, 1), outputs=(),
                    accum_dtype="bfloat16")

    def planned(x):
        launch_observed("planted", x.device, lambda: [narrow])
        return x
    found = dtypes.run_accum_check(
        "planted", "cuda", T.trace(planned, (a,), {}), "float32")
    assert [f.detail["op"] for f in found] == ["planted_kernel"]


def _sharded(fn, n=4):
    def run(x):
        return fn(list(x.chunk(n)))[0]
    return run


def _gathered(xs):
    """A planted decomposition that re-materializes the whole array on
    every shard, counting itself as a collective does."""
    out = [torch.cat(xs) for _ in xs]
    collectives._count("all_gather", moved=xs, received=out)
    return out


def test_planted_undeclared_all_gather_fires():
    tr = T.trace(_sharded(_gathered), (torch.ones(8),), {})
    (_, expected), = collectives_audit.normalize_contract(None, ())
    found = collectives_audit.check_counts("planted", "torch_shard", tr,
                                           expected, declared=False)
    assert {f.code for f in found} == {"undeclared-all-gather"}


def test_comm_contract_mismatch_fires():
    tr = T.trace(_sharded(collectives.psum), (torch.ones(8),), {})
    found = collectives_audit.check_counts(
        "planted", "torch_shard", tr, {"ppermute": 0, "psum": 0},
        declared=True)
    assert {f.code for f in found} == {"comm-contract-mismatch"}
    assert collectives_audit.check_counts(
        "planted", "torch_shard", tr, {"ppermute": 0, "psum": 1},
        declared=True) == []


@pytest.mark.parametrize("overlap", [False, True])
def test_overlap_witness_follows_the_halos(overlap):
    """The overlapped stencil computes each shard's interior before its
    halos land; the plain exchange fills them first."""
    fn = registry.get("stencil7").backend("torch_shard").fn
    tr = T.trace(fn, (torch.empty(16, 8, 8),),
                 {"decomp": "slab", "shard_grid": (4, 1), "overlap": overlap})
    assert T.count_collectives(tr)["ppermute"] == 2
    assert T.independent_compute_exists(tr, (4, 8, 8)) is overlap


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------
def test_census_elementwise_floor():
    t = cost.census(T.trace(lambda a: a + 1.0, (torch.empty(128),), {}))
    assert t.flops == 128
    assert t.hbm_min_bytes == t.hbm_bytes == 2 * 128 * 4
    assert t.inflation == 1.0


def test_census_matmul_flops():
    t = cost.census(T.trace(torch.mm, (torch.empty(64, 32),
                                       torch.empty(32, 16)), {}))
    assert t.flops == 2 * 64 * 16 * 32


def test_census_repeated_ops_multiply():
    """Ten adds on one carry: ten times the flops, the floor still one
    array in and one out (the reference's scan multiplicity)."""
    def ten_adds(a):
        for _ in range(10):
            a = a + 1.0
        return a
    t = cost.census(T.trace(ten_adds, (torch.empty(256),), {}))
    assert t.flops == 10 * 256
    assert t.hbm_min_bytes == 2 * 256 * 4
    assert t.eager_bytes == 10 * 2 * 256 * 4


def test_census_counts_halo_rereads_from_a_plan():
    """The stencil's plan re-reads the planes below and above each chunk:
    at 64 planes in chunks of 16, the three inner chunk borders' two planes
    each, of (16, 32) cells."""
    u = torch.empty(64, 16, 32)
    t = cost.census(T.trace(s7_kernel.laplacian, (u,),
                            {"block_x": 32, "block_y": 16, "zchunk": 16}))
    assert t.launches == 1 and t.grid_steps == 4
    assert t.reread_bytes == 0      # each plane tile is read once
    assert t.hbm_read_bytes == u.numel() * 4 + 6 * 16 * 32 * 4
    assert t.hbm_write_bytes == u.numel() * 4
    assert t.inflation == pytest.approx(1 + 6 / 128)


def test_census_collective_bytes():
    """The sharded dot's psum moves each shard's float32 partial."""
    fn = registry.get("babelstream.dot").backend("torch_shard").fn
    t = cost.census(T.trace(fn, (torch.empty(64), torch.empty(64)),
                            {"num_shards": 4}))
    assert t.collective_count == 1
    assert t.collective_bytes == 4 * 4.0


@pytest.mark.parametrize("traffic,chip,bound", [
    (cost.Traffic(hbm_read_bytes=1e6, hbm_write_bytes=1e6), CPU_HOST,
     "memory"),
    (cost.Traffic(hbm_read_bytes=8.0, hbm_write_bytes=8.0), CPU_HOST,
     "compute"),
    (cost.Traffic(hbm_read_bytes=8.0, hbm_write_bytes=8.0,
                  collective_bytes=1e9, devices=4), CPU_HOST, "collective"),
    # one device: the collective is a copy, its bytes already HBM traffic
    (cost.Traffic(hbm_read_bytes=8.0, hbm_write_bytes=8.0,
                  collective_bytes=1e9), CPU_HOST, "compute"),
])
def test_verdicts(traffic, chip, bound):
    traffic.add_flops(100.0 if bound == "memory" else 1e9, "float32")
    assert cost.verdict(traffic, chip).bound == bound


def test_verdict_uses_the_dtype_peaks():
    """The H100's float32 work runs on the FMA pipes (67 TFLOP/s), not at
    the bfloat16 tensor-core rate of ChipSpec.peak_flops."""
    t = cost.Traffic(hbm_read_bytes=1.0)
    t.add_flops(67e12, "float32")
    t.add_flops(989e12, "bfloat16")
    assert cost.verdict(t, NVIDIA_H100).compute_s == pytest.approx(2.0)


def _drift_cache(seconds, tmp_path):
    entries = {}
    for (k, b, sig), sec in seconds.items():
        key = tuning.TuningKey(kernel=k, backend=b, shape=sig,
                               dtype="float32", platform="cpu", code="x")
        entries[key.as_str()] = {"params": {}, "seconds": sec,
                                 "search": "exhaustive"}
    path = tmp_path / "drift.json"
    path.write_text(json.dumps({"schema": tuning.CACHE_SCHEMA,
                                "entries": entries}))
    return path


_PROBES = [(f"babelstream.{op}", "torch",
            tuning.shape_signature(*[torch.ones(1 << 14)] * n))
           for op, n in (("copy", 1), ("mul", 1), ("add", 2), ("triad", 2))]


def test_planted_drift_beyond_band_fires(tmp_path):
    """Three calibrated joins and one 1000x outlier: the outlier alone
    fires, and the calibration is the median ratio."""
    preds = {p: cost.predict_seconds(cost.Measurement(
        kernel=p[0], backend=p[1], shape=p[2], params={}, seconds=1.0,
        source="cache"), CPU_HOST) for p in _PROBES}
    assert all(v and v > 0 for v in preds.values())
    seconds = {p: 100.0 * v for p, v in preds.items()}
    seconds[_PROBES[-1]] *= 1000.0
    findings, summary = cost.drift_gate(
        cache_path=_drift_cache(seconds, tmp_path), band=8.0, chip=CPU_HOST)
    assert summary["joined"] == 4
    assert summary["calibration"] == pytest.approx(100.0, rel=0.01)
    assert [(f.kernel, f.code, f.waived) for f in findings] == \
        [("babelstream.triad", "perf-drift", False)]
    assert findings[0].detail["relative"] > 8.0


def test_drift_gate_is_silent_under_min_joins(tmp_path):
    findings, summary = cost.drift_gate(
        cache_path=_drift_cache({_PROBES[0]: 1.0}, tmp_path), band=8.0)
    assert findings == []
    assert summary["joined"] < cost.MIN_DRIFT_JOINS
    assert summary["calibration"] is None


def test_parse_shape_signature_roundtrip():
    sig = tuning.shape_signature(torch.ones(3, 5), torch.ones(
        2, dtype=torch.int32), 0.5, "x", n=2, k=torch.ones(4))
    args, kwargs = cost.parse_shape_signature(sig)
    assert [tuple(a.shape) for a in args[:2]] == [(3, 5), (2,)]
    assert args[1].dtype == torch.int32 and args[0].is_meta
    assert args[2:] == (0.5, "x") and kwargs["n"] == 2
    assert cost.parse_shape_signature("float128[2]") is None


def test_rank_points_orders_by_prediction():
    k = registry.get("stencil7")
    args, kwargs = conformance.CASES["stencil7"]()
    points = k.tunable_space("cuda").valid_points(*args, **kwargs)
    ranked = cost.rank_points(k, "cuda", points, args, kwargs)
    assert len(ranked) == len(points) == 27
    preds = [r["predicted_s"] for r in ranked]
    assert preds == sorted(preds) and all(p > 0 for p in preds)
    assert all("error" not in r and r["bound"] == "memory" for r in ranked)


def test_prune_dominated():
    ranked = [
        {"params": {"a": 1}, "predicted_s": 1.0, "hbm_bytes": 100.0,
         "parallelism": 4.0, "order": 0},
        # worse on both axes than the first: pruned
        {"params": {"a": 2}, "predicted_s": 2.0, "hbm_bytes": 200.0,
         "parallelism": 2.0, "order": 1},
        # worse traffic, more parallelism: kept
        {"params": {"a": 3}, "predicted_s": 3.0, "hbm_bytes": 300.0,
         "parallelism": 8.0, "order": 2},
        # did not trace: dropped
        {"params": {"a": 4}, "predicted_s": float("inf"), "error": "boom",
         "hbm_bytes": float("inf"), "parallelism": 0.0, "order": 3},
    ]
    assert [r["params"]["a"] for r in cost.prune_dominated(ranked)] == [1, 3]


def test_model_search_provenance_and_top_k(tmp_path, monkeypatch):
    """tune(search='model') on stencil7's real plans, with a fake clock
    and a stand-in CUDA call (the CPU has no card): it times at most the
    top k, caches its pick as 'model', serves it to a model request and
    never to an exhaustive one."""
    monkeypatch.setattr(tuning, "_cuda_device",
                        lambda a, k: torch.device("cuda", 0))
    monkeypatch.setattr(tuning, "platform", lambda *a: "NVIDIA H100")
    k = registry.get("stencil7")
    real = k.backends["cuda"]
    k.backends["cuda"] = Backend("cuda", real.fn)        # no probe
    timed = []

    def fake_time(*a, backend, graph=False, **kw):
        timed.append(kw)
        return 1e-3 / kw["zchunk"] + 1e-6 * kw["block_y"]
    monkeypatch.setattr(k, "time_backend", fake_time)
    try:
        args, kwargs = conformance.CASES["stencil7"]()
        args = T.as_meta(args)
        cache = tuning.TuningCache(tmp_path / "model.json")
        r = tuning.tune(k, *args, backend="cuda", cache=cache,
                        search="model", budget=3, **kwargs)
        assert r.search == "model" and not r.cached and r.skipped is None
        assert 1 <= len(r.swept) <= 3
        assert r.params in k.tunable_space("cuda").valid_points(*args)
        key = tuning.make_key(k, *args, backend="cuda", **kwargs)
        assert cache.get(key)["search"] == "model"
        again = tuning.tune(k, *args, backend="cuda", cache=cache,
                            search="model", **kwargs)
        assert again.cached
        full = tuning.tune(k, *args, backend="cuda", cache=cache,
                           search="exhaustive", **kwargs)
        assert not full.cached and len(full.swept) == 27
        assert cache.get(key)["search"] == "exhaustive"
    finally:
        k.backends["cuda"] = real
