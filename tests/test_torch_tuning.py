"""The port's tuning (``repro_torch.core.tuning``) held against the JAX
package's on the CPU, plus the attention dispatch's tuned injection.

The same numpy inputs give the same shape signatures in both packages; the
same synthetic kernel, registered in a private ``PortableKernel`` of each
package with ``time_backend`` replaced by one deterministic seconds-per-point
table, gives the same best point and the same sweep order, exhaustive and
coordinate, with a budget and with ``max_points``.  The rest are the
counterparts of ``tests/test_tuning.py`` that mean something here: the
cache, the key (the device from the call's own tensors), the code hash over
the CUDA sources, and the hand-written backends skipped on the CPU with
their probe's reason.
"""

import importlib
import json
import shutil
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import portable as jax_portable
from repro.core import tuning as jax_tuning
import repro_torch.kernels  # noqa: F401  (registers the kernels)
from repro_torch import _build
from repro_torch.core import conformance, portable, tuning
from repro_torch.core.portable import PortableKernel, registry
from repro_torch.models import attention as A


def _toy_kernel(calls):
    """A kernel whose 'fast' backend counts invocations (to prove cache hits
    skip re-timing) and exposes a 3-point tunable grid."""
    k = PortableKernel(name="toy")
    k.add_backend("torch", lambda x: x * 2.0)

    def fast(x, *, block=8):
        calls["n"] += 1
        return x + x

    k.add_backend("fast", fast)
    k.declare_tunables("fast", block=(4, 8, 16))
    return k


# ---- signatures --------------------------------------------------------
def test_shape_signatures_equal_the_reference():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-1, 9, (2, 7)).astype(np.int32)
    bf = rng.standard_normal((4,)).astype(np.float32)
    ours = tuning.shape_signature(
        torch.from_numpy(f32), torch.from_numpy(bf).to(torch.bfloat16),
        torch.from_numpy(i32), 3, 0.5, "x", causal=True, window=0,
        k_pos=torch.from_numpy(i32))
    theirs = jax_tuning.shape_signature(
        jnp.asarray(f32), jnp.asarray(bf, jnp.bfloat16), jnp.asarray(i32),
        3, 0.5, "x", causal=True, window=0, k_pos=jnp.asarray(i32))
    assert ours == theirs
    assert ours.startswith("float32[3,5];bfloat16[4];int32[2,7];3;0.5;'x'")
    # numpy arrays themselves key alike in both packages
    assert tuning.shape_signature(f32, i32, n=2) == \
        jax_tuning.shape_signature(f32, i32, n=2)


# ---- parity of the search ----------------------------------------------
def _cost(block, rows):
    # a bowl with its floor at (16, 4), not separable, no ties at the floor
    return 1.0 + abs(block - 16) / 8 + abs(rows - 4) * (1 + block / 64)


def _synthetic(pkg_portable, backend_kw, blocks, rows, *, constraint=None):
    k = pkg_portable.PortableKernel(name="synthetic")
    oracle = "xla" if pkg_portable is jax_portable else "torch"
    k.add_backend(oracle, lambda x: x)
    k.add_backend("fast", lambda x, *, block=4, rows=1: x + x, **backend_kw)
    k.declare_tunables("fast", block=blocks, rows=rows,
                       constraint=constraint)
    k.time_backend = lambda *a, backend, iters=3, warmup=1, **kw: _cost(
        kw["block"], kw["rows"])
    return k


@pytest.mark.parametrize("grid,opts", [
    (((4, 8, 16, 32), (1, 2, 4, 8)), {"search": "exhaustive"}),
    (((4, 8, 16, 32), (1, 2, 4, 8)), {"search": "coordinate"}),
    (((4, 8, 16, 32), (1, 2, 4, 8)), {"search": "coordinate", "budget": 5}),
    (((4, 8, 16, 32, 64), (1, 2, 4, 8, 16)), {}),           # auto: coord
    (((4, 8, 16, 32, 64), (1, 2, 4, 8, 16)), {"max_points": 7}),
    (((4, 8, 16), (1, 2, 4)), {"max_points": 4}),            # exhaustive
    (((4, 8, 16, 32), (1, 2, 4, 8)), {"constrained": True}),
], ids=["exhaustive", "coordinate", "budget", "auto", "max_points-coord",
        "max_points-exhaustive", "constraint"])
def test_tune_picks_and_sweeps_as_the_reference(grid, opts, tmp_path):
    opts = dict(opts)
    constraint = None
    if opts.pop("constrained", False):
        constraint = (lambda p, x, **kw: p["block"] * p["rows"]
                      <= x.shape[0])
    blocks, rows = grid
    ours = tuning.tune(_synthetic(portable, {}, blocks, rows,
                                  constraint=constraint),
                       torch.ones(64), backend="fast",
                       cache=tuning.TuningCache(tmp_path / "a.json"), **opts)
    theirs = jax_tuning.tune(_synthetic(jax_portable, {}, blocks, rows,
                                        constraint=constraint),
                             jnp.ones(64), backend="fast",
                             cache=jax_tuning.TuningCache(tmp_path / "b.json"),
                             **opts)
    assert ours.skipped is None and theirs.skipped is None
    assert ours.params == theirs.params
    assert ours.seconds == theirs.seconds
    assert ours.search == theirs.search
    assert ours.swept == theirs.swept
    assert ours.timer == "host"
    persisted = "max_points" not in opts or len(ours.swept) == len(
        list(_synthetic(portable, {}, blocks, rows).tunable_space("fast")
             .valid_points(torch.ones(64))))
    assert len(tuning.TuningCache(tmp_path / "a.json")) == \
        len(jax_tuning.TuningCache(tmp_path / "b.json")) == int(persisted)


# ---- the reference's tests that mean something here --------------------
def test_tune_is_deterministic_and_cache_hit_skips_retiming(tmp_path):
    calls = {"n": 0}
    k = _toy_kernel(calls)
    cache = tuning.TuningCache(path=tmp_path / "tuning.json")
    x = torch.ones(16)

    r1 = tuning.tune(k, x, backend="fast", cache=cache, iters=2, warmup=1)
    assert not r1.cached and r1.params["block"] in (4, 8, 16)
    assert len(r1.swept) == 3
    n_after_first = calls["n"]
    assert n_after_first > 0

    r2 = tuning.tune(k, x, backend="fast", cache=cache, iters=2, warmup=1)
    assert r2.cached and r2.params == r1.params
    assert r2.seconds == r1.seconds and r2.timer == r1.timer == "host"
    assert calls["n"] == n_after_first

    r3 = tuning.tune(k, x, backend="fast",
                     cache=tuning.TuningCache(path=tmp_path / "tuning.json"),
                     iters=2, warmup=1)
    assert r3.cached and r3.params == r1.params

    r4 = tuning.tune(k, torch.ones(32), backend="fast", cache=cache, iters=2,
                     warmup=1)
    assert not r4.cached


def test_truncated_sweep_never_poisons_the_cache(tmp_path):
    k = _toy_kernel({"n": 0})
    cache = tuning.TuningCache(path=tmp_path / "tuning.json")
    x = torch.ones(16)
    r1 = tuning.tune(k, x, backend="fast", cache=cache, iters=1, warmup=0,
                     max_points=2)
    assert not r1.cached and len(r1.swept) == 2
    assert len(cache) == 0
    r2 = tuning.tune(k, x, backend="fast", cache=cache, iters=1, warmup=0)
    assert not r2.cached and len(r2.swept) == 3
    assert len(cache) == 1


def test_cache_put_merges_on_disk_entries(tmp_path):
    k = _toy_kernel({"n": 0})
    path = tmp_path / "tuning.json"
    a, b = tuning.TuningCache(path=path), tuning.TuningCache(path=path)
    key_a = tuning.make_key(k, torch.ones(16), backend="fast")
    key_b = tuning.make_key(k, torch.ones(32), backend="fast")
    a.get(key_a)
    b.get(key_b)
    a.put(key_a, {"block": 4}, 1e-6)
    b.put(key_b, {"block": 8}, 2e-6, timer="graph")
    fresh = tuning.TuningCache(path=path)
    assert fresh.get(key_a) == {"params": {"block": 4}, "seconds": 1e-6,
                                "search": "exhaustive"}
    assert fresh.get(key_b) == {"params": {"block": 8}, "seconds": 2e-6,
                                "search": "exhaustive", "timer": "graph"}


def test_tuning_key_separates_shape_dtype_backend_and_devices(monkeypatch):
    k = _toy_kernel({"n": 0})
    keys = {tuning.make_key(k, x, backend=b).as_str()
            for x, b in ((torch.ones(16), "fast"), (torch.ones(32), "fast"),
                         (torch.ones(16, dtype=torch.bfloat16), "fast"),
                         (torch.ones(16), "torch"))}
    assert len(keys) == 4
    k1 = tuning.make_key(k, torch.ones(16), backend="fast")
    assert (k1.platform, k1.devices, k1.dtype) == ("cpu", 1, "float32")
    monkeypatch.setattr(tuning, "device_count", lambda *a: 8)
    k2 = tuning.make_key(k, torch.ones(16), backend="fast")
    assert k2.devices == 8 and k2.as_str() != k1.as_str()


def test_a_cpu_call_on_a_gpu_host_keys_as_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    key = tuning.make_key(_toy_kernel({"n": 0}), torch.ones(16),
                          backend="fast")
    assert (key.platform, key.devices) == ("cpu", 1)


def test_constraint_filters_sweep_points():
    k = PortableKernel(name="constrained")
    k.add_backend("torch", lambda x: x)
    k.add_backend("fast", lambda x, *, block=4: x + x)
    k.declare_tunables(
        "fast", block=(4, 8, 16),
        constraint=lambda p, x, **kw: x.shape[0] % p["block"] == 0)
    r = tuning.tune(k, torch.ones(8), backend="fast", iters=1, warmup=0)
    assert [p["block"] for p, _ in r.swept] == [4, 8]


def test_call_tuned_uses_cached_params(tmp_path):
    seen = []
    k = PortableKernel(name="tunedcall")
    k.add_backend("torch", lambda x: x)

    def fast(x, *, block=8):
        seen.append(block)
        return x + x

    k.add_backend("fast", fast)
    k.declare_tunables("fast", block=(4, 8, 16))
    cache = tuning.TuningCache(path=tmp_path / "t.json")
    x = torch.ones(16)
    k(x, backend="fast", tuned=True, tuning_cache=cache)
    assert seen[-1] == 8                       # miss: the declared default
    cache.put(tuning.make_key(k, x, backend="fast"), {"block": 16}, 1e-6)
    k(x, backend="fast", tuned=True, tuning_cache=cache)
    assert seen[-1] == 16
    k(x, backend="fast", tuned=True, tuning_cache=cache, block=4)
    assert seen[-1] == 4                       # explicit kwargs win


def test_tuple_valued_params_round_trip_the_json_cache(tmp_path):
    seen = []
    k = PortableKernel(name="tuplegrid")
    k.add_backend("torch", lambda x: x)

    def fast(x, *, grid=(2, 1)):
        seen.append(tuple(grid))
        return x + x

    k.add_backend("fast", fast)
    k.declare_tunables(
        "fast", grid=((2, 1), (4, 1), (2, 2), (3, 2)),
        constraint=lambda p, x, **kw: x.shape[0] % p["grid"][0] == 0)
    cache = tuning.TuningCache(path=tmp_path / "t.json")
    x = torch.ones(8)
    r1 = tuning.tune(k, x, backend="fast", cache=cache, iters=1, warmup=0)
    assert [p["grid"] for p, _ in r1.swept] == [(2, 1), (4, 1), (2, 2)]
    fresh = tuning.TuningCache(path=tmp_path / "t.json")
    r2 = tuning.tune(k, x, backend="fast", cache=fresh, iters=1, warmup=0)
    assert r2.cached and r2.params == r1.params
    assert isinstance(r2.params["grid"], tuple)
    k(x, backend="fast", tuned=True, tuning_cache=fresh)
    assert seen[-1] == r1.params["grid"]
    assert tuning.params_from_cache({"grid": [2, 4], "by": 8}) == \
        jax_tuning.params_from_cache({"grid": [2, 4], "by": 8})


def test_coordinate_results_never_serve_exhaustive_requests(tmp_path):
    cache = tuning.TuningCache(path=tmp_path / "t.json")
    x = torch.ones(64)
    k = _synthetic(portable, {}, (4, 8, 16, 32, 64), (1, 2, 4, 8, 16))
    timed = []
    k.time_backend = lambda *a, backend, iters=3, warmup=1, **kw: (
        timed.append(kw), _cost(kw["block"], kw["rows"]))[1]
    r1 = tuning.tune(k, x, backend="fast", cache=cache)
    assert r1.search == "coordinate" and not r1.cached
    r2 = tuning.tune(k, x, backend="fast", cache=cache)
    assert r2.cached and r2.search == "coordinate"
    n = len(timed)
    r3 = tuning.tune(k, x, backend="fast", cache=cache, search="exhaustive")
    assert not r3.cached and r3.search == "exhaustive"
    assert len(timed) == n + 25
    r4 = tuning.tune(k, x, backend="fast", cache=cache, search="exhaustive")
    assert r4.cached and r4.search == "exhaustive"


def test_reference_and_foreign_cache_files_are_discarded(tmp_path,
                                                        monkeypatch):
    """A file the reference wrote (``repro.tuning/v2``: TPU or CPU params)
    is never served here, and the next put writes the port's schema."""
    k = _toy_kernel({"n": 0})
    x = torch.ones(16)
    key = tuning.make_key(k, x, backend="fast")
    path = tmp_path / "tuning.json"
    jax_cache = jax_tuning.TuningCache(path=path)
    jax_cache.put(jax_tuning.make_key(_synthetic(jax_portable, {}, (4,), (1,)),
                                      jnp.ones(16), backend="fast"),
                  {"block": 4, "rows": 1}, 1e-6)
    raw = json.loads(path.read_text())
    assert raw["schema"] == jax_tuning.CACHE_SCHEMA
    # even a reference file carrying this very key string is discarded
    raw["entries"][key.as_str()] = {"params": {"block": 4}, "seconds": 1e-9,
                                    "search": "exhaustive"}
    path.write_text(json.dumps(raw))
    cache = tuning.TuningCache(path=path)
    assert len(cache) == 0 and cache.get(key) is None
    r = tuning.tune(k, x, backend="fast", cache=cache, iters=1, warmup=0)
    assert not r.cached
    raw = json.loads(path.read_text())
    assert raw["schema"] == tuning.CACHE_SCHEMA == "repro_torch.tuning/v1"
    assert list(raw["entries"]) == [key.as_str()]
    # its own env and default path, apart from the reference's
    assert tuning.CACHE_ENV == "REPRO_TORCH_TUNING_CACHE" != \
        jax_tuning.CACHE_ENV
    monkeypatch.delenv(tuning.CACHE_ENV, raising=False)
    assert tuning.default_cache_path() == \
        Path.home() / ".cache" / "repro_torch" / "tuning.json"


def test_model_search_waits_for_the_cost_model(tmp_path):
    """The cost model (core/analysis/cost.py) is ported: search='model'
    ranks the points statically, times at most the top k (MODEL_TOP_K, or
    ``budget``) and caches its pick with provenance 'model'."""
    k = _toy_kernel({"n": 0})
    cache = tuning.TuningCache(tmp_path / "model.json")
    r = tuning.tune(k, torch.ones(16), backend="fast", cache=cache,
                    iters=1, warmup=0, search="model", budget=2)
    assert r.skipped is None and r.search == "model" and not r.cached
    assert len(r.swept) <= 2 <= tuning.MODEL_TOP_K
    key = tuning.make_key(k, torch.ones(16), backend="fast")
    assert cache.get(key)["search"] == "model"
    with pytest.raises(ValueError, match="search mode"):
        tuning.tune(k, torch.ones(16), backend="fast", search="bogus")


# ---- the timer on CUDA tensors -------------------------------------------
def _fake_cuda(monkeypatch):
    """Make tune() see a CUDA call without a card: the device test, the
    key's device name and count."""
    monkeypatch.setattr(tuning, "_cuda_device",
                        lambda a, k: torch.device("cuda", 0))
    monkeypatch.setattr(tuning, "platform", lambda *a: "NVIDIA H100")
    monkeypatch.setattr(tuning, "device_count", lambda *a: 1)


@pytest.mark.parametrize("events_s,timer", [(1e-3, "events"),
                                            (9e-5, "graph")])
def test_fast_points_are_ranked_by_graph_time(monkeypatch, tmp_path,
                                              events_s, timer):
    """Below GRAPH_TIMER_BELOW_S every point of the sweep is ranked by its
    CUDA-graph time (here the events reading ties across points, as the
    host's enqueue rate does; the graph times do not); above it by
    time_call's CUDA events."""
    _fake_cuda(monkeypatch)
    calls = []
    k = PortableKernel(name="timed")
    k.add_backend("torch", lambda x: x)
    k.add_backend("fast", lambda x, *, bkv=64: x)
    k.declare_tunables("fast", bkv=(64, 128, 256, 512))
    graph_s = {64: 3e-5, 128: 2e-5, 256: 2.5e-5, 512: 4e-5}

    def time_backend(*a, backend, iters=3, warmup=1, graph=False, **kw):
        calls.append((kw["bkv"], graph))
        return graph_s[kw["bkv"]] if graph else events_s

    k.time_backend = time_backend
    cache = tuning.TuningCache(tmp_path / "t.json")
    r = tuning.tune(k, torch.ones(4), backend="fast", cache=cache)
    assert r.timer == timer
    if timer == "graph":
        assert r.params == {"bkv": 128} and r.seconds == 2e-5
        # one events reading decides; then every point by graph
        assert calls == [(64, False)] + [(b, True) for b in graph_s]
    else:
        assert r.params == {"bkv": 64}       # ties keep the earlier point
        assert all(not g for _, g in calls)
    (entry,) = json.loads((tmp_path / "t.json").read_text())[
        "entries"].values()
    assert entry["timer"] == timer


# ---- the code hash -------------------------------------------------------
def test_code_hash_sees_through_thin_wrappers(tmp_path, monkeypatch):
    pkg = tmp_path / "repro_torch" / "fakekern"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")

    def write_kernel(body):
        (pkg / "kernel.py").write_text(textwrap.dedent(f"""
            def laplacian(u):
                return {body}
        """))
        (pkg / "ops.py").write_text(textwrap.dedent("""
            from fakekern import kernel as K

            def wrapper(u):
                return K.laplacian(u)
        """))

    write_kernel("u + u")
    monkeypatch.syspath_prepend(str(tmp_path / "repro_torch"))
    for mod in [m for m in sys.modules if m.startswith("fakekern")]:
        del sys.modules[mod]
    try:
        import fakekern.ops as ops
        h1 = tuning.backend_code_hash(ops.wrapper)
        write_kernel("u * 2.0")            # kernel edit; wrapper unchanged
        importlib.reload(sys.modules["fakekern.kernel"])
        ops = importlib.reload(ops)
        assert tuning.backend_code_hash(ops.wrapper) != h1
    finally:
        for mod in [m for m in sys.modules if m.startswith("fakekern")]:
            del sys.modules[mod]


def test_code_hash_covers_the_cuda_source_and_the_build(tmp_path,
                                                        monkeypatch):
    """No Python name reaches a ``.cu``: the kernel module's CUDA_SOURCES
    put the source's digest, and ``_build.py``'s (the nvcc flags), into the
    hash of every backend that reaches the module."""
    fn = registry.get("stencil7").backend("cuda").fn
    csrc = tmp_path / "repro_torch" / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    build_py = tmp_path / "repro_torch" / "_build.py"
    shutil.copy(_build.__file__, build_py)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "__file__", str(build_py))

    def fresh_hash():
        monkeypatch.setattr(tuning, "_CODE_HASHES", {})
        return tuning.backend_code_hash(fn)

    parts = tuning._referenced_file_hashes(fn)
    assert any(p.startswith("repro_torch/csrc/stencil7.cu=") for p in parts)
    assert any(p.startswith("repro_torch/_build.py=") for p in parts)
    assert all(p.startswith("repro_torch/") for p in parts), parts
    h0 = fresh_hash()
    assert fresh_hash() == h0
    (csrc / "stencil7.cu").write_text((csrc / "stencil7.cu").read_text()
                                      + "\n// edited\n")
    h1 = fresh_hash()
    assert h1 != h0
    # another kernel's source does not move this key
    (csrc / "rwkv6.cu").write_text("// edited\n")
    assert fresh_hash() == h1
    build_py.write_text(build_py.read_text() + "\n# flags edited\n")
    assert fresh_hash() != h1


@pytest.mark.parametrize("name", ["stencil7", "minibude.fasten",
                                  "hartree_fock.twoel", "attention.flash",
                                  "attention.decode", "rwkv6.wkv"])
def test_every_cuda_backend_hash_reaches_its_source(name):
    fn = registry.get(name).backend("cuda").fn
    parts = tuning._referenced_file_hashes(fn)
    assert sum(p.startswith("repro_torch/csrc/") for p in parts) == 1, parts


def test_code_hash_unwraps_a_triton_jit_function():
    def body(x):
        return x

    class JITFunction:                  # Triton's: the Python body is .fn
        def __init__(self, fn):
            self.fn = fn

    assert tuning._unwrap_callable(JITFunction(body)) is body
    assert tuning.backend_code_hash(JITFunction(body)) == \
        tuning.backend_code_hash(body)


def test_edited_backend_invalidates_its_cache_entry(tmp_path):
    cache = tuning.TuningCache(path=tmp_path / "tuning.json")
    x = torch.ones(16)
    tuning.tune(_toy_kernel({"n": 0}), x, backend="fast", cache=cache,
                iters=1, warmup=0)
    edited = PortableKernel(name="toy")
    edited.add_backend("torch", lambda x: x * 2.0)
    edited.add_backend("fast", lambda x, *, block=8: x + x + 0.0)
    edited.declare_tunables("fast", block=(4, 8, 16))
    r = tuning.tune(edited, x, backend="fast", cache=cache, iters=1,
                    warmup=0)
    assert not r.cached and len(cache) == 2


# ---- the registered kernels ----------------------------------------------
@pytest.mark.parametrize("name,params", [
    ("stencil7", ("block_x", "block_y", "zchunk")),
    ("babelstream.triad", ("block", "num_warps")),
    ("minibude.fasten", ("ppwi", "split")),
    ("hartree_fock.twoel", ("team",)),
    ("attention.flash", ("bq", "bk")),
    ("attention.decode", ("bkv",)),
    ("rwkv6.wkv", ("chunk",)),
])
def test_hand_written_backends_declare_spaces_and_skip_on_the_cpu(
        name, params):
    k = registry.get(name)
    space = k.tunable_space(k.native)
    assert space is not None and tuple(space.params) == params
    args, kwargs = conformance.case_tensors(name)
    r = tuning.tune(k, *args, backend=k.native, **kwargs)
    reason = k.backend(k.native).unavailable_reason()
    assert reason is not None           # this host has no card
    assert r.skipped == f"backend {k.native!r} unavailable: {reason}"
    assert r.swept == [] and r.params == {}


def test_a_hand_written_backend_on_cpu_tensors_is_never_timed():
    """On a GPU host, CPU tensors would make the wrapper run the plain
    version: tune() skips rather than time the oracle under the kernel's
    name."""
    fake = PortableKernel(name="native.cpu", native="cuda")
    fake.add_backend("torch", lambda x: x)
    fake.add_backend("cuda", lambda x, *, block=4: pytest.fail("timed"))
    fake.declare_tunables("cuda", block=(4, 8))
    r = tuning.tune(fake, torch.ones(4), backend="cuda")
    assert r.skipped is not None and "CUDA tensors only" in r.skipped


def test_tune_registered_uses_the_global_registry():
    r = tuning.tune_registered("babelstream.copy", torch.ones(64),
                               backend="triton")
    assert r.kernel == "babelstream.copy" and r.skipped is not None


# ---- the attention dispatch ----------------------------------------------
def _attn_inputs(kind, rng):
    b, s, t, h, kv, dh = (2, 1, 16, 4, 2, 16) if kind == "decode" else \
        (1, 8, 8, 4, 2, 16)
    q = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, kv, dh)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, kv, dh)).astype(
        np.float32))
    qp = torch.full((b, s), t - 1, dtype=torch.int32) if kind == "decode" \
        else torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    kp = torch.arange(t, dtype=torch.int32)[None].expand(b, t).contiguous()
    return q, k, v, qp, kp


@pytest.fixture
def stub_cuda_route(monkeypatch, tmp_path):
    """The ``cuda`` route of ``attend`` on CPU tensors: resolution says
    ``cuda``, the backends' probes pass and their functions record the
    kwargs they were given (and run the plain version); the default tuning
    cache is a fresh file."""
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "tuning.json"))
    monkeypatch.setattr(A, "resolve_attention_backend",
                        lambda kind, backend, device: "cuda")
    seen = []
    for name in A.ATTN_KERNELS.values():
        k = registry.get(name)
        plain = k.backend("torch").fn

        def fn(*args, _plain=plain, _name=name, **kw):
            seen.append((_name, kw))
            return _plain(*args, **{n: v for n, v in kw.items()
                                    if n in ("causal", "window")})

        monkeypatch.setitem(k.backends, "cuda",
                            portable.Backend("cuda", fn))
    A.reset_dispatch_log()
    yield seen
    A.reset_dispatch_log()


@pytest.mark.parametrize("kind,planted", [("decode", {"bkv": 256}),
                                          ("prefill", {"bq": 64, "bk": 32})])
def test_dispatch_injects_planted_params_and_records_provenance(
        stub_cuda_route, kind, planted):
    rng = np.random.default_rng(3)
    q, k, v, qp, kp = _attn_inputs(kind, rng)
    kernel = registry.get(A.ATTN_KERNELS[kind])
    causal = True
    args, kwargs = A.kernel_args(kind, q, k, v, qp, kp, causal=causal)
    A.attend(q, k, v, qp, kp, n_kv_heads=2, causal=causal)
    assert A.dispatch_log()[kind] == {"backend": "cuda",
                                      "kernel": kernel.name,
                                      "tuning": "miss-default", "params": {}}
    assert stub_cuda_route[-1] == (kernel.name, kwargs)
    cache = tuning.default_cache()
    cache.put(tuning.make_key(kernel, *args, backend="cuda", **kwargs),
              planted, 1e-5, search="coordinate", timer="graph")
    A.attend(q, k, v, qp, kp, n_kv_heads=2, causal=causal)
    assert A.dispatch_log()[kind]["tuning"] == "coordinate"
    assert A.dispatch_log()[kind]["params"] == planted
    assert stub_cuda_route[-1] == (kernel.name, {**kwargs, **planted})
    assert A._tuned_params(kernel, *args, backend="cuda", **kwargs) == (
        planted, "coordinate")
    recs = A.dispatch_records()
    assert [r["tuning"] for r in recs] == ["miss-default", "coordinate"]
    assert all(r["kind"] == kind and "fallback" not in r for r in recs)


def test_torch_route_records_no_tuning(monkeypatch):
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    A.reset_dispatch_log()
    q, k, v, qp, kp = _attn_inputs("decode", np.random.default_rng(0))
    A.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True)
    assert A.dispatch_log() == {"decode": {
        "backend": "torch", "kernel": "attention.decode", "tuning": "n/a",
        "params": {}}}
    # a prefill a layer per call floods the ring: the last decode decision
    # stays in dispatch_log() all the same
    qf, kf, vf, qpf, kpf = _attn_inputs("prefill", np.random.default_rng(1))
    for i in range(A.DISPATCH_LOG_CAP + 5):
        A.attend(qf, kf, vf, qpf, kpf, n_kv_heads=2, causal=True)
    assert len(A.dispatch_records()) == A.DISPATCH_LOG_CAP
    assert all(r["kind"] == "prefill" for r in A.dispatch_records())
    assert A.dispatch_log()["decode"]["tuning"] == "n/a"
    A.reset_dispatch_log()
    assert A.dispatch_records() == []


#: the port's module of each reference module that ``repro.core`` exports
#: from, and the port's name for each reference name that says XLA
CORE_MODULES = {"portable": "portable", "tuning": "tuning",
                "metrics": "metrics", "roofline": "roofline",
                "hlo_analysis": "op_analysis"}
COUNTERPARTS = {"roofline_from_compiled": "roofline_from_cost",
                "parse_collective_bytes": "collective_stats"}


@pytest.mark.parametrize("module", list(CORE_MODULES))
def test_core_exports_the_references_names_of_the_ported_modules(module):
    """``repro_torch.core`` re-exports every name that ``repro.core``
    re-exports from each module, from the port's module of it; a name that
    says XLA has its counterpart, listed in ``COUNTERPARTS``, and no other
    name is exempt."""
    import repro.core as jax_core
    import repro_torch.core as core
    theirs = {name for name in dir(jax_core)
              if getattr(getattr(jax_core, name), "__module__", None)
              == f"repro.core.{module}"}
    assert theirs
    ours = {COUNTERPARTS.get(name, name) for name in theirs}
    assert {name for name in ours if not hasattr(core, name)} == set()
    for name in ours:
        assert getattr(core, name).__module__ == \
            f"repro_torch.core.{CORE_MODULES[module]}"
