"""The port's telemetry (``repro_torch.core.telemetry``) held against the JAX
package's on the CPU.

The same synthetic event stream, on one monkeypatched clock, goes through
both packages' recorders and gives equal JSONL logs, Chrome traces and
summaries; the reference's ``summarize_file`` reads the port's JSONL.  The
same requests through the reference's engine (granite-3-8b SMOKE, ``xla``)
and the port's (CPU, ``torch``) give the same ordered lifecycle events.
Also: the compile bridge (``cudamon``: nvcc builds through a stand-in nvcc,
graph captures, a stand-in Triton's hooks),
the registry's timing events, the disabled no-op, ring eviction and a bad
mode raising.
"""

import dataclasses
import itertools
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import telemetry as jax_tel
from repro.models import transformer as JT
from repro.serving import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import _build
from repro_torch.configs import get_config
from repro_torch.core import portable
from repro_torch.core import telemetry as tel
from repro_torch.core.telemetry import cudamon
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine

REPO = Path(__file__).resolve().parents[1]
ARCH = "granite-3-8b"
LIFECYCLE = ("serving.enqueue", "serving.slot_assign", "serving.first_token",
             "serving.finish")


@pytest.fixture
def telem():
    """Port telemetry on for one test, back to the environment's after."""
    rec = tel.configure("on")
    yield rec
    tel.configure(os.environ.get(tel.ENV))


# ---- parity of the recorder and the exporters ----------------------------
def _stream(pkg):
    """One synthetic event stream: nested spans, an instant with a params
    dict, counters, gauges, and a span whose attrs hold a tuple."""
    with pkg.span("outer", proc="engine", uid=1):
        pkg.instant("serving.enqueue", proc="engine", uid=1,
                    params={"bq": 64, "grid": (2, 1)})
        with pkg.span("inner", proc="engine", step=0):
            pkg.counter("tuning.cache.hit", proc="tuning")
        pkg.gauge("serving.queue_depth", 3, proc="engine")
        pkg.counter("tuning.cache.hit", proc="tuning")
    for i in range(4):
        with pkg.span("serving.decode_step", proc="engine", step=i):
            pass
    pkg.gauge("serving.slot_occupancy", 0.5, proc="engine")


def _record_on_a_fake_clock(pkg, monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter",
                        lambda: 100.0 + 0.125 * next(ticks))
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    rec = pkg.configure("on")
    try:
        _stream(pkg)
        return rec
    finally:
        monkeypatch.undo()
        pkg.configure(os.environ.get(pkg.ENV))


def test_recorders_and_exporters_equal_the_reference(monkeypatch, tmp_path):
    ours = _record_on_a_fake_clock(tel, monkeypatch)
    theirs = _record_on_a_fake_clock(jax_tel, monkeypatch)
    assert ours.event_list() == theirs.event_list()
    assert ours.snapshot() == theirs.snapshot()
    assert tel.SCHEMA == jax_tel.SCHEMA == "repro.telemetry/v1"
    a, b = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    tel.write_jsonl(str(a), ours)
    jax_tel.write_jsonl(str(b), theirs)
    assert a.read_text() == b.read_text()
    assert tel.chrome_trace(ours) == jax_tel.chrome_trace(theirs)
    tel.write_chrome_trace(str(tmp_path / "ours.json"), ours)
    jax_tel.write_chrome_trace(str(tmp_path / "theirs.json"), theirs)
    for suffix in (".jsonl", ".json"):
        assert tel.summarize_file(str(tmp_path / f"ours{suffix}")) == \
            jax_tel.summarize_file(str(tmp_path / f"theirs{suffix}"))
    # the reference's reader takes the port's files
    summary = jax_tel.summarize_file(str(a))
    assert summary == tel.summarize_file(str(a))
    assert summary["spans"]["serving.decode_step"]["count"] == 4
    assert summary["counters"] == {"tuning.cache.hit": 2.0}
    assert tel.format_summary(summary) == jax_tel.format_summary(summary)


def test_summarize_cli_reads_the_ports_trace(tmp_path, monkeypatch):
    rec = _record_on_a_fake_clock(tel, monkeypatch)
    path = tmp_path / "trace.jsonl"
    tel.write_jsonl(str(path), rec)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.telemetry", "summarize",
         str(path)], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "serving.decode_step" in out.stdout and "p99_ms" in out.stdout
    assert "tuning.cache.hit = 2" in out.stdout


def test_percentile_matches_numpy():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 100):
        xs = rng.standard_normal(n).tolist()
        for q in (0, 50, 95, 99, 100):
            assert tel.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12, abs=1e-12)
    with pytest.raises(ValueError):
        tel.percentile([], 50)


def test_ring_buffer_evicts_the_oldest():
    rec = tel.Recorder(capacity=4)
    for i in range(10):
        rec.instant("tick", i=i)
    rec.counter("c", 2)
    events = rec.event_list()
    assert len(events) == 4 and rec.dropped == 7
    assert [e["attrs"].get("i") for e in events[:3]] == [7, 8, 9]
    assert rec.snapshot()["counters"] == {"c": 2.0}
    assert rec.snapshot()["events_dropped"] == 7
    log = tel.RingLog(capacity=2)
    for i in range(3):
        log.append({"i": i})
    assert log.records() == [{"i": 1}, {"i": 2}] and len(log) == 2


def test_disabled_telemetry_is_a_noop():
    tel.configure("off")
    try:
        assert not tel.enabled() and tel.recorder() is None
        assert tel.span("x") is tel.NOOP_SPAN
        with tel.span("x", a=1) as sp:
            tel.instant("y")
            tel.counter("z")
            tel.gauge("g", 1.0)
        assert sp is tel.span("other")
        assert tel.snapshot() == {} and tel.events() == []
        assert tel.flush() is None
    finally:
        tel.configure(os.environ.get(tel.ENV))


@pytest.mark.parametrize("mode", ["bogus", "jsonl:", "tracing"])
def test_a_bad_mode_raises(mode):
    with pytest.raises(ValueError):
        tel.configure(mode)


def test_jsonl_mode_flushes_to_its_path(tmp_path):
    path = tmp_path / "t.jsonl"
    tel.configure(f"jsonl:{path}")
    try:
        tel.counter("a")
        assert tel.flush() == str(path)
    finally:
        tel.configure(os.environ.get(tel.ENV))
    assert tel.read_events(str(path))["footer"]["counters"] == {"a": 1.0}


# ---- the compile bridge --------------------------------------------------
def test_nvcc_builds_are_spans_and_compiles(monkeypatch, tmp_path, telem):
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    _build.build(["stencil7", "rwkv6"])
    spans = [e for e in telem.event_list() if e["name"] == cudamon.BUILD
             and e["kind"] == "span"]
    assert sorted(e["attrs"]["source"] for e in spans) == ["rwkv6",
                                                           "stencil7"]
    assert all(e["attrs"]["ok"] and e["dur"] >= 0 for e in spans)
    counters = telem.snapshot()["counters"]
    assert counters[cudamon.BUILD] == 2
    assert counters[cudamon.COMPILE_COUNTER] == 2
    _build.build(["stencil7"])             # built already: no compile
    assert telem.snapshot()["counters"][cudamon.BUILD] == 2


def test_graph_captures_count_as_compiles(telem):
    cudamon.graph_captured("serving.decode_step")
    counters = telem.snapshot()["counters"]
    assert counters[cudamon.GRAPH_CAPTURE] == 1
    assert counters[cudamon.COMPILE_COUNTER] == 1
    (ev,) = [e for e in telem.event_list() if e["kind"] == "instant"]
    assert ev["attrs"] == {"site": "serving.decode_step"}


def test_bridge_is_silent_when_telemetry_is_off():
    tel.configure("off")
    try:
        cudamon.graph_captured("x")
        cudamon.record_build("stencil7", 0.0, 1.0, True)
        assert tel.snapshot() == {}
    finally:
        tel.configure(os.environ.get(tel.ENV))


def _fake_triton(monkeypatch, **jit_attrs):
    jit = types.ModuleType("triton.runtime.jit")
    jit.JITFunction = type("JITFunction", (), dict(jit_attrs))
    runtime = types.ModuleType("triton.runtime")
    runtime.jit = jit
    triton = types.ModuleType("triton")
    triton.runtime = runtime
    for name, mod in (("triton", triton), ("triton.runtime", runtime),
                      ("triton.runtime.jit", jit)):
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(cudamon, "_triton_route", None)
    return jit.JITFunction


def test_triton_compiles_count_through_its_hook(monkeypatch, telem):
    JITFunction = _fake_triton(monkeypatch, compiled_hook=None,
                               cache_hook=None)
    assert cudamon.watch_triton() == "JITFunction.compiled_hook"
    assert cudamon.watch_triton() == "JITFunction.compiled_hook"  # once
    fn = types.SimpleNamespace(name="stream_kernel")
    assert JITFunction.compiled_hook(key="k", repr="r", fn=fn, compile={},
                                     is_manual_warmup=False,
                                     already_compiled=False) is None
    assert telem.snapshot()["counters"] == {cudamon.TRITON_COMPILE: 1.0,
                                            cudamon.COMPILE_COUNTER: 1.0}
    (ev,) = [e for e in telem.event_list() if e["kind"] == "instant"]
    assert ev["attrs"] == {"kernel": "stream_kernel"}


def test_triton_knobs_hook_chains_an_earlier_hook(monkeypatch, telem):
    """Triton 3.4 on (the H100 host's 3.6.0): the post-compile hook in
    ``knobs.runtime``; a hook installed before ours still runs."""
    _fake_triton(monkeypatch)
    earlier = []
    runtime = types.SimpleNamespace(
        jit_post_compile_hook=lambda **kw: earlier.append(kw) or "kept")
    monkeypatch.setattr(sys.modules["triton"], "knobs",
                        types.SimpleNamespace(runtime=runtime),
                        raising=False)
    assert cudamon.watch_triton() == "knobs.runtime.jit_post_compile_hook"
    assert runtime.jit_post_compile_hook(fn=None) == "kept"
    assert len(earlier) == 1
    assert telem.snapshot()["counters"][cudamon.TRITON_COMPILE] == 1


def test_a_triton_without_hooks_is_not_counted(monkeypatch, telem):
    _fake_triton(monkeypatch)
    assert cudamon.watch_triton() == "none"
    assert telem.snapshot()["counters"] == {}


# ---- the registry's timing events ------------------------------------------
def test_time_backend_emits_one_measure_a_sample(telem):
    k = portable.PortableKernel(name="timed")
    k.add_backend("torch", lambda x, *, block=4: x + 1.0)
    secs = k.time_backend(torch.ones(8), backend="torch", iters=5, warmup=1,
                          block=8)
    assert secs > 0
    events = telem.event_list()
    (span,) = [e for e in events if e["name"] == "registry.time_backend"]
    assert span["attrs"]["params"] == {"block": 8}
    assert span["attrs"]["timer"] == "host"
    measures = [e for e in events if e["name"] == "registry.measure"]
    assert len(measures) == 5
    assert all(e["parent"] == span["sid"] and e["attrs"]["calls"] == 1
               for e in measures)
    assert sorted(e["attrs"]["ms"] for e in measures)[2] == pytest.approx(
        secs * 1e3)
    (res,) = [e for e in events if e["name"] ==
              "registry.time_backend.result"]
    assert res["attrs"]["shape"] == "float32[8]"
    assert (res["attrs"]["platform"], res["attrs"]["devices"]) == ("cpu", 1)
    assert res["attrs"]["params_json"] == '{"block": 8}'
    assert telem.snapshot()["counters"]["registry.time_backend.calls"] == 1


def test_time_graph_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        portable.time_graph(lambda x: x, torch.ones(2))


# ---- the engine's lifecycle against the reference's ----------------------
def _both():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _prompts(cfg, n=4):
    rng = np.random.default_rng(5)
    return [(i, rng.integers(2, cfg.vocab_size, int(rng.integers(3, 9)))
             .astype(np.int32)) for i in range(n)]


def _lifecycle(events):
    return [(e["name"], e["attrs"]["uid"], e["attrs"].get("slot"))
            for e in events if e["name"] in LIFECYCLE]


def _serve(engine_cls, request_cls, params, cfg, prompts):
    eng = engine_cls(params, cfg, num_slots=2, cache_len=32, prefill_len=8)
    done = eng.run([request_cls(uid=i, prompt=p, max_new_tokens=3 + i % 3)
                    for i, p in prompts])
    return {r.uid: list(r.generated) for r in done}


def test_engine_lifecycle_equals_the_reference_engine(monkeypatch):
    monkeypatch.delenv("REPRO_ATTN_BACKEND", raising=False)
    jcfg, jparams, cfg, params = _both()
    prompts = _prompts(cfg)
    jrec = jax_tel.configure("on")
    try:
        want_tokens = _serve(JaxServingEngine, JaxRequest, jparams, jcfg,
                             prompts)
        want = jrec.event_list()
        want_counters = jrec.snapshot()["counters"]
    finally:
        jax_tel.configure(os.environ.get(jax_tel.ENV))
    rec = tel.configure("on")
    try:
        tokens = _serve(ServingEngine, Request, params, cfg, prompts)
        got = rec.event_list()
        counters = rec.snapshot()["counters"]
    finally:
        tel.configure(os.environ.get(tel.ENV))
    assert tokens == want_tokens
    assert _lifecycle(got) == _lifecycle(want)
    assert len(_lifecycle(got)) == 4 * len(prompts)
    assert counters["serving.requests_finished"] == \
        want_counters["serving.requests_finished"] == len(prompts)

    def names(events, kind):
        return sorted({e["name"] for e in events if e["kind"] == kind
                       and e["name"].startswith("serving.")})

    for kind in ("span", "gauge", "instant"):
        assert names(got, kind) == names(want, kind), kind
    steps = [e for e in got if e["name"] == "serving.decode_step"]
    run_sid = next(e["sid"] for e in got if e["name"] == "serving.run")
    assert steps and all(e["parent"] == run_sid for e in steps)
    assert len([e for e in got if e["name"] == "serving.queue_depth"]) == \
        len(steps) == len([e for e in want
                           if e["name"] == "serving.decode_step"])
    # the torch route records its dispatch, one a call
    assert counters["attn.dispatch.prefill.torch"] == len(prompts) * \
        cfg.n_layers


@pytest.mark.parametrize("threaded", [False, True], ids=["run", "threaded"])
def test_engine_tokens_are_the_same_with_telemetry_on_and_off(threaded):
    _, _, cfg, params = _both()
    prompts = _prompts(cfg)

    def serve():
        eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                            prefill_len=8)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
                for i, p in prompts]
        done = eng.run_threaded(reqs) if threaded else eng.run(reqs)
        return {r.uid: list(r.generated) for r in done}

    tel.configure("off")
    off = serve()
    rec = tel.configure("on")
    try:
        on = serve()
        events = rec.event_list()
    finally:
        tel.configure(os.environ.get(tel.ENV))
    assert on == off
    assert sum(e["name"] == "serving.finish" for e in events) == len(prompts)
    (run,) = [e for e in events if e["name"] == "serving.run"]
    assert run["attrs"].get("mode") == ("threaded" if threaded else None)
