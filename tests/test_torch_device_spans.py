"""Device spans on the recorder's clock (``core/telemetry/cudamon.py``) and
the serving engine's host/device split of each prefill and decode step.

On the CPU the engine's work is synchronous, so each ``device.*`` span is
the host interval of the same work and the span tree is the card's: every
``serving.prefill`` holds one ``engine.prefill.enqueue``, one
``engine.prefill.wait`` and one ``device.prefill``; every
``serving.decode_step`` the decode trio.  Also: with telemetry off nothing
touches ``torch.cuda``; device spans get their own Chrome track; deferred
spans wait until their events complete; the summary's device section and
the profiler's records on the recorder's clock.  The card's side is
``tests/test_torch_device_spans_on_card.py``.
"""

import dataclasses
import itertools
import os
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import telemetry as tel
from repro_torch.core.telemetry import cudamon
from repro_torch.models.transformer import init_params
from repro_torch.serving import Request, ServingEngine

TRIOS = {"serving.prefill": ("engine.prefill.enqueue", "engine.prefill.wait",
                             "device.prefill"),
         "serving.decode_step": ("engine.decode.enqueue",
                                 "engine.decode.wait", "device.decode_step")}


@pytest.fixture
def telem():
    rec = tel.configure("on")
    yield rec
    tel.configure(os.environ.get(tel.ENV))


def _smoke():
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              compute_dtype="float32")
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg


def _serve(params, cfg, threaded):
    eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                        prefill_len=8)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size,
                                               int(rng.integers(3, 9)))
                    .astype(np.int32), max_new_tokens=3 + i % 3)
            for i in range(4)]
    done = eng.run_threaded(reqs) if threaded else eng.run(reqs)
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("threaded", [False, True], ids=["run", "threaded"])
def test_each_prefill_and_step_splits_into_host_and_device(threaded):
    params, cfg = _smoke()
    tel.configure("off")
    off = _serve(params, cfg, threaded)
    rec = tel.configure("on")
    try:
        on = _serve(params, cfg, threaded)
        events = rec.event_list()
    finally:
        tel.configure(os.environ.get(tel.ENV))
    assert on == off
    spans = [e for e in events if e["kind"] == "span"]
    by_sid = {e["sid"]: e for e in spans}
    for parent_name, trio in TRIOS.items():
        parents = [e for e in spans if e["name"] == parent_name]
        assert parents
        for p in parents:
            kids = [e for e in spans if e["parent"] == p["sid"]]
            assert sorted(e["name"] for e in kids) == sorted(trio)
            for k in kids:
                assert p["ts"] <= k["ts"]
                assert k["ts"] + k["dur"] <= p["ts"] + p["dur"]
            enq, wait, dev = (next(e for e in kids if e["name"] == n)
                              for n in trio)
            assert enq["ts"] + enq["dur"] <= wait["ts"]
            assert dev["proc"] == "device" and enq["proc"] == "engine"
            carried = {k: p["attrs"][k] for k in cudamon.CARRIED
                       if k in p["attrs"]}
            assert carried and dev["attrs"] == carried
    # nothing new under serving.*, nothing between run and its steps
    names = {e["name"] for e in spans}
    assert names == {"serving.run", *TRIOS, *TRIOS["serving.prefill"],
                     *TRIOS["serving.decode_step"]}
    (run,) = [e for e in spans if e["name"] == "serving.run"]
    assert all(by_sid[e["parent"]] is run for e in spans
               if e["name"] == "serving.decode_step")


def test_telemetry_off_touches_no_cuda(monkeypatch):
    def no(*a, **kw):
        raise AssertionError("torch.cuda touched with telemetry off")

    for attr in ("Event", "current_stream", "current_device",
                 "is_initialized"):
        monkeypatch.setattr(torch.cuda, attr, no)
    tel.configure("off")
    try:
        dev = cudamon.DeviceSpans(torch.device("cuda", 0))
        start, end = dev.mark(), dev.mark()
        assert start is None and end is None
        dev.span("device.decode_step", start, end)
        dev.settle()
    finally:
        monkeypatch.undo()
        tel.configure(os.environ.get(tel.ENV))


def test_no_anchor_without_cuda(monkeypatch, telem):
    """A process that has not initialised CUDA takes no anchor, and reads no
    clock for one (the parity test's fake clock counts each read)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    reads = itertools.count()
    real = time.perf_counter
    monkeypatch.setattr(time, "perf_counter",
                        lambda: (next(reads), real())[1])
    tel.reset()
    cudamon.anchor(telem)
    assert next(reads) == 0 and telem.anchors == {}


class _Event:
    """A timing event that completes when told to."""

    def __init__(self, ms):
        self.ms, self.done = ms, False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_deferred_device_span_waits_for_its_events(telem):
    anchor_host = time.perf_counter()
    telem.anchors[0] = (_Event(100.0), anchor_host)
    dev = cudamon.DeviceSpans(torch.device("cuda", 0))
    start, end = _Event(102.0), _Event(105.5)
    with telem.span("serving.decode_step", proc="engine", step=7) as host:
        dev.span("device.decode_step", start, end)
    assert not [e for e in telem.event_list() if e["name"].startswith(
        "device.")]                                # not complete: held
    start.done = end.done = True
    (ev,) = [e for e in telem.event_list()
             if e["name"] == "device.decode_step"]
    assert ev["ts"] == pytest.approx(anchor_host + 0.002 - telem.epoch)
    assert ev["dur"] == pytest.approx(0.0035)
    assert ev["parent"] == host.sid and ev["attrs"] == {"step": 7}
    assert ev["proc"] == "device" and ev["tid"] == "cuda:0"
    assert dev._free == [start, end]               # back in the pool
    dev.span("device.decode_step", start, end, pooled=False)
    telem.clear()                                  # a reset drops it
    assert telem.event_list() == [] and telem._pending == []


def test_device_spans_get_their_own_chrome_track(telem):
    dev = cudamon.DeviceSpans(torch.device("cpu"))
    with tel.span("serving.prefill", proc="engine", uid=3):
        dev.span("device.prefill", dev.mark(), dev.mark())
    doc = tel.chrome_trace(telem)
    procs = {te["args"]["name"]: te["pid"] for te in doc["traceEvents"]
             if te["ph"] == "M" and te["name"] == "process_name"}
    xs = {te["name"]: te for te in doc["traceEvents"] if te["ph"] == "X"}
    assert xs["device.prefill"]["pid"] == procs["device"]
    assert xs["serving.prefill"]["pid"] == procs["engine"] != procs["device"]
    assert xs["device.prefill"]["args"]["uid"] == 3


def _trace(tmp_path, events):
    path = tmp_path / "t.jsonl"
    tel.write_jsonl(str(path), events)
    return tel.summarize_file(str(path))


def _span(name, ts, dur, proc="engine"):
    return {"kind": "span", "name": name, "ts": ts, "dur": dur, "sid": None,
            "parent": None, "proc": proc, "tid": "main", "attrs": {}}


def test_summary_has_a_device_section_only_with_device_spans(tmp_path):
    host = [_span("serving.run", 0.0, 1.0),
            _span("serving.decode_step", 0.1, 0.1),
            _span("engine.decode.wait", 0.15, 0.05),
            _span("serving.decode_step", 0.3, 0.1),
            _span("serving.prefill", 0.5, 0.2)]
    plain = _trace(tmp_path, host)
    assert "device" not in plain
    assert "device" not in tel.format_summary(plain)
    dev = [_span("device.decode_step", 0.11, 0.05, "device"),
           _span("device.decode_step", 0.31, 0.05, "device"),
           _span("device.prefill", 0.52, 0.1, "device")]
    summary = _trace(tmp_path, host + dev)
    d = summary["device"]
    assert d["intervals"] == 3
    assert d["window_ms"] == pytest.approx(510.0)
    assert d["idle_ms"] == pytest.approx(150.0 + 160.0)
    assert d["busy_ms"] == pytest.approx(200.0)
    # each gap under the innermost host span open at its start
    assert d["idle_by_host_span"] == {
        "engine.decode.wait": {"gaps": 1, "total_ms": pytest.approx(150.0)},
        "serving.decode_step": {"gaps": 1,
                                "total_ms": pytest.approx(160.0)}}
    text = tel.format_summary(summary)
    without = tel.format_summary({k: v for k, v in summary.items()
                                  if k != "device"})
    assert text.startswith(without + "\ndevice: 3 device spans")
    assert "engine.decode.wait" in text.split("device:")[1]


def test_gaps_named_by_the_innermost_open_span():
    from repro_torch.core.telemetry.summarize import gaps_by_host_span
    host = [(0.0, 10.0, "outer"), (1.0, 2.0, "a"), (1.0, 1.5, "a.inner"),
            (3.0, 9.0, "b")]
    gaps = [(1.2, 1.3), (2.5, 2.6), (4.0, 5.0), (10.5, 11.0)]
    by = gaps_by_host_span(gaps, host)
    assert {k: v["gaps"] for k, v in by.items()} == {
        "a.inner": 1, "outer": 1, "b": 1, "(none)": 1}
    assert by["b"]["total_ms"] == pytest.approx(1000.0)


class _Record:
    """A Kineto record: what ``profiler_records`` reads."""

    def __init__(self, name, start_ns, dur_ns, device=True, note=False):
        self._n, self._s, self._d = name, start_ns, dur_ns
        self._dev, self._note = device, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._note


def test_profiler_records_land_on_the_recorders_clock(telem):
    base = telem.epoch_ns
    recs = [_Record("decode_kernel", base + 2_000_000, 30_000),
            _Record("nvjet", base + 1_000_000, 500_000),
            _Record("aten::mm", base + 900_000, 10, device=False),
            _Record("portbench.stretch", base, 10**9, note=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: recs)))
    got = cudamon.profiler_records(prof)
    assert [r[0] for r in got] == ["nvjet", "decode_kernel"]
    assert got[1][1] == pytest.approx(0.002)
    assert got[1][2] == pytest.approx(0.00203)
    # the profile's gaps named by the program's spans
    with telem.span("engine.decode.wait", proc="engine"):
        pass
    d = tel.device_summary(telem.event_list(),
                           device=[(s, e) for _, s, e in got])
    assert d["intervals"] == 2
    assert d["idle_ms"] == pytest.approx(0.5)


def test_recorder_epoch_on_the_profilers_base(telem):
    assert abs(telem.epoch_ns / 1e9 - telem.epoch_unix) < 0.01
    tel.configure("off")
    with pytest.raises(RuntimeError, match="telemetry is off"):
        cudamon.profiler_records(None)
