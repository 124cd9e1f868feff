"""Exporters: JSONL event log, Chrome/Perfetto trace.json, metrics snapshot.

Three consumers, three formats:

  * ``write_jsonl`` — the archival form.  Line 1 is a schema header, then
    one event object per line, then a footer carrying the aggregated
    counters/gauges and the ring-eviction count.  ``read_events`` reads it
    back (and also accepts a Chrome ``trace.json``, so the summarize CLI
    works on either artifact).
  * ``chrome_trace`` / ``write_chrome_trace`` — a ``chrome://tracing`` /
    Perfetto-loadable ``{"traceEvents": [...]}`` document: spans become
    complete events (``ph: "X"`` with microsecond ``ts``/``dur``),
    counters/gauges become counter tracks (``ph: "C"``), instants become
    ``ph: "i"``, and the logical ``proc``/``tid`` labels map to stable
    pid/tid ids declared via ``process_name``/``thread_name`` metadata
    (``ph: "M"``) — so the engine's prefill/decode timeline and its worker
    threads land on separate labelled tracks.
  * ``Recorder.snapshot()`` (re-exported here as ``metrics_snapshot``) —
    the flat dict benchmarks embed in their ``BENCH_*.json`` artifacts.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Union

from repro_torch.core.telemetry.recorder import Recorder, SCHEMA

EventSource = Union[Recorder, Iterable[Dict[str, Any]]]


def _events_of(source: EventSource) -> List[Dict[str, Any]]:
    if isinstance(source, Recorder):
        return source.event_list()
    return list(source)


def write_jsonl(path: str, source: EventSource,
                meta: Optional[Dict[str, Any]] = None,
                footer_data: Optional[Dict[str, Any]] = None) -> int:
    """Write header + events + footer; returns the number of event lines.

    ``footer_data`` overrides the footer aggregates — callers that drained
    a recorder's ring incrementally pass the recorder's final ``snapshot()``
    here so the counters still land in the file.
    """
    events = _events_of(source)
    header: Dict[str, Any] = {"schema": SCHEMA, "kind": "header"}
    footer: Dict[str, Any] = {"kind": "footer"}
    if isinstance(source, Recorder):
        header["t0_unix"] = source.epoch_unix
        snap = source.snapshot()
        footer.update(counters=snap["counters"], gauges=snap["gauges"],
                      events_dropped=snap["events_dropped"])
    if footer_data:
        footer.update({k: v for k, v in footer_data.items()
                       if k in ("counters", "gauges", "events_dropped")})
    if meta:
        header.update(meta)
    with open(path, "w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
        f.write(json.dumps(footer, sort_keys=True) + "\n")
    return len(events)


def read_events(path: str) -> Dict[str, Any]:
    """Load a trace file into ``{"header", "events", "footer"}``.

    Accepts both the JSONL event log and a Chrome ``trace.json`` (detected
    by its ``traceEvents`` key; ``ph: "X"`` rows are mapped back to span
    events with seconds-valued ``ts``/``dur`` so summarize treats the two
    formats identically).
    """
    with open(path) as f:
        first = f.read(4096)
    if first.lstrip().startswith("{") and '"traceEvents"' in first:
        doc = json.loads(open(path).read())
        events = []
        for te in doc.get("traceEvents", []):
            if te.get("ph") == "X":
                events.append({
                    "kind": "span", "name": te["name"],
                    "ts": te["ts"] / 1e6, "dur": te.get("dur", 0.0) / 1e6,
                    "proc": str(te.get("pid", "main")),
                    "tid": str(te.get("tid", "main")),
                    "sid": None, "parent": None,
                    "attrs": te.get("args", {}),
                })
            elif te.get("ph") == "C":
                args = te.get("args", {})
                val = next(iter(args.values()), 0.0)
                events.append({"kind": "counter", "name": te["name"],
                               "ts": te["ts"] / 1e6, "value": val,
                               "proc": str(te.get("pid", "main")),
                               "tid": str(te.get("tid", "main")),
                               "attrs": {}})
        return {"header": {"schema": SCHEMA, "format": "chrome"},
                "events": events, "footer": {}}

    header: Dict[str, Any] = {}
    footer: Dict[str, Any] = {}
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.get("kind")
            if kind == "header":
                header = obj
            elif kind == "footer":
                footer = obj
            else:
                events.append(obj)
    return {"header": header, "events": events, "footer": footer}


def chrome_trace(source: EventSource,
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the Chrome tracing document (pure dict — json.dump it)."""
    events = _events_of(source)
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    trace: List[Dict[str, Any]] = []

    def pid_of(proc: str) -> int:
        if proc not in pids:
            pids[proc] = len(pids) + 1
            trace.append({"ph": "M", "name": "process_name",
                          "pid": pids[proc], "tid": 0,
                          "args": {"name": proc}})
        return pids[proc]

    def tid_of(proc: str, tid: str) -> int:
        key = (proc, tid)
        if key not in tids:
            tids[key] = len(tids) + 1
            trace.append({"ph": "M", "name": "thread_name",
                          "pid": pid_of(proc), "tid": tids[key],
                          "args": {"name": tid}})
        return tids[key]

    for ev in events:
        proc = ev.get("proc", "main")
        tid = ev.get("tid", "main")
        base = {"pid": pid_of(proc), "tid": tid_of(proc, tid),
                "ts": ev["ts"] * 1e6, "name": ev["name"], "cat": ev["kind"]}
        if ev["kind"] == "span":
            args = dict(ev.get("attrs", {}))
            if ev.get("parent") is not None:
                args["parent_sid"] = ev["parent"]
            trace.append({**base, "ph": "X", "dur": ev["dur"] * 1e6,
                          "args": args})
        elif ev["kind"] in ("counter", "gauge"):
            trace.append({**base, "ph": "C", "cat": ev["kind"],
                          "args": {ev["name"]: ev.get("value", 0.0)}})
        else:
            trace.append({**base, "ph": "i", "s": "t",
                          "args": dict(ev.get("attrs", {}))})
    doc = {"traceEvents": trace, "displayTimeUnit": "ms",
           "otherData": {"schema": SCHEMA, **(meta or {})}}
    return doc


def write_chrome_trace(path: str, source: EventSource,
                       meta: Optional[Dict[str, Any]] = None) -> int:
    doc = chrome_trace(source, meta=meta)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for te in doc["traceEvents"] if te["ph"] != "M")


def metrics_snapshot(recorder: Recorder) -> Dict[str, Any]:
    """Alias for ``Recorder.snapshot()`` so benchmark code imports one
    exporter module for all three output forms."""
    return recorder.snapshot()
