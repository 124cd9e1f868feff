"""Per-span-name latency summary of a recorded trace.

``python -m repro_torch.core.telemetry summarize <trace>`` prints, for every
span name in a JSONL event log or Chrome ``trace.json``::

    name  count  total_ms  p50_ms  p95_ms  p99_ms

plus the aggregated counters from the footer (compile events, cache
hit/miss, dispatch counts) when the file carries them.  This is the
human-facing end of the telemetry pipeline: run a script with
``REPRO_TELEMETRY=jsonl:trace.jsonl``, then summarize the file.

Percentiles use linear interpolation between order statistics — the same
definition as ``numpy.percentile``'s default — implemented in pure Python
so the telemetry package stays stdlib-only.

When a trace holds device spans (``device.*``, the port's), the summary
adds a ``device`` section: the device's idle time between them, by the
innermost host span open at the start of each gap
(:func:`device_summary`).  A trace without them summarizes as the
reference's does.
"""

from __future__ import annotations

import heapq
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: the name prefix of device spans
DEVICE_PREFIX = "device."

from repro_torch.core.telemetry.export import read_events


def percentile(values: Sequence[float], q: float) -> float:
    """numpy-compatible linear-interpolation percentile (0 <= q <= 100)."""
    if not values:
        raise ValueError("percentile() of empty sequence")
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def summarize_events(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """{span name -> {count, total_ms, p50_ms, p95_ms, p99_ms}}."""
    durs: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("kind") == "span" and "dur" in ev:
            durs.setdefault(ev["name"], []).append(float(ev["dur"]))
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(durs):
        ms = [d * 1e3 for d in durs[name]]
        out[name] = {
            "count": len(ms),
            "total_ms": sum(ms),
            "p50_ms": percentile(ms, 50),
            "p95_ms": percentile(ms, 95),
            "p99_ms": percentile(ms, 99),
        }
    return out


def idle_gaps(intervals: Sequence[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """The gaps between the union of (start, end) intervals, in order."""
    gaps: List[Tuple[float, float]] = []
    reach: Optional[float] = None
    for a, b in sorted(intervals):
        if reach is not None and a > reach:
            gaps.append((reach, a))
        reach = b if reach is None else max(reach, b)
    return gaps


def gaps_by_host_span(gaps: Sequence[Tuple[float, float]],
                      host: Sequence[Tuple[float, float, str]]
                      ) -> Dict[str, Dict[str, float]]:
    """{name: {gaps, total_ms}}: each (start, end) gap under the innermost
    of the (start, end, name) host spans open at its start (the latest
    begun, the shortest of those begun together), ``(none)`` where none
    was."""
    ordered = sorted(host)
    open_: List[Tuple[float, float, str]] = []     # (-start, end, name)
    out: Dict[str, Dict[str, float]] = {}
    i = 0
    for g0, g1 in sorted(gaps):                    # a sweep, in time order
        while i < len(ordered) and ordered[i][0] <= g0:
            s, e, name = ordered[i]
            heapq.heappush(open_, (-s, e, name))
            i += 1
        while open_ and open_[0][1] <= g0:         # closed before the gap
            heapq.heappop(open_)
        label = open_[0][2] if open_ else "(none)"
        agg = out.setdefault(label, {"gaps": 0, "total_ms": 0.0})
        agg["gaps"] += 1
        agg["total_ms"] += (g1 - g0) * 1e3
    return out


def device_summary(events: List[Dict[str, Any]],
                   device: Optional[Sequence[Tuple[float, float]]] = None
                   ) -> Optional[Dict[str, Any]]:
    """The device's busy and idle time over the trace's device spans, or
    over ``device``, (start, end) intervals on the events' clock (a
    profile's records, ``cudamon.profiler_records``), each idle gap named
    by :func:`gaps_by_host_span` over the other spans; None when there is
    no device interval."""
    spans = [ev for ev in events if ev.get("kind") == "span" and "dur" in ev]
    if device is None:
        device = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in spans
                  if ev["name"].startswith(DEVICE_PREFIX)]
    if not device:
        return None
    host = [(ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in spans
            if not ev["name"].startswith(DEVICE_PREFIX)]
    gaps = idle_gaps(device)
    window = max(b for _, b in device) - min(a for a, _ in device)
    idle = sum(b - a for a, b in gaps)
    by = gaps_by_host_span(gaps, host)
    return {"intervals": len(device), "window_ms": window * 1e3,
            "busy_ms": (window - idle) * 1e3, "idle_ms": idle * 1e3,
            "idle_by_host_span": dict(sorted(
                by.items(), key=lambda kv: -kv[1]["total_ms"]))}


def summarize_file(path: str) -> Dict[str, Any]:
    doc = read_events(path)
    out = {
        "schema": doc["header"].get("schema", "?"),
        "spans": summarize_events(doc["events"]),
        "counters": doc["footer"].get("counters", {}),
        "gauges": doc["footer"].get("gauges", {}),
        "events": len(doc["events"]),
        "events_dropped": doc["footer"].get("events_dropped", 0),
    }
    device = device_summary(doc["events"])
    if device is not None:
        out["device"] = device
    return out


def format_summary(summary: Dict[str, Any]) -> str:
    lines = [f"trace: {summary['events']} events "
             f"({summary['events_dropped']} dropped) "
             f"schema {summary['schema']}"]
    spans = summary["spans"]
    if spans:
        w = max(len(n) for n in spans)
        lines.append(f"{'span'.ljust(w)}  {'count':>6} {'total_ms':>10} "
                     f"{'p50_ms':>9} {'p95_ms':>9} {'p99_ms':>9}")
        for name, s in spans.items():
            lines.append(
                f"{name.ljust(w)}  {s['count']:>6d} {s['total_ms']:>10.3f} "
                f"{s['p50_ms']:>9.3f} {s['p95_ms']:>9.3f} "
                f"{s['p99_ms']:>9.3f}")
    else:
        lines.append("(no span events)")
    if summary["counters"]:
        lines.append("counters:")
        for name in sorted(summary["counters"]):
            lines.append(f"  {name} = {summary['counters'][name]:g}")
    device = summary.get("device")
    if device:
        lines.append(
            f"device: {device['intervals']} device spans over "
            f"{device['window_ms']:.3f} ms, busy {device['busy_ms']:.3f} ms, "
            f"idle {device['idle_ms']:.3f} ms; idle by the host span open "
            f"at each gap's start:")
        by = device["idle_by_host_span"]
        if by:
            w = max(len(n) for n in by)
            lines.append(f"  {'host span'.ljust(w)}  {'gaps':>6} "
                         f"{'idle_ms':>10}")
            for name, g in by.items():
                lines.append(f"  {name.ljust(w)}  {g['gaps']:>6d} "
                             f"{g['total_ms']:>10.3f}")
    return "\n".join(lines)


def main(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.telemetry",
        description="summarize a repro.telemetry/v1 trace")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize",
                       help="per-span count/total/p50/p95/p99 of a trace")
    s.add_argument("trace", help="JSONL event log or Chrome trace.json")
    s.add_argument("--json", action="store_true",
                   help="machine-readable output instead of the table")
    args = ap.parse_args(argv)

    summary = summarize_file(args.trace)
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print(format_summary(summary))
    return 0
