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
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

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


def summarize_file(path: str) -> Dict[str, Any]:
    doc = read_events(path)
    return {
        "schema": doc["header"].get("schema", "?"),
        "spans": summarize_events(doc["events"]),
        "counters": doc["footer"].get("counters", {}),
        "gauges": doc["footer"].get("gauges", {}),
        "events": len(doc["events"]),
        "events_dropped": doc["footer"].get("events_dropped", 0),
    }


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
