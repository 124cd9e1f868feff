"""Runtime telemetry of the port (schema ``repro.telemetry/v1``).

The port of ``repro.core.telemetry``: structured spans (monotonic
start/duration, parent nesting), instants, counters and gauges in a
thread-safe bounded ring buffer, with three exporters (JSONL event log,
Chrome/Perfetto ``trace.json``, flat metrics snapshot) and a CLI::

    python -m repro_torch.core.telemetry summarize <trace>

The schema is the reference's, so either package's ``summarize`` reads the
other's traces.  Control is environmental, with the reference's contract,
and zero-cost when off::

    REPRO_TELEMETRY=off          # default: module-level no-op fast path
    REPRO_TELEMETRY=on           # record into the in-memory ring
    REPRO_TELEMETRY=jsonl:PATH   # record + flush the JSONL log at exit
    REPRO_TELEMETRY_CAP=65536    # ring capacity (events)

Instrumentation sites call the module-level helpers::

    from repro_torch.core import telemetry as tel
    with tel.span("serving.decode_step", proc="engine", active=n):
        ...                       # around the graph's replay, never inside
    tel.counter("tuning.cache.hit")
    tel.gauge("serving.queue_depth", len(queue), proc="engine")

When disabled (the default) ``span`` returns a shared no-op context manager
and ``instant``/``counter``/``gauge`` return at once: an instrumented hot
path pays one module-attribute load and one ``is None`` check.  Events fire
on the host only, never inside a captured CUDA graph, and add no device
synchronise: a span around asynchronous work closes where the caller
already waits for the device.

Enabling telemetry also installs the compile bridge
(:mod:`repro_torch.core.telemetry.cudamon`, the port's ``jaxmon``): nvcc
builds, Triton compiles and CUDA-graph captures become counters (and the
builds spans) under the aggregate ``cuda.compile``.
"""

from __future__ import annotations

import atexit
import os
from typing import Any, Dict, List, Optional

from repro_torch.core.telemetry.recorder import (DEFAULT_CAPACITY, NOOP_SPAN,
                                                 Recorder, RingLog, SCHEMA,
                                                 safe_attrs)
from repro_torch.core.telemetry.export import (chrome_trace, metrics_snapshot,
                                               read_events,
                                               write_chrome_trace,
                                               write_jsonl)
from repro_torch.core.telemetry.summarize import (format_summary, percentile,
                                                  summarize_events,
                                                  summarize_file)

__all__ = [
    "SCHEMA", "ENV", "CAP_ENV", "Recorder", "RingLog", "configure",
    "enabled", "recorder", "span", "instant", "counter", "gauge",
    "snapshot", "events", "reset", "flush", "safe_attrs", "write_jsonl",
    "write_chrome_trace", "chrome_trace", "read_events", "metrics_snapshot",
    "summarize_file", "summarize_events", "format_summary", "percentile",
    "DEFAULT_CAPACITY",
]

ENV = "REPRO_TELEMETRY"
CAP_ENV = "REPRO_TELEMETRY_CAP"

_recorder: Optional[Recorder] = None      # None <=> disabled fast path
_jsonl_path: Optional[str] = None


def configure(mode: Optional[str] = None,
              capacity: Optional[int] = None) -> Optional[Recorder]:
    """(Re)configure global telemetry; returns the active recorder or None.

    ``mode`` follows the env contract: ``"off"``/``""``/None disables,
    ``"on"`` records in memory, ``"jsonl:<path>"`` records and flushes the
    JSONL log at interpreter exit (or on :func:`flush`).  Reconfiguring
    replaces the recorder (prior events are dropped — snapshot first).
    """
    global _recorder, _jsonl_path
    mode = (mode or "off").strip()
    if mode.lower() in ("", "off", "0", "false"):
        _recorder, _jsonl_path = None, None
        return None
    if capacity is None:
        capacity = int(os.environ.get(CAP_ENV, DEFAULT_CAPACITY))
    path: Optional[str] = None
    if mode.lower().startswith("jsonl:"):
        path = mode[len("jsonl:"):]
        if not path:
            raise ValueError(f"{ENV}=jsonl:<path> needs a path")
    elif mode.lower() not in ("on", "1", "true"):
        raise ValueError(
            f"bad {ENV} value {mode!r}: expected off|on|jsonl:<path>")
    _recorder = Recorder(capacity=capacity)
    _jsonl_path = path
    from repro_torch.core.telemetry import cudamon
    cudamon.install()
    return _recorder


def enabled() -> bool:
    return _recorder is not None


def recorder() -> Optional[Recorder]:
    """The active recorder (None when disabled)."""
    return _recorder


# ---- recording fast paths ------------------------------------------------
def span(name: str, proc: str = "main", **attrs: Any):
    rec = _recorder
    if rec is None:
        return NOOP_SPAN
    return rec.span(name, proc=proc, **attrs)


def instant(name: str, proc: str = "main", **attrs: Any) -> None:
    rec = _recorder
    if rec is not None:
        rec.instant(name, proc=proc, **attrs)


def counter(name: str, value: float = 1.0, proc: str = "main") -> None:
    rec = _recorder
    if rec is not None:
        rec.counter(name, value, proc=proc)


def gauge(name: str, value: float, proc: str = "main") -> None:
    rec = _recorder
    if rec is not None:
        rec.gauge(name, value, proc=proc)


def snapshot() -> Dict[str, Any]:
    """Metrics snapshot of the active recorder ({} when disabled)."""
    rec = _recorder
    return rec.snapshot() if rec is not None else {}


def events() -> List[Dict[str, Any]]:
    rec = _recorder
    return rec.event_list() if rec is not None else []


def reset() -> None:
    """Clear the active recorder's events and aggregates (keep recording)."""
    rec = _recorder
    if rec is not None:
        rec.clear()


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the JSONL log now (to ``path`` or the ``jsonl:`` env path)."""
    rec = _recorder
    target = path or _jsonl_path
    if rec is None or target is None:
        return None
    write_jsonl(target, rec)
    return target


@atexit.register
def _flush_at_exit() -> None:  # pragma: no cover - exercised via subprocess
    try:
        flush()
    except Exception:
        pass


# env bootstrap: a bad value must fail loudly at import, not silently
# record nothing while the user thinks they are tracing
configure(os.environ.get(ENV))
