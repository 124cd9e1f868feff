"""Structured-event recorder: spans, counters, gauges in a bounded ring.

The paper's Eq.-4 portability metric and the serving SLO report are only as
trustworthy as the instrumentation behind them, so every measured number in
this repo should be able to carry provenance: *what* ran, *when*, *under
which parameters*, nested inside *which* larger operation.  This module is
the zero-dependency (stdlib-only) substrate for that:

  * :class:`Recorder` holds a thread-safe bounded ring buffer of event
    dicts (schema ``repro.telemetry/v1``) plus aggregated counters and
    last-value gauges that never suffer ring eviction;
  * spans measure ``time.perf_counter()`` start/duration and nest — each
    thread keeps its own span stack, so a child span records its parent's
    id and exporters can rebuild the tree;
  * events are timestamped relative to the recorder's epoch (monotonic),
    with the wall-clock epoch recorded once for provenance.

Event fields (all events)::

    kind   "span" | "instant" | "counter" | "gauge"
    name   dotted event name ("serving.decode_step", "tuning.cache.hit")
    ts     seconds since recorder epoch (monotonic)
    proc   logical process/track label ("engine", "tuning", ...)
    tid    recording thread's name
    attrs  {str: scalar} tags (kernel, backend, uid, ...)

plus ``dur`` (seconds) / ``sid`` / ``parent`` on spans and ``value`` on
counter/gauge samples.

The port's copy of ``repro.core.telemetry.recorder`` (same schema, so either
package's ``summarize`` reads the other's traces).  Instrumented hot paths
record only on the host, around kernel launches and graph replays, never
inside a captured CUDA graph (a replay runs no Python): an instrumented
program emits its events once per *call*, adds no device synchronise, and
its results are bitwise independent of whether telemetry is on.

The port adds what the reference has no need of: ``record_span`` records
a span measured elsewhere (a device interval timed by CUDA events), and
``defer``/``settle`` hold such a span until its events have completed, so
it is recorded after the work's own synchronise; reading the ring settles
first.  ``epoch_ns`` and ``anchors`` tie the profiler's clock and the
device's to this one (``cudamon``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

SCHEMA = "repro.telemetry/v1"

#: default ring capacity (events); override per-Recorder or via
#: ``REPRO_TELEMETRY_CAP`` (read in __init__.py's env bootstrap)
DEFAULT_CAPACITY = 65536

_SCALARS = (bool, int, float, str, tuple, type(None))


def safe_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only JSON-friendly scalar tags; everything else becomes repr.

    Instrumentation sites pass whatever they have (params dicts may hold
    tuples, callers may pass numpy ints) — the ring must never hold live
    array references.
    """
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, _SCALARS):
            out[k] = list(v) if isinstance(v, tuple) else v
        elif isinstance(v, dict):
            out[k] = safe_attrs(v)
        elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[k] = v.item()          # numpy scalar (never pass a tensor)
        else:
            out[k] = repr(v)
    return out


class _Span:
    """Context manager recording one span event on exit."""

    __slots__ = ("_rec", "name", "proc", "attrs", "sid", "parent", "_t0")

    def __init__(self, rec: "Recorder", name: str, proc: str,
                 attrs: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.proc = proc
        self.attrs = attrs
        self.sid = next(rec._ids)
        self.parent: Optional[int] = None
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        stack = self._rec._stack()
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        stack = self._rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._rec._record({
            "kind": "span", "name": self.name,
            "ts": self._t0 - self._rec.epoch, "dur": t1 - self._t0,
            "sid": self.sid, "parent": self.parent,
            "proc": self.proc, "tid": threading.current_thread().name,
            "attrs": self.attrs,
        })


class NoopSpan:
    """Shared do-nothing span for the disabled fast path (reentrant,
    stateless — one instance serves every call site)."""

    __slots__ = ()

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = NoopSpan()


class Recorder:
    """Thread-safe bounded event ring + counter/gauge aggregates."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = int(capacity)
        self.events: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.dropped = 0                     # events evicted from the ring
        self.epoch = time.perf_counter()     # monotonic zero for ts fields
        # the epoch on the time.time_ns() base, read beside it: the base of
        # torch.profiler's records (cudamon.profiler_records)
        self.epoch_ns = time.time_ns()
        self.epoch_unix = time.time()        # wall-clock provenance
        #: device index -> (timing event, perf_counter read just after it
        #: completed): where device time meets this clock (cudamon)
        self.anchors: Dict[int, Tuple[Any, float]] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        # callables that record an event once its times are known, each
        # returning False while they are not (deferred device spans)
        self._pending: List[Callable[[], bool]] = []

    # ---- internals ----------------------------------------------------
    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(ev)

    def _now(self) -> float:
        return time.perf_counter() - self.epoch

    # ---- recording API -------------------------------------------------
    def span(self, name: str, proc: str = "main", **attrs: Any) -> _Span:
        return _Span(self, name, proc, safe_attrs(attrs))

    def open_span(self) -> Optional[_Span]:
        """The innermost span open on the calling thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    def record_span(self, name: str, start: float, dur: float,
                    parent: Optional[int] = None, proc: str = "main",
                    tid: Optional[str] = None, **attrs: Any) -> int:
        """Record a span measured elsewhere: ``start`` on this recorder's
        clock (``time.perf_counter()`` seconds), ``dur`` in seconds, under
        the span ``parent`` (a sid); returns its sid."""
        sid = next(self._ids)
        self._record({
            "kind": "span", "name": name, "ts": start - self.epoch,
            "dur": dur, "sid": sid, "parent": parent, "proc": proc,
            "tid": tid or threading.current_thread().name,
            "attrs": safe_attrs(attrs),
        })
        return sid

    def defer(self, record: Callable[[], bool]) -> None:
        """Hold ``record`` until :meth:`settle` finds it ready: it records
        its event and returns True, or returns False to be asked again."""
        with self._lock:
            self._pending.append(record)

    def settle(self) -> None:
        """Record every deferred event that is ready, in order.  Reading
        the ring settles first."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        waiting = [record for record in pending if not record()]
        if waiting:
            with self._lock:
                self._pending[:0] = waiting

    def instant(self, name: str, proc: str = "main", **attrs: Any) -> None:
        stack = self._stack()
        self._record({
            "kind": "instant", "name": name, "ts": self._now(),
            "parent": stack[-1].sid if stack else None, "proc": proc,
            "tid": threading.current_thread().name,
            "attrs": safe_attrs(attrs),
        })

    def counter(self, name: str, value: float = 1.0,
                proc: str = "main") -> float:
        """Increment an aggregated counter (and log the new total as a
        counter sample so Chrome tracing can draw the track)."""
        with self._lock:
            total = self.counters.get(name, 0.0) + value
            self.counters[name] = total
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append({
                "kind": "counter", "name": name, "ts": self._now(),
                "value": total, "proc": proc,
                "tid": threading.current_thread().name, "attrs": {},
            })
        return total

    def gauge(self, name: str, value: float, proc: str = "main") -> None:
        """Record the current value of a sampled quantity (queue depth,
        slot occupancy).  Last value wins in the snapshot; every sample
        lands in the ring for the trace timeline."""
        with self._lock:
            self.gauges[name] = float(value)
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append({
                "kind": "gauge", "name": name, "ts": self._now(),
                "value": float(value), "proc": proc,
                "tid": threading.current_thread().name, "attrs": {},
            })

    # ---- reading -------------------------------------------------------
    def drain(self) -> List[Dict[str, Any]]:
        """Copy-and-clear the event ring (aggregates are kept)."""
        self.settle()
        with self._lock:
            out = list(self.events)
            self.events.clear()
        return out

    def event_list(self) -> List[Dict[str, Any]]:
        self.settle()
        with self._lock:
            return list(self.events)

    def snapshot(self) -> Dict[str, Any]:
        """Flat metrics dict benchmarks can embed in their artifacts:
        counters, gauges (last value), per-span-name count/total, and the
        ring-eviction count (so a truncated trace is visible as such)."""
        self.settle()
        with self._lock:
            events = list(self.events)
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            dropped = self.dropped
        spans: Dict[str, Dict[str, float]] = {}
        for ev in events:
            if ev["kind"] != "span":
                continue
            agg = spans.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += ev["dur"]
        return {"schema": SCHEMA, "counters": counters, "gauges": gauges,
                "spans": spans, "events_recorded": len(events),
                "events_dropped": dropped}

    def clear(self) -> None:
        """Drop every event, aggregate, deferred event and anchor."""
        with self._lock:
            self.events.clear()
            self.counters.clear()
            self.gauges.clear()
            self.dropped = 0
            self._pending = []
            self.anchors = {}


class RingLog:
    """Tiny always-on bounded record stream for subsystems that must keep
    their own history regardless of whether global telemetry is enabled
    (``models/attention``'s dispatch log).  Thread-safe; eviction drops the
    oldest records, never the newest."""

    def __init__(self, capacity: int = 256) -> None:
        self._events: Deque[Dict[str, Any]] = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(record)

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
