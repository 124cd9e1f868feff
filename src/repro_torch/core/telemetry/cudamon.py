"""Count the port's compiles as telemetry events (the port's ``jaxmon``).

The reference counts XLA's backend compiles through ``jax.monitoring``, so
that a recompile storm shows in every trace.  The port compiles in three
other places, and each reports here:

  * ``_build.build()`` runs one ``nvcc`` per CUDA source: a ``cuda.build``
    span (start to exit of that ``nvcc``; the sources build in parallel, so
    the spans overlap) and the ``cuda.build`` counter, per source;
  * ``ServingEngine`` captures its decode step as a CUDA graph: the
    ``cuda.graph_capture`` counter and an instant naming the site;
  * Triton JIT-compiles a kernel for each new (kernel, constexprs,
    ``num_warps``): the ``triton.compile`` counter and an instant naming the
    kernel, through the compile hook the installed Triton offers
    (:func:`watch_triton`, installed when the Triton kernels are first
    built: nothing here imports Triton).  The H100 host's Triton 3.6.0
    offers ``knobs.runtime.jit_post_compile_hook``; a Triton with no hook
    at all leaves its compiles uncounted, and ``triton_route()`` says so.

:data:`COMPILE_COUNTER` aggregates the builds, the Triton compiles and the
graph captures.  Every entry point reads the *current* global recorder, so
with telemetry off it returns at once, and turning telemetry on later needs
no re-registration.

It is also where the device's clock meets the recorder's:

  * :func:`anchor` (at ``configure("on")`` and every ``reset()``, only if
    CUDA is initialised; else lazily, at the first device span) records one
    timing event, waits for it, and reads ``time.perf_counter()`` right
    after: a completed event ``e`` then ran at ``anchor_host +
    anchor.elapsed_time(e) / 1e3`` on the recorder's clock
    (:func:`device_time`);
  * :class:`DeviceSpans` turns two marks in a device's queue into a span on
    proc ``"device"`` (its own Chrome track), under the host span open when
    it is declared, whose ``uid``/``step`` it carries.  On CUDA a mark is a
    timing event from a small reused pool (or one of the pair a captured
    graph records itself), and the span waits in the recorder until the
    events have completed: it is recorded at the next ``settle()``, which
    the engine calls outside its spans, or when the ring is read.  On the
    CPU the work is synchronous, a mark is ``perf_counter`` and the span is
    recorded at once.  With telemetry off nothing touches ``torch.cuda``;
  * :func:`profiler_records` places a ``torch.profiler`` session's device
    records on the same clock (Kineto stamps them on the ``time.time_ns()``
    base, which the recorder read beside its epoch), so that the idle gaps
    of a profile of CUDA activity alone can be named by the program's host
    spans (``summarize.device_summary``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: the aggregate of every compile the port makes (builds, Triton
#: compiles, graph captures)
COMPILE_COUNTER = "cuda.compile"
BUILD = "cuda.build"
GRAPH_CAPTURE = "cuda.graph_capture"
TRITON_COMPILE = "triton.compile"

#: the proc (Chrome track) of device spans
DEVICE_PROC = "device"
#: what a device span takes over from the host span that enqueued it
CARRIED = ("uid", "step")

_lock = threading.Lock()
#: which Triton hook counts compiles: None until :func:`watch_triton` ran
_triton_route: Optional[str] = None


def _current():
    from repro_torch.core import telemetry
    return telemetry._recorder


#: device index -> whether it times events recorded inside a graph
_graph_timing: Dict[int, bool] = {}


def install(rec) -> None:
    """Called by ``telemetry.configure`` when ``rec`` starts recording.
    nvcc builds and graph captures report through :func:`record_build` and
    :func:`graph_captured`, which need no registration; the Triton hook is
    installed here only if Triton is already loaded (importing it is the
    kernels' business, at their first launch).  Then :func:`anchor`."""
    if "triton" in sys.modules:
        watch_triton()
    anchor(rec)


def anchor(rec) -> None:
    """Tie the current CUDA device's clock to ``rec``'s, only if this
    process has initialised CUDA (nothing is imported or initialised here):
    one timing event, recorded and waited for, then ``perf_counter``."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        _anchor(rec, torch.cuda.current_device())


def _anchor(rec, index: int) -> Tuple[Any, float]:
    import torch
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(index))
    event.synchronize()
    rec.anchors[index] = (event, time.perf_counter())
    return rec.anchors[index]


def device_time(rec, event: Any, index: int) -> float:
    """When the completed timing ``event`` ran on device ``index``, on
    ``rec``'s clock (``perf_counter`` seconds); anchors the device first if
    ``rec`` has no anchor there."""
    ref, host = rec.anchors.get(index) or _anchor(rec, index)
    return host + ref.elapsed_time(event) / 1e3


class DeviceSpans:
    """Device intervals of one site's work (the serving engine's) as
    telemetry spans on the recorder's clock (module docstring)."""

    def __init__(self, device: Any):
        self.device = device             # a torch.device
        self._free: List[Any] = []       # timing events to record again

    def mark(self) -> Any:
        """A point in the device's queue: a recorded timing event on CUDA,
        ``perf_counter`` elsewhere; None with telemetry off."""
        if _current() is None:
            return None
        if self.device.type != "cuda":
            return time.perf_counter()
        import torch
        event = (self._free.pop() if self._free
                 else torch.cuda.Event(enable_timing=True))
        event.record(torch.cuda.current_stream(self.device))
        return event

    def span(self, name: str, start: Any, end: Any,
             pooled: bool = True) -> None:
        """The device's time from mark ``start`` to mark ``end`` as the span
        ``name`` on proc ``"device"``, under the innermost host span open
        now.  ``pooled=False`` for events the caller keeps (a graph's)."""
        rec = _current()
        if rec is None or start is None or end is None:
            return
        host = rec.open_span()
        parent = host.sid if host is not None else None
        attrs = {k: host.attrs[k] for k in CARRIED
                 if host is not None and k in host.attrs}
        tid = str(self.device)
        if self.device.type != "cuda":
            rec.record_span(name, start, end - start, parent=parent,
                            proc=DEVICE_PROC, tid=tid, **attrs)
            return
        index = self.device.index
        if index is None:
            import torch
            index = torch.cuda.current_device()

        def record() -> bool:
            if not end.query():
                return False
            t0 = device_time(rec, start, index)
            t1 = device_time(rec, end, index)
            rec.record_span(name, t0, t1 - t0, parent=parent,
                            proc=DEVICE_PROC, tid=tid, **attrs)
            if pooled:
                self._free += (start, end)
            return True
        rec.defer(record)

    @staticmethod
    def settle() -> None:
        """Record the device spans whose events have completed."""
        rec = _current()
        if rec is not None:
            rec.settle()


def graph_events_timed(device: Any) -> bool:
    """Whether CUDA on ``device`` times events recorded inside a captured
    CUDA graph (``external=True`` event nodes) against one recorded outside
    it; probed once per device on a graph of one small kernel."""
    import torch
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _graph_timing:
        _graph_timing[index] = _probe_graph_timing(torch, index)
    return _graph_timing[index]


def _probe_graph_timing(torch: Any, index: int) -> bool:
    with torch.cuda.device(index):
        x = torch.zeros(1, device="cuda")
        x.add_(1)                        # the kernel loaded before capture
        torch.cuda.synchronize()
        ref = torch.cuda.Event(enable_timing=True)
        try:
            marks = [torch.cuda.Event(enable_timing=True, external=True)
                     for _ in range(2)]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                marks[0].record()
                x.add_(1)
                marks[1].record()
            ref.record()
            graph.replay()
            torch.cuda.synchronize()
            into = ref.elapsed_time(marks[0])
            inside = marks[0].elapsed_time(marks[1])
        except (RuntimeError, TypeError):
            return False
    return into >= 0.0 and inside >= 0.0


def profiler_records(prof: Any) -> List[Tuple[str, float, float]]:
    """A ``torch.profiler`` profile's device records (kernels, copies,
    sets; not the ranges Kineto copies onto the device's timeline) as
    (name, start, end) in seconds since the active recorder's epoch, as an
    event's ``ts``, sorted by start."""
    import torch
    rec = _current()
    if rec is None:
        raise RuntimeError("telemetry is off: there is no recorder's clock "
                           "to put the profile's records on")
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() != cuda or (annotation and annotation()):
            continue
        start = (e.start_ns() - rec.epoch_ns) / 1e9
        out.append((e.name(), start, start + e.duration_ns() / 1e9))
    return sorted(out, key=lambda r: r[1])


def record_build(source: str, t0: float, t1: float, ok: bool) -> None:
    """One ``nvcc`` run over ``csrc/<source>.cu`` between the
    ``time.perf_counter()`` stamps ``t0`` and ``t1``."""
    rec = _current()
    if rec is None:
        return
    rec.counter(BUILD, proc="cuda")
    rec.counter(COMPILE_COUNTER, proc="cuda")
    start = max(t0, rec.epoch)
    rec.record_span(BUILD, start, max(t1, rec.epoch) - start, proc="cuda",
                    source=source, ok=ok)


def graph_captured(site: str) -> None:
    """One CUDA-graph capture at ``site`` (who captured)."""
    rec = _current()
    if rec is None:
        return
    rec.counter(GRAPH_CAPTURE, proc="cuda")
    rec.counter(COMPILE_COUNTER, proc="cuda")
    rec.instant(GRAPH_CAPTURE, proc="cuda", site=site)


def _on_triton_compile(*args: Any, **kwargs: Any) -> None:
    # Triton's hooks pass keywords (key, repr, fn, compile, ...); ``fn``
    # carries the kernel's name.  Return None: Triton's pre-compile hook
    # skips the compile on a truthy return.
    rec = _current()
    if rec is None:
        return None
    fn = kwargs.get("fn")
    name = getattr(fn, "name", None) or getattr(fn, "__name__", repr(fn))
    rec.counter(TRITON_COMPILE, proc="triton")
    rec.counter(COMPILE_COUNTER, proc="triton")
    rec.instant(TRITON_COMPILE, proc="triton", kernel=str(name))
    return None


def watch_triton() -> str:
    """Install the compile hook of the loaded Triton, once; returns which
    route counts Triton's compiles: ``knobs.runtime.jit_post_compile_hook``
    (Triton 3.4 on), ``JITFunction.compiled_hook`` (3.0-3.3, after the
    compile), ``JITFunction.cache_hook`` (older: before the compile), or
    ``"none"`` when it offers none."""
    global _triton_route
    with _lock:
        if _triton_route is not None:
            return _triton_route
        import triton
        from triton.runtime import jit
        runtime = getattr(getattr(triton, "knobs", None), "runtime", None)
        if runtime is not None and hasattr(runtime, "jit_post_compile_hook"):
            prev = runtime.jit_post_compile_hook
            runtime.jit_post_compile_hook = _chain(prev)
            _triton_route = "knobs.runtime.jit_post_compile_hook"
        elif hasattr(jit.JITFunction, "compiled_hook"):
            jit.JITFunction.compiled_hook = _chain(
                jit.JITFunction.compiled_hook)
            _triton_route = "JITFunction.compiled_hook"
        elif hasattr(jit.JITFunction, "cache_hook"):
            jit.JITFunction.cache_hook = _chain(jit.JITFunction.cache_hook)
            _triton_route = "JITFunction.cache_hook"
        else:
            _triton_route = "none"
        return _triton_route


def _chain(prev):
    """Our hook, then a hook installed before ours (its return value
    kept)."""
    if prev is None:
        return _on_triton_compile

    def hook(*args: Any, **kwargs: Any):
        _on_triton_compile(*args, **kwargs)
        return prev(*args, **kwargs)
    return hook


def triton_route() -> Optional[str]:
    return _triton_route
