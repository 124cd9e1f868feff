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
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Optional

#: the aggregate of every compile the port makes (builds, Triton
#: compiles, graph captures)
COMPILE_COUNTER = "cuda.compile"
BUILD = "cuda.build"
GRAPH_CAPTURE = "cuda.graph_capture"
TRITON_COMPILE = "triton.compile"

_lock = threading.Lock()
#: which Triton hook counts compiles: None until :func:`watch_triton` ran
_triton_route: Optional[str] = None


def _current():
    from repro_torch.core import telemetry
    return telemetry._recorder


def install() -> None:
    """Called by ``telemetry.configure`` when recording starts.  nvcc builds
    and graph captures report through :func:`record_build` and
    :func:`graph_captured`, which need no registration; the Triton hook is
    installed here only if Triton is already loaded (importing it is the
    kernels' business, at their first launch)."""
    if "triton" in sys.modules:
        watch_triton()


def record_build(source: str, t0: float, t1: float, ok: bool) -> None:
    """One ``nvcc`` run over ``csrc/<source>.cu`` between the
    ``time.perf_counter()`` stamps ``t0`` and ``t1``."""
    rec = _current()
    if rec is None:
        return
    rec.counter(BUILD, proc="cuda")
    rec.counter(COMPILE_COUNTER, proc="cuda")
    start = max(t0 - rec.epoch, 0.0)
    rec._record({
        "kind": "span", "name": BUILD, "ts": start,
        "dur": max(t1 - rec.epoch, 0.0) - start, "sid": next(rec._ids),
        "parent": None, "proc": "cuda",
        "tid": threading.current_thread().name,
        "attrs": {"source": source, "ok": ok}})


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
