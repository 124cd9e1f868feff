"""The traced stretches: ``torch.profiler`` over short steady stretches.

The profiler on the card can drop the first device records of a session
(the port's ``chip_smoke.py::profiling`` learned this), so ``FILLER``
spin kernels (``torch.cuda._sleep``) go first and take the loss.  Raw
Kineto events are read (no ``FunctionEvent`` tree is built: that costs
~70 us a record on the host).

Two kinds of stretch:

  * quiet (``host=False``): CUDA activity alone, so the host runs as it
    does untraced.  The stretch runs from the end of the last filler
    kernel to the end of the last device record.  It gives each device
    activity (kernels, copies, sets) as (name, start, end) in seconds
    from the stretch's start, the busy time (the union of those
    intervals) and the stretch's length: every device metric reads it;
  * labelled (``host=True``): host activity too, marked by a
    ``record_function``; only records inside the mark count.  Host
    tracing slows the loop, so it only names the idle gaps, each by what
    the host was doing when it began (the innermost host record open
    then: an ATen op, a CUDA runtime call, the harness's mark, or
    ``python`` when none was).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch

FILLER = 10000
FILLER_KERNEL = "spin_kernel"
MARK = "portbench.stretch"


@dataclasses.dataclass
class Stretch:
    window_s: float
    kernels: List[Tuple[str, float, float]]      # (name, start s, end s)
    busy_s: float
    idle_by_host: Dict[str, float]
    t0: float                                    # engine clock at start
    t1: float


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _annotation(e: Any) -> bool:
    """A range Kineto copied onto the device's timeline, not work: every
    other device record (a kernel, a copy, a set) is the device busy."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name() == MARK or bool(flag and flag())


def profile(run: Callable[[], Tuple[float, float]],
            host: bool = False) -> Stretch:
    """Profile ``run()``, which serves the stretch and returns its (start,
    end) on the engine's clock: quiet, or labelled with ``host``."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(FILLER):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        if host:
            with torch.profiler.record_function(MARK):
                t0, t1 = run()
                torch.cuda.synchronize()
        else:
            t0, t1 = run()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return digest(events, t0, t1) if host else digest_quiet(events, t0, t1)


def digest_quiet(events: Any, t0: float, t1: float) -> Stretch:
    """A ``Stretch`` of raw Kineto events of CUDA activity alone: from the
    end of the last filler kernel to the end of the last other record."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events
           if e.device_type() == cuda and not _annotation(e)]
    filler = [e.end_ns() for e in dev if FILLER_KERNEL in e.name()]
    if not filler:
        raise RuntimeError("the profile lost every filler record")
    a = max(filler)
    work = [(e.name(), e.start_ns(), e.end_ns()) for e in dev
            if FILLER_KERNEL not in e.name() and e.start_ns() >= a]
    if not work:
        raise RuntimeError("the profile holds no record of the stretch")
    b = max(t for _, _, t in work)
    kernels = [(n, (s - a) / 1e9, (t - a) / 1e9) for n, s, t in work]
    busy = _union([(s, t) for _, s, t in kernels])
    return Stretch(window_s=(b - a) / 1e9, kernels=kernels,
                   busy_s=sum(t - s for s, t in busy), idle_by_host={},
                   t0=t0, t1=t1)


def digest(events: Any, t0: float, t1: float) -> Stretch:
    """A labelled ``Stretch`` of raw Kineto events holding one ``MARK``."""
    cuda = torch.autograd.DeviceType.CUDA
    # the host's range (Kineto copies a range onto the device's timeline
    # too, as a gpu_user_annotation)
    mark = [e for e in events
            if e.name() == MARK and e.device_type() != cuda]
    if len(mark) != 1:
        raise RuntimeError(f"the profile holds {len(mark)} stretch marks")
    a, b = mark[0].start_ns(), mark[0].end_ns()
    dev, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= a or s >= b:
            continue
        if e.device_type() == cuda:
            if not _annotation(e) and FILLER_KERNEL not in e.name():
                dev.append((e.name(), (max(s, a) - a) / 1e9,
                            (min(t, b) - a) / 1e9))
        elif e.name() != MARK:
            host.append(((s - a) / 1e9, (t - a) / 1e9, e.name()))
    window = (b - a) / 1e9
    busy = _union([(s, t) for _, s, t in dev])
    gaps, prev = [], 0.0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if prev < window:
        gaps.append((prev, window))
    host.sort()
    idle: Dict[str, float] = defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in gaps:                  # a sweep: gaps come in order
        while i < len(host) and host[i][0] <= g0:
            active.append(host[i])
            i += 1
        active = [r for r in active if r[1] > g0]
        # the innermost record open at the gap's start (the latest start)
        label = max(active)[2] if active else "python"
        idle[label] += g1 - g0
    return Stretch(window_s=window, kernels=dev,
                   busy_s=sum(t - s for s, t in busy),
                   idle_by_host=dict(idle), t0=t0, t1=t1)


def top_ops(stretch: Stretch, n: int = 10) -> List[List[Any]]:
    """The ``n`` device operations that took most time: [name, seconds]."""
    by: Dict[str, float] = defaultdict(float)
    for name, s, t in stretch.kernels:
        by[name[:120]] += t - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def top_gaps(stretch: Stretch, n: int = 10) -> List[List[Any]]:
    """The idle time by what the host was doing: [name, seconds]."""
    return [[k[:120], v] for k, v in sorted(stretch.idle_by_host.items(),
                                            key=lambda kv: -kv[1])[:n]]


def kernel_time(stretch: Stretch, match: str) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds ``match``."""
    hits = [t - s for name, s, t in stretch.kernels if match in name]
    return sum(hits), len(hits)
