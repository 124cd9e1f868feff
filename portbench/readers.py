"""Arithmetic that several metric readers share.

A reader (``metrics/<name>.py``) defines ``read(ctx)`` and returns a
number, or None when the run gave it nothing to read.  ``ctx`` is
``run.Context``: the window, every request submitted, the spans the
program recorded in the window (traced run), the profiled stretch, the
configuration, its model arithmetic (``counts``) and the engine's
geometry.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np

from portbench import counts


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between ranks), None if empty."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def in_window(ctx: Any, t: float) -> bool:
    return ctx.t_open <= t < ctx.t_close


def arrived(ctx: Any) -> List[Any]:
    return [r for r in ctx.requests if in_window(ctx, r.arrival_time)]


def waited(ctx: Any, t_event: float, t_from: float) -> float:
    """Seconds from ``t_from`` to an event, or to the end of the wait for
    one that has not come (the time waited so far)."""
    end = ctx.t_waited if math.isnan(t_event) else t_event
    return end - t_from


def spans(ctx: Any, name: str) -> List[float]:
    """Durations (s) of the program's ``name`` spans begun in the window."""
    return [dur for n, start, dur in ctx.spans
            if n == name and in_window(ctx, start)]


def useful_flops(ctx: Any) -> float:
    """Model flops of the work done in the window: each prefill whose
    first token came in it (its prompt without pads), each decoded token
    that came in it (the configuration's counts, ``counts.py`` by
    default)."""
    total = 0.0
    for r in ctx.requests:
        if in_window(ctx, r.t_first_token):
            total += ctx.counts.prefill_flops(ctx.arch, r.prompt_len)
        for i, t in enumerate(r.t_tokens[1:], start=1):
            if in_window(ctx, t):
                total += ctx.counts.decode_token_flops(ctx.arch,
                                                       r.prompt_len + i - 1)
    return total


def mfu(ctx: Any) -> Optional[float]:
    """Useful model flops over the window's seconds at the bf16 peak, %."""
    flops = useful_flops(ctx)
    if not flops:
        return None
    return 100.0 * flops / (ctx.seconds * counts.PEAK_BF16_FLOPS)

