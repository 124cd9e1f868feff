"""Arithmetic over the program's device spans, which the readers of
``decode_gap_ms`` and ``prefill_enqueue_share.*`` share.

The engine records ``device.decode_step`` and ``device.prefill`` on the
engine's clock, timed by CUDA events on the card (the host interval of the
same work on the CPU), and splits each ``serving.prefill`` into
``engine.prefill.enqueue`` and ``engine.prefill.wait``.  A program that
records none of them gives these readers nothing to read: they return
None.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from portbench import readers


def intervals(ctx: Any, name: str) -> List[Tuple[float, float]]:
    """(start, end) of every ``name`` span, in order of start."""
    return sorted((start, start + dur) for n, start, dur in ctx.spans
                  if n == name)


def decode_gaps(ctx: Any) -> List[float]:
    """The device's idle time (s) between consecutive
    ``device.decode_step`` spans begun in the window, next start less
    previous end, leaving out each pair with a ``device.prefill`` begun
    between them."""
    steps = [s for s in intervals(ctx, "device.decode_step")
             if readers.in_window(ctx, s[0])]
    prefills = [a for a, _ in intervals(ctx, "device.prefill")]
    gaps, i = [], 0
    for (a0, b0), (a1, _) in zip(steps, steps[1:]):
        while i < len(prefills) and prefills[i] < a0:
            i += 1
        if i < len(prefills) and prefills[i] < a1:
            continue
        gaps.append(a1 - b0)
    return gaps


def enqueue_share(ctx: Any) -> Optional[float]:
    """Σ ``engine.prefill.enqueue`` over Σ ``serving.prefill``, both begun
    in the window, %."""
    enqueue = readers.spans(ctx, "engine.prefill.enqueue")
    whole = readers.spans(ctx, "serving.prefill")
    if not enqueue or not whole:
        return None
    return 100.0 * sum(enqueue) / sum(whole)
