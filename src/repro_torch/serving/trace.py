"""Synthetic arrival traces + latency aggregation for the serving engine.

The port of ``repro/serving/trace.py`` (numpy only, line for line).

Arrivals are Poisson-ish: exponential inter-arrival gaps at `rate` requests
per second, ragged prompt lengths, fixed generation budget.  Times are
relative to `ServingEngine.run`'s clock start.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.request import Request


def synthetic_trace(n_requests: int, *, vocab_size: int, rate: float = 50.0,
                    min_prompt: int = 4, max_prompt: int = 16,
                    max_new_tokens: int = 16, seed: int = 0,
                    uid_base: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    min_prompt = max(1, min(min_prompt, max_prompt))    # tiny --prefill-len
    t = 0.0
    out: List[Request] = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        length = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(2, vocab_size, length).astype(np.int32)
        out.append(Request(uid=uid_base + i, prompt=prompt,
                           max_new_tokens=max_new_tokens, arrival_time=t))
    return out


def latency_summary(requests: Sequence[Request]) -> Dict[str, float]:
    """SLO percentiles over the *completed* requests (seconds).

    p50/p95/p99 of end-to-end latency and time-to-first-token, plus
    p50/p95/p99 inter-token latency pooled across every request's
    consecutive-token gaps (``Request.inter_token_gaps``; requests without
    per-token timestamps — e.g. hand-built test fixtures — contribute no
    gaps, and the ``itl`` keys are omitted when no request has any).

    Unfinished requests are excluded from the percentiles but NOT hidden:
    ``submitted`` counts every request handed in and ``unfinished`` the ones
    that never completed, so a half-drained trace can't masquerade as a
    clean SLO report (the serving benchmark fails any row with
    ``unfinished > 0``).

    A trace where nothing finished returns the explicit empty summary
    (``requests == 0``) instead of crashing ``np.percentile`` on an empty
    list.
    """
    done = [r for r in requests if r.finished]
    out: Dict[str, float] = {
        "requests": len(done),
        "submitted": len(requests),
        "unfinished": len(requests) - len(done),
    }
    if not done:
        return out
    lats = np.asarray([r.latency() for r in done])
    ttfts = np.asarray([r.ttft() for r in done])
    for q in (50, 95, 99):
        out[f"p{q}_latency_s"] = float(np.percentile(lats, q))
        out[f"p{q}_ttft_s"] = float(np.percentile(ttfts, q))
    gaps = [g for r in done for g in r.inter_token_gaps()]
    if gaps:
        arr = np.asarray(gaps)
        for q in (50, 95, 99):
            out[f"p{q}_itl_s"] = float(np.percentile(arr, q))
    return out
