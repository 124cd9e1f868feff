"""The loop a deployment writes around the engine, and what it records.

``Loop`` feeds a ``traffic.Stream`` into ``ServingEngine`` through
``submit`` and ``step`` alone: an open loop submits each request once the
engine's clock passes its scheduled arrival (sleeping while the engine is
idle), a closed backlog keeps ``num_slots`` requests waiting.  Times are
the engine's clock, which ``Request``'s timestamps use too.  For a
profiled stretch it notes, after each step that decoded, the cache rows
that step's queries admitted, and the prefills it ran.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: the longest an idle open loop sleeps before it looks again (s)
IDLE_SLEEP = 0.002


class Loop:
    def __init__(self, engine: Any, stream: Any, request_cls: Any):
        self.engine = engine
        self.stream = stream
        self.Request = request_cls
        self.requests: List[Any] = []
        self.rejected = 0
        self._next: Optional[Any] = None
        self._t_sched = 0.0
        self._start: Optional[float] = None
        self.recording = False
        #: (engine time, rows admitted by the step's queries) a decode step
        self.decode_rows: List[Tuple[float, int]] = []

    def clock(self) -> float:
        return self.engine._clock()

    def _make(self) -> Any:
        uid, prompt, out, gap = self.stream.next()
        self._t_sched += gap
        return self.Request(uid=uid, prompt=prompt, max_new_tokens=out,
                            arrival_time=self._start + self._t_sched)

    def _submit(self, req: Any) -> None:
        try:
            self.engine.submit(req)
        except ValueError:
            self.rejected += 1
            return
        self.requests.append(req)

    def _feed(self, now: float) -> None:
        if self.stream.open:
            if self._next is None:
                self._next = self._make()
            while self._next.arrival_time <= now:
                self._submit(self._next)
                self._next = self._make()
        else:
            while len(self.engine.queue) < self.engine.num_slots:
                self._t_sched = now - self._start
                self._submit(self._make())

    def run_until(self, t_stop: float, steps: Optional[int] = None) -> None:
        """Serve until the engine's clock reaches ``t_stop`` (or for
        ``steps`` steps that decoded)."""
        eng = self.engine
        if self._start is None:
            self._start = self.clock()
        done = 0
        while True:
            now = self.clock()
            if now >= t_stop or (steps is not None and done >= steps):
                return
            self._feed(now)
            if not eng.active_count() and not eng.queue.has_ready(now):
                time.sleep(max(0.0, min(IDLE_SLEEP,
                                        self._next.arrival_time - now)))
                continue
            before = eng.stats["decode_steps"]
            eng.step()
            if eng.stats["decode_steps"] > before:
                done += 1
                if self.recording:
                    self.decode_rows.append((self.clock(), self._rows()))

    def _rows(self) -> int:
        """Cache rows the last decode step's queries admitted: a slot that
        decoded for a live request sat at ``pos_buf - 1`` (the engine has
        moved it on); any other slot at ``pos_buf``; each admits its
        position + 1 rows."""
        eng = self.engine
        live = np.array([r is not None for r in eng.slot_req])
        used = eng.pos_buf[:, 0].astype(np.int64) - live
        return int((used + 1).sum())

    def wait_first_tokens(self, t_open: float, t_close: float,
                          limit_s: float) -> None:
        """Keep serving (the traffic keeps arriving) until every request
        that arrived in the window has its first token, at most
        ``limit_s`` past the window."""
        deadline = t_close + limit_s
        while self.clock() < deadline:
            waiting = [r for r in self.requests
                       if t_open <= r.arrival_time < t_close
                       and np.isnan(r.t_first_token)]
            if not waiting:
                return
            self.run_until(min(deadline, self.clock() + 0.25))


def prefills(requests: List[Any], t0: float, t1: float,
             buckets) -> List[Tuple[int, int]]:
    """(prompt length, bucket) of each prefill that ran in [t0, t1]."""
    out = []
    for r in requests:
        if t0 <= r.t_admitted <= t1 and not np.isnan(r.t_first_token):
            out.append((r.prompt_len,
                        min(b for b in buckets if r.prompt_len <= b)))
    return out


def summary(requests: List[Any], t_open: float, t_close: float
            ) -> Dict[str, Any]:
    """Counts of the window for the result line."""
    arrived = [r for r in requests if t_open <= r.arrival_time < t_close]
    return {"arrived": len(arrived),
            "finished": sum(1 for r in requests
                            if t_open <= r.t_done <= t_close)}
