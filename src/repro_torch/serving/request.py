"""Request lifecycle objects for the serving engine.

The port of ``repro/serving/request.py``.  A ``Request`` carries its prompt
plus the timing fields the latency summary reads (seconds on the engine's
clock, which starts at 0 when ``ServingEngine.run`` begins).
``RequestQueue`` is a FIFO admission queue gated on arrival time: a request
becomes visible to the scheduler once the engine clock passes
``arrival_time``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                   # (L,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_id: Optional[int] = None

    # filled in by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    t_admitted: float = math.nan         # slot assigned (prefill start)
    t_first_token: float = math.nan
    t_done: float = math.nan
    # engine-clock timestamp of every generated token (t_tokens[0] is the
    # first token): inter-token-latency percentiles come from the diffs
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    #: the request's own random stream (temperature sampling)
    generator: Optional[torch.Generator] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def finished(self) -> bool:
        return not math.isnan(self.t_done)

    def latency(self) -> float:
        """Arrival -> last token."""
        return self.t_done - self.arrival_time

    def ttft(self) -> float:
        """Arrival -> first token (queueing + prefill)."""
        return self.t_first_token - self.arrival_time

    def inter_token_gaps(self) -> List[float]:
        """Seconds between consecutive generated tokens."""
        return [b - a for a, b in zip(self.t_tokens, self.t_tokens[1:])]


class RequestQueue:
    def __init__(self) -> None:
        self._q: Deque[Request] = deque()

    def submit(self, req: Request) -> None:
        if self._q and req.arrival_time < self._q[-1].arrival_time:
            raise ValueError("requests must be submitted in arrival order")
        self._q.append(req)

    def has_ready(self, now: float) -> bool:
        return bool(self._q) and self._q[0].arrival_time <= now

    def peek_ready(self, now: float) -> Optional[Request]:
        """The request the scheduler would admit next, without popping."""
        if self.has_ready(now):
            return self._q[0]
        return None

    def pop_ready(self, now: float) -> Optional[Request]:
        if self.has_ready(now):
            return self._q.popleft()
        return None

    def next_arrival(self) -> Optional[float]:
        return self._q[0].arrival_time if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
