"""Fault-tolerance machinery: heartbeat, straggler EMA, preemption-safe loop.

The port's own copy of ``repro/distributed/fault_tolerance.py`` (numpy and
the standard library only).  Every component keeps local state only and
composes with the checkpoint manager and the seekable data pipeline for a
restart that replays no data.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class Heartbeat:
    """Touches a file every `interval` steps; external watchdogs alert on
    stale mtime (the standard k8s/SLURM liveness pattern)."""

    def __init__(self, path: str, interval_s: float = 30.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as f:
                f.write(f"{step} {now}\n")
            self._last = now


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time EMA; flags steps slower than `factor` x EMA.

    At fleet scale the flagged host ids feed the scheduler's replacement
    logic; here we record and expose them.
    """

    alpha: float = 0.1
    factor: float = 2.0
    warmup: int = 5
    _ema: float = 0.0
    _n: int = 0
    events: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float, host_id: int = 0) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ema = dt if self._ema == 0 else \
                (1 - self.alpha) * self._ema + self.alpha * dt
            return False
        slow = dt > self.factor * self._ema
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self._ema,
                                "host": host_id})
        else:
            # stragglers don't poison the EMA
            self._ema = (1 - self.alpha) * self._ema + self.alpha * dt
        return slow

    @property
    def ema(self) -> float:
        return self._ema


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful `should_stop` flag (checked per step)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._installed = False
        self._signals = signals

    def install(self) -> "PreemptionGuard":
        if not self._installed:
            for s in self._signals:
                try:
                    signal.signal(s, self._handler)
                except ValueError:  # non-main thread (tests)
                    pass
            self._installed = True
        return self

    def _handler(self, signum, frame):
        self._stop = True

    def request_stop(self) -> None:
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


def elastic_mesh_shape(n_devices: int, prefer_model: int = 16
                       ) -> Dict[str, int]:
    """Factor an arbitrary surviving-device count into (data, model).

    Elastic restarts may come back with fewer hosts; we keep the model axis
    as large as divisibility allows (weights reshard via checkpoint restore).
    """
    model = prefer_model
    while model > 1 and n_devices % model:
        model //= 2
    return {"data": n_devices // model, "model": model}
