"""Deterministic, host-sharded, resumable synthetic token pipeline.

The port's own copy of ``repro/data/pipeline.py``: the same numpy
streams, so a batch is the reference's bit for bit.  Every batch is a pure function of (seed, step, host), so a restarted
or replaced host replays no data.  Also a memory-mapped binary-corpus
loader with the same interface, double-buffered prefetch, and
``to_device``, which moves a batch to the device through pinned memory.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    eos_id: int = 1
    mean_doc_len: int = 512


class SyntheticLM:
    """counter-based RNG stream => random-access batches (seekable)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        self._step = 0

    def seek(self, step: int) -> None:
        self._step = step

    @property
    def step(self) -> int:
        return self._step

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        # independent counter-based stream per (seed, step, host)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s = self.host_batch, cfg.seq_len
        tokens = rng.integers(2, cfg.vocab_size, (b, s + 1), dtype=np.int32)
        # document packing: EOS resets at geometric boundaries
        doc_ends = rng.random((b, s + 1)) < (1.0 / cfg.mean_doc_len)
        tokens = np.where(doc_ends, cfg.eos_id, tokens)
        return {
            "tokens": tokens[:, :-1],
            "targets": tokens[:, 1:],
            "mask": np.ones((b, s), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            out = self.batch_at(self._step)
            self._step += 1
            yield out


class BinaryCorpus:
    """Memory-mapped flat token file with the same seekable interface."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.int32):
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.tokens_per_batch = self.host_batch * (cfg.seq_len + 1)
        self._step = 0

    def seek(self, step: int) -> None:
        self._step = step

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n = self.data.shape[0]
        stride = self.tokens_per_batch * cfg.n_hosts
        start = (step * stride + cfg.host_id * self.tokens_per_batch) \
            % max(n - self.tokens_per_batch, 1)
        flat = np.asarray(self.data[start:start + self.tokens_per_batch])
        tok = flat.reshape(self.host_batch, cfg.seq_len + 1)
        return {"tokens": tok[:, :-1].astype(np.int32),
                "targets": tok[:, 1:].astype(np.int32),
                "mask": np.ones((self.host_batch, cfg.seq_len), np.float32)}

    def __iter__(self):
        while True:
            out = self.batch_at(self._step)
            self._step += 1
            yield out


class Prefetcher:
    """Double-buffered background prefetch (overlap host data with device)."""

    def __init__(self, source, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src = iter(source)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._src:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``.  To a CUDA device each array
    goes through pinned host memory with a non-blocking copy, so the copy
    overlaps the work already queued on the current stream; on the CPU the
    tensors share the arrays' memory."""
    device = torch.device(device)
    out = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out
