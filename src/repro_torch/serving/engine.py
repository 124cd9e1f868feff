"""Continuous-batching decode engine with fixed shapes, contiguous layout.

The port of ``repro/serving/engine.py``'s synchronous engine over the
contiguous KV layout.  The engine owns the KV cache of ``num_slots``
concurrent requests, one (num_slots, cache_len) row a slot, and runs two
call shapes that never change as requests arrive and finish:

  * prefill — one shape per bucket of the prefill ladder
    (``prefill_buckets``).  A prompt is left-padded to the smallest bucket
    that fits and masked via position -1
    (``models/transformer.leftpad_positions``); the single-row cache it
    fills is copied into the engine's cache at the assigned slot
    (``scatter_slot_cache``, MaxText-style prefill-insert);
  * decode — one (num_slots, 1) step for all slots.  Inactive slots decode
    garbage whose tokens are ignored and whose cache writes land in rows no
    active request reads.

Scheduling is slot-granular continuous batching: a FIFO queue admits work
into freed slots between decode steps (head-of-line: nothing jumps the
queue), and each slot tracks its own absolute position.  Greedy tokens
equal those of unbatched ``serve_step.generate`` on the same cache length.

Supported models: dense decoder-only attention archs.  The paged layout,
``run_threaded`` and the telemetry spans come in later slices (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import resolve_attention_backend
from repro_torch.models.transformer import Params, forward, init_caches
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.slots import SlotAllocator
from repro_torch.training.serve_step import (decode_step, sample,
                                             sample_per_slot)


def scatter_slot_cache(big: Params, small: Params, slot: int) -> None:
    """Copy a batch-1 cache into the engine cache at ``slot``, in place.

    Eager-layer leaves are (batch, ...); scan-segment leaves are stacked
    (n_layers, batch, ...), so the batch axis is 0 and 1 respectively.
    """
    for key, c in big["eager"].items():
        for name, t in c["self"].items():
            t[slot].copy_(small["eager"][key]["self"][name][0])
    for bg, sm in zip(big["segments"], small["segments"]):
        for name, t in bg["self"].items():
            t[:, slot].copy_(sm["self"][name][:, 0])


class ServingEngine:
    def __init__(self, params: Params, cfg: ModelConfig, *,
                 num_slots: int = 4, cache_len: int = 128,
                 prefill_len: int = 32,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, seed: int = 0,
                 attn_backend: Optional[str] = None):
        if cfg.rwkv or cfg.ssm_state or cfg.is_encoder_decoder:
            raise NotImplementedError(
                "slot engine supports decoder-only attention archs; "
                f"{cfg.name} carries per-request recurrent/encoder state")
        if prefill_buckets is None:
            buckets: Tuple[int, ...] = (int(prefill_len),)
        else:
            buckets = tuple(sorted({int(b) for b in prefill_buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError("prefill buckets must be positive")
        if buckets[-1] > cache_len:
            raise ValueError("prefill_len must fit in cache_len")
        if attn_backend is not None:
            cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        # what each call shape dispatches to (env var applied; raises for
        # a backend that cannot run on these weights' device)
        self.attn_backends = {
            kind: resolve_attention_backend(kind, cfg.attn_backend,
                                            self.device)
            for kind in ("prefill", "decode")}
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.prefill_buckets = buckets
        self.prefill_len = buckets[-1]       # largest admissible prompt
        self.temperature = temperature
        self.seed = seed

        self.caches = init_caches(cfg, num_slots, cache_len, self.device)
        # the single-row cache every prefill writes, emptied before each
        self._prefill_cache = init_caches(cfg, 1, cache_len, self.device)
        self.tok_buf = np.zeros((num_slots, 1), np.int32)
        self.pos_buf = np.zeros((num_slots, 1), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slots = SlotAllocator(num_slots)
        self.queue = RequestQueue()
        self._t0 = time.perf_counter()
        self.stats: Dict[str, int] = {
            "prefill_calls": 0, "decode_steps": 0,
            "requests_finished": 0, "tokens_generated": 0,
        }

    # ------------------------------------------------------------------
    def _prefill(self, tokens: torch.Tensor, length: int, slot: int,
                 generator: Optional[torch.Generator]) -> int:
        small = self._prefill_cache
        for c in [*small["eager"].values(), *small["segments"]]:
            c["self"]["pos"].fill_(-1)
        lengths = torch.tensor([length], dtype=torch.int32,
                               device=self.device)
        logits, small = forward(self.params, self.cfg, tokens, caches=small,
                                lengths=lengths, last_only=True)
        scatter_slot_cache(self.caches, small, slot)
        return int(sample(logits[:, -1], generator, self.temperature)[0])

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def active_count(self) -> int:
        return self.slots.in_use()

    def _bucket_for(self, prompt_len: int) -> int:
        """Smallest ladder bucket that fits the prompt."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise AssertionError("unreachable: submit validated prompt_len")

    # ------------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        if req.prompt_len < 1 or req.prompt_len > self.prefill_len:
            raise ValueError(
                f"prompt length {req.prompt_len} outside [1, "
                f"{self.prefill_len}]")
        if req.prompt_len + req.max_new_tokens > self.cache_len:
            raise ValueError("prompt + max_new_tokens exceeds cache_len")

    def submit(self, req: Request) -> None:
        self._validate(req)
        if req.generator is None and self.temperature > 0.0:
            req.generator = torch.Generator(device=self.device).manual_seed(
                self.seed * 1_000_003 + req.uid)
        self.queue.submit(req)

    def _finish(self, slot: int, req: Request, now: float,
                finished: List[Request]) -> None:
        req.t_done = now
        self.slot_req[slot] = None
        self.slots.free(slot)
        self.stats["requests_finished"] += 1
        finished.append(req)

    def _admit(self, req: Request, now: float,
               finished: List[Request]) -> None:
        slot = self.slots.alloc()
        self.slot_req[slot] = req
        req.t_admitted = now
        L = req.prompt_len
        bucket = self._bucket_for(L)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, bucket - L:] = req.prompt                # left-pad
        tok0 = self._prefill(torch.from_numpy(toks).to(self.device), L,
                             slot, req.generator)        # host sync
        self.stats["prefill_calls"] += 1
        now = self._clock()
        req.t_first_token = now
        req.t_tokens.append(now)
        req.generated.append(tok0)
        self.stats["tokens_generated"] += 1
        if len(req.generated) >= req.max_new_tokens or tok0 == req.eos_id:
            self._finish(slot, req, now, finished)
            return
        self.tok_buf[slot, 0] = tok0
        self.pos_buf[slot, 0] = L        # true length, not padded length

    # ------------------------------------------------------------------
    def _decode_once(self, finished: List[Request]) -> None:
        """Decode one token for every slot; appends newly finished requests
        to ``finished``."""
        if self.active_count() == 0:
            return
        logits, self.caches = decode_step(
            self.params, self.cfg,
            torch.from_numpy(self.tok_buf.astype(np.int64)).to(self.device),
            torch.from_numpy(self.pos_buf).to(self.device), self.caches)
        gens = [None if r is None else r.generator for r in self.slot_req]
        toks = sample_per_slot(logits, gens, self.temperature).cpu().numpy()
        self.stats["decode_steps"] += 1
        now = self._clock()
        for s, req in enumerate(self.slot_req):
            if req is None:                      # inactive slot: token ignored
                continue
            t = int(toks[s])
            req.generated.append(t)
            req.t_tokens.append(now)
            self.stats["tokens_generated"] += 1
            if len(req.generated) >= req.max_new_tokens or t == req.eos_id:
                self._finish(s, req, now, finished)
            else:
                self.tok_buf[s, 0] = t
                self.pos_buf[s, 0] += 1

    def step(self, now: Optional[float] = None) -> List[Request]:
        """Admit ready requests into free slots, then decode one token for
        every slot.  Returns the requests that finished this step."""
        if now is None:
            now = self._clock()
        finished: List[Request] = []
        first = True
        while self.slots.available():
            if not first:
                # a prefill takes real time: later admits in the same step
                # read the clock again
                now = max(now, self._clock())
            if self.queue.peek_ready(now) is None:
                break                    # FIFO head-of-line: no queue jumping
            self._admit(self.queue.pop_ready(now), now, finished)
            first = False
        self._decode_once(finished)
        return finished

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve a trace to completion.  Resets the engine clock to 0, so
        ``arrival_time`` fields are relative to this call."""
        self._t0 = time.perf_counter()
        for req in sorted(requests, key=lambda r: r.arrival_time):
            self.submit(req)
        finished: List[Request] = []
        while self.queue or self.active_count():
            now = self._clock()
            if self.active_count() == 0 and not self.queue.has_ready(now):
                # idle: sleep until the next arrival (capped)
                nxt = self.queue.next_arrival()
                time.sleep(min(max(0.0, nxt - now), 0.05))
                continue
            finished.extend(self.step(now))
        return finished
