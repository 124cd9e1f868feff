"""Continuous-batching decode engine with fixed shapes (v2).

The port of ``repro/serving/engine.py``.  The engine owns the KV cache of
``num_slots`` concurrent requests and runs two call shapes that never
change as requests arrive and finish:

  * prefill — one shape per bucket of the prefill ladder
    (``prefill_buckets``).  A prompt is left-padded to the smallest bucket
    that fits and masked via position -1
    (``models/transformer.leftpad_positions``); the single-row cache it
    fills is copied into the engine's cache at the assigned slot
    (MaxText-style prefill-insert).  Prefill runs eagerly: a 2048-bucket
    prefill of granite-3-8b keeps an H100 busy about 91% of its wall time
    (PERF.md), so ``stats["prefill_traces"]`` stays 0;
  * decode — one (num_slots, 1) step for all slots.  Inactive slots decode
    garbage whose tokens are ignored and whose cache writes land in storage
    no active request reads.  On CUDA weights the step is captured once per
    engine as a CUDA graph, the port's counterpart of the reference's one
    ``jax.jit`` decode program (``stats["decode_traces"] == 1`` for the
    life of the engine); before each replay the step's inputs are copied
    into static device buffers, and the caches are the engine's own
    tensors, written in place.  On CPU tensors the same step runs eagerly
    and ``decode_traces`` stays 0.  A capture or replay that fails raises:
    there is no eager retry.

Two KV-cache layouts (``cache_layout=``), equal in their greedy tokens:

  * ``"contiguous"`` — one (num_slots, cache_len) row a slot;
  * ``"paged"``      — a shared (num_blocks, block_size) page pool with
    per-slot block tables (``serving/paged.py``).  A request owns only the
    pages its positions need, reserved in full at admission, and admission
    waits for free pages; the decode step gathers the pool through the
    tables into the contiguous view the contiguous step reads, then writes
    each slot's new entry back to its page.

Scheduling is slot-granular continuous batching: a FIFO queue admits work
into freed slots between decode steps (head-of-line: if the head request
does not fit, for want of a slot or of pages, nothing behind it jumps
ahead), each slot tracks its own absolute position, and each request
samples from its own ``torch.Generator``.  Greedy tokens equal those of
unbatched ``serve_step.generate`` on the same cache length.

Two driver loops share the admission and decode core:

  * ``run``          — synchronous: admit, then decode, a step at a time;
  * ``run_threaded`` — producer/consumer (MaxText JetThread + queue): an
    injector thread feeds a bounded queue at each arrival time, an
    admission thread waits for capacity and prefills under the engine
    lock, and the decode loop runs on the calling thread under the same
    lock, so the prefill and the graph's replay never overlap on the card.

Supported models: dense decoder-only attention archs.  RWKV, SSM and
encoder-decoder state is per-request state this slot scatter does not
carry.

Telemetry (``core/telemetry``; off by default) records the reference's
lifecycle events at the same host-level sites: the instants
``serving.enqueue``, ``serving.slot_assign``, ``serving.first_token`` and
``serving.finish``, the ``serving.requests_finished`` counter, the
``serving.queue_depth`` and ``serving.slot_occupancy`` gauges, and the
spans ``serving.prefill``, ``serving.decode_step`` (around the graph's
replay; it closes on the step's own copy of the tokens to the host, so no
event adds a synchronise) and ``serving.run``; the decode step's capture
counts as ``cuda.graph_capture``.  Nothing enters the captured region, and
the tokens are the same with telemetry on or off.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry as tel
from repro_torch.core.telemetry import cudamon
from repro_torch.models.attention import resolve_attention_backend
from repro_torch.models.transformer import Params, forward, init_caches
from repro_torch.serving.paged import (check_paged_geometry, gather_caches,
                                       init_paged_caches, scatter_decode,
                                       scatter_prefill)
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.slots import (RESERVED_BLOCKS, SENTINEL_BLOCK,
                                       TRASH_BLOCK, BlockAllocator,
                                       SlotAllocator)
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


class JetThread(threading.Thread):
    """A thread that records its exception instead of dying silently
    (MaxText offline-inference idiom); the driver raises it after join."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            super().run()
        except BaseException as exc:        # noqa: BLE001 — raised on join
            self.error = exc


class ServingEngine:
    def __init__(self, params: Params, cfg: ModelConfig, *,
                 num_slots: int = 4, cache_len: int = 128,
                 prefill_len: int = 32,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, seed: int = 0,
                 attn_backend: Optional[str] = None,
                 cache_layout: str = "contiguous", block_size: int = 16,
                 num_blocks: Optional[int] = None):
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
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown cache_layout {cache_layout!r}")
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
        self.cache_layout = cache_layout

        self._tables: Optional[torch.Tensor] = None
        if cache_layout == "paged":
            if num_blocks is None:
                # the contiguous layout's KV footprint, plus the reserved
                num_blocks = (num_slots * (cache_len // max(1, block_size))
                              + RESERVED_BLOCKS)
            self.pages_per_slot = check_paged_geometry(cache_len, block_size,
                                                       num_blocks)
            self.block_size = block_size
            self.num_blocks = num_blocks
            self.balloc = BlockAllocator(num_blocks, block_size)
            self.block_tables = np.full(
                (num_slots, self.pages_per_slot), TRASH_BLOCK, np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
            self.caches = init_paged_caches(
                cfg, num_slots=num_slots, cache_len=cache_len,
                block_size=block_size, num_blocks=num_blocks,
                device=self.device)
            self._tables = torch.full((num_slots, self.pages_per_slot),
                                      TRASH_BLOCK, dtype=torch.int64,
                                      device=self.device)
        else:
            self.caches = init_caches(cfg, num_slots, cache_len, self.device)
        # the single-row cache every prefill writes, emptied before each
        self._prefill_cache = init_caches(cfg, 1, cache_len, self.device)
        self.tok_buf = np.zeros((num_slots, 1), np.int32)
        self.pos_buf = np.zeros((num_slots, 1), np.int32)
        # the decode step's static inputs: tok_buf, pos_buf and the block
        # tables are copied into them before each step
        self._tok = torch.zeros((num_slots, 1), dtype=torch.int64,
                                device=self.device)
        self._pos = torch.zeros((num_slots, 1), dtype=torch.int32,
                                device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slots = SlotAllocator(num_slots)
        self.queue = RequestQueue()
        self._t0 = time.perf_counter()
        # run_threaded: every engine mutation happens under this lock; the
        # condition signals capacity changes (finish) and admissions
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # the reference's counters, then the port's own: graph_replays
        # (decode steps run as a replay of the captured graph),
        # page_waits (requests that found a free slot but too few free
        # pages, each counted once) and pages_peak (the most pages held)
        self.stats: Dict[str, int] = {
            "prefill_traces": 0, "decode_traces": 0,
            "prefill_calls": 0, "decode_steps": 0,
            "requests_finished": 0, "tokens_generated": 0,
            "graph_replays": 0, "page_waits": 0, "pages_peak": 0,
        }
        self._page_wait: Optional[Request] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if self.device.type == "cuda":
            self._capture_decode()

    # ------------------------------------------------------------------
    def _decode_fn(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step for every slot from the static inputs: (logits
        (num_slots, V), greedy tokens (num_slots,) int32).  Writes the
        caches (the pool, for the paged layout) in place."""
        if self.cache_layout == "paged":
            contig = gather_caches(self.caches, self._tables, self.cfg,
                                   num_slots=self.num_slots,
                                   cache_len=self.cache_len,
                                   block_size=self.block_size)
            logits, _ = decode_step(self.params, self.cfg, self._tok,
                                    self._pos, contig)
            scatter_decode(self.caches, contig, self._pos[:, 0],
                           self._tables, self.cfg, cache_len=self.cache_len,
                           block_size=self.block_size)
        else:
            logits, _ = decode_step(self.params, self.cfg, self._tok,
                                    self._pos, self.caches)
        return logits, logits.argmax(dim=-1).to(torch.int32)

    def _capture_decode(self) -> None:
        """Capture the decode step once as a CUDA graph (PyTorch's recipe).

        One eager warm-up step on a side stream first: it sizes the decode
        kernel's arrival counters, which may not be allocated during a
        capture, and loads the kernels.  It runs on the initial inputs
        (token 0 at position 0, every table row on the trash page), so it
        writes only position 0 of each contiguous row, which the prefill
        of any request admitted to that row overwrites whole, or the trash
        page.  The capture itself executes nothing.  It runs in the
        constructor, before any driver loop starts a thread, so no other
        thread's CUDA work can overlap it.
        """
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._graph_out = self._decode_fn()
        self._graph = graph
        self.stats["decode_traces"] += 1
        cudamon.graph_captured("serving.decode_step")

    def decode_logits(self, eager: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step on the static inputs as they stand (the host's
        are not copied): (logits, greedy tokens) on the device.  The
        graph's replay on CUDA, whose outputs are overwritten by the next
        replay; eagerly on the CPU.  ``eager=True`` runs the step the graph
        was captured from, eagerly, on CUDA too: the before figure for a
        measurement.  The driver loops never ask for it."""
        if self._graph is not None and not eager:
            self._graph.replay()
            self.stats["graph_replays"] += 1
            return self._graph_out
        return self._decode_fn()

    def decode_tokens(self) -> np.ndarray:
        """One step of the driver loops, and the hook to time or profile
        one: copy the host's inputs into the static buffers, run the step
        (``decode_logits``) and return each slot's token on the host,
        sampled from its request's generator when the temperature is above
        0.  Outside a loop it repeats the last step: every slot writes the
        same cache entry again."""
        self._tok.copy_(torch.from_numpy(self.tok_buf))
        self._pos.copy_(torch.from_numpy(self.pos_buf))
        if self._tables is not None:
            self._tables.copy_(torch.from_numpy(self.block_tables))
        logits, toks = self.decode_logits()
        if self.temperature > 0.0:
            gens = [None if r is None else r.generator for r in self.slot_req]
            toks = sample_per_slot(logits, gens, self.temperature)
        return toks.cpu().numpy()

    def _prefill(self, tokens: torch.Tensor, length: int, slot: int,
                 generator: Optional[torch.Generator],
                 table_row: Optional[np.ndarray]) -> int:
        small = self._prefill_cache
        for c in [*small["eager"].values(), *small["segments"]]:
            # a fresh cache: scatter_prefill's sentinel writes rely on it
            c["self"]["k"].zero_()
            c["self"]["v"].zero_()
            c["self"]["pos"].fill_(-1)
        lengths = torch.tensor([length], dtype=torch.int32,
                               device=self.device)
        logits, small = forward(self.params, self.cfg, tokens, caches=small,
                                lengths=lengths, last_only=True)
        if table_row is None:
            scatter_slot_cache(self.caches, small, slot)
        else:
            scatter_prefill(self.caches, small,
                            torch.from_numpy(table_row).long().to(self.device),
                            slot, self.cfg, cache_len=self.cache_len,
                            block_size=self.block_size)
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
        if self.cache_layout == "paged":
            need = self.balloc.blocks_for(req.prompt_len, req.max_new_tokens)
            if need > self.balloc.capacity():
                raise ValueError(
                    f"request needs {need} KV pages but the pool holds only "
                    f"{self.balloc.capacity()}")

    def _prepare(self, req: Request) -> None:
        """Validate ``req`` and give it its own generator (temperature
        sampling), on the caller's thread."""
        self._validate(req)
        if req.generator is None and self.temperature > 0.0:
            req.generator = torch.Generator(device=self.device).manual_seed(
                self.seed * 1_000_003 + req.uid)

    def submit(self, req: Request) -> None:
        self._prepare(req)
        self.queue.submit(req)
        tel.instant("serving.enqueue", proc="engine", uid=req.uid,
                    prompt_len=req.prompt_len,
                    max_new_tokens=req.max_new_tokens,
                    queue_depth=len(self.queue))

    def _has_capacity(self, req: Request) -> bool:
        """Can ``req`` be admitted now?  A free slot always; the paged
        layout also needs the request's whole page reservation."""
        if not self.slots.available():
            return False
        if self.cache_layout == "paged":
            fits = (self.balloc.available()
                    >= self.balloc.blocks_for(req.prompt_len,
                                              req.max_new_tokens))
            if not fits and req is not self._page_wait:
                self._page_wait = req
                self.stats["page_waits"] += 1
            return fits
        return True

    def _finish(self, slot: int, req: Request, now: float,
                finished: List[Request]) -> None:
        req.t_done = now
        self.slot_req[slot] = None
        self.slots.free(slot)
        if self.cache_layout == "paged":
            self.balloc.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            # inactive again: this slot's garbage decode writes go to the
            # trash page, never to a mapped page
            self.block_tables[slot] = TRASH_BLOCK
        self.stats["requests_finished"] += 1
        finished.append(req)
        tel.instant("serving.finish", proc="engine", uid=req.uid, slot=slot,
                    tokens=len(req.generated),
                    latency_s=req.t_done - req.arrival_time)
        tel.counter("serving.requests_finished", proc="engine")

    def _admit(self, req: Request, now: float,
               finished: List[Request]) -> None:
        slot = self.slots.alloc()
        self.slot_req[slot] = req
        req.t_admitted = now
        tel.instant("serving.slot_assign", proc="engine", uid=req.uid,
                    slot=slot, queued_s=now - req.arrival_time)
        L = req.prompt_len
        bucket = self._bucket_for(L)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, bucket - L:] = req.prompt                # left-pad
        row = None
        if self.cache_layout == "paged":
            # the request's whole lifetime up front: decode never reaches
            # a page it does not own
            n_pages = self.balloc.blocks_for(L, req.max_new_tokens)
            pages = self.balloc.alloc(n_pages)
            self._slot_blocks[slot] = pages
            self.stats["pages_peak"] = max(self.stats["pages_peak"],
                                           self.balloc.in_use())
            row = np.full(self.pages_per_slot, SENTINEL_BLOCK, np.int32)
            row[:n_pages] = pages
            self.block_tables[slot] = row
        with tel.span("serving.prefill", proc="engine", uid=req.uid,
                      slot=slot, prompt_len=L, bucket=bucket):
            tok0 = self._prefill(torch.from_numpy(toks).to(self.device), L,
                                 slot, req.generator, row)   # host sync
        self.stats["prefill_calls"] += 1
        now = self._clock()
        req.t_first_token = now
        req.t_tokens.append(now)
        tel.instant("serving.first_token", proc="engine", uid=req.uid,
                    slot=slot, ttft_s=now - req.arrival_time)
        req.generated.append(tok0)
        self.stats["tokens_generated"] += 1
        if len(req.generated) >= req.max_new_tokens or tok0 == req.eos_id:
            self._finish(slot, req, now, finished)
            return
        self.tok_buf[slot, 0] = tok0
        self.pos_buf[slot, 0] = L        # true length, not padded length

    # ------------------------------------------------------------------
    def _decode_once(self, finished: List[Request]) -> int:
        """Decode one token for every slot; appends newly finished requests
        to ``finished`` and returns how many finished."""
        active = self.active_count()
        if active == 0:
            return 0
        n0 = len(finished)
        tel.gauge("serving.queue_depth", len(self.queue), proc="engine")
        tel.gauge("serving.slot_occupancy", active / self.num_slots,
                  proc="engine")
        with tel.span("serving.decode_step", proc="engine", active=active,
                      step=self.stats["decode_steps"]):
            toks = self.decode_tokens()      # the tokens' .cpu() syncs
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
        return len(finished) - n0

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
            head = self.queue.peek_ready(now)
            if head is None or not self._has_capacity(head):
                break                    # FIFO head-of-line: no queue jumping
            self._admit(self.queue.pop_ready(now), now, finished)
            first = False
        self._decode_once(finished)
        return finished

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve a trace to completion, synchronously.  Resets the engine
        clock to 0, so ``arrival_time`` fields are relative to this call."""
        self._t0 = time.perf_counter()
        with tel.span("serving.run", proc="engine",
                      requests=len(requests), num_slots=self.num_slots):
            for req in sorted(requests, key=lambda r: r.arrival_time):
                self.submit(req)
            finished: List[Request] = []
            while self.queue or self.active_count():
                now = self._clock()
                if self.active_count() == 0 and not self.queue.has_ready(
                        now):
                    # idle: sleep until the next arrival (capped)
                    nxt = self.queue.next_arrival()
                    time.sleep(min(max(0.0, nxt - now), 0.05))
                    continue
                finished.extend(self.step(now))
        return finished

    # ------------------------------------------------------------------
    def run_threaded(self, requests: Sequence[Request], *,
                     backpressure: Optional[int] = None,
                     poll_s: float = 0.02) -> List[Request]:
        """Serve a trace with concurrent arrival injection, admission and
        decode (MaxText JetThread + queue idiom).

        * injector thread — sleeps until each request's arrival time, then
          puts it on a bounded queue (default ``2 * num_slots``); a put
          into a full queue blocks, which is the backpressure;
        * admission thread — pops arrivals, waits on the engine condition
          until the request fits (a free slot, and free pages for the paged
          layout), then prefills under the engine lock;
        * decode loop — runs here on the calling thread, under the same
          lock; finishing a request wakes the admission thread.

        The lock keeps the prefill and the decode step from overlapping on
        the card (the decode kernel's arrival counters are shared on a
        device).  Greedy tokens equal ``run``'s on the same trace: each
        request's continuation depends only on its own prompt, never on
        which step admitted it.  Requests are validated here, on the
        caller; a thread's error is raised here after both threads join.
        """
        reqs = sorted(requests, key=lambda r: r.arrival_time)
        for r in reqs:                   # fail on the caller, not a thread
            self._prepare(r)
        if backpressure is None:
            backpressure = max(2, 2 * self.num_slots)
        arrivals: _queue.Queue = _queue.Queue(maxsize=backpressure)
        finished: List[Request] = []
        admission_done = threading.Event()
        abort = threading.Event()
        self._t0 = time.perf_counter()

        def _put(item) -> bool:
            while not abort.is_set():
                try:
                    arrivals.put(item, timeout=poll_s)
                    return True
                except _queue.Full:
                    continue
            return False

        def inject() -> None:
            for r in reqs:
                wait = r.arrival_time - self._clock()
                if wait > 0:
                    time.sleep(wait)
                tel.instant("serving.enqueue", proc="engine", uid=r.uid,
                            prompt_len=r.prompt_len,
                            max_new_tokens=r.max_new_tokens,
                            queue_depth=arrivals.qsize())
                if not _put(r):
                    return
            _put(None)                   # sentinel: the trace is injected

        def admit() -> None:
            while not abort.is_set():
                try:
                    r = arrivals.get(timeout=poll_s)
                except _queue.Empty:
                    continue
                if r is None:
                    break
                with self._cond:
                    while not self._has_capacity(r):
                        if abort.is_set():
                            return
                        self._cond.wait(poll_s)
                    self._admit(r, self._clock(), finished)
                    self._cond.notify_all()
            admission_done.set()

        threads = [JetThread(target=inject, name="serving-inject",
                             daemon=True),
                   JetThread(target=admit, name="serving-admit",
                             daemon=True)]
        with tel.span("serving.run", proc="engine", requests=len(reqs),
                      num_slots=self.num_slots, mode="threaded",
                      backpressure=backpressure):
            for t in threads:
                t.start()
            try:
                while True:
                    with self._cond:
                        if self.active_count():
                            if self._decode_once(finished):
                                self._cond.notify_all()   # capacity freed
                        elif admission_done.is_set():
                            break
                        else:
                            self._cond.wait(poll_s)
                    if any(t.error is not None for t in threads):
                        break
            finally:
                abort.set()
                for t in threads:
                    t.join()
        for t in threads:
            if t.error is not None:
                raise t.error
        return finished
