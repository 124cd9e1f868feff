"""Continuous-batching decode engine with fixed shapes (v2).

The port of ``repro/serving/engine.py``.  The engine owns the KV cache of
``num_slots`` concurrent requests and runs two call shapes that never
change as requests arrive and finish:

  * prefill — one shape per bucket of the prefill ladder
    (``prefill_buckets``).  A prompt is left-padded to the smallest bucket
    that fits and masked via position -1
    (``models/transformer.leftpad_positions``); the single-row cache it
    fills is copied into the engine's cache at the assigned slot
    (MaxText-style prefill-insert).  On CUDA weights each bucket's prefill
    is captured as a CUDA graph in the constructor, largest bucket first,
    into one memory pool the prefill graphs share (prefills never overlap,
    and each graph's outputs are read before the next replay): the reset
    of the single-row cache, ``forward``, for the contiguous layout the
    copy into the engine's cache at a slot read from a static device index
    (so one graph serves every slot), and the greedy token.  Eagerly
    enqueued, a 512- or 1024-bucket prefill of granite-3-8b kept the host
    busy for almost all of its time and the card mostly idle (PERF.md).
    ``_admit`` writes the left-padded prompt, its length and its slot into
    pinned host staging, copied into the static inputs before each replay.
    Sampling at a temperature above 0 and the paged layout's
    ``scatter_prefill`` run eagerly after the replay.
    ``stats["prefill_traces"]`` counts the captured buckets and
    ``stats["prefill_replays"]`` the prefills run as a replay; on CPU
    tensors the same prefill runs eagerly and both stay 0;
  * decode — one (num_slots, 1) step for all slots.  Inactive slots decode
    garbage whose tokens are ignored and whose cache writes land in storage
    no active request reads.  On CUDA weights the step is captured once per
    engine as a CUDA graph, the port's counterpart of the reference's one
    ``jax.jit`` decode program (``stats["decode_traces"] == 1`` for the
    life of the engine); before each replay the step's inputs are copied
    into static device buffers, and the caches are the engine's own
    tensors, written in place.  On CPU tensors the same step runs eagerly
    and ``decode_traces`` stays 0.  The decode graph keeps a memory pool of
    its own.  A capture or replay that fails raises: there is no eager
    retry.  The graphs are captured before any driver thread exists.  A
    replay, prefill or decode, moves neither the attention wrappers'
    launch counters nor ``attn.dispatch`` records: the capture did.

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

Supported models: decoder-only attention archs, dense or MoE (the MoE
layer's dense dispatch has static shapes and no host sync, so its decode
step captures like a dense one; its capacity depends on the batch, so at
a capacity factor that drops tokens the engine's greedy tokens can differ
from an unbatched ``generate``'s, as the reference's can).  RWKV, SSM and
encoder-decoder state is per-request state this slot scatter does not
carry, and those archs are refused, as the reference refuses them.

Telemetry (``core/telemetry``; off by default) records the reference's
lifecycle events at the same host-level sites: the instants
``serving.enqueue``, ``serving.slot_assign``, ``serving.first_token`` and
``serving.finish``, the ``serving.requests_finished`` counter, the
``serving.queue_depth`` and ``serving.slot_occupancy`` gauges, and the
spans ``serving.prefill`` (``replay=True`` when a graph ran it),
``serving.decode_step`` (around the graph's replay; it closes on the
step's own copy of the tokens to the host, so no event adds a synchronise)
and ``serving.run``; each capture, the decode step's and each prefill
bucket's, counts as ``cuda.graph_capture``.  The tokens are the same with
telemetry on or off.

The port splits each prefill and decode step into host and device time.
Under ``serving.prefill``: ``engine.prefill.enqueue`` (the copy-in and the
replay, or the eager prefill, then the paged scatter and ``sample``, up to
the sync), ``engine.prefill.wait`` (the ``int(...)`` that syncs) and
``device.prefill`` (timing events before the copy-in and after
``sample``).  Under ``serving.decode_step``: ``engine.decode.enqueue`` (the
copy-in and ``replay()``), ``engine.decode.wait`` (the tokens' ``.cpu()``)
and ``device.decode_step``.  With telemetry on when the engine is built,
and events recorded in a graph timed on this card
(``cudamon.graph_events_timed``), the decode step is captured between two
timing events of its own, and ``device.decode_step`` runs from the
graph's first node to its last (``decode_events == "graph"``); otherwise
the events sit around the copy-in and the replay, and the span holds the
copy-in and the launch's latency too (``"around"``).  The ``device.*``
spans are on the recorder's clock (``cudamon.DeviceSpans``), each carries
its host parent's ``uid``/``step``, and they are recorded at the next
step, outside the ``serving.*`` spans, or when the events are read.  On the
CPU the work is synchronous and a ``device.*`` span is the host interval
of the same work.  Untraced engines capture the graph without events.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


def scatter_slot_cache(big: Params, small: Params,
                       slot: Union[int, torch.Tensor]) -> None:
    """Copy a batch-1 cache into the engine cache at ``slot``, in place.

    ``slot`` is an int or a (1,) int64 tensor on the caches' device, read
    on the device: one captured prefill serves every slot.  Eager-layer
    leaves are (batch, ...); scan-segment leaves are stacked (n_layers,
    batch, ...), so the batch axis is 0 and 1 respectively.
    """
    if isinstance(slot, int):
        slot = torch.tensor([slot])
    for key, c in big["eager"].items():
        for name, t in c["self"].items():
            t.index_copy_(0, slot.to(t.device),
                          small["eager"][key]["self"][name])
    for bg, sm in zip(big["segments"], small["segments"]):
        for name, t in bg["self"].items():
            t.index_copy_(1, slot.to(t.device), sm["self"][name])


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
        # the prefill's static inputs: a bucket's left-padded prompt in the
        # first columns, then the prompt's true length and its slot; _admit
        # writes the host side (pinned on CUDA), _prefill copies it in
        self._prefill_host = torch.zeros(
            self.prefill_len + 2, dtype=torch.int64,
            pin_memory=self.device.type == "cuda")
        self._prefill_in = torch.zeros(self.prefill_len + 2,
                                       dtype=torch.int64, device=self.device)
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
        # prefill_replays (prefills run as a replay of their bucket's),
        # page_waits (requests that found a free slot but too few free
        # pages, each counted once) and pages_peak (the most pages held)
        self.stats: Dict[str, int] = {
            "prefill_traces": 0, "decode_traces": 0,
            "prefill_calls": 0, "decode_steps": 0,
            "requests_finished": 0, "tokens_generated": 0,
            "graph_replays": 0, "prefill_replays": 0, "page_waits": 0,
            "pages_peak": 0,
        }
        self._page_wait: Optional[Request] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._device_spans = cudamon.DeviceSpans(self.device)
        # the timing events captured in the graph (telemetry on at capture)
        self._graph_events: Optional[Tuple[torch.cuda.Event, ...]] = None
        # bucket -> (its prefill's graph, the graph's outputs)
        self._prefill_graphs: Dict[
            int, Tuple[torch.cuda.CUDAGraph,
                       Tuple[torch.Tensor, torch.Tensor]]] = {}
        if self.device.type == "cuda":
            self._capture_decode()
            self._capture_prefill()

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
        events = None
        if tel.enabled() and cudamon.graph_events_timed(self.device):
            events = tuple(torch.cuda.Event(enable_timing=True,
                                            external=True) for _ in (0, 1))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            if events:
                events[0].record()
            self._graph_out = self._decode_fn()
            if events:
                events[1].record()
        self._graph = graph
        self._graph_events = events
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

    @property
    def decode_events(self) -> str:
        """Where ``device.decode_step``'s timing events sit: ``"graph"``,
        captured in the graph, or ``"around"`` the copy-in and the replay
        (module docstring)."""
        return "around" if self._graph_events is None else "graph"

    def decode_tokens(self) -> np.ndarray:
        """One step of the driver loops, and the hook to time or profile
        one: copy the host's inputs into the static buffers, run the step
        (``decode_logits``) and return each slot's token on the host,
        sampled from its request's generator when the temperature is above
        0.  Outside a loop it repeats the last step: every slot writes the
        same cache entry again."""
        dev = self._device_spans
        in_graph = self._graph_events is not None
        if in_graph:
            dev.settle()          # the graph's events are recorded anew
        with tel.span("engine.decode.enqueue", proc="engine"):
            start = None if in_graph else dev.mark()
            self._tok.copy_(torch.from_numpy(self.tok_buf))
            self._pos.copy_(torch.from_numpy(self.pos_buf))
            if self._tables is not None:
                self._tables.copy_(torch.from_numpy(self.block_tables))
            logits, toks = self.decode_logits()
            end = None if in_graph else dev.mark()
            if self.temperature > 0.0:
                gens = [None if r is None else r.generator
                        for r in self.slot_req]
                toks = sample_per_slot(logits, gens, self.temperature)
        with tel.span("engine.decode.wait", proc="engine"):
            out = toks.cpu().numpy()
        if in_graph:
            start, end = self._graph_events
        dev.span("device.decode_step", start, end, pooled=not in_graph)
        return out

    def _prefill_fn(self, bucket: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill at ``bucket`` from the static inputs: (the last
        position's logits (1, V), its greedy token (1,) int32).  Empties
        the single-row cache and fills it; for the contiguous layout,
        copies it into the engine's cache at the static slot."""
        n = self.prefill_len
        small = self._prefill_cache
        for c in [*small["eager"].values(), *small["segments"]]:
            # a fresh cache: scatter_prefill's sentinel writes rely on it
            c["self"]["k"].zero_()
            c["self"]["v"].zero_()
            c["self"]["pos"].fill_(-1)
        logits, _, _ = forward(self.params, self.cfg,
                               self._prefill_in[None, :bucket], caches=small,
                               lengths=self._prefill_in[n:n + 1],
                               last_only=True)
        if self._tables is None:
            scatter_slot_cache(self.caches, small, self._prefill_in[n + 1:])
        last = logits[:, -1]
        return last, sample(last)

    def _capture_prefill(self) -> None:
        """Capture each bucket's prefill as a CUDA graph (module docstring),
        the decode step's recipe: largest bucket first, into one pool, so
        that the smaller buckets reuse the largest one's blocks.

        Each capture follows one eager warm-up on a side stream, which loads
        the kernels and the library handles at the bucket's shapes.  The
        warm-up runs on a prompt of token 0 filling the bucket, into slot
        0, whose row the prefill of any request admitted to it overwrites
        whole; the paged pool it does not touch.  The capture itself
        executes nothing.
        """
        pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        for bucket in reversed(self.prefill_buckets):
            self._prefill_in[self.prefill_len] = bucket
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._prefill_fn(bucket)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                out = self._prefill_fn(bucket)
            self._prefill_graphs[bucket] = (graph, out)
            self.stats["prefill_traces"] += 1
            cudamon.graph_captured("serving.prefill")

    def prefill_logits(self, bucket: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill at ``bucket`` on the static inputs as they stand:
        (the last position's logits, its greedy token) on the device.  The
        bucket's graph replayed on CUDA, whose outputs are overwritten by
        the next prefill's replay; eagerly on the CPU."""
        captured = self._prefill_graphs.get(bucket)
        if captured is None:
            return self._prefill_fn(bucket)
        graph, out = captured
        graph.replay()
        self.stats["prefill_replays"] += 1
        return out

    def _prefill(self, bucket: int, slot: int,
                 generator: Optional[torch.Generator],
                 table_row: Optional[np.ndarray]) -> int:
        """The prefill ``_admit`` staged: copy its inputs in, run it
        (``prefill_logits``), scatter the paged layout's pages and sample;
        the first token, on the host."""
        dev = self._device_spans
        with tel.span("engine.prefill.enqueue", proc="engine"):
            start = dev.mark()
            self._prefill_in.copy_(self._prefill_host, non_blocking=True)
            logits, tok = self.prefill_logits(bucket)
            if table_row is not None:
                scatter_prefill(
                    self.caches, self._prefill_cache,
                    torch.from_numpy(table_row).long().to(self.device),
                    slot, self.cfg, cache_len=self.cache_len,
                    block_size=self.block_size)
            if self.temperature > 0.0:
                tok = sample(logits, generator, self.temperature)
            end = dev.mark()
        with tel.span("engine.prefill.wait", proc="engine"):
            tok0 = int(tok[0])
        dev.span("device.prefill", start, end)
        return tok0

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
        staged = self._prefill_host.numpy()      # the static inputs' layout
        staged[:bucket - L] = 0                          # left-pad
        staged[bucket - L:bucket] = req.prompt
        staged[self.prefill_len:] = L, slot
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
        self._device_spans.settle()          # the last step's, outside
        with tel.span("serving.prefill", proc="engine", uid=req.uid,
                      slot=slot, prompt_len=L, bucket=bucket,
                      replay=bucket in self._prefill_graphs):
            tok0 = self._prefill(bucket, slot, req.generator, row)  # syncs
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
        self._device_spans.settle()          # the last step's, outside
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
