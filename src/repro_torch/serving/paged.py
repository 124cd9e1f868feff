"""Paged KV-cache layout: a page pool with per-slot block tables.

The port of ``repro/serving/paged.py``.  The contiguous engine owns one
``(num_slots, cache_len)`` KV row a slot.  Here the KV store is a shared
pool of ``(num_blocks, block_size)`` pages and each slot carries a block
table, ``(num_slots, pages_per_slot)`` physical page ids with
``pages_per_slot = cache_len // block_size``, mapping logical page ``j``
(positions ``j*block_size .. (j+1)*block_size - 1``) to its physical page.

Attention here is purely position-masked (the cache's ``pos``, -1 = empty;
slot order is arbitrary by contract), so the pool composes with the
engine's decode step unchanged:

  * ``gather_caches``   pool + tables -> a contiguous ``(num_slots,
    cache_len)`` cache tree, bit-identical to what the contiguous engine
    holds (unallocated entries point at the sentinel page, whose ``pos`` is
    -1 and whose K/V are zero: the untouched tail of a contiguous row);
  * ``scatter_prefill`` writes a freshly prefilled single-row cache, split
    into pages, to the request's pages (all-empty tail pages land on the
    sentinel, which keeps its invariant because they are all-empty);
  * ``scatter_decode``  copies the one entry per slot that a decode step
    over the gathered view wrote back to ``tables[slot, pos // block_size]``
    at offset ``pos % block_size`` (an inactive slot's table points every
    entry at the trash page, so its garbage write lands there).

The port's cache tree (``models/transformer.py::init_caches``): eager
leaves are ``(batch, T, ...)``, a segment's leaves are stacked ``(n_layers,
batch, T, ...)``, ``pos`` is int32.  The pool is written in place, as the
port writes its caches (``index_copy_``, ``index_put_``), so a decode step
captured in a CUDA graph and the eager prefill see the same memory.
Sliding-window layers keep their per-slot ``(num_slots, window)`` rings
(a ring is already bounded and dense); only full-``cache_len`` caches page.
``models/transformer.py::cache_seq_lens`` decides which is which.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (Params, cache_seq_lens,
                                            init_caches)
from repro_torch.serving.slots import (RESERVED_BLOCKS, SENTINEL_BLOCK,
                                       TRASH_BLOCK)

__all__ = ["RESERVED_BLOCKS", "SENTINEL_BLOCK", "TRASH_BLOCK",
           "check_paged_geometry", "init_paged_caches", "gather_caches",
           "scatter_prefill", "scatter_decode"]


def check_paged_geometry(cache_len: int, block_size: int,
                         num_blocks: int) -> int:
    """Validate the paged layout and return ``pages_per_slot``."""
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    if cache_len % block_size:
        raise ValueError(
            f"cache_len {cache_len} must be a multiple of block_size "
            f"{block_size} (logical pages tile the cache exactly)")
    if num_blocks <= RESERVED_BLOCKS:
        raise ValueError(
            f"num_blocks {num_blocks} leaves no allocatable pages "
            f"({RESERVED_BLOCKS} reserved)")
    return cache_len // block_size


def _map_caches(fn: Callable[..., Any], cfg: ModelConfig, cache_len: int,
                *trees: Params) -> Params:
    """``fn(batch_axis, paged, *leaves)`` over cache trees of one layout.

    Engine caches hold only attention ``{"self": {"k", "v", "pos"}}``
    entries (the engine refuses RWKV, SSM and encoder-decoder archs): eager
    leaves have their batch axis at 0, segment leaves at 1.  ``paged`` is
    True when the entry's KV length is the full ``cache_len``.  Returns the
    tree of ``fn``'s results.
    """
    lens = cache_seq_lens(cfg, cache_len)
    out: Params = {"eager": {}, "segments": []}

    def entry(axis: int, paged: bool, caches) -> Params:
        return {"self": {name: fn(axis, paged,
                                  *(c["self"][name] for c in caches))
                         for name in caches[0]["self"]}}

    for idx in trees[0]["eager"]:
        out["eager"][idx] = entry(0, lens["eager"][idx] == cache_len,
                                  [t["eager"][idx] for t in trees])
    for i, seg in enumerate(lens["segments"]):
        out["segments"].append(entry(1, seg == cache_len,
                                     [t["segments"][i] for t in trees]))
    return out


def init_paged_caches(cfg: ModelConfig, *, num_slots: int, cache_len: int,
                      block_size: int, num_blocks: int, device) -> Params:
    """The pool tree on ``device``: paged leaves become ``(num_blocks,
    block_size, ...)`` pages (``pos`` -1 and K/V zero, so the sentinel
    invariant holds from the start); window leaves keep their per-slot
    layout.  The contiguous layout's shapes come from a ``meta`` tree, so
    the contiguous cache is never allocated."""
    check_paged_geometry(cache_len, block_size, num_blocks)

    def one(axis: int, paged: bool, leaf: torch.Tensor) -> torch.Tensor:
        shape = leaf.shape
        if paged:
            shape = shape[:axis] + (num_blocks, block_size) + shape[axis + 2:]
        fill = -1 if leaf.dtype == torch.int32 else 0
        return torch.full(shape, fill, dtype=leaf.dtype, device=device)

    return _map_caches(one, cfg, cache_len,
                       init_caches(cfg, num_slots, cache_len, "meta"))


def gather_caches(pool: Params, tables: torch.Tensor, cfg: ModelConfig, *,
                  num_slots: int, cache_len: int, block_size: int) -> Params:
    """pool + ``(num_slots, pages_per_slot)`` int64 tables -> contiguous
    caches: fresh tensors for paged leaves, the pool's own window rings."""
    flat = tables.reshape(-1)                   # (num_slots * pages,)

    def one(axis: int, paged: bool, leaf: torch.Tensor) -> torch.Tensor:
        if not paged:
            return leaf
        g = leaf.index_select(axis, flat)       # (.., S*P, bs, ..)
        return g.view(leaf.shape[:axis] + (num_slots, cache_len)
                      + leaf.shape[axis + 2:])

    return _map_caches(one, cfg, cache_len, pool)


def scatter_prefill(pool: Params, small: Params, table_row: torch.Tensor,
                    slot: int, cfg: ModelConfig, *, cache_len: int,
                    block_size: int) -> None:
    """Write a batch-1 prefilled cache into the pool at ``table_row``, in
    place.

    ``table_row`` is ``(pages_per_slot,)`` int64 physical ids: the
    request's pages followed by ``SENTINEL_BLOCK`` for the unallocated
    tail.  The whole row is written.  The sentinel may appear many times in
    ``table_row``, and ``index_copy_`` leaves the order of duplicate writes
    open: that is safe only because ``small`` is a fresh cache (the engine
    empties its prefill cache: K/V 0, pos -1), so every page written to the
    sentinel is the same all-empty page it already holds.  Window leaves
    are copied in at ``slot``, as the contiguous engine does.
    """
    pages = cache_len // block_size

    def one(axis: int, paged: bool, big: torch.Tensor,
            sm: torch.Tensor) -> None:
        if not paged:
            big.select(axis, slot).copy_(sm.select(axis, 0))
            return
        # (.., 1, cache_len, ..) -> (.., pages, block_size, ..)
        big.index_copy_(axis, table_row, sm.reshape(
            sm.shape[:axis] + (pages, block_size) + sm.shape[axis + 2:]))

    _map_caches(one, cfg, cache_len, pool, small)


def scatter_decode(pool: Params, new_contig: Params,
                   positions: torch.Tensor, tables: torch.Tensor,
                   cfg: ModelConfig, *, cache_len: int,
                   block_size: int) -> None:
    """Copy each slot's newly written cache entry back into its page, in
    place.

    ``positions`` is ``(num_slots,)``: the position each slot's decode step
    just wrote (its input token's).  An active slot hits a page it owns by
    the reservation invariant; an inactive slot hits the trash page through
    its all-``TRASH_BLOCK`` row.  Window leaves were written in place by
    the decode step (the gathered tree holds the pool's own rings).
    """
    positions = positions.long()
    blk = tables.gather(1, (positions // block_size)[:, None])[:, 0]
    off = positions % block_size
    rows = torch.arange(positions.shape[0], device=positions.device)

    def one(axis: int, paged: bool, big: torch.Tensor,
            new: torch.Tensor) -> None:
        if not paged:
            return
        if axis == 0:
            big[blk, off] = new[rows, positions]
        else:
            big[:, blk, off] = new[:, rows, positions]

    _map_caches(one, cfg, cache_len, pool, new_contig)
