"""Slot and KV-page allocators for the continuous-batching engine.

The port of ``repro/serving/slots.py`` (plain Python, line for line).  Two
granularities of cache ownership:

  * ``SlotAllocator`` — a slot is one batch row of the engine's decode
    step.  A request borrows a slot from prefill through its last decode
    step and returns it on completion; the allocator is a free heap, lowest
    id first, with a set shadowing it so a double free is caught in O(1).

  * ``BlockAllocator`` — the paged KV layout (vLLM idiom): the KV cache is
    a shared pool of ``(num_blocks, block_size)`` pages and each request
    owns just the pages its positions need
    (``ceil((prompt_len + max_new - 1) / block_size)``), recorded in a
    per-slot block table.  Admission is gated on free pages rather than a
    whole ``cache_len`` row.

    Two physical pages are reserved and never enter the free pool:

      - ``SENTINEL_BLOCK`` (0): every unallocated block-table entry points
        here.  Its positions are always -1 ("empty" to the position-masked
        attention) and its K/V always zero, so gathering it contributes
        nothing.  The only writes it receives are the all-empty tail pages
        of a fresh prefill insert, so the invariant holds without wipes.
      - ``TRASH_BLOCK`` (1): every entry of an inactive slot's table points
        here, so the decode step's unconditional per-slot cache write
        (inactive slots decode garbage whose output is ignored) lands in a
        page no active request maps.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Set

#: the page every unallocated block-table entry points at (pos -1 and zero
#: K/V everywhere); never allocated
SENTINEL_BLOCK = 0
#: the page inactive slots' decode writes land in; never allocated, never
#: mapped by an active request's table row
TRASH_BLOCK = 1
#: ids below this are reserved (see above) and never enter the free pool
RESERVED_BLOCKS = 2


class SlotAllocator:
    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots))
        heapq.heapify(self._free)
        self._free_set: Set[int] = set(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        slot = heapq.heappop(self._free)
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free_set:
            raise ValueError(f"slot {slot} already free")
        heapq.heappush(self._free, slot)
        self._free_set.add(slot)

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.num_slots - len(self._free)


class BlockAllocator:
    """Free list over the physical pages of a paged KV pool.

    ``num_blocks`` counts every physical page, the two reserved ids
    included; ``capacity()`` is what requests can own.  Like
    ``SlotAllocator``: lowest ids first, a set-backed double-free check.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if num_blocks <= RESERVED_BLOCKS:
            raise ValueError(
                f"need more than {RESERVED_BLOCKS} blocks "
                f"({RESERVED_BLOCKS} are reserved), got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(RESERVED_BLOCKS, num_blocks))
        heapq.heapify(self._free)
        self._free_set: Set[int] = set(self._free)

    def blocks_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request needs for its whole lifetime.

        Cache entries are written for positions ``0 .. prompt_len +
        max_new_tokens - 2`` (the last sampled token is never written
        back), so ``prompt_len + max_new_tokens - 1`` positions are mapped.
        """
        need = max(1, prompt_len + max_new_tokens - 1)
        return -(-need // self.block_size)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        out = [heapq.heappop(self._free) for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not RESERVED_BLOCKS <= b < self.num_blocks:
                raise ValueError(f"block {b} out of range or reserved")
            if b in self._free_set:
                raise ValueError(f"block {b} already free")
        for b in blocks:
            heapq.heappush(self._free, b)
            self._free_set.add(b)

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.capacity() - len(self._free)

    def capacity(self) -> int:
        return self.num_blocks - RESERVED_BLOCKS
