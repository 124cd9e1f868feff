"""Slot allocator for the continuous-batching engine.

The port of ``repro/serving/slots.py::SlotAllocator``: a slot is one batch
row of the engine's decode step.  A request borrows a slot from prefill
through its last decode step and returns it on completion; the allocator
is a free heap, lowest id first, with a set shadowing it so a double free
is caught in O(1).  ``BlockAllocator`` comes with the paged KV layout
(ROADMAP).
"""

from __future__ import annotations

import heapq
from typing import List, Set


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
