"""Collective traffic of a costed step.

The counterpart of ``repro/core/hlo_analysis.py``, which parses the
collectives out of compiled HLO text.  The port's step is costed by the
op-cost walker (``core/op_cost.py``), which counts each ``_c10d_functional``
collective once, by kind, with the bytes of its result on one rank — the
reference's proxy for link traffic (``hlo_analysis.py:113-136``).
``collective_stats(cost)`` stands for ``parse_collective_bytes(hlo_text)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["CollectiveStats", "collective_stats", "dtype_bytes"]


def dtype_bytes(dtype: torch.dtype) -> int:
    """Bytes of one element of a torch dtype."""
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dtype.itemsize


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind collective byte/opcount totals for one step."""

    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {
            k: {"count": self.count_by_kind.get(k, 0),
                "bytes": self.bytes_by_kind.get(k, 0)}
            for k in sorted(set(self.bytes_by_kind) | set(self.count_by_kind))
        }


def collective_stats(cost) -> CollectiveStats:
    """The collectives of a costed step (``op_cost.OpCost``), by kind:
    all-gather, all-reduce, reduce-scatter, all-to-all, collective-permute."""
    return CollectiveStats(
        bytes_by_kind={k: int(v) for k, v in
                       sorted(cost.collective_bytes_by_kind.items())},
        count_by_kind={k: int(v) for k, v in
                       sorted(cost.collective_count_by_kind.items())})
