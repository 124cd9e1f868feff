"""Finding / skip records and the ``repro_torch.analysis/v1`` report.

The port of ``repro/core/analysis/report.py``.  The report keeps the
reference's ``repro.analysis/v2`` layout (findings, waived, skips, the
per-cell ``cost`` section, the ``drift`` joins, the summary) under the
port's own schema name, as the tuning cache keeps the reference's layout
under ``repro_torch.tuning/v1``: a report of one package is never read as
the other's.  Each cell's ``cost`` adds ``launches``: the hand-written
kernels its launch plans hold (symbol, grid, block, dynamic shared
memory), in launch order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

SCHEMA = "repro_torch.analysis/v1"

#: the seven static passes, in report order (4 correctness + 3 performance)
PASSES = ("dtypes", "grid", "collectives", "recompile",
          "traffic", "roofline", "drift")

SEVERITIES = ("error", "warning")


@dataclasses.dataclass
class Finding:
    """One defect the auditor can prove from the trace (or source) alone."""

    kernel: str
    backend: str
    pass_name: str          # one of PASSES
    code: str               # stable slug, e.g. "f64-promotion", "write-race"
    message: str
    severity: str = "error"
    waived: bool = False
    waive_reason: Optional[str] = None
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SkipRecord:
    """A (cell, pass) the auditor could not run here, and why."""

    kernel: str
    backend: str
    pass_name: str
    reason: str

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CellResult:
    """Audit outcome of one (kernel, backend) registry cell."""

    kernel: str
    backend: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    skips: List[SkipRecord] = dataclasses.field(default_factory=list)
    passes_run: Tuple[str, ...] = ()
    #: ``{"chip", "traffic", "verdict", "launches", "points",
    #: "best_predicted"}``: the census and verdict of the default call
    cost: Optional[Dict[str, Any]] = None

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]


def _dedup_source_level(findings: List[Finding]) -> List[Finding]:
    """Recompile findings are per source location, not per cell: many
    registry cells share a defining module, so the report keeps one entry
    per (code, module, line) while per-cell results keep them all."""
    out, seen = [], set()
    for f in findings:
        if f.pass_name != "recompile":
            out.append(f)
            continue
        key = (f.code, f.detail.get("module"), f.detail.get("line"))
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def assemble_report(cells: List[CellResult], *, device_count: int,
                    smoke: bool, chip: Optional[str] = None,
                    drift: Optional[Tuple[List[Finding], Dict[str, Any]]]
                    = None) -> Dict[str, Any]:
    """The ``repro_torch.analysis/v1`` JSON document.  ``drift`` is the
    registry-level drift pass's outcome: its findings merge into the same
    findings/waived lists as the per-cell passes (so the CLI's exit code
    gates on them), its joins land under the top-level ``drift`` key."""
    drift_findings, drift_summary = drift if drift is not None else ([], {})
    all_errors = [f for c in cells for f in c.errors] \
        + [f for f in drift_findings if not f.waived]
    all_waived = [f for c in cells for f in c.waived] \
        + [f for f in drift_findings if f.waived]
    findings = _dedup_source_level(all_errors)
    waived = _dedup_source_level(all_waived)
    skips = [s for c in cells for s in c.skips]
    return {
        "schema": SCHEMA,
        "smoke": bool(smoke),
        "device_count": int(device_count),
        "chip": chip,
        "passes": list(PASSES),
        "matrix": [[c.kernel, c.backend] for c in cells],
        "findings": [f.to_json() for f in findings],
        "waived": [f.to_json() for f in waived],
        "skips": [s.to_json() for s in skips],
        "cost": {f"{c.kernel}[{c.backend}]": c.cost
                 for c in cells if c.cost is not None},
        "drift": drift_summary,
        "summary": {
            "cells": len(cells),
            "audited": sum(1 for c in cells if c.passes_run),
            "findings": len(findings),
            "waived": len(waived),
            "skips": len(skips),
            "drift_joined": drift_summary.get("joined", 0),
        },
    }
