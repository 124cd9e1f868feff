"""Grid pass — coverage of every launch plan's outputs.

The port of ``repro/core/analysis/grid.py``.  The reference evaluates each
Pallas output ``BlockSpec``'s index map over the whole grid; the port does
the same with each hand-written launch's ``Tile`` maps
(``core/portable.py::Launch``, built by the wrapper's ``launch_plan``), and
proves, without building or launching anything:

  * **no holes** — every tile of every output is written by at least one
    program (an unwritten tile is uninitialized memory: the wrappers
    allocate with ``torch.empty``);
  * **no write races** — a tile written by more than one program is legal
    only for a declared accumulator (``Launch.accumulators``, or the
    backend's ``declare_grid_contract(accumulator_outputs=...)``): on
    Hopper blocks run in no order, so anything else is the atomic-update
    pitfall of the paper;
  * **in-bounds tiles** — no program writes a tile outside the
    ceil(extent / tile) index space (the last tile of each axis is clipped
    at the array's end, and is legal).

The full audit re-plans every constraint-valid tunable point and holds each
to the same three proofs (``core/analysis/__init__.py::audit_cell``).
"""

from __future__ import annotations

import itertools
from typing import Any, List, Sequence, Tuple

from repro_torch.core.analysis import trace as T
from repro_torch.core.analysis.report import Finding

#: refuse to enumerate absurd grids (no registry kernel at its conformance
#: case is near this)
MAX_GRID_POINTS = 262144
#: nor more tile visits than this, summed over a launch's programs
MAX_TILE_VISITS = 1 << 21


def _points(grid: Tuple[int, ...]) -> int:
    n = 1
    for g in grid:
        n *= int(g)
    return n


def audit_launch(kernel: str, backend: str, launch: Any,
                 accumulator_outputs: Sequence[int],
                 variant: str = "") -> List[Finding]:
    """Audit one launch's output coverage.  Pure index-map arithmetic."""
    findings: List[Finding] = []
    grid = tuple(int(g) for g in launch.grid)
    tag = f" [{variant}]" if variant else ""
    where = f"{launch.symbol}{tag}"
    npoints = _points(grid)
    if npoints > MAX_GRID_POINTS:
        findings.append(Finding(
            kernel=kernel, backend=backend, pass_name="grid",
            code="grid-too-large", severity="warning",
            message=(f"{where}: grid {grid} has {npoints} programs — "
                     f"coverage not enumerated (cap {MAX_GRID_POINTS})"),
            detail={"grid": list(grid), "symbol": launch.symbol}))
        return findings
    accum = set(accumulator_outputs) | set(launch.accumulators)
    for out_idx, tile in enumerate(launch.outputs):
        nblocks = tuple(-(-s // t) for s, t in zip(tile.shape, tile.tile))
        visits = T.tile_visits(tile, grid, MAX_TILE_VISITS)
        if visits is None:
            findings.append(Finding(
                kernel=kernel, backend=backend, pass_name="grid",
                code="grid-too-large", severity="warning",
                message=(f"{where} output {out_idx} ({tile.name}): more "
                         f"than {MAX_TILE_VISITS} tile writes — coverage "
                         f"not enumerated"),
                detail={"grid": list(grid), "symbol": launch.symbol,
                        "output": out_idx}))
            continue
        oob = sorted(bi for bi in visits
                     if len(bi) != len(nblocks)
                     or any(i < 0 or i >= n for i, n in zip(bi, nblocks)))
        if oob:
            findings.append(Finding(
                kernel=kernel, backend=backend, pass_name="grid",
                code="out-of-bounds-tile",
                message=(f"{where} output {out_idx} ({tile.name}): tile(s) "
                         f"{oob[:4]} outside the {nblocks} tile space"),
                detail={"output": out_idx, "symbol": launch.symbol,
                        "oob": [list(b) for b in oob[:16]],
                        "nblocks": list(nblocks)}))
        holes = sorted(bi for bi in
                       itertools.product(*(range(n) for n in nblocks))
                       if bi not in visits)
        if holes:
            findings.append(Finding(
                kernel=kernel, backend=backend, pass_name="grid",
                code="coverage-hole",
                message=(f"{where} output {out_idx} ({tile.name}): tile(s) "
                         f"{holes[:4]} of {nblocks} never written — "
                         f"uninitialized output"),
                detail={"output": out_idx, "symbol": launch.symbol,
                        "holes": [list(h) for h in holes[:16]],
                        "nblocks": list(nblocks)}))
        oob_set = set(oob)
        revisited = sorted(bi for bi, c in visits.items()
                           if c > 1 and bi not in oob_set)
        if revisited and out_idx not in accum:
            findings.append(Finding(
                kernel=kernel, backend=backend, pass_name="grid",
                code="write-race",
                message=(f"{where} output {out_idx} ({tile.name}): tile(s) "
                         f"{revisited[:4]} written by several programs but "
                         f"output {out_idx} is not a declared accumulator "
                         f"(declare_grid_contract)"),
                detail={"output": out_idx, "symbol": launch.symbol,
                        "revisited": [list(r) for r in revisited[:16]]}))
    return findings


def run(kernel: str, backend: str, tr: "T.Trace",
        accumulator_outputs: Sequence[int],
        variant: str = "") -> Tuple[List[Finding], int]:
    """Audit every planned launch of a traced cell.  Returns (findings,
    number of launches audited): zero means the pass was vacuous for this
    backend (the plain PyTorch version), which the caller records."""
    findings: List[Finding] = []
    launches = tr.launches
    for _, launch in launches:
        findings.extend(audit_launch(kernel, backend, launch,
                                     accumulator_outputs, variant))
    return findings, len(launches)
