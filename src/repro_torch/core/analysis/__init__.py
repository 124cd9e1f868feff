"""Registry-wide static kernel auditor.

The port of ``repro.core.analysis``.  Conformance is dynamic: it runs one
case per cell, and cannot see a write race in a launch grid, a float64
op, a collective the contract does not allow, or a Python scalar baked
into an ``lru_cache``'d builder.  This package is the layer ahead of
execution: every (kernel, backend) cell of the live registry is traced on
its conformance case (``trace.trace``: the backend runs once on ``meta``
twins of its inputs; a hand-written wrapper hands its launch plan to the
trace instead of building or launching, ``portable.launch_observed``), and
seven passes run without executing anything on a device:

  1. **dtypes** (``analysis.dtypes``) — float64 lint on the trace and the
     accumulation dtype of every reduction, psum and launch plan;
  2. **grid** (``analysis.grid``) — coverage of every launch plan's
     outputs: holes, write races and out-of-bounds tiles, swept over every
     constraint-valid tunable point in the full audit;
  3. **collectives** (``analysis.collectives_audit``) — the census of
     ``distributed.collectives`` against each backend's declared contract
     (slab stencil 2 ppermutes, pencil 4, the overlap variants' witness;
     any undeclared all_gather is a finding);
  4. **recompile** (``analysis.recompile``) — AST scan for ``lru_cache``'d
     trace producers (``_library()``, ``_build.load``) keyed on runtime
     Python scalars;
  5. **traffic**, 6. **roofline**, 7. **drift** (``analysis.cost``) — the
     HBM byte and flop census (launch plans tile by tile), its verdict on
     the detected chip, and the predictions joined to measured time.

The audited matrix derives from ``conformance.conformance_pairs()``, never
a hand-written list, minus the kernels registered ``traceable=False`` (the
serving engine's host-side loops).  ``python -m repro_torch.core.analysis``
walks it and writes a ``repro_torch.analysis/v1`` JSON report; the port's
shards share one device (``distributed/domain.py``), so, unlike the
reference's CLI, it never re-executes under forced devices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.analysis import (collectives_audit, cost, dtypes, grid,
                                       recompile)
from repro_torch.core.analysis import trace as T
from repro_torch.core.analysis.report import (PASSES, SCHEMA, CellResult,
                                              Finding, SkipRecord,
                                              assemble_report)

__all__ = [
    "PASSES",
    "SCHEMA",
    "SMOKE_KERNELS",
    "Finding",
    "SkipRecord",
    "CellResult",
    "audit_cell",
    "audit_pairs",
    "audit_registry",
    "launch_json",
    "write_report",
]

#: the smoke subset: one kernel per shape of trouble (the two-pass dot, a
#: halo-exchange stencil, the pair-table scratch of miniBUDE, and the
#: decode kernel's combine of its partials).  Still derived:
#: conformance_pairs() filtered to these kernels.
SMOKE_KERNELS = ("stencil7", "babelstream.dot", "minibude.fasten",
                 "attention.decode")

#: bound on the constraint-valid tunable points swept per cell by the full
#: audit; anything dropped is recorded as a skip, never silently truncated.
#: Planning a point takes milliseconds (no jaxpr to build), so the bound
#: covers every declared space of the registry (stencil7's shard_cuda has
#: the largest, 162 points), where the reference's stops at 32
MAX_TUNABLE_POINTS = 256


def _registered() -> None:
    import repro_torch.kernels  # noqa: F401  (registers every kernel)
    import repro_torch.serving.portable  # noqa: F401


def audit_pairs(smoke: bool = False) -> List[Tuple[str, str]]:
    """The audited (kernel, backend) matrix: conformance_pairs(), whole or
    filtered to the smoke kernels, without the kernels registered
    ``traceable=False`` (host-side driver loops, which conformance still
    runs)."""
    _registered()
    from repro_torch.core import conformance
    from repro_torch.core.portable import registry
    pairs = [(k, b) for k, b in conformance.conformance_pairs()
             if registry.get(k).traceable]
    if smoke:
        pairs = [(k, b) for k, b in pairs if k in SMOKE_KERNELS]
    return pairs


def _short(exc: BaseException) -> str:
    msg = str(exc).split("\n")[0]
    return f"{type(exc).__name__}: {msg[:200]}"


def _variant_tag(kwargs: Dict[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(kwargs.items()))


def launch_json(tr: "T.Trace") -> List[Dict[str, Any]]:
    """The planned launches of a trace: wrapper, symbol, grid, block and
    dynamic shared memory, in launch order."""
    return [{"wrapper": name, "symbol": launch.symbol,
             "grid": list(launch.grid), "block": list(launch.block),
             "smem": launch.smem}
            for name, launch in tr.launches]


def _recompile_findings(kernel: str, backend: str, fn: Any) -> List[Finding]:
    module = recompile.module_of(fn)
    if module is None or not module.startswith("repro_torch"):
        return []
    findings = []
    for items in recompile.scan_module(module):
        h = dict(items)
        waived = h["waiver"] is not None
        findings.append(Finding(
            kernel=kernel, backend=backend, pass_name="recompile",
            code="scalar-cache-key",
            message=(f"{h['module']}:{h['line']} calls lru_cache'd "
                     f"trace-producing builder {h['builder']!r} with "
                     f"runtime scalar(s): {', '.join(h['scalars'])} — one "
                     f"program per distinct value"),
            waived=waived, waive_reason=h["waiver"],
            detail={"module": h["module"], "line": h["line"],
                    "builder": h["builder"], "scalars": list(h["scalars"])}))
    return findings


def audit_cell(kernel: str, backend: str, *,
               smoke: bool = False) -> CellResult:
    """Run the static passes on one registry cell.  Never builds or
    launches a kernel: a hand-written backend is audited through the
    launch plans its wrappers hand to the trace.  A pass that cannot run
    comes back as a ``SkipRecord`` with its reason."""
    _registered()
    from repro_torch.core import conformance
    from repro_torch.core.portable import registry
    from repro_torch.core.roofline import detect_chip

    k = registry.get(kernel)
    b = k.backend(backend)
    res = CellResult(kernel=kernel, backend=backend)
    passes_run: List[str] = []

    # source-level: runs even for cells that cannot trace
    res.findings.extend(_recompile_findings(kernel, backend, b.fn))
    passes_run.append("recompile")

    case = conformance.CASES.get(kernel)
    if case is None:
        for p in ("dtypes", "grid", "collectives"):
            res.skips.append(SkipRecord(
                kernel, backend, p,
                "no conformance case (conformance itself fails this cell)"))
        res.passes_run = tuple(passes_run)
        return res
    args, kwargs = case()

    variants = collectives_audit.normalize_contract(
        k.comm_contract(backend), args)
    declared = backend in k.comm_contracts
    traces: Dict[Tuple[Tuple[str, Any], ...], Any] = {}

    def trace_with(extra: Dict[str, Any]):
        call = {**kwargs, **extra}
        key = tuple(sorted(call.items(), key=lambda kv: kv[0]))
        if key not in traces:
            traces[key] = T.trace(b.fn, args, call)
        return traces[key]

    # --- collectives, one trace per contract variant ---------------------
    coll_ok = True
    for vkw, expected in variants:
        try:
            tr = trace_with(vkw)
        except Exception as exc:   # recorded: a cell this host can't trace
            res.skips.append(SkipRecord(kernel, backend, "collectives",
                                        f"variant {_variant_tag(vkw)} "
                                        f"untraceable: {_short(exc)}"))
            coll_ok = False
            continue
        res.findings.extend(collectives_audit.check_counts(
            kernel, backend, tr, expected, declared,
            variant=_variant_tag(vkw)))
    if coll_ok:
        passes_run.append("collectives")

    # --- dtypes and grid on the default variant's trace ------------------
    default_kw = variants[0][0]
    try:
        tr = trace_with(default_kw)
    except Exception as exc:       # recorded as the passes' skips
        for p in ("dtypes", "grid", "traffic", "roofline"):
            res.skips.append(SkipRecord(kernel, backend, p, _short(exc)))
        res.passes_run = tuple(passes_run)
        return res

    res.findings.extend(dtypes.run_accum_check(kernel, backend, tr,
                                               k.accum_dtype))
    res.findings.extend(dtypes.run_f64_lint(kernel, backend, tr))
    passes_run.append("dtypes")

    accum = k.grid_contract(backend).get("accumulator_outputs", ())
    gfindings, nlaunches = grid.run(kernel, backend, tr, accum,
                                    variant=_variant_tag(default_kw))
    res.findings.extend(gfindings)
    passes_run.append("grid")

    # --- traffic census and roofline verdict -----------------------------
    chip = detect_chip()
    t = cost.census(tr)
    v = cost.verdict(t, chip)
    res.findings.extend(cost.traffic_findings(
        kernel, backend, k, t, variant=_variant_tag(default_kw)))
    res.findings.extend(cost.roofline_findings(kernel, backend, k, t, v))
    res.cost = {"chip": chip.name, "traffic": t.to_json(),
                "verdict": v.to_json(), "launches": launch_json(tr),
                "points": [], "best_predicted": None}
    passes_run.extend(["traffic", "roofline"])

    # full audit: every constraint-valid point of the declared space must
    # still plan, cover its outputs and stay inside the traffic limit
    space = k.tunable_space(backend)
    if not smoke and space is not None:
        try:
            points = space.valid_points(*T.as_meta(tuple(args)), **kwargs)
        except Exception as exc:   # recorded: the sweep is skipped
            points = []
            res.skips.append(SkipRecord(
                kernel, backend, "grid",
                f"constraint not evaluable here: {_short(exc)}"))
        if len(points) > MAX_TUNABLE_POINTS:
            res.skips.append(SkipRecord(
                kernel, backend, "grid",
                f"tunable sweep capped at {MAX_TUNABLE_POINTS} of "
                f"{len(points)} valid points"))
            points = points[:MAX_TUNABLE_POINTS]
        for pt in points:
            try:
                ptr = trace_with({**default_kw, **pt})
            except Exception as exc:   # the finding names the point
                res.findings.append(Finding(
                    kernel=kernel, backend=backend, pass_name="grid",
                    code="constraint-admits-untraceable-point",
                    message=(f"constraint-valid point {pt} does not even "
                             f"trace: {_short(exc)}"),
                    detail={"point": {n: repr(v) for n, v in pt.items()}}))
                continue
            if nlaunches:
                pfind, _ = grid.run(kernel, backend, ptr, accum,
                                    variant=_variant_tag(pt))
                res.findings.extend(pfind)
            pt_traffic = cost.census(ptr)
            pv = cost.verdict(pt_traffic, chip)
            res.findings.extend(cost.traffic_findings(
                kernel, backend, k, pt_traffic, variant=_variant_tag(pt)))
            res.cost["points"].append({
                "params": {n: repr(v) for n, v in pt.items()},
                "flops": pt_traffic.flops,
                "hbm_bytes": pt_traffic.hbm_bytes,
                "inflation": pt_traffic.inflation,
                "predicted_ms": pv.predicted_s * 1e3, "bound": pv.bound})
        if res.cost["points"]:
            best = min(res.cost["points"], key=lambda p: p["predicted_ms"])
            res.cost["best_predicted"] = best["params"]

    res.passes_run = tuple(passes_run)
    return res


def audit_registry(*, smoke: bool = False, tuning_cache: Any = None,
                   telemetry_trace: Optional[str] = None,
                   drift_band: Optional[float] = None) -> Dict[str, Any]:
    """Audit the whole derived matrix and assemble the report: the
    per-cell passes, then the drift pass, which joins the tuning cache
    (``tuning_cache``, default the process's) and an optional telemetry
    JSONL trace to the predictions for the same matrix."""
    from repro_torch.core.roofline import detect_chip
    pairs = audit_pairs(smoke)
    cells = [audit_cell(k, b, smoke=smoke) for k, b in pairs]
    drift = cost.drift_gate(cache_path=tuning_cache,
                            trace_path=telemetry_trace,
                            pairs=set(pairs), band=drift_band)
    return assemble_report(cells, device_count=cost.here()[1], smoke=smoke,
                           chip=detect_chip().name, drift=drift)


def write_report(report: Dict[str, Any], path: str) -> None:
    import json
    import os
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
