"""Traffic, roofline and drift passes — the static performance auditor.

The port of ``repro/core/analysis/cost.py``.  Three execution-free passes
over the same op traces as the correctness passes:

  5. **traffic** — a census of HBM bytes read and written and of flops.
     ATen ops count their flops as the op-cost walker counts them
     (``core/op_cost.py``).  Their bytes are not the census's: an op
     outside a launch plan is read as fused, the reference's reading of an
     XLA op (its bytes, what eager PyTorch moves op by op, are kept apart
     as ``eager_bytes``).  Each planned launch of a hand-written kernel
     (``portable.Launch``) is costed by enumerating its tiles over its
     grid, the grid pass's arithmetic: a tile that several programs read
     is a *re-read* (a halo plane, a pair table every block stages), an
     output tile written again is an accumulator *revisit* (written each
     time and read back), and scratch (the Hartree-Fock integrals, the
     WKV's increments, the dot's partials) is traffic like any other.  The
     call's boundary (every tensor it is given and returns) is the
     compulsory floor; ``inflation = traffic / floor``, and a cell above
     its declared (or the default) limit is a finding;
  6. **roofline** — the three terms on the detected ``ChipSpec``
     (``core/roofline.py``): flops over the peak rate of their dtype (the
     data sheet's float32, float64 and bfloat16 rates where the chip's
     table has them, ``DTYPE_PEAKS``), bytes over HBM bandwidth,
     collective bytes over the link; the largest is the predicted time and
     its name the bound, which must match ``declare_roofline_contract``.
     The port's shards share one device (``distributed/domain.py``), so no
     term is divided by a shard count, and a collective between them is a
     copy on that device: its payload is read and written through HBM, and
     the link term counts only for a census of ``devices > 1``;
  7. **drift** — the predictions joined to *measured* seconds: the tuning
     cache (``core/tuning.py``, ``REPRO_TORCH_TUNING_CACHE``) and the
     ``registry.time_backend.result`` events of a telemetry trace
     (``core/telemetry``), measured on this process's platform.  The
     median measured/predicted ratio is the host's calibration; a cell
     whose own ratio passes ``band x`` that median is a finding.

The same model is the prior of ``tuning.tune(search="model")``:
:func:`rank_points` orders a tunable grid by predicted time and
:func:`prune_dominated` drops points worse on traffic and on parallelism
than another before anything is timed.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import re
import statistics
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.analysis import trace as T
from repro_torch.core.analysis.grid import MAX_GRID_POINTS, MAX_TILE_VISITS
from repro_torch.core.analysis.report import Finding
from repro_torch.core.roofline import ChipSpec, detect_chip

__all__ = [
    "Traffic",
    "Verdict",
    "Measurement",
    "census",
    "verdict",
    "peak_flops",
    "traffic_findings",
    "roofline_findings",
    "drift_gate",
    "collect_measurements",
    "predict_seconds",
    "parse_shape_signature",
    "rank_points",
    "prune_dominated",
    "DEFAULT_INFLATION_LIMIT",
    "DEFAULT_DRIFT_BAND",
    "MIN_DRIFT_JOINS",
    "DRIFT_WAIVERS",
    "DTYPE_PEAKS",
]

#: traffic over the compulsory floor tolerated without a declared limit
#: (the reference's): room for halo re-reads and scratch, while a tile map
#: that re-streams whole operands a program still fires
DEFAULT_INFLATION_LIMIT = 8.0

#: drift findings fire when a cell's measured/predicted ratio passes
#: ``band x`` the median ratio of every join (the host's calibration)
DEFAULT_DRIFT_BAND = 8.0

#: the calibration median means nothing over fewer joins than this: the
#: gate reports the joins and emits no finding below it
MIN_DRIFT_JOINS = 3

#: (kernel, backend) cells whose drift is understood and accepted; the
#: finding still appears in the report's ``waived`` list
DRIFT_WAIVERS: Dict[Tuple[str, str], str] = {}

#: FLOP/s by dtype of the chips whose data sheet gives them (NVIDIA H100
#: SXM, dense): float32 and float64 on the FMA pipes, bfloat16 and float16
#: on the tensor cores.  Other dtypes and chips run at ``peak_flops``.
DTYPE_PEAKS: Dict[str, Dict[str, float]] = {
    "nvidia-h100": {"float32": 67e12, "float64": 34e12,
                    "bfloat16": 989e12, "float16": 989e12},
}


def _short(exc: BaseException) -> str:
    msg = str(exc).split("\n")[0]
    return f"{type(exc).__name__}: {msg[:200]}"


def _prod(xs) -> float:
    out = 1.0
    for x in xs:
        out *= float(x)
    return out


def peak_flops(chip: ChipSpec, dtype: str) -> float:
    return DTYPE_PEAKS.get(chip.name, {}).get(dtype, chip.peak_flops)


@dataclasses.dataclass
class Traffic:
    """The census: one traced call's modelled work and data movement."""

    flops: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    hbm_read_bytes: float = 0.0
    hbm_write_bytes: float = 0.0
    hbm_min_bytes: float = 0.0       # compulsory floor: inputs + outputs
    eager_bytes: float = 0.0         # the ATen ops' bytes, op by op
    collective_bytes: float = 0.0
    collective_count: float = 0.0
    reread_bytes: float = 0.0        # input tiles read by several programs
    revisit_bytes: float = 0.0       # output tiles written again
    launches: int = 0                # planned hand-written launches
    grid_steps: float = 0.0          # their programs
    approx_grids: int = 0            # tiles costed without enumeration
    devices: int = 1                 # devices the shards spread over

    @property
    def hbm_bytes(self) -> float:
        return self.hbm_read_bytes + self.hbm_write_bytes

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def inflation(self) -> float:
        return self.hbm_bytes / max(self.hbm_min_bytes, 1.0)

    def add_flops(self, flops: float, dtype: str) -> None:
        self.flops += flops
        self.flops_by_dtype[dtype] += flops

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["flops_by_dtype"] = dict(sorted(self.flops_by_dtype.items()))
        d["hbm_bytes"] = self.hbm_bytes
        d["arithmetic_intensity"] = self.arithmetic_intensity
        d["inflation"] = self.inflation
        return d


def _clipped_bytes(bi: Tuple[int, ...], tile: Any) -> float:
    elems = 1.0
    for i, b, s in zip(bi, tile.tile, tile.shape):
        extent = min(b, s - i * b)
        if extent <= 0 or i < 0:
            return 0.0   # out of bounds: the grid pass owns that finding
        elems *= extent
    return elems * tile.itemsize


def _sampled_tiles(tile: Any, grid: Tuple[int, ...]) -> float:
    """Mean tiles a program touches, over up to 64 programs spread along
    the grid (for a grid too large to enumerate)."""
    steps = int(_prod(grid))
    picks = sorted({int(i * steps / 64) for i in range(min(64, steps))})
    g = tuple(grid) + (1,) * (3 - len(grid))
    total = 0
    for p in picks:
        pid = (p % g[0], p // g[0] % g[1], p // (g[0] * g[1]))
        total += len(set(T._indices(tile, pid)))
    return total / max(len(picks), 1)


def _tile_traffic(tile: Any, grid: Tuple[int, ...],
                  t: Traffic) -> Tuple[float, float]:
    """(bytes over every program's visits, bytes of the distinct tiles)."""
    steps = _prod(grid)
    visits = (T.tile_visits(tile, grid, MAX_TILE_VISITS)
              if steps <= MAX_GRID_POINTS else None)
    if visits is None:
        t.approx_grids += 1
        total = steps * _sampled_tiles(tile, grid) \
            * _prod(tile.tile) * tile.itemsize
        return total, min(total, _prod(tile.shape) * tile.itemsize)
    total = distinct = 0.0
    for bi, count in visits.items():
        b = _clipped_bytes(bi, tile)
        total += count * b
        distinct += b
    return total, distinct


def _launch_traffic(launch: Any, t: Traffic) -> None:
    grid = tuple(int(g) for g in launch.grid)
    t.launches += 1
    t.grid_steps += _prod(grid)
    t.add_flops(launch.flops, launch.flops_dtype)
    for tile in launch.outputs:
        total, distinct = _tile_traffic(tile, grid, t)
        extra = max(0.0, total - distinct)
        # every visit writes the tile; a revisit reads the partial back
        t.hbm_write_bytes += total
        t.hbm_read_bytes += extra
        t.revisit_bytes += extra
    for tile in launch.inputs:
        total, distinct = _tile_traffic(tile, grid, t)
        t.hbm_read_bytes += total
        t.reread_bytes += max(0.0, total - distinct)


def _op_dtype(op: Any) -> str:
    for d in op.out_dtypes + op.in_dtypes:
        dt = getattr(torch, d, None)
        if isinstance(dt, torch.dtype) and dt.is_floating_point:
            return d
    return "float32"


def census(tr: "T.Trace") -> Traffic:
    """One trace into a :class:`Traffic` record, its shards on one device
    (the port's meshes on one card).  Pure arithmetic."""
    t = Traffic()
    for op in tr.ops:
        if op.kind == "aten":
            t.add_flops(op.flops, _op_dtype(op))
            t.eager_bytes += op.hbm_bytes
        elif op.kind == "collective":
            t.collective_bytes += op.moved_bytes
            t.collective_count += op.count
            t.hbm_read_bytes += op.moved_bytes
            t.hbm_write_bytes += op.moved_bytes
            if op.name == "psum" and op.in_dtypes:
                # the reference's count: one add a payload element
                size = getattr(torch, op.in_dtypes[0]).itemsize
                t.add_flops(op.moved_bytes / size, op.in_dtypes[0])
        else:
            for launch in op.launches:
                _launch_traffic(launch, t)
    t.hbm_min_bytes = tr.input_bytes + tr.output_bytes
    # the boundary is every cell's floor; the planned tiles replace it
    # where they move more (a cell of ATen ops alone is at its floor)
    t.hbm_read_bytes = max(t.hbm_read_bytes, tr.input_bytes)
    t.hbm_write_bytes = max(t.hbm_write_bytes, tr.output_bytes)
    return t


# --------------------------------------------------------------------------
# roofline verdict
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Verdict:
    """Three-term static roofline of one cell on one chip."""

    chip: str
    compute_s: float
    memory_s: float
    collective_s: float
    predicted_s: float
    bound: str                      # "compute" | "memory" | "collective"
    attainable_frac: float          # compute term's share of the time

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["predicted_ms"] = self.predicted_s * 1e3
        return d


def verdict(t: Traffic, chip: Optional[ChipSpec] = None) -> Verdict:
    """The largest of the three terms is the predicted time, its name the
    bound, and the compute term's share of it the attainable fraction of
    the peak rates."""
    chip = chip if chip is not None else detect_chip()
    compute_s = sum(f / peak_flops(chip, d)
                    for d, f in t.flops_by_dtype.items())
    memory_s = t.hbm_bytes / chip.hbm_bw
    collective_s = t.collective_bytes / chip.ici_bw if t.devices > 1 else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    predicted_s = max(terms.values())
    bound = max(terms, key=terms.get)
    attainable = compute_s / predicted_s if predicted_s > 0 else 1.0
    return Verdict(chip=chip.name, compute_s=compute_s, memory_s=memory_s,
                   collective_s=collective_s, predicted_s=predicted_s,
                   bound=bound, attainable_frac=attainable)


def traffic_findings(kernel: str, backend: str, k: Any, t: Traffic,
                     variant: str = "") -> List[Finding]:
    """Traffic check: modelled traffic against the compulsory floor."""
    contract = k.roofline_contract(backend)
    limit = float(contract.get("traffic_inflation_limit",
                               DEFAULT_INFLATION_LIMIT))
    tag = f" [{variant}]" if variant else ""
    if t.inflation <= limit:
        return []
    return [Finding(
        kernel=kernel, backend=backend, pass_name="traffic",
        code="traffic-inflation",
        message=(f"modelled HBM traffic{tag} is {t.inflation:.1f}x the "
                 f"compulsory {t.hbm_min_bytes:.0f} bytes (re-reads "
                 f"{t.reread_bytes:.0f}, revisits {t.revisit_bytes:.0f}); "
                 f"limit {limit:g}x — declare_roofline_contract raises it "
                 f"where that is intended"),
        detail={"inflation": t.inflation, "limit": limit,
                "hbm_bytes": t.hbm_bytes, "floor_bytes": t.hbm_min_bytes,
                "reread_bytes": t.reread_bytes,
                "revisit_bytes": t.revisit_bytes, "variant": variant})]


def roofline_findings(kernel: str, backend: str, k: Any, t: Traffic,
                      v: Verdict) -> List[Finding]:
    """Roofline check: the verdict against the declared bound."""
    declared = k.roofline_contract(backend).get("bound")
    if not declared or v.bound == declared:
        return []
    return [Finding(
        kernel=kernel, backend=backend, pass_name="roofline",
        code="bound-mismatch",
        message=(f"declared {declared}-bound but the {v.chip} roofline says "
                 f"{v.bound}-bound (AI {t.arithmetic_intensity:.2f} "
                 f"FLOP/byte, predicted {v.predicted_s * 1e3:.4g} ms)"),
        detail={"declared": declared, "verdict": v.bound,
                "arithmetic_intensity": t.arithmetic_intensity,
                "predicted_ms": v.predicted_s * 1e3, "chip": v.chip})]


def predict(fn: Any, args: tuple, kwargs: dict,
            chip: Optional[ChipSpec] = None
            ) -> Tuple[Traffic, Verdict, "T.Trace"]:
    """Trace ``fn(*args, **kwargs)`` and cost it: (census, verdict,
    trace)."""
    tr = T.trace(fn, args, kwargs)
    t = census(tr)
    return t, verdict(t, chip), tr


# --------------------------------------------------------------------------
# drift: predictions against measured time
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Measurement:
    """One measured (kernel, backend, shape, params) -> seconds sample."""

    kernel: str
    backend: str
    shape: str                      # tuning.shape_signature string
    params: Dict[str, Any]
    seconds: float
    source: str                     # "cache" | "telemetry"
    devices: int = 1
    platform: str = ""


_ARRAY_SIG = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)\[([0-9,]*)\]$")


def parse_shape_signature(
        sig: str) -> Optional[Tuple[Tuple[Any, ...], Dict[str, Any]]]:
    """Invert ``tuning.shape_signature``: ``float32[8,64];0.5;k=int32[2]``
    -> (positional args, kwargs).  Array parts come back as ``meta``
    tensors (traceable, no data), scalars by ``ast.literal_eval``; None
    when a part is neither, and that measurement is not joined."""
    args: List[Any] = []
    kwargs: Dict[str, Any] = {}
    if sig == "":
        return tuple(args), kwargs
    for part in sig.split(";"):
        name = None
        if "=" in part and not part.startswith("="):
            maybe, rest = part.split("=", 1)
            if maybe.isidentifier():
                name, part = maybe, rest
        m = _ARRAY_SIG.match(part)
        if m:
            dtype = getattr(torch, m.group(1), None)
            if not isinstance(dtype, torch.dtype):
                return None
            dims = tuple(int(d) for d in m.group(2).split(",") if d)
            val: Any = torch.empty(dims, dtype=dtype, device="meta")
        else:
            try:
                val = ast.literal_eval(part)
            except (ValueError, SyntaxError):
                return None
        if name is None:
            args.append(val)
        else:
            kwargs[name] = val
    return tuple(args), kwargs


def _cache_measurements(cache_path: Any,
                        pairs: Optional[set]) -> List[Measurement]:
    from pathlib import Path

    from repro_torch.core import tuning
    path = Path(cache_path) if cache_path is not None \
        else tuning.default_cache_path()
    out = []
    for key_str, entry in tuning.TuningCache._read_entries(path).items():
        parts = key_str.split("|")
        if len(parts) != 7:
            continue
        kernel, backend, shape, _dtype, platform, _code, dev = parts
        if pairs is not None and (kernel, backend) not in pairs:
            continue
        try:
            devices = int(dev.lstrip("d"))
            seconds = float(entry.get("seconds", 0.0))
        except (TypeError, ValueError):
            continue
        if not (seconds > 0.0 and math.isfinite(seconds)):
            continue
        out.append(Measurement(
            kernel=kernel, backend=backend, shape=shape,
            params=tuning.params_from_cache(entry.get("params", {}) or {}),
            seconds=seconds, source="cache", devices=devices,
            platform=platform))
    return out


def _telemetry_measurements(trace_path: str,
                            pairs: Optional[set]) -> List[Measurement]:
    from repro_torch.core import tuning
    from repro_torch.core.telemetry import export
    try:
        doc = export.read_events(trace_path)
    except (OSError, ValueError):
        return []
    out = []
    for ev in doc.get("events", ()):
        if ev.get("name") != "registry.time_backend.result":
            continue
        attrs = ev.get("attrs", {}) or {}
        kernel, backend = attrs.get("kernel"), attrs.get("backend")
        shape, seconds = attrs.get("shape"), attrs.get("seconds")
        if not kernel or not backend or shape is None or seconds is None:
            continue
        if pairs is not None and (kernel, backend) not in pairs:
            continue
        try:
            seconds = float(seconds)
            params = json.loads(attrs.get("params_json", "{}"))
        except (TypeError, ValueError):
            continue
        if not (seconds > 0.0 and math.isfinite(seconds)):
            continue
        out.append(Measurement(
            kernel=kernel, backend=backend, shape=str(shape),
            params=tuning.params_from_cache(params or {}), seconds=seconds,
            source="telemetry", devices=int(attrs.get("devices", 1) or 1),
            platform=str(attrs.get("platform", ""))))
    return out


def here() -> Tuple[str, int]:
    """(platform, device count) of this process, as the tuning key names
    them: the first CUDA device's name, or ``"cpu"`` and 1."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0), torch.cuda.device_count()
    return "cpu", 1


def collect_measurements(cache_path: Any = None,
                         trace_path: Optional[str] = None,
                         pairs: Optional[set] = None) -> List[Measurement]:
    """Measured samples joinable to predictions, deduped on (kernel,
    backend, shape, params), keeping the fastest.  Only samples of this
    process's platform at a device count it has are kept: a CPU timing
    never calibrates a prediction for the card."""
    platform, devices = here()
    ms = _cache_measurements(cache_path, pairs)
    if trace_path:
        ms += _telemetry_measurements(trace_path, pairs)
    best: Dict[Tuple[str, str, str, str], Measurement] = {}
    for m in ms:
        if m.platform and m.platform != platform:
            continue
        if m.devices > devices:
            continue
        key = (m.kernel, m.backend, m.shape,
               json.dumps(m.params, sort_keys=True, default=repr))
        if key not in best or m.seconds < best[key].seconds:
            best[key] = m
    return [best[k] for k in sorted(best)]


def predict_seconds(m: Measurement,
                    chip: Optional[ChipSpec] = None) -> Optional[float]:
    """Predicted seconds for one measurement's exact call, or None when it
    cannot be traced here (unknown cell, unparsable signature, a plan that
    refuses the shape)."""
    from repro_torch.core.portable import registry
    try:
        b = registry.get(m.kernel).backends[m.backend]
    except KeyError:
        return None
    parsed = parse_shape_signature(m.shape)
    if parsed is None:
        return None
    args, sig_kwargs = parsed
    try:
        _, v, _ = predict(b.fn, args, {**sig_kwargs, **m.params}, chip)
    except Exception:       # a cell this host cannot trace is not joined
        return None
    return v.predicted_s if v.predicted_s > 0 else None


def drift_gate(*, cache_path: Any = None, trace_path: Optional[str] = None,
               pairs: Optional[set] = None,
               band: Optional[float] = None,
               chip: Optional[ChipSpec] = None,
               ) -> Tuple[List[Finding], Dict[str, Any]]:
    """The drift pass: join measurements to predictions and flag outliers.

    The model's absolute scale is the chip's data sheet, which no host
    reaches, so the gate is relative: the median measured/predicted ratio
    is the host's calibration, and only a cell whose own ratio passes
    ``band x`` that median fires.  Under :data:`MIN_DRIFT_JOINS` joins it
    records the joins and emits nothing (an empty cache keeps the CLI
    deterministic)."""
    band = float(band) if band is not None else DEFAULT_DRIFT_BAND
    chip = chip if chip is not None else detect_chip()
    measurements = collect_measurements(cache_path, trace_path, pairs)
    joined: List[Tuple[Measurement, float, float]] = []
    records: List[Dict[str, Any]] = []
    for m in measurements:
        p = predict_seconds(m, chip)
        rec = {"kernel": m.kernel, "backend": m.backend, "shape": m.shape,
               "params": {k: repr(v) for k, v in m.params.items()},
               "seconds": m.seconds, "source": m.source,
               "predicted_s": p}
        if p is not None:
            rec["ratio"] = m.seconds / p
            joined.append((m, p, m.seconds / p))
        records.append(rec)
    summary: Dict[str, Any] = {
        "band": band, "chip": chip.name,
        "measurements": len(measurements), "joined": len(joined),
        "min_joins": MIN_DRIFT_JOINS, "calibration": None,
        "records": records,
    }
    if len(joined) < MIN_DRIFT_JOINS:
        return [], summary
    med = statistics.median(r for _, _, r in joined)
    summary["calibration"] = med
    findings: List[Finding] = []
    for (m, p, r), rec in zip(joined, [rec for rec in records
                                       if "ratio" in rec]):
        rel = r / med if med > 0 else float("inf")
        rec["relative"] = rel
        if rel <= band:
            continue
        reason = DRIFT_WAIVERS.get((m.kernel, m.backend))
        findings.append(Finding(
            kernel=m.kernel, backend=m.backend, pass_name="drift",
            code="perf-drift",
            message=(f"measured {m.seconds * 1e3:.4g} ms vs calibrated "
                     f"prediction {p * med * 1e3:.4g} ms — {rel:.1f}x left "
                     f"on the table (band {band:g}x, host calibration "
                     f"{med:.3g}x, source {m.source})"),
            waived=reason is not None, waive_reason=reason,
            detail={"seconds": m.seconds, "predicted_s": p,
                    "calibrated_predicted_s": p * med, "ratio": r,
                    "relative": rel, "band": band, "shape": m.shape,
                    "params": {k: repr(v) for k, v in m.params.items()},
                    "source": m.source}))
    return findings, summary


# --------------------------------------------------------------------------
# the model as a tuning prior
# --------------------------------------------------------------------------
def rank_points(kernel: Any, backend: str, points: Sequence[Dict[str, Any]],
                args: tuple, kwargs: dict,
                chip: Optional[ChipSpec] = None) -> List[Dict[str, Any]]:
    """Cost every tunable point statically and return them sorted by
    predicted seconds (ties keep declaration order, the exhaustive sweep's
    rule).  Points that cannot be traced sort last, with their error."""
    chip = chip if chip is not None else detect_chip()
    b = kernel.backend(backend)
    costed: List[Dict[str, Any]] = []
    for i, pt in enumerate(points):
        rec: Dict[str, Any] = {"params": dict(pt), "order": i}
        try:
            t, v, _ = predict(b.fn, args, {**kwargs, **pt}, chip)
            rec.update(predicted_s=v.predicted_s, bound=v.bound,
                       hbm_bytes=t.hbm_bytes, flops=t.flops,
                       parallelism=max(t.grid_steps, 1.0))
        except Exception as exc:   # recorded: the point is not timed
            rec.update(predicted_s=float("inf"), error=_short(exc),
                       hbm_bytes=float("inf"), parallelism=0.0)
        costed.append(rec)
    return sorted(costed, key=lambda r: (r["predicted_s"], r["order"]))


def prune_dominated(ranked: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Drop points strictly worse on traffic AND parallelism than another
    point (they win on neither roofline term, so timing them buys nothing)
    and the points that failed to trace."""
    live = [r for r in ranked if "error" not in r]
    return [r for r in live
            if not any(o is not r and o["hbm_bytes"] < r["hbm_bytes"]
                       and o["parallelism"] > r["parallelism"]
                       for o in live)]
