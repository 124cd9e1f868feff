"""Registry-driven autotuning for PortableKernel backends.

The port of ``repro.core.tuning``.  Kokkos/Julia-style portability
evaluations (Godoy et al., 2023) and the Mojo paper's own methodology both
time each kernel at its *best* tunable configuration before computing
Eq.-4 efficiencies — an untuned portable kernel understates the metric.
This module supplies that measurement spine:

  * each backend declares its tunable grid via
    ``PortableKernel.declare_tunables`` (block/tile sizes plus a validity
    constraint over the concrete inputs);
  * ``tune()`` walks the grid *deterministically* (declaration order),
    timing every valid point through ``PortableKernel.time_backend`` and
    picking the fastest (ties break toward the earlier point);
  * results persist in a JSON :class:`TuningCache` keyed by
    ``(kernel, backend, shape-signature, dtype, device, code, devices)`` so
    repeat runs — and ``PortableKernel.__call__(tuned=True)`` and the
    attention dispatch at serving time — skip the re-search entirely;
  * an unavailable backend is *skipped with the probe's reason*
    (``TuningResult.skipped``), never crashed into and never replaced by
    the ``torch`` oracle: a CPU host can sweep the catalogue and time
    nothing of the hand-written kernels.

Grids past ``COORD_THRESHOLD`` points switch (under ``search="auto"``) to a
budgeted coordinate descent: sweep one parameter at a time from a
deterministic start, repeat until a full pass stops improving or the timing
budget runs out.  Partial results (``"coordinate"``) are cached with their
provenance and are **never** served to a caller whose sweep would be
exhaustive.  ``search="model"`` (the reference's cost-model prior) waits
for the port of ``core/analysis/`` (ROADMAP item 15) and raises.

Where the port differs from the reference:

  * **the key's device** comes from the call's own tensors: the CUDA
    device's name (``torch.cuda.get_device_name``) and
    ``torch.cuda.device_count()`` for a call on CUDA tensors, ``"cpu"`` and
    1 otherwise — a CPU call on a GPU host never keys as the GPU;
  * **dtype names** are numpy's (``float32``, ``bfloat16``, ``int32``), so
    the same numpy inputs give the same signature in both packages;
  * **the code hash** also covers the CUDA sources: a kernel module names
    the ``csrc/*.cu`` it loads in ``CUDA_SOURCES``, and their digests and
    ``_build.py``'s (its nvcc flags) enter the hash of every backend whose
    walk reaches that module;
  * **the timer**: on CUDA tensors a point is timed by ``time_call``
    (CUDA events around batches of calls).  Below ``GRAPH_TIMER_BELOW_S``
    that figure can be the host's enqueue rate rather than the device's
    time, and every point would tie; so when the sweep's first timed point
    reads under it, every point of the sweep is ranked by its time as a
    CUDA graph's replay (``time_graph``, after its own eager warm-up), one
    clock for the whole sweep.  The cache entry records which timer ranked
    it (``"timer": "events" | "graph" | "host"``).

Cache location: ``$REPRO_TORCH_TUNING_CACHE`` if set, else
``~/.cache/repro_torch/tuning.json``.  Schema ``repro_torch.tuning/v1``
(``{"schema", "entries": {key: {"params", "seconds", "search",
"timer"}}}``, rewritten atomically).  A file of another schema — the
reference's ``repro.tuning/v2`` among them — is discarded on load, so
params tuned on a TPU or a CPU are never served on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import telemetry as tel
from repro_torch.core.portable import (PortableKernel, _cuda_device,
                                       registry)

__all__ = [
    "TuningKey",
    "TuningCache",
    "TuningResult",
    "make_key",
    "shape_signature",
    "backend_code_hash",
    "params_from_cache",
    "tune",
    "tune_registered",
    "cached_best_params",
    "cached_entry",
    "default_cache",
    "default_cache_path",
    "platform",
    "device_count",
    "COORD_THRESHOLD",
    "GRAPH_TIMER_BELOW_S",
    "PARTIAL_SEARCHES",
]

CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
CACHE_SCHEMA = "repro_torch.tuning/v1"

#: grids larger than this switch from exhaustive sweep to coordinate descent
#: under ``search="auto"``
COORD_THRESHOLD = 16

#: a sweep whose first point reads under this many seconds by ``time_call``
#: is ranked by CUDA-graph device time instead.  One registry call takes
#: the host 0.03-0.32 ms to enqueue on the H100's host (PERF.md section 5),
#: so a reading below ~0.25 ms may be the host's rate: decode attention
#: reads 0.0946 ms by ``time_call`` against 0.0238 ms of device time.
GRAPH_TIMER_BELOW_S = 2.5e-4


def params_from_cache(params: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a cached params dict for re-injection as call kwargs.

    Tunable values may be tuples; JSON has no tuple type, so they come back
    as lists.  Declared grids are flat, so a shallow list->tuple conversion
    restores the declared value — keeping cache-served params hashable and
    ``==`` to their swept twins.
    """
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in params.items()}


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------
def dtype_name(dtype: Any) -> str:
    """numpy's name for a dtype: ``torch.bfloat16`` -> ``bfloat16``."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _sig_one(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{dtype_name(dtype)}[{','.join(str(d) for d in shape)}]"
    return repr(x)


def shape_signature(*args: Any, **kwargs: Any) -> str:
    """Deterministic signature of the concrete call: dtypes+shapes of array
    arguments, ``repr`` of scalars, kwargs sorted by name."""
    parts = [_sig_one(a) for a in args]
    parts += [f"{k}={_sig_one(v)}" for k, v in sorted(kwargs.items())]
    return ";".join(parts)


@dataclasses.dataclass(frozen=True)
class TuningKey:
    """Cache key: a tuned configuration is only valid for the exact problem
    shape/dtype on the device *and device count* it was measured on — and
    only for the exact backend *code* it was measured against (``code``
    hashes the backend's Python and CUDA sources, so kernel edits
    invalidate their cached params)."""

    kernel: str
    backend: str
    shape: str
    dtype: str
    platform: str
    code: str = "-"
    devices: int = 1

    def as_str(self) -> str:
        return "|".join((self.kernel, self.backend, self.shape, self.dtype,
                         self.platform, self.code, f"d{self.devices}"))


_CODE_HASHES: Dict[int, Tuple[Any, str]] = {}
#: ``TuningCache.put`` calls made in this process (see :func:`writes`)
_WRITES = 0


def _own_source(fn: Any) -> str:
    try:
        return inspect.getsource(fn)
    except (OSError, TypeError):
        code = getattr(fn, "__code__", None)
        return code.co_code.hex() if code is not None else repr(fn)


def _unwrap_callable(val: Any) -> Any:
    """Peel ``functools.partial`` / ``__wrapped__`` chains (lru_cache) and
    Triton's ``JITFunction`` (its Python body is ``.fn``) down to the
    underlying function; cycles and exotic wrappers fall back to the value
    itself."""
    for _ in range(16):
        if isinstance(val, functools.partial):
            val = val.func
        elif getattr(val, "__wrapped__", None) is not None:
            val = val.__wrapped__
        elif not inspect.isfunction(val) and inspect.isfunction(
                getattr(val, "fn", None)):
            val = val.fn
        else:
            break
    return val


def _container_callables(val: Any) -> List[Any]:
    """Callables sitting in a plain dict/tuple/list global (dispatch
    tables mapping names to (fn, ...) tuples)."""
    if isinstance(val, dict):
        vals = list(val.values())
    elif isinstance(val, (list, tuple)):
        vals = list(val)
    else:
        return []
    out = []
    for v in vals:
        if isinstance(v, (list, tuple)):
            out.extend(w for w in v if callable(w))
        elif callable(v):
            out.append(v)
    return out


def _digest(path: Path) -> Optional[str]:
    try:
        return hashlib.sha1(path.read_bytes()).hexdigest()
    except OSError:
        return None


def _cuda_source_digests(module: Any) -> Dict[str, str]:
    """Digests of the ``csrc/*.cu`` a kernel module loads (its
    ``CUDA_SOURCES``) and of ``_build.py`` (the nvcc flags), keyed by
    package-relative path; {} for a module that loads none."""
    names = getattr(module, "CUDA_SOURCES", ())
    if not names:
        return {}
    from repro_torch import _build
    out = {}
    for name in names:
        d = _digest(_build.CSRC / f"{name}.cu")
        if d is not None:
            out[f"repro_torch/csrc/{name}.cu"] = d
    d = _digest(Path(_build.__file__))
    if d is not None:
        out["repro_torch/_build.py"] = d
    return out


def _referenced_file_hashes(fn: Any) -> List[str]:
    """sha1s of the port's source files a backend wrapper dispatches into.

    Registered backends are mostly thin wrappers (``fock_cuda`` is a few
    lines around ``K.twoel``), so hashing only their own source would miss
    the kernel-body edits this key exists to catch.  Starting from the
    wrapper's code, walk the modules/callables its globals reference —
    unwrapping lru_cache/partial/Triton layers and looking inside plain
    dict/tuple dispatch tables — and pull in each referenced
    ``repro_torch`` *file's* digest, recursing (bounded) through the port's
    functions, plus the CUDA sources each visited module names in
    ``CUDA_SOURCES`` (the walk follows names, and no name reaches a
    ``.cu``).  Entries are keyed by package-relative path so hosts sharing
    a cache agree on the hash for byte-identical code."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return []
    marker = os.sep + "repro_torch" + os.sep
    digests: Dict[str, str] = {}
    seen = {code}
    queue = [(code, getattr(fn, "__globals__", {}))]
    budget = 64

    def visit(val):
        if inspect.ismodule(val):
            mod, target = val, None
        elif callable(val):
            target = _unwrap_callable(val)
            mod = inspect.getmodule(target)
        else:
            return
        path = getattr(mod, "__file__", None) if mod else None
        if not path or marker not in path:
            return
        rel = path[path.rfind(marker) + 1:].replace(os.sep, "/")
        if rel not in digests:
            d = _digest(Path(path))
            if d is None:
                return
            digests[rel] = d
            digests.update(_cuda_source_digests(mod))
        tcode = getattr(target, "__code__", None)
        if tcode is not None and tcode not in seen:
            seen.add(tcode)
            queue.append((tcode, getattr(target, "__globals__", {})))

    visit(fn)
    while queue and budget > 0:
        budget -= 1
        c, g = queue.pop(0)
        for name in c.co_names:
            val = g.get(name)
            visit(val)
            for v in _container_callables(val):
                visit(v)
    return sorted(f"{p}={d}" for p, d in digests.items())


def backend_code_hash(fn: Any) -> str:
    """Short sha1 identifying the backend's *implementation*: its own
    source (partials and wrappers unwrapped first), the repr of its closure
    constants (factory-made wrappers share source but close over different
    ops), and the file digests of the port's modules/functions it
    dispatches into, CUDA sources included (thin wrappers change when the
    kernel body does).  Falls back to bytecode, then repr, when source is
    unavailable — the hash only needs to *change when the kernel changes*,
    not be human-readable."""
    hit = _CODE_HASHES.get(id(fn))
    if hit is not None and hit[0] is fn:
        return hit[1]
    target, root = _unwrap_callable(fn), fn
    parts = [_own_source(target)]
    code = getattr(target, "__code__", None)
    closure = getattr(target, "__closure__", None) or ()
    for name, cell in zip(code.co_freevars if code else (), closure):
        try:
            val = cell.cell_contents
        except ValueError:  # pragma: no cover - still-empty cell
            continue
        parts.append(f"{name}:{_own_source(val)}"
                     if inspect.isfunction(val) else f"{name}={val!r}")
    parts.extend(_referenced_file_hashes(target))
    digest = hashlib.sha1("\n".join(parts).encode()).hexdigest()[:12]
    _CODE_HASHES[id(root)] = (root, digest)
    return digest


def platform(args: Sequence[Any] = (),
             kwargs: Mapping[str, Any] = {}) -> str:
    """The device a call runs on, from its own tensors: the CUDA device's
    name, or ``"cpu"``."""
    device = _cuda_device(args, kwargs)
    return "cpu" if device is None else torch.cuda.get_device_name(device)


def device_count(args: Sequence[Any] = (),
                 kwargs: Mapping[str, Any] = {}) -> int:
    """``torch.cuda.device_count()`` for a call on CUDA tensors, else 1."""
    return 1 if _cuda_device(args, kwargs) is None \
        else torch.cuda.device_count()


def make_key(kernel: PortableKernel, *args: Any, backend: str,
             **kwargs: Any) -> TuningKey:
    dtypes = [dtype_name(a.dtype) for a in args if hasattr(a, "dtype")]
    b = kernel.backends.get(backend)
    return TuningKey(
        kernel=kernel.name,
        backend=backend,
        shape=shape_signature(*args, **kwargs),
        dtype=dtypes[0] if dtypes else "-",
        platform=platform(args, kwargs),
        code=backend_code_hash(b.fn) if b is not None else "-",
        devices=device_count(args, kwargs),
    )


# --------------------------------------------------------------------------
# persistent cache
# --------------------------------------------------------------------------
def writes() -> int:
    """How many cache entries this process has written: callers that
    memoise lookups (the attention dispatch) start over when it moves."""
    return _WRITES


def default_cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "tuning.json"


class TuningCache:
    """Persistent JSON map ``key-string -> {"params", "seconds", "search",
    "timer"}`` wrapped in a schema envelope (``CACHE_SCHEMA``).

    Writes are atomic (tmp file + rename) so concurrent runs cannot leave a
    torn file behind, and each ``put`` merges the on-disk state back in
    first, so two processes tuning different kernels keep each other's
    entries (the race on one *identical* key is last-writer-wins, which is
    fine — both wrote a valid measurement).  Cached ``seconds`` are
    historical: they skip the re-search, but anything computing a ratio
    against a fresh timing must re-time at the cached params.  ``search``
    records provenance (``"exhaustive"`` vs ``"coordinate"``), ``timer``
    the clock that ranked the points; a file of another schema is
    discarded on load.
    """

    def __init__(self, path: Optional[os.PathLike] = None) -> None:
        self.path = Path(path) if path is not None else default_cache_path()
        self._data: Optional[Dict[str, Dict[str, Any]]] = None

    @staticmethod
    def _read_entries(path: Path) -> Dict[str, Dict[str, Any]]:
        try:
            raw = json.loads(path.read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(raw, dict) or raw.get("schema") != CACHE_SCHEMA:
            return {}  # the reference's (or a foreign) file: start over
        entries = raw.get("entries")
        return entries if isinstance(entries, dict) else {}

    def _load(self) -> Dict[str, Dict[str, Any]]:
        if self._data is None:
            self._data = self._read_entries(self.path)
        return self._data

    def get(self, key: TuningKey) -> Optional[Dict[str, Any]]:
        return self._load().get(key.as_str())

    def put(self, key: TuningKey, params: Dict[str, Any], seconds: float,
            search: str = "exhaustive", timer: Optional[str] = None) -> None:
        global _WRITES
        _WRITES += 1
        data = self._load()
        for k, v in self._read_entries(self.path).items():
            data.setdefault(k, v)
        entry = {"params": dict(params), "seconds": float(seconds),
                 "search": search}
        if timer is not None:
            entry["timer"] = timer
        data[key.as_str()] = entry
        self._save(data)

    def _save(self, data: Dict[str, Dict[str, Any]]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"schema": CACHE_SCHEMA, "entries": data}, f,
                          indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        return len(self._load())


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TuningResult:
    """Outcome of one ``tune()`` call."""

    kernel: str
    backend: str
    params: Dict[str, Any]            # best point ({} = declared defaults)
    seconds: float                    # best median seconds per call
    swept: List[Tuple[Dict[str, Any], float]]  # every timed (point, seconds)
    cached: bool                      # True = served from the cache, no timing
    skipped: Optional[str] = None     # reason this backend was not tuned
    search: str = "exhaustive"        # "exhaustive" | "coordinate"
    timer: Optional[str] = None       # "events" | "graph" | "host"


#: provenances of partial searches — cache hits carrying one of these are
#: never served to a caller whose own sweep would be exhaustive
PARTIAL_SEARCHES = ("coordinate", "model")


def _coordinate_descent(kernel, space, points, budget, time_point):
    """Budgeted one-parameter-at-a-time search over the valid grid.

    Deterministic: starts at the first valid point, walks parameters in
    declaration order, moves only on strict improvement (ties keep the
    earlier point).  ``budget`` caps the number of *distinct* points timed;
    already-timed points are free.  Returns (best_params, best_secs).
    """
    names = list(space.params)
    index = {tuple(p[n] for n in names): p for p in points}
    timed: Dict[Tuple[Any, ...], float] = {}

    def measure(p):
        k = tuple(p[n] for n in names)
        if k in timed:
            return timed[k], False
        if len(timed) >= budget:
            return None, True
        timed[k] = time_point(p)
        return timed[k], False

    cur = points[0]
    cur_secs, exhausted = measure(cur)
    improved = True
    while improved and not exhausted:
        improved = False
        for name in names:
            for value in space.params[name]:
                cand_key = tuple(value if n == name else cur[n]
                                 for n in names)
                cand = index.get(cand_key)
                if cand is None:  # constraint excluded this neighbour
                    continue
                secs, exhausted = measure(cand)
                if exhausted:
                    break
                if secs < cur_secs:
                    cur, cur_secs, improved = cand, secs, True
            if exhausted:
                break
    return cur, cur_secs


def _skip(kernel: PortableKernel, backend: str, reason: str) -> TuningResult:
    return TuningResult(kernel=kernel.name, backend=backend, params={},
                        seconds=float("inf"), swept=[], cached=False,
                        skipped=reason)


def tune(kernel: PortableKernel, *args: Any, backend: str,
         cache: Optional[TuningCache] = None, iters: int = 3,
         warmup: int = 1, max_points: Optional[int] = None,
         search: str = "auto", budget: Optional[int] = None,
         **kwargs: Any) -> TuningResult:
    """Find (or recall) the best tunable point for one backend + inputs.

    Deterministic: the grid is walked in declaration order and ties break
    toward the earlier point, so two runs on the same host pick the same
    configuration.  A cache hit skips all timing.  An unavailable backend,
    a hand-written backend given no CUDA tensor (its wrapper would run the
    plain version) or a backend with an empty valid grid returns
    ``skipped=<reason>`` with the declared defaults instead of raising.

    ``search`` picks the strategy: ``"exhaustive"`` times every valid
    point; ``"coordinate"`` runs a budgeted coordinate descent
    (``budget`` distinct points, default twice the summed per-parameter
    grid lengths); ``"auto"`` (default) uses coordinate descent only when
    the valid grid exceeds ``COORD_THRESHOLD`` points.  ``"model"`` needs
    the static cost model, which the port does not have yet, and raises.
    Partial (coordinate) results are cached with their provenance and are
    never served to a caller whose own sweep would be exhaustive.
    ``max_points`` bounds the work of every strategy, and a sweep it cut
    short is never persisted.
    """
    if search == "model":
        raise ValueError(
            "search='model' ranks points by the static cost model of "
            "core/analysis/, which the port does not have yet (ROADMAP "
            "item 15); use 'auto', 'exhaustive' or 'coordinate'")
    if search not in ("auto", "exhaustive", "coordinate"):
        raise ValueError(f"unknown search mode {search!r}")
    b = kernel.backends.get(backend)
    if b is None:
        raise KeyError(
            f"kernel {kernel.name!r} has no backend {backend!r}; "
            f"have {sorted(kernel.backends)}")
    reason = b.unavailable_reason()
    if reason is not None:
        return _skip(kernel, backend,
                     f"backend {backend!r} unavailable: {reason}")
    on_cuda = _cuda_device(args, kwargs) is not None
    if backend == kernel.native and not on_cuda:
        return _skip(kernel, backend,
                     f"backend {backend!r} launches its kernel on CUDA "
                     f"tensors only; these inputs are on the CPU")

    key = make_key(kernel, *args, backend=backend, **kwargs)
    space = kernel.tunable_space(backend)
    if space is None:
        # not cached: a cache hit would flip skipped/swept on repeat runs,
        # and there is no search to skip anyway
        secs = kernel.time_backend(*args, backend=backend, iters=iters,
                                   warmup=warmup, **kwargs)
        return TuningResult(kernel=kernel.name, backend=backend, params={},
                            seconds=secs, swept=[({}, secs)], cached=False,
                            skipped="no tunable space declared")

    points = space.valid_points(*args, **kwargs)
    coordinate = (search == "coordinate"
                  or (search == "auto" and len(points) > COORD_THRESHOLD))

    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            hit_search = hit.get("search", "exhaustive")
            # a partial (coordinate) entry must not satisfy an exhaustive
            # request — fall through and run the full sweep
            if not (hit_search in PARTIAL_SEARCHES and not coordinate):
                tel.counter("tuning.cache.hit", proc="tuning")
                return TuningResult(
                    kernel=kernel.name, backend=backend,
                    params=params_from_cache(hit["params"]),
                    seconds=float(hit["seconds"]), swept=[], cached=True,
                    search=hit_search, timer=hit.get("timer"))
        tel.counter("tuning.cache.miss", proc="tuning")

    # max_points is the smoke lane's hard work bound and applies to both
    # strategies: exhaustive sweeps drop the grid tail, coordinate descent
    # caps its timing budget — and no truncated result may persist
    truncated = max_points is not None and len(points) > max_points
    if truncated and not coordinate:
        points = points[:max_points]
    if not points:
        return _skip(kernel, backend,
                     "no valid tunable point for these inputs")

    swept: List[Tuple[Dict[str, Any], float]] = []
    mode = "coordinate" if coordinate else "exhaustive"
    # one clock for the whole sweep, chosen by its first timed point
    timer: List[Optional[str]] = [None if on_cuda else "host"]

    def time_point(point):
        try:
            if timer[0] != "graph":
                secs = kernel.time_backend(*args, backend=backend,
                                           iters=iters, warmup=warmup,
                                           **point, **kwargs)
                if timer[0] is None:
                    timer[0] = ("graph" if secs < GRAPH_TIMER_BELOW_S
                                else "events")
            if timer[0] == "graph":
                secs = kernel.time_backend(*args, backend=backend,
                                           iters=iters, warmup=warmup,
                                           graph=True, **point, **kwargs)
        except (ValueError, TypeError):
            # a point the constraint failed to exclude — record and move on
            secs = float("inf")
        swept.append((point, secs))
        tel.instant("tuning.point", proc="tuning", kernel=kernel.name,
                    backend=backend, params=point, seconds=secs,
                    search=mode, timer=timer[0])
        return secs

    with tel.span("tuning.tune", proc="tuning", kernel=kernel.name,
                  backend=backend, search=mode, points=len(points)):
        if coordinate:
            if budget is None:
                budget = 2 * sum(len(v) for v in space.params.values())
            if max_points is not None:
                budget = min(budget, max_points)
            best_params, best_secs = _coordinate_descent(
                kernel, space, points, max(budget, 1), time_point)
        else:
            best_params, best_secs = None, float("inf")
            for point in points:
                secs = time_point(point)
                if secs < best_secs:
                    best_secs, best_params = secs, point

    if best_params is None or best_secs == float("inf"):
        return TuningResult(
            kernel=kernel.name, backend=backend, params={},
            seconds=float("inf"), swept=swept, cached=False,
            skipped="every tunable point failed to run")

    result = TuningResult(kernel=kernel.name, backend=backend,
                          params=best_params, seconds=best_secs, swept=swept,
                          cached=False, search=mode, timer=timer[0])
    # a truncated sweep (smoke lane) must not poison the cache: its key is
    # identical to the full run's, which would then inherit the partial
    # search as if it were the tuned optimum; coordinate results persist,
    # but carry their provenance so exhaustive callers re-search
    if cache is not None and not truncated:
        cache.put(key, result.params, result.seconds, search=mode,
                  timer=result.timer)
    return result


_DEFAULT_CACHES: Dict[Path, TuningCache] = {}


def default_cache() -> TuningCache:
    """The shared cache object of ``default_cache_path()``, one per path,
    so hot callers (``tuned=True`` in a serving loop, the attention
    dispatch) parse the JSON file once, not per call, and a sweep that
    writes through it is seen by them at once."""
    path = default_cache_path()
    c = _DEFAULT_CACHES.get(path)
    if c is None:
        c = _DEFAULT_CACHES[path] = TuningCache(path)
    return c


def cached_entry(kernel: PortableKernel, *args: Any, backend: str,
                 cache: Optional[TuningCache] = None,
                 **kwargs: Any) -> Optional[Dict[str, Any]]:
    """Cache-lookup-only: the raw cache entry (``params``/``seconds``/
    ``search``/``timer``) for this exact problem, or ``None`` on a miss.
    Never times anything — callers that need to *report* provenance
    (dispatch logs) use this; plain param injection goes through
    :func:`cached_best_params`."""
    if cache is None:
        cache = default_cache()
    hit = cache.get(make_key(kernel, *args, backend=backend, **kwargs))
    tel.counter("tuning.cache.hit" if hit is not None
                else "tuning.cache.miss", proc="tuning")
    return hit


def cached_best_params(kernel: PortableKernel, *args: Any, backend: str,
                       cache: Optional[TuningCache] = None,
                       **kwargs: Any) -> Dict[str, Any]:
    """Cache-lookup-only path used by ``PortableKernel.__call__(tuned=True)``:
    returns the recorded best params for this exact problem, or ``{}``
    (declared defaults) on a miss.  Never times anything."""
    hit = cached_entry(kernel, *args, backend=backend, cache=cache, **kwargs)
    return params_from_cache(hit["params"]) if hit else {}


def tune_registered(name: str, *args: Any, backend: str,
                    **kwargs: Any) -> TuningResult:
    """Convenience: ``tune()`` against the global registry by kernel name."""
    return tune(registry.get(name), *args, backend=backend, **kwargs)
