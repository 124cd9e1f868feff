"""PortableKernel — the paper's portable-kernel registry on PyTorch.

The port of ``repro.core.portable``.  A *kernel spec* is a named operation
with a figure-of-merit model (FLOPs / moved bytes from the input shapes —
paper Eqs. 1-3); *backends* are alternative implementations of it:

  * ``torch``            plain eager PyTorch, the oracle (``xla`` in the
                         reference) — runs on any device;
  * ``triton`` / ``cuda`` the kernel written by hand for Hopper (``pallas``
                         in the reference) — CUDA tensors only.

Two rules differ from the reference on purpose:

  * the default backend follows the tensors: CUDA tensors go to the
    kernel's hand-written backend and never silently to the oracle; CPU
    tensors go to ``torch``;
  * an availability probe looks only for the toolchain (a CUDA device and
    ``nvcc``, or a CUDA device and ``triton``).  It never tries a build,
    and a build or launch that fails raises to the caller instead of
    turning into "unavailable".

``kernel_call(name, fn, plain, *args)`` is where the models run a kernel
of the registry on whichever route they chose (the hand-written kernel or
its plain version): an observer may take the call over.  The op-cost walker
(``core/op_cost.py``) does, because a launch through ctypes is invisible to
a ``TorchDispatchMode``.

``launch_observed(name, device, plan, *args, **params)`` is where each
hand-written wrapper stops before it builds or launches its kernel: with a
launch observer on (the static auditor, ``core/analysis/``), the observer
gets the wrapper's launch plan, ``plan(*args, **params)``, one ``Launch``
record per CUDA or Triton kernel the call would launch, in launch order;
the wrapper then returns its outputs unlaunched (``meta`` tensors, when it
was called on ``meta`` twins).  Nothing falls back: the hook never runs the
plain version.

``__call__(tuned=True)`` reads the best tunable point for the exact call
from the tuning cache (``core/tuning.py``), and ``time_backend`` emits the
reference's telemetry events (``core/telemetry/``): one
``registry.time_backend`` span a measurement, one ``registry.measure``
instant a timing sample and one ``registry.time_backend.result`` instant.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.core import telemetry as tel

__all__ = [
    "Backend",
    "BackendUnavailableError",
    "no_grad_kernel",
    "kernel_call",
    "call_observers",
    "TunableSpace",
    "PortableKernel",
    "KernelRegistry",
    "registry",
    "register_kernel",
    "get_kernel",
    "cuda_probe",
    "triton_probe",
    "Tile",
    "Launch",
    "launch_observers",
    "launch_observed",
    "time_call",
    "time_graph",
]

#: availability probe: None when the backend can run here, else the reason
Probe = Callable[[], Optional[str]]


class BackendUnavailableError(RuntimeError):
    """A backend exists in the registry but cannot run on this host."""


def no_grad_kernel(name: str, *tensors: Any) -> None:
    """Refuse a hand-written kernel under autograd.

    The kernels write into tensors they allocate, so their outputs carry no
    ``grad_fn``: a gradient would stop there, and nothing would say so.
    Every hand-written entry calls this first; it raises ``RuntimeError``
    when grad mode is on and any tensor among ``tensors`` requires grad.
    Nothing falls back: the caller asks for the ``torch`` backend, which
    autograd differentiates.
    """
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward: it was called with a tensor "
            f"that requires grad, and its output would carry no gradient.  "
            f"Ask for the 'torch' backend (attn_backend='torch', "
            f"wkv_backend='torch' or backend='torch'), or call it under "
            f"torch.no_grad()")


#: observers of ``kernel_call``, innermost last.  Process-wide, not per
#: thread: autograd runs a checkpointed layer's recompute on its own thread.
call_observers: List[Callable[..., Any]] = []


def kernel_call(name: str, fn: Callable[..., Any], plain: Callable[..., Any],
                *args: Any, **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``: one call of registry kernel ``name`` on the
    tensors as the model holds them (attention: q (B, S, H, Dh), k, v
    (B, T, Kv, Dh), q_pos, k_pos; the WKV: r, k, v, w, u, state);
    ``plain`` is the plain PyTorch version of the same call (``fn`` itself
    on the ``torch`` route).  The innermost observer, if any, gets
    ``(name, fn, plain, args, kwargs)`` and returns the result instead."""
    if call_observers:
        return call_observers[-1](name, fn, plain, args, kwargs)
    return fn(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class Tile:
    """One buffer of a launch, as the grid sees it: the array's ``shape``
    (elements), the ``tile`` one program reads or writes, and ``index``,
    which maps a program id ``(x, y, z)`` (CUDA's ``blockIdx``; a Triton
    program id is ``(pid, 0, 0)``) to the tile index it touches: a tuple
    of ``len(shape)`` ints, a list of such tuples (a program that touches
    several tiles), or None (none).  Tile indices count in tiles: index
    ``(i, j)`` of a ``(ti, tj)`` tile is elements ``[i ti, (i + 1) ti)`` x
    ``[j tj, (j + 1) tj)``, clipped at the array's end.  A plan's stand-in
    for the reference's Pallas ``BlockSpec``."""

    name: str
    shape: Tuple[int, ...]
    tile: Tuple[int, ...]
    index: Callable[[int, int, int], Any]
    itemsize: int = 4


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a hand-written wrapper's call, as its launcher
    computes it: the kernel's symbol (as nvcc demangles it, template
    arguments included; a Triton kernel's function name), its grid and
    block (x, y, z), its dynamic shared memory in bytes, its output and
    input buffers, the output indices that are declared accumulators (a
    tile that several programs write on purpose), the dtype it accumulates
    in, and the operations it does on this call's shapes, with their
    dtype."""

    symbol: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    outputs: Tuple[Tile, ...]
    inputs: Tuple[Tile, ...] = ()
    smem: int = 0
    accumulators: Tuple[int, ...] = ()
    accum_dtype: str = "float32"
    flops: float = 0.0
    flops_dtype: str = "float32"


#: observers of hand-written launches, innermost last (``launch_observed``)
launch_observers: List[Callable[[str, List[Launch]], None]] = []


def launch_observed(name: str, device: torch.device,
                    plan: Callable[..., List[Launch]], *args: Any,
                    **params: Any) -> bool:
    """A hand-written wrapper's last step before it builds or launches.

    With a launch observer on, the innermost one gets ``(name,
    plan(*args, **params))`` and this returns True: the wrapper returns its
    outputs without building or launching anything (and counts no launch).
    With none, it returns False and the wrapper launches as it always has;
    a ``meta`` device, which has nothing to launch on, raises
    ``ValueError``."""
    if launch_observers:
        launch_observers[-1](name, plan(*args, **params))
        return True
    if device.type == "meta":
        raise ValueError(f"{name} runs on CUDA or CPU tensors: meta tensors "
                         f"cannot launch a kernel, they only hand its "
                         f"launch plan to the static auditor")
    return False


def _runs_anywhere() -> Optional[str]:
    return None


def _no_cuda_device() -> Optional[str]:
    if not torch.cuda.is_available():
        return f"torch {torch.__version__} sees no CUDA device"
    return None


def cuda_probe() -> Optional[str]:
    """A ``cuda`` backend needs a CUDA device and ``nvcc`` (the kernels
    are compiled from ``csrc/`` at first use)."""
    from repro_torch import _build
    reason = _no_cuda_device()
    if reason is None and _build.nvcc_path() is None:
        reason = "nvcc not found on PATH or under $CUDA_HOME/bin"
    return reason


def triton_probe() -> Optional[str]:
    """A ``triton`` backend needs a CUDA device and the triton package."""
    reason = _no_cuda_device()
    if reason is None and importlib.util.find_spec("triton") is None:
        reason = "the triton package is not installed"
    return reason


@dataclasses.dataclass(frozen=True)
class Backend:
    """One implementation of a kernel spec."""

    name: str
    fn: Callable[..., Any]
    probe: Probe = _runs_anywhere

    def unavailable_reason(self) -> Optional[str]:
        return self.probe()

    def is_available(self) -> bool:
        return self.probe() is None

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.fn(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class TunableSpace:
    """Declared tunable parameters of one backend.

    ``params`` maps parameter name -> candidate values (declaration order is
    the deterministic sweep order).  ``constraint(point, *args, **kwargs)``
    filters points that are invalid for the concrete inputs.
    """

    params: Mapping[str, Tuple[Any, ...]]
    constraint: Optional[Callable[..., bool]] = None

    def points(self) -> Iterator[Dict[str, Any]]:
        """Deterministic cartesian product over the declared grid."""
        names = list(self.params)
        for values in itertools.product(*(self.params[n] for n in names)):
            yield dict(zip(names, values))

    def valid_points(self, *args: Any, **kwargs: Any) -> List[Dict[str, Any]]:
        return [p for p in self.points()
                if self.constraint is None or self.constraint(p, *args,
                                                              **kwargs)]


def _tensors(args: Sequence[Any], kwargs: Mapping[str, Any]):
    for v in itertools.chain(args, kwargs.values()):
        if isinstance(v, torch.Tensor):
            yield v


def _cuda_device(args: Sequence[Any],
                 kwargs: Mapping[str, Any]) -> Optional[torch.device]:
    for t in _tensors(args, kwargs):
        if t.device.type == "cuda":
            return t.device
    return None


def _leaves(out: Any) -> List[torch.Tensor]:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [torch.as_tensor(out)]


@dataclasses.dataclass
class PortableKernel:
    """A named kernel spec with multiple backends and a figure-of-merit model.

    ``native`` names the hand-written backend, the default for CUDA tensors.
    ``flops_model`` / ``bytes_model`` take the same arguments as the kernel
    and return the paper-defined operation/byte counts.  ``accum_dtype`` is
    the dtype every reduction of the kernel accumulates in, or wider (the
    static auditor's dtypes pass); ``traceable=False`` marks a kernel whose
    backends are host-side driver loops (the serving engine), which the
    auditor leaves out and conformance still runs (the reference's
    ``jaxpr_traceable``).
    """

    name: str
    backends: Dict[str, Backend] = dataclasses.field(default_factory=dict)
    oracle: str = "torch"
    native: Optional[str] = None
    flops_model: Optional[Callable[..., float]] = None
    bytes_model: Optional[Callable[..., float]] = None
    doc: str = ""
    tunables: Dict[str, TunableSpace] = dataclasses.field(default_factory=dict)
    accum_dtype: str = "float32"
    traceable: bool = True
    #: backend name -> static performance expectations (see
    #: ``declare_roofline_contract``); audited by ``core/analysis/cost.py``
    roofline_contracts: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    #: backend name -> declared communication contract (see
    #: ``declare_comm_contract``); ``audit_comm_contract`` holds a run to it
    comm_contracts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: backend name -> grid-coverage metadata (see ``declare_grid_contract``)
    grid_contracts: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    # ---- registration -------------------------------------------------
    def add_backend(self, name: str, fn: Callable[..., Any],
                    probe: Probe = _runs_anywhere) -> None:
        self.backends[name] = Backend(name=name, fn=fn, probe=probe)

    def declare_tunables(
            self, backends: Union[str, Sequence[str]], *,
            constraint: Optional[Callable[..., bool]] = None,
            **params: Sequence[Any]) -> None:
        """Declare the tunable grid for one or more backends."""
        space = TunableSpace(
            params={k: tuple(v) for k, v in params.items()},
            constraint=constraint)
        names = [backends] if isinstance(backends, str) else list(backends)
        for n in names:
            self.tunables[n] = space

    def tunable_space(self, backend: str) -> Optional[TunableSpace]:
        return self.tunables.get(backend)

    def declare_roofline_contract(
            self, backends: Union[str, Sequence[str]], *,
            bound: Optional[str] = None,
            traffic_inflation_limit: Optional[float] = None) -> None:
        """Record the expected roofline verdict ("memory" | "compute" |
        "collective") and traffic-inflation limit of a backend."""
        if bound is not None and bound not in ("memory", "compute",
                                               "collective"):
            raise ValueError(f"unknown roofline bound {bound!r}")
        contract: Dict[str, Any] = {}
        if bound is not None:
            contract["bound"] = bound
        if traffic_inflation_limit is not None:
            contract["traffic_inflation_limit"] = \
                float(traffic_inflation_limit)
        names = [backends] if isinstance(backends, str) else list(backends)
        for n in names:
            self.roofline_contracts[n] = contract

    def roofline_contract(self, backend: str) -> Dict[str, Any]:
        return self.roofline_contracts.get(backend, {})

    def declare_comm_contract(self, backends: Union[str, Sequence[str]],
                              contract: Any) -> None:
        """Declare the collective traffic one (sharded) backend may emit.

        ``contract`` is either a dict ``{"ppermute": n, "psum": n,
        "all_gather": n}`` (one variant, default call parameters), or a
        callable ``contract(*case_args)`` returning a list of
        ``(variant_kwargs, expectation_dict)`` pairs — the audit runs the
        backend once per variant.  An expectation may carry other keys
        (the reference's ``"overlap_shape"``), which the port's audit
        keeps as metadata.  Backends with no declared contract are audited
        against *zero* collectives.
        """
        names = [backends] if isinstance(backends, str) else list(backends)
        for n in names:
            self.comm_contracts[n] = contract

    def comm_contract(self, backend: str) -> Any:
        return self.comm_contracts.get(backend)

    def declare_grid_contract(self, backends: Union[str, Sequence[str]], *,
                              accumulator_outputs: Sequence[int] = ()) -> None:
        """Declare grid-coverage metadata for one or more backends.

        ``accumulator_outputs`` lists output indices whose tile is *meant*
        to be revisited across a launch grid (a sequential accumulator).
        Any other revisited output tile is a write race, and an unvisited
        one a hole: findings of the grid pass (``core/analysis/grid.py``),
        which reads the outputs of every launch of a backend's plans by
        these indices, and each launch's own ``Launch.accumulators``.
        """
        names = [backends] if isinstance(backends, str) else list(backends)
        for n in names:
            self.grid_contracts[n] = {
                "accumulator_outputs": tuple(accumulator_outputs)}

    def grid_contract(self, backend: str) -> Dict[str, Any]:
        return self.grid_contracts.get(backend, {})

    def audit_comm_contract(self, *args: Any, backend: str,
                            **kwargs: Any) -> List[Tuple[Dict[str, Any],
                                                         Dict[str, int]]]:
        """Run ``backend`` once per declared variant and hold the
        collectives it issued (``distributed.collectives.counting``) to the
        contract; a backend with none is held to zero collectives.
        Returns ``[(variant_kwargs, counts), ...]``; raises
        ``AssertionError`` naming the first variant whose counts differ."""
        from repro_torch.distributed import collectives
        contract = self.comm_contract(backend)
        if contract is None:
            variants = [({}, {})]
        elif callable(contract):
            variants = contract(*args)
        else:
            variants = [({}, contract)]
        fn = self._require_available(backend)
        out = []
        for variant, expect in variants:
            with collectives.counting() as counts:
                fn(*args, **{**kwargs, **variant})
            want = {c: int(expect.get(c, 0)) for c in collectives.COLLECTIVES}
            if counts != want:
                raise AssertionError(
                    f"{self.name}[{backend}] {variant or 'default call'} "
                    f"issued {counts}, its comm contract says {want}")
            out.append((variant, dict(counts)))
        return out

    def backend(self, name: Optional[str] = None) -> Backend:
        if name is None:
            name = self.oracle
        if name not in self.backends:
            raise KeyError(
                f"kernel {self.name!r} has no backend {name!r}; "
                f"have {sorted(self.backends)}")
        return self.backends[name]

    def available_backends(self) -> List[str]:
        return [n for n in sorted(self.backends)
                if self.backends[n].is_available()]

    def default_backend(self, *args: Any, **kwargs: Any) -> str:
        """The hand-written backend for CUDA tensors, the oracle otherwise.

        No fallback: on the card the hand-written backend is chosen even
        when it cannot run, so calling it raises ``BackendUnavailableError``
        instead of quietly timing the oracle.
        """
        if _cuda_device(args, kwargs) is None:
            return self.oracle
        if self.native is None:
            raise BackendUnavailableError(
                f"kernel {self.name!r} has no hand-written backend for CUDA "
                f"tensors (registered: {sorted(self.backends)})")
        return self.native

    def _require_available(self, name: str) -> Backend:
        b = self.backend(name)
        reason = b.unavailable_reason()
        if reason is not None:
            raise BackendUnavailableError(
                f"kernel {self.name!r} backend {name!r} is not available on "
                f"this host: {reason} "
                f"(available: {self.available_backends()})")
        return b

    def __call__(self, *args: Any, backend: Optional[str] = None,
                 tuned: bool = False, tuning_cache: Any = None,
                 **kwargs: Any) -> Any:
        """Run the kernel on ``backend`` (default: see ``default_backend``).

        With ``tuned=True`` the tuning cache (``repro_torch.core.tuning``;
        ``tuning_cache`` or the default file) is read for the best tunable
        point recorded for this (kernel, backend, shape, dtype, device):
        cached params are merged *under* explicit kwargs, and a miss runs
        the declared defaults.  Nothing is timed.
        """
        name = backend if backend is not None else \
            self.default_backend(*args, **kwargs)
        if tuned:
            from repro_torch.core import tuning as _tuning
            best = _tuning.cached_best_params(
                self, *args, backend=name, cache=tuning_cache, **kwargs)
            kwargs = {**best, **kwargs}
        return self._require_available(name)(*args, **kwargs)

    # ---- validation ----------------------------------------------------
    def validate(self, *args: Any, backend: str,
                 rtol: Optional[float] = None, atol: Optional[float] = None,
                 **kwargs: Any) -> float:
        """Assert ``backend`` matches the oracle; return the max abs error.

        Default tolerances come from ``repro_torch.core.conformance``
        (``"bitwise"`` -> 0/0, an unlisted kernel -> (1e-5, 1e-5)); explicit
        ``rtol``/``atol`` override per call.  The comparison runs on the
        tensors' own device, in float64, and counts a NaN as a mismatch.
        """
        if rtol is None or atol is None:
            from repro_torch.core import conformance
            tol = conformance.oracle_tolerance(self.name, backend)
            d_rtol, d_atol = ((0.0, 0.0) if tol == "bitwise"
                              else tol if tol is not None else (1e-5, 1e-5))
            rtol = d_rtol if rtol is None else rtol
            atol = d_atol if atol is None else atol
        want = _leaves(self._require_available(self.oracle)(*args, **kwargs))
        got = _leaves(self._require_available(backend)(*args, **kwargs))
        if len(want) != len(got):
            raise AssertionError(
                f"{self.name}[{backend}] returned {len(got)} outputs, "
                f"oracle {len(want)}")
        return max((max_abs_err(g, w, rtol, atol,
                                f"{self.name}[{backend}] vs {self.oracle}")
                    for w, g in zip(want, got)), default=0.0)

    # ---- measurement ---------------------------------------------------
    def time_backend(self, *args: Any, backend: str, iters: int = 10,
                     warmup: int = 2, graph: bool = False,
                     **kwargs: Any) -> float:
        """Median seconds per call after ``warmup`` calls (paper §3).

        CUDA tensors are timed with CUDA events around batches of calls
        (``time_call``), or with ``graph=True`` as a CUDA graph's replays
        (``time_graph``: device time, the host's enqueue taken out); CPU
        tensors with the host clock around each call.

        Each measurement emits one ``registry.time_backend`` span tagged
        with (kernel, backend, params, timer), one ``registry.measure``
        instant per timing sample (a sample of ``CALLS_PER_SAMPLE`` calls
        between two CUDA events is timed only as a whole, after the
        synchronise, so a span around one call would time its enqueue) with
        the sample's ms a call, the ``registry.time_backend.calls`` counter
        and one ``registry.time_backend.result`` instant (shape signature,
        params, median seconds, devices, platform, timer).  Events fire
        after the timed region; with telemetry off the timing is the same.
        """
        fn = self._require_available(backend)
        params = {k: v for k, v in kwargs.items()
                  if isinstance(v, (bool, int, float, str, tuple))}
        device = _cuda_device(args, kwargs)
        timer = "host" if device is None else "graph" if graph else "events"
        with tel.span("registry.time_backend", proc="registry",
                      kernel=self.name, backend=backend, iters=iters,
                      warmup=warmup, params=params, timer=timer):
            measure = _graph_timed if graph else _timed
            median_s, samples, per_sample = measure(fn, args, kwargs, iters,
                                                    warmup)
            for s in samples:
                tel.instant("registry.measure", proc="registry",
                            kernel=self.name, backend=backend, timer=timer,
                            ms=s * 1e3, calls=per_sample)
        tel.counter("registry.time_backend.calls", proc="registry")
        if tel.enabled():
            import json as _json

            from repro_torch.core import tuning as _tuning
            base = {k: v for k, v in kwargs.items() if k not in params}
            tel.instant(
                "registry.time_backend.result", proc="registry",
                kernel=self.name, backend=backend,
                shape=_tuning.shape_signature(*args, **base),
                params_json=_json.dumps(params, sort_keys=True, default=repr),
                seconds=median_s, iters=iters,
                devices=_tuning.device_count(args, kwargs),
                platform=_tuning.platform(args, kwargs), timer=timer)
        return median_s

    def figure_of_merit(self, elapsed_s: float, *args: Any,
                        **kwargs: Any) -> Dict[str, float]:
        """GFLOP/s and GB/s from the paper's operation/byte models."""
        out: Dict[str, float] = {"seconds": elapsed_s}
        if self.flops_model is not None:
            out["gflops_per_s"] = self.flops_model(*args, **kwargs) / elapsed_s / 1e9
        if self.bytes_model is not None:
            out["gbytes_per_s"] = self.bytes_model(*args, **kwargs) / elapsed_s / 1e9
        return out


def max_abs_err(got: torch.Tensor, want: torch.Tensor, rtol: float,
                atol: float, what: str) -> float:
    """Max abs error of ``got`` against ``want``, compared in float64 on
    their own device; ``AssertionError`` when the shapes differ or any
    element (a NaN included) lies outside ``atol + rtol * |want|``."""
    if got.shape != want.shape:
        raise AssertionError(
            f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    err = (g - w).abs()
    bad = ~(err <= atol + rtol * w.abs())
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())}/{w.numel()} elements outside "
            f"rtol={rtol} atol={atol}; max abs err "
            f"{float(err.nan_to_num(float('inf')).max())}")
    return float(err.max()) if err.numel() else 0.0


#: back-to-back calls between the two CUDA events of one timing sample
CALLS_PER_SAMPLE = 10
#: a call of this many seconds or more is timed one call a sample ...
LONG_CALL_S = 1e-3
#: ... over at most this many samples
LONG_CALL_SAMPLES = 5


def time_call(fn: Callable[..., Any], *args: Any, iters: int = 10,
              warmup: int = 2, **kwargs: Any) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)`` over ``iters``
    samples.

    With a CUDA tensor among the arguments a sample is ``CALLS_PER_SAMPLE``
    back-to-back calls between two CUDA events on the current stream, and
    the device is synchronised once at the end.  The host enqueues the next
    call while the device runs the last, so the figure is device time per
    call — unless the host cannot keep up, and then it is the host's rate,
    which is what a caller gets.  (Events around every single call would add
    the host's enqueue jitter whenever it is near the kernel's time.)  The
    last warm-up call is timed on the host clock: when it takes
    ``LONG_CALL_S`` or more, that jitter is noise, and a sample is one call
    and there are at most ``LONG_CALL_SAMPLES`` of them.  With no CUDA
    tensor the host clock times each call.
    """
    return _timed(fn, args, kwargs, iters, warmup)[0]


def _timed(fn: Callable[..., Any], args: Sequence[Any],
           kwargs: Mapping[str, Any], iters: int, warmup: int
           ) -> Tuple[float, List[float], int]:
    """``time_call``'s measurement: (median seconds per call, each sample's
    seconds per call, calls a sample)."""
    device = _cuda_device(args, kwargs)
    if device is None:
        for _ in range(warmup):
            fn(*args, **kwargs)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), times, 1
    with torch.cuda.device(device):
        last = 0.0
        for _ in range(warmup):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            torch.cuda.synchronize()
            last = time.perf_counter() - t0
        per_sample = 1 if last >= LONG_CALL_S else CALLS_PER_SAMPLE
        if per_sample == 1:
            iters = min(iters, LONG_CALL_SAMPLES)
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in marks:
            start.record()
            for _ in range(per_sample):
                fn(*args, **kwargs)
            end.record()
        torch.cuda.synchronize()
    samples = [s.elapsed_time(e) for s, e in marks]
    ms = np.median(samples) / per_sample
    return float(ms) / 1e3, [m / per_sample / 1e3 for m in samples], \
        per_sample


def time_graph(fn: Callable[..., Any], *args: Any, iters: int = 10,
               warmup: int = 1, **kwargs: Any) -> float:
    """Median device seconds per call of ``fn(*args, **kwargs)``: one call
    captured as a CUDA graph and replayed ``CALLS_PER_SAMPLE`` times between
    two CUDA events a sample, over ``iters`` samples, so the host's time to
    enqueue the call (which ``time_call`` reads when it is the longer) drops
    out.  ``warmup`` eager calls come first (at least one: a kernel may
    build, configure or allocate at its first call, which a capture may
    not do).  On the device of the CUDA tensors among the arguments, or on
    the current CUDA device when no tensor is passed (a closure)."""
    return _graph_timed(fn, args, kwargs, iters, warmup)[0]


def _graph_timed(fn: Callable[..., Any], args: Sequence[Any],
                 kwargs: Mapping[str, Any], iters: int, warmup: int
                 ) -> Tuple[float, List[float], int]:
    device = _cuda_device(args, kwargs)
    if device is None:
        if any(True for _ in _tensors(args, kwargs)) or \
                not torch.cuda.is_available():
            raise ValueError("time_graph times CUDA graphs: it needs CUDA "
                             "tensors, or a CUDA device for a closure")
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.device(device):
        for _ in range(max(warmup, 1)):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(*args, **kwargs)
        graph.replay()
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in marks:
            start.record()
            for _ in range(CALLS_PER_SAMPLE):
                graph.replay()
            end.record()
        torch.cuda.synchronize()
    samples = [s.elapsed_time(e) / CALLS_PER_SAMPLE for s, e in marks]
    return float(np.median(samples)) / 1e3, [m / 1e3 for m in samples], \
        CALLS_PER_SAMPLE


class KernelRegistry:
    """Global name -> PortableKernel map (the port's kernel catalogue)."""

    def __init__(self) -> None:
        self._kernels: Dict[str, PortableKernel] = {}

    def register(self, kernel: PortableKernel) -> PortableKernel:
        if kernel.name in self._kernels:
            raise ValueError(f"duplicate kernel {kernel.name!r}")
        self._kernels[kernel.name] = kernel
        return kernel

    def get(self, name: str) -> PortableKernel:
        try:
            return self._kernels[name]
        except KeyError:
            raise KeyError(
                f"no kernel {name!r} registered; "
                f"registered kernels: {self.names()}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._kernels

    def names(self) -> Sequence[str]:
        return sorted(self._kernels)


registry = KernelRegistry()


def register_kernel(name: str, *, oracle: str = "torch",
                    native: Optional[str] = None,
                    flops_model: Optional[Callable[..., float]] = None,
                    bytes_model: Optional[Callable[..., float]] = None,
                    doc: str = "", accum_dtype: str = "float32",
                    traceable: bool = True) -> PortableKernel:
    """Create-or-get a PortableKernel in the global registry."""
    if name in registry:
        return registry.get(name)
    return registry.register(PortableKernel(
        name=name, oracle=oracle, native=native, flops_model=flops_model,
        bytes_model=bytes_model, doc=doc, accum_dtype=accum_dtype,
        traceable=traceable))


def get_kernel(name: str) -> PortableKernel:
    return registry.get(name)
