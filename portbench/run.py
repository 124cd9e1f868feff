"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``PYTHONPATH=src python -m portbench.run ...``) from the root of a
checkout, on a machine with the card(s) the cell asks for.  It draws the
weights and the traffic from the seed, builds
``repro_torch.serving.engine.ServingEngine`` as the program serves by
default (contiguous cache, bf16, the hand-written ``cuda`` attention, the
decode step as one CUDA graph, greedy with no EOS), warms up the buckets
the traffic uses and the traffic itself, then serves the traffic for
``--seconds`` through ``submit`` and ``step``.  With ``--trace 0`` it
prints the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (telemetry on, then two profiled stretches).  Then it frees the
engine, compares a sample of the served tokens with the float32
reference (``judge.py``) and prints, as its last line on standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), then ``checks``, the numbers
compared beside their limits, which also end standard error.

Caches stay in the checkout (``build/``), the tuning cache and anything
else a run writes in a directory of its own under ``$TMPDIR``, removed at
the end.  Without the card(s), or if JAX or the JAX package is loaded by
the end, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import counts as plain_counts  # noqa: E402

#: modules a run may not load, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the profiled stretch of a traced run (s), by loop kind
STRETCH_S = {"closed": 1.5, "open": 4.0}
#: the telemetry ring of a traced run (events)
TELEMETRY_CAP = 2_000_000


def checkout_env(tmp: str) -> None:
    """Fix every cache of the program inside the checkout or ``tmp``, set
    before the program is imported."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    os.environ["REPRO_TORCH_TUNING_CACHE"] = os.path.join(tmp, "tuning.json")
    os.environ["REPRO_TELEMETRY"] = "off"
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_ATTN_BACKEND", None)
    # one host thread drives the card: no idle OpenMP workers beside it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """A cell's pieces, found by name (``spec.py``): ``weights``,
    ``reference`` and ``counts`` are its configuration's modules."""

    name: str
    entry: Dict[str, Any]
    bench: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    own: Dict[str, Any]
    arch: Dict[str, Any]
    geom: Dict[str, Any]
    weights: Any
    reference: Any
    counts: Any
    rate_scale: float = 1.0

    @classmethod
    def load(cls, name: str, smoke: bool = False) -> "Cell":
        from portbench import spec, traffic
        bench = spec.benchmark()
        entry = spec.workload(bench, name)
        config = spec.config(bench, entry["config"])
        mix = spec.traffic(entry["traffic"])
        arch, geom = dict(config["arch"]), dict(config["engine"])
        rate_scale = 1.0
        if smoke:
            rate_scale = config["smoke"].get("rate_scale", 1.0)
            arch.update(config["smoke"]["arch"])
            geom.update(config["smoke"]["engine"])
            mix = traffic.scaled(mix, config["smoke"]["scale"],
                                 config["smoke"].get("output_scale"))
        return cls(name, entry, bench, config, mix, spec.cell(name), arch,
                   geom, spec.module(config, "weights"),
                   spec.module(config, "reference"),
                   spec.module(config, "counts"), rate_scale)

    @property
    def open(self) -> bool:
        return self.mix["loop"] == "open"


@dataclasses.dataclass
class Context:
    """What the metric readers read (``readers.py``); ``counts`` is the
    configuration's model arithmetic."""

    seconds: float
    t_open: float
    t_close: float
    t_waited: float
    requests: List[Any]
    arch: Dict[str, Any]
    geom: Dict[str, Any]
    setup_s: float
    spans: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    stretch: Any = None
    stretch_rows: List[int] = dataclasses.field(default_factory=list)
    stretch_prefills: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    counts: Any = plain_counts


# --------------------------------------------------------------------------
def build(cell: Cell, seed: int, device: str):
    """(weights, engine) as the program serves by default."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving.engine import ServingEngine
    params = cell.weights.draw(cell.arch, seed, device)
    engine = ServingEngine(params, ModelConfig(**cell.arch), **cell.geom)
    kinds = engine.attn_backends
    if device == "cuda" and (not kinds or set(kinds.values()) != {"cuda"}):
        raise RuntimeError(f"the engine resolved its attention to "
                           f"{kinds}, not the kernels")
    return params, engine


def warm_buckets(engine: Any, cell: Cell, seed: int) -> None:
    """One prefill (and a decode step) at the longest prompt of each
    bucket the traffic uses: the shapes the window will run."""
    import numpy as np
    from repro_torch.serving.request import Request
    from portbench import traffic
    rng = np.random.default_rng([int(seed) % (1 << 63), 3])
    lengths = traffic.block_lengths(cell.mix)[0]
    for i, b in enumerate(traffic.buckets_used(cell.mix,
                                               engine.prefill_buckets)):
        n = int(lengths[lengths <= b].max())
        req = Request(uid=-1 - i, prompt=rng.integers(
            traffic.FIRST_ID, cell.arch["vocab_size"], n).astype(np.int32),
            max_new_tokens=2, arrival_time=engine._clock())
        engine.submit(req)
        while not req.finished:
            engine.step()


def new_loop(engine: Any, cell: Cell, seed: int,
             rate: Optional[float] = None):
    from repro_torch.serving.request import Request
    from portbench import serve, traffic
    rate = rate or cell.own.get("rate_rps")
    stream = traffic.Stream(cell.mix, cell.arch["vocab_size"], seed,
                            rate=rate and rate * cell.rate_scale)
    return serve.Loop(engine, stream, Request)


def warm_traffic(loop: Any, cell: Cell) -> None:
    """The traffic's own warm-up: a closed backlog until the slots' finish
    times are staggered (``warmup_lifetimes`` mean lifetimes, in decode
    steps); an open loop for ``warmup_s`` seconds."""
    from portbench import traffic
    if cell.open:
        loop.run_until(loop.clock() + float(cell.mix["warmup_s"]))
    else:
        steps = round(float(cell.mix["warmup_lifetimes"])
                      * traffic.mean_output(cell.mix))
        loop.run_until(math.inf, steps=steps)


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def telemetry_spans(engine: Any) -> List[Tuple[str, float, float]]:
    """The program's spans as (name, start on the engine's clock, s)."""
    from repro_torch.core import telemetry as tel
    rec = tel.recorder()
    shift = rec.epoch - engine._t0
    return [(e["name"], e["ts"] + shift, e["dur"]) for e in tel.events()
            if e["kind"] == "span"]


def judge_run(params: Any, cell: Cell, finished: List[Any], seed: int,
              mode: str = "f32") -> Tuple[Dict[str, float], int]:
    """(the compared numbers, served tokens compared) for a sample of the
    finished requests against the cell's reference in ``mode``."""
    from portbench import judge
    chosen = judge.sample(finished, seed)
    items = [(list(r.prompt), list(r.generated),
              min(b for b in cell.geom["prefill_buckets"]
                  if r.prompt_len <= b)) for r in chosen]
    logits = cell.reference.served_logits(params, cell.arch, items,
                                          cell.geom["cache_len"], mode=mode)
    gaps = [judge.gaps(lg, r.generated) for lg, r in zip(logits, chosen)]
    return judge.numbers(gaps), sum(len(r.generated) for r in chosen)


def invalid(req: Any, vocab: int) -> bool:
    """A finished request whose tokens are not what it asked for."""
    return (len(req.generated) != req.max_new_tokens
            or any(not 0 <= t < vocab for t in req.generated))


# --------------------------------------------------------------------------
def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, device: Optional[str] = None,
         smoke: bool = False,
         fault: Optional[Callable[[Any], None]] = None) -> int:
    """Run one cell once; return the exit code.  ``device``, ``smoke`` and
    ``fault`` serve the CPU tests: another device than the card, the
    configuration's smoke sizes, and a change planted in the engine."""
    args = parse(argv)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        checkout_env(tmp)
        return _run(args, device, smoke, fault)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args: argparse.Namespace, device: Optional[str], smoke: bool,
         fault: Optional[Callable[[Any], None]]) -> int:
    import torch
    cell = Cell.load(args.workload, smoke=smoke)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.entry["chips"]:
            print(f"{cell.name} needs {cell.entry['chips']} CUDA device(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = "cuda"
    torch.set_num_threads(1)
    trace = bool(args.trace)
    from repro_torch.core import telemetry as tel
    from portbench import profile, readers, serve, spec
    if trace:
        tel.configure("on", capacity=TELEMETRY_CAP)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, engine = build(cell, args.seed, device)
    if fault is not None:
        fault(engine)
    warm_buckets(engine, cell, args.seed)
    loop = new_loop(engine, cell, args.seed)
    warm_traffic(loop, cell)
    sync(device)
    gc.collect()
    gc.freeze()              # set-up's objects out of the collector's way
    t_open = loop.clock()
    setup_s = time.perf_counter() - T_START
    tel.reset()
    t_close = t_open + args.seconds
    loop.run_until(t_close)
    if cell.open:
        loop.wait_first_tokens(t_open, t_close,
                               float(cell.mix.get("drain_s", 60.0)))
    t_waited = max(loop.clock(), t_close)
    ctx = Context(seconds=args.seconds, t_open=t_open, t_close=t_close,
                  t_waited=t_waited, requests=loop.requests, arch=cell.arch,
                  geom=cell.geom, setup_s=setup_s, counts=cell.counts)
    breakdown = None
    device_info: Dict[str, Any] = {}
    stretches: Dict[str, Any] = {}
    if trace:
        ctx.spans = telemetry_spans(engine)
        if device == "cuda":
            def stretch() -> Tuple[float, float]:
                loop.recording = True
                t0 = loop.clock()
                loop.run_until(t0 + STRETCH_S[cell.mix["loop"]])
                loop.recording = False
                return t0, loop.clock()
            # the quiet stretch feeds every device metric; the labelled one,
            # which host tracing slows, only names the idle gaps
            ctx.stretch = profile.profile(stretch)
            labelled = profile.profile(stretch, host=True)
            ctx.stretch_rows = [n for t, n in loop.decode_rows
                                if ctx.stretch.t0 <= t <= ctx.stretch.t1]
            ctx.stretch_prefills = serve.prefills(
                loop.requests, ctx.stretch.t0, ctx.stretch.t1,
                cell.geom["prefill_buckets"])
            breakdown = {"device_ops": profile.top_ops(ctx.stretch),
                         "idle_gaps": profile.top_gaps(labelled)}
            device_info = {"busy_s": ctx.stretch.busy_s,
                           "window_s": ctx.stretch.window_s}
            stretches = {
                "window_steps_per_s": len(readers.spans(
                    ctx, "serving.decode_step")) / args.seconds,
                **{k: {"window_s": st.window_s, "busy_s": st.busy_s,
                       "steps_per_s": sum(st.t0 <= t <= st.t1
                                          for t, _ in loop.decode_rows)
                       / (st.t1 - st.t0)}
                   for k, st in (("quiet", ctx.stretch),
                                 ("labelled", labelled))}}
    sync(device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    metrics: Dict[str, Dict[str, Any]] = {}
    for m in spec.metrics(cell.bench, cell.name, trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # correctness, once the window has closed and the engine is freed
    vocab = cell.arch["vocab_size"]
    window = [r for r in loop.requests
              if (t_open <= r.arrival_time < t_close if cell.open
                  else t_open <= r.t_admitted < t_close)]
    finished = [r for r in loop.requests if t_open <= r.t_done < t_close]
    failed = loop.rejected + sum(invalid(r, vocab) for r in finished)
    gc.unfreeze()
    loop.engine = engine = None          # the caches and the graph go
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    nums, compared = judge_run(params, cell, finished, args.seed)
    from portbench import judge
    ok, checks = judge.verdict(nums, cell.own.get("limits", {}))
    info = {"platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else device),
            "count": cell.entry["chips"] if device == "cuda" else 0,
            "memory_peak_bytes": int(peak), **device_info}
    out: Dict[str, Any] = {
        "correct": bool(ok and failed == 0), "attempted": len(window),
        "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["served"] = {**serve.summary(loop.requests, t_open, t_close),
                     "compared_tokens": compared,
                     "unlimited": {k: v for k, v in nums.items()
                                   if k not in checks}}
    if stretches:
        out["stretches"] = stretches
    out["checks"] = checks
    # whatever the judge and the reference loaded counts too
    bad = forbidden_modules()
    if bad:
        print(f"loaded {bad}: a run may not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
