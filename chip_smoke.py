#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

The paper's portable-kernel workflow (``examples/quickstart.py``) at the
paper's sizes: BabelStream over 2^25 float32 elements (128 MiB an array),
the seven-point stencil over a 512^3 float32 volume (512 MiB), miniBUDE on
a bm1-shaped deck (938 protein atoms, 26 ligand atoms, 65536 poses) and
the Hartree-Fock Fock build on the paper's two smallest helium systems
(N = 128 with STO-3G, N = 64 with STO-6G: 2.17e10 primitive quartets each),
plus the build split into four l-slabs, as a distributed caller runs it;
then the LM serving path: granite-3-8b at full width and depth (40 layers,
random bf16 weights from ``--seed``) served by the port's ``ServingEngine``
(8 slots, a 4096-slot KV cache, prefill buckets 512 and 2048), whose every
prefill runs the flash attention kernel and every decode step the
ring-buffer decode attention kernel, 40 launches a call each.

  1. build:     nvcc for every ``csrc/*.cu`` (all started together), then
                each kernel once on its small conformance case on the card,
                which compiles the Triton kernels and checks them;
  2. main path: four paths — slice 1 (BabelStream, stencil), miniBUDE,
                Hartree-Fock, the Hartree-Fock slabs — each with every
                launch count set to 0 just before it and read just after;
                registry kernels go through ``get_kernel(name)`` with their
                default backend on CUDA tensors, which must be the
                hand-written one, and each kernel must have launched;
  3. check:     each kernel against its plain PyTorch version on the same
                inputs at the port's ORACLE_TOL; the stencil's boundary
                faces are zero, the Fock matrices symmetric, the four slabs
                sum to the full build, and nothing is NaN;
  4. timing:    CUDA-event medians of the kernel, its plain version and the
                one PyTorch call computing the same function (where there
                is one), beside the least time the card could take, and
                the host's time to enqueue one call;
  5. Eq. 4:     e_i = plain time / kernel time and their mean, Phi-bar,
                over the registry's kernels; the slab, the Hartree-Fock
                kernel again, gets its e_i apart;
  6. attention: the two kernels on their float32 conformance cases (in 1),
                a sweep over their tunables, head dims 64/128, ragged S/T,
                a window and a wrapped ring, then each in bfloat16 at the
                serving shapes against its plain version, timed beside
                ``scaled_dot_product_attention`` and its least-work bound;
  7. serving:   16 greedy requests (prompts of 64-2048 tokens from the seed,
                32 new tokens each) through the engine, with the attention
                launch counts set to 0 just before and read just after:
                they must be 40 x prefill calls and 40 x decode steps; one
                prefill's logits against the plain attention's, and two
                requests replayed through unbatched ``generate``.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  With no CUDA
device, or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import _build  # noqa: E402
import repro_torch.kernels  # noqa: E402,F401  (registers the kernels)
from repro_torch.core import (  # noqa: E402
    Efficiency, get_kernel, max_abs_err, phi_bar, time_call)
from repro_torch.core import conformance  # noqa: E402
from repro_torch.core.portable import (  # noqa: E402
    CALLS_PER_SAMPLE, LONG_CALL_S)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.babelstream.ref import START_SCALAR  # noqa: E402
from repro_torch.kernels.flash_attention import cases as attn_cases  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ServingEngine, latency_summary, synthetic_trace)
from repro_torch.training.serve_step import (  # noqa: E402
    decode_step, generate, prefill)
from repro_torch.kernels.hartree_fock import kernel as hf_kernel  # noqa: E402
from repro_torch.kernels.hartree_fock import ops as hf_ops  # noqa: E402
from repro_torch.kernels.hartree_fock import ref as hf_ref  # noqa: E402
from repro_torch.kernels.minibude.ops import make_deck  # noqa: E402
from repro_torch.kernels.stencil7.ref import default_coefficients  # noqa: E402

STREAM_N = 1 << 25     # the paper's BabelStream size
STENCIL_L = 512        # the paper's smaller stencil volume
BUDE = {"natpro": 938, "natlig": 26, "nposes": 65536}  # bm1's shape
HF_CASES = ((128, 3), (64, 6))  # (N, ngauss): the paper's Table 4 He systems
SLABS = 4              # l-slabs of the N = 128 build
ITERS = 20             # timed samples per median (time_call takes fewer
                       # for calls of a millisecond or more)
STREAM_OPS = ("copy", "mul", "add", "triad", "dot")
SLICE1 = tuple(f"babelstream.{op}" for op in STREAM_OPS) + ("stencil7",)
KERNELS = SLICE1 + ("minibude.fasten", "hartree_fock.twoel")  # registry
SLAB = "hartree_fock.twoel_slab"  # the slab wrapper, outside the registry
RECORDS = KERNELS + (SLAB,)
HF_TOL = conformance.ORACLE_TOL["hartree_fock.twoel"]

ATTN = ("attention.flash", "attention.decode")   # slice 3's kernels
#: the serving path: granite-3-8b at full width and depth
ARCH = "granite-3-8b"
SERVE = {"num_slots": 8, "cache_len": 4096, "prefill_buckets": (512, 2048)}
REQUESTS, MIN_PROMPT, MAX_PROMPT, MAX_NEW = 16, 64, 2048, 32
REPLAY = 2          # requests replayed through unbatched generate
#: bfloat16 attention against its plain version: the reference's own bf16
#: tolerance (tests/test_kernels_lm.py::test_flash_bf16)
BF16_TOL = (2e-2, 2e-2)
#: one prefill's last-position logits with the kernels against the plain
#: attention's, over 40 bf16 layers: within this share of the logits' range
#: (read 1.08% on an H100, PERF.md)
LOGITS_TOL = 0.02

SOURCE = {name: "src/repro_torch/kernels/babelstream/kernel.py"
          for name in SLICE1[:5]}
SOURCE.update({
    "stencil7": "src/repro_torch/csrc/stencil7.cu",
    "minibude.fasten": "src/repro_torch/csrc/minibude.cu",
    "hartree_fock.twoel": "src/repro_torch/csrc/hartree_fock.cu",
    SLAB: "src/repro_torch/csrc/hartree_fock.cu",
    "attention.flash": "src/repro_torch/csrc/flash_attention.cu",
    "attention.decode": "src/repro_torch/csrc/flash_attention.cu",
})
REPLACES = {
    "babelstream.copy": "src/repro/kernels/babelstream/kernel.py:99",
    "babelstream.mul": "src/repro/kernels/babelstream/kernel.py:105",
    "babelstream.add": "src/repro/kernels/babelstream/kernel.py:113",
    "babelstream.triad": "src/repro/kernels/babelstream/kernel.py:119",
    "babelstream.dot": "src/repro/kernels/babelstream/kernel.py:126",
    "stencil7": "src/repro/kernels/stencil7/kernel.py:93",
    "minibude.fasten": "src/repro/kernels/minibude/kernel.py:146",
    "hartree_fock.twoel": "src/repro/kernels/hartree_fock/kernel.py:153",
    SLAB: "src/repro/kernels/hartree_fock/kernel.py:180",
    "attention.flash": "src/repro/kernels/flash_attention/kernel.py:118",
    "attention.decode": "src/repro/kernels/flash_attention/kernel.py:215",
}

# one PyTorch call computing the same function: the yardstick, never
# called by the port itself; no single call computes the stencil, the BUDE
# energies or a Fock build
LIBRARY = {
    "babelstream.copy": torch.clone,
    "babelstream.mul": lambda c: torch.mul(c, START_SCALAR),
    "babelstream.add": torch.add,
    "babelstream.triad": lambda b, c: torch.add(b, c, alpha=START_SCALAR),
    "babelstream.dot": torch.dot,
    "stencil7": None,
    "minibude.fasten": None,
    "hartree_fock.twoel": None,
    SLAB: None,
}

# data-sheet rates (dense, no sparsity): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, and bfloat16 tensor-core FLOP/s; the first name
# that occurs in the device name
DATASHEET = (
    ("H100 PCIe", "H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100", "H100 SXM", 3.35e12, 67e12, 989e12),
)


@dataclasses.dataclass
class Case:
    """One call of the main path: the record it belongs to, the kernel
    (or wrapper) and its plain version, and the inputs."""

    label: str
    record: str
    kernel: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    shape: Tuple[int, ...]
    flops: float        # the registry's model: GFLOP/s
    least_flops: float  # the fewest the function needs: the bound


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def datasheet(kind: str):
    for key, label, bw, flops, bf16 in DATASHEET:
        if key in kind:
            return label, bw, flops, bf16
    fail(f"no data-sheet rates for {kind!r}")


def flops(name: str, args, kwargs) -> float:
    """Floating-point operations the function does on these inputs: the
    registry's model where the kernel has one (Eq. 3 for miniBUDE,
    120 N^4 G^4 for Hartree-Fock), else counted from the shapes."""
    k = get_kernel(name)
    if k.flops_model is not None:
        return float(k.flops_model(*args, **kwargs))
    if name == "stencil7":
        nz, ny, nx = args[0].shape
        return 10.0 * (nz - 2) * (ny - 2) * (nx - 2)
    per_elem = {"copy": 0, "mul": 1, "add": 1, "triad": 2, "dot": 2}
    return float(per_elem[name.split(".")[1]] * args[0].numel())


def enqueue_ms(fn, args, kwargs, calls: int) -> float:
    """Host milliseconds to enqueue one call, averaged over ``calls``
    calls: the registry's and the wrapper's own cost per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args, **kwargs)
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def registry_case(label: str, name: str, args, kwargs, shape,
                  least_flops=None) -> Case:
    """A registry kernel's call; its timing calls the two backends' own
    functions, as ``PortableKernel.time_backend`` does.  The bound counts
    the registry's flops unless ``least_flops`` says the function needs
    fewer."""
    k = get_kernel(name)
    ops = flops(name, args, kwargs)
    return Case(label, name, k.backend(k.native).fn, k.backend("torch").fn,
                args, kwargs, shape, ops,
                ops if least_flops is None else least_flops)


def drive(phase: str, cases: List[Case], wrappers) -> Dict[str, Any]:
    """One path of the main path: every launch count set to 0 just before,
    the path's own counts read just after."""
    for w in wrappers.values():
        w.launches = 0
    outs = {}
    for c in cases:
        if c.record == SLAB:
            outs[c.label] = hf_kernel.twoel_slab(*c.args, **c.kwargs)
            continue
        k = get_kernel(c.record)
        chosen = k.default_backend(*c.args, **c.kwargs)
        if chosen != k.native:
            fail(f"{c.record}: default backend on CUDA tensors is "
                 f"{chosen!r}, not the hand-written {k.native!r}")
        outs[c.label] = k(*c.args, **c.kwargs)
    torch.cuda.synchronize()
    counts = {c.record: wrappers[c.record].launches for c in cases}
    print(f"main path [{phase}] launches: {counts}")
    for name, count in counts.items():
        if count < 1:
            fail(f"{name}: the main path never launched its kernel")
    return outs, counts


# ---- slice 3: attention and serving ----------------------------------------
def graph_ms(fn: Callable[[], Any], iters: int = ITERS) -> float:
    """Device milliseconds per call of ``fn()``: one call captured in a CUDA
    graph and replayed in batches between CUDA events, so that the host's
    time to enqueue the call (which ``time_call`` reads when it is the
    longer) drops out."""
    fn()                         # warm-up: builds, configures, allocates
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
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
    return float(np.median([s.elapsed_time(e) for s, e in marks])
                 / CALLS_PER_SAMPLE)


def device_profile(fn: Callable[[], Any], top: int = 6):
    """(device ms, top kernels) of one call of ``fn()`` under
    ``torch.profiler``: the summed time of the kernels it ran, and the
    ``top`` kernels by time as (name, ms, calls)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return busy, [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                  for e in ranked]


def attention_sweep(dev) -> None:
    """Both kernels over their declared tunables at head dims 64 and 128,
    float32 at ORACLE_TOL and bfloat16 at BF16_TOL, on the shared sweep
    cases (``flash_attention/cases.py``): ragged S/T, GQA 4:1 and 1:1, a
    window, left pads, a wrapped ring (k_index_aligned False)."""
    rng = np.random.default_rng(11)
    points = {name: list(get_kernel(name).tunable_space("cuda").points())
              for name in ATTN}
    worst = dict.fromkeys(ATTN, 0.0)
    calls = dict.fromkeys(ATTN, 0)

    def hold(name, fn, want, live, tol, what):
        for pt in points[name]:
            err = attn_cases.hold_live(fn(**pt), want, live, *tol,
                                       f"{name} sweep {what} {pt}")
            worst[name] = max(worst[name], err)
            calls[name] += 1

    for dtype, tol in ((torch.float32, conformance.ORACLE_TOL[ATTN[0]]),
                       (torch.bfloat16, BF16_TOL)):
        for dh in (64, 128):
            for mode, b, h, kv, s, t, causal, window in attn_cases.FLASH_SWEEP:
                q, k, v = (x.transpose(1, 2) for x in attn_cases.draw(
                    rng, (b, s, h, dh), (b, t, kv, dh), dtype, dev))
                qp, kp, aligned = attn_cases.flash_positions(mode, b, s, t)
                qp, kp = torch.tensor(qp, device=dev), torch.tensor(kp,
                                                                  device=dev)
                pos = (None, None) if mode == "index" else (qp, kp)
                want = attn_ref.flash_ref(q, k, v, *pos, causal=causal,
                                          window=window)
                live = attn_ref.admitted(qp, kp, causal=causal,
                                         window=window).any(-1)
                hold(ATTN[0], lambda **pt: attn_kernel.flash(
                    q, k, v, *pos, causal=causal, window=window,
                    k_index_aligned=aligned, **pt),
                    want, live[:, None].expand(b, h, s), tol,
                    f"{mode} {dtype} dh={dh} S={s} T={t} window={window}")
            for b, h, kv, t, wrap, fill, window in attn_cases.DECODE_SWEEP:
                q, k, v = attn_cases.draw(rng, (b, 1, h, dh), (b, t, kv, dh),
                                          dtype, dev)
                qp, kp = (torch.tensor(x, device=dev) for x in
                          attn_cases.decode_positions(b, t, wrap, fill))
                want = attn_ref.decode_ref(q, k, v, qp, kp, window=window)
                live = attn_ref.admitted(qp, kp, causal=True,
                                         window=window).any(-1)
                hold(ATTN[1], lambda **pt: attn_kernel.decode(
                    q, k, v, qp, kp, window=window, **pt),
                    want, live, tol,
                    f"{dtype} dh={dh} T={t} wrap={wrap} window={window}")
    for name in ATTN:
        print(f"tunable sweep {name}[cuda]: {calls[name]} calls (float32 at "
              f"ORACLE_TOL, bfloat16 at {BF16_TOL}), worst max abs err "
              f"{worst[name]:.3g}")


@dataclasses.dataclass
class AttnCase:
    """One attention kernel at the serving shapes, bfloat16."""

    name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    plain: Callable[..., torch.Tensor]
    library: Callable[..., torch.Tensor]
    live: torch.Tensor          # output rows that admit a key
    least_flops: float          # 4 Dh flops per admitted (query, key) pair
    least_bytes: float          # q, o, positions, the K/V rows admitted
    whole_bytes: float          # the same with every K/V row of the cache


def attention_cases(dev, seed: int) -> List[AttnCase]:
    """The engine's largest prefill (one prompt of a length drawn from the
    seed, left-padded to 2048, against a fresh 4096-slot cache) and its
    decode step (8 rows filled to lengths drawn from the seed), as
    ``flash_attention/cases.py::serving_cases`` draws them."""
    cfg = get_config(ARCH)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t, s = SERVE["cache_len"], max(SERVE["prefill_buckets"])
    drawn = attn_cases.serving_cases(
        seed, n_heads=h, n_kv_heads=kv, head_dim=dh,
        num_slots=SERVE["num_slots"], cache_len=t, bucket=s,
        min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT, max_new=MAX_NEW,
        device=dev)

    def sdpa(mask):
        def call(q, k, v, *_, **__):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None], enable_gqa=True)
        return call

    def case(name, kwargs, plain, library):
        q, k, v, qp, kp = args = drawn[name]["args"]
        mask = attn_ref.admitted(qp, kp, causal=True)
        kv_rows = int((kp >= 0).sum())
        row_bytes = kv * dh * k.element_size() * 2          # K and V
        fixed = 2 * q.nbytes + qp.nbytes + kp.nbytes        # q, o, positions
        live = mask.any(-1)
        live = (live[:, None].expand(q.shape[:3]) if name == ATTN[0]
                else live)
        return AttnCase(name, args, kwargs, plain, library(mask), live,
                        4.0 * dh * h * float(mask.sum()),
                        fixed + kv_rows * row_bytes,
                        fixed + k.shape[0] * t * row_bytes)

    print(f"attention.flash at the serving shape: B 1, H {h}, Kv {kv}, S "
          f"{s} left-padded from a prompt of "
          f"{drawn[ATTN[0]]['lengths'][0]}, T {t}, Dh {dh}, bfloat16, q and "
          f"k at std {attn_cases.QK_STD}, v at std {attn_cases.V_STD}")
    flash = case(ATTN[0], {"causal": True, "k_index_aligned": True},
                 lambda *a, **_: attn_ref.flash_ref(*a, causal=True), sdpa)
    print(f"attention.decode at the serving shape: B {SERVE['num_slots']}, "
          f"H {h}, Kv {kv}, T {t}, Dh {dh}, bfloat16, rows filled to "
          f"{drawn[ATTN[1]]['lengths']}")
    decode = case(ATTN[1], {}, attn_ref.decode_ref,
                  lambda mask: lambda q, k, v, *a: sdpa(mask)(
                      q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2)))
    return [flash, decode]


def serve(dev, seed: int) -> Dict[str, Any]:
    """The serving path: granite-3-8b at full width and depth, 16 greedy
    requests through the engine with the attention counts read around the
    run; then one prefill's logits against the plain attention's, and a
    replay through unbatched generate."""
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    param_gb = n_params * torch.finfo(cfg.cdtype()).bits / 8 / 1e9
    print(f"serving {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}): "
          f"{n_params / 1e9:.3f}e9 parameters, {param_gb:.2f} GB in "
          f"{cfg.compute_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(params, cfg, **SERVE)
    if engine.attn_backends != {"prefill": "cuda", "decode": "cuda"}:
        fail(f"the engine's attention on CUDA weights resolved to "
             f"{engine.attn_backends}, not the hand-written kernels")
    kv_gb = sum(x.nbytes for c in engine.caches["segments"]
                for x in c["self"].values()) / 1e9
    trace = synthetic_trace(REQUESTS, vocab_size=cfg.vocab_size,
                            min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                            max_new_tokens=MAX_NEW, seed=seed)
    for req in trace:
        req.arrival_time = 0.0
    lens = sorted(r.prompt_len for r in trace)
    print(f"serving trace: {REQUESTS} requests at t = 0, prompts {lens}, "
          f"{MAX_NEW} new tokens each, {SERVE}")

    torch.cuda.reset_peak_memory_stats()
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    t0 = time.perf_counter()
    finished = engine.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {ATTN[0]: attn_kernel.flash.launches,
              ATTN[1]: attn_kernel.decode.launches}
    st = engine.stats
    expect = {ATTN[0]: cfg.n_layers * st["prefill_calls"],
              ATTN[1]: cfg.n_layers * st["decode_steps"]}
    print(f"main path [serving] launches: {counts}; prefill calls "
          f"{st['prefill_calls']}, decode steps {st['decode_steps']}")
    if counts != expect:
        fail(f"serving launched {counts}, not {cfg.n_layers} a prefill "
             f"call and a decode step: {expect}")
    done = sorted(finished, key=lambda r: r.uid)
    if len(done) != REQUESTS or any(
            len(r.generated) != MAX_NEW
            or not all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in done):
        fail("serving: a request did not finish with 32 tokens in the "
             "vocabulary")
    summ = latency_summary(done)
    tokens = st["tokens_generated"]
    out = {"tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "prefill_calls": st["prefill_calls"],
           "decode_steps": st["decode_steps"], "launches": counts,
           "param_gb": param_gb, "kv_cache_gb": kv_gb,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    out.update({k: summ[k] for k in ("p50_ttft_s", "p95_ttft_s",
                                     "p50_itl_s", "p50_latency_s")})
    print(f"serving: {tokens} tokens in {wall:.3f} s = "
          f"{out['tok_per_s']:.2f} tok/s; TTFT p50 "
          f"{summ['p50_ttft_s'] * 1e3:.1f} ms, p95 "
          f"{summ['p95_ttft_s'] * 1e3:.1f} ms; inter-token p50 "
          f"{summ['p50_itl_s'] * 1e3:.2f} ms; peak device memory "
          f"{out['max_memory_allocated_gb']:.2f} GB (parameters "
          f"{param_gb:.2f} GB, KV cache {kv_gb:.2f} GB)")

    # one prefill, kernels against the plain attention: the longest prompt
    req = max(done, key=lambda r: r.prompt_len)
    bucket = engine._bucket_for(req.prompt_len)
    toks = torch.zeros(1, bucket, dtype=torch.int64, device=dev)
    toks[0, bucket - req.prompt_len:] = torch.from_numpy(
        req.prompt.astype(np.int64))
    lengths = torch.tensor([req.prompt_len], device=dev)
    got = prefill(params, cfg, toks, cache_len=SERVE["cache_len"],
                  lengths=lengths)[0].float()
    want = prefill(params, cfg, toks, cache_len=SERVE["cache_len"],
                   lengths=lengths, attn_backend="torch")[0].float()
    valid = want[:, :cfg.vocab_size]
    err = float((got - want)[:, :cfg.vocab_size].abs().max())
    span = float(valid.max() - valid.min())
    same = bool(got.argmax(-1).eq(want.argmax(-1)).all())
    print(f"prefill logits (prompt {req.prompt_len}, bucket {bucket}), "
          f"kernels vs plain attention: max abs err {err:.4g} against a "
          f"logit range of {span:.4g} (gate {LOGITS_TOL} of it); same "
          f"argmax: {same}")
    if not err <= LOGITS_TOL * span:
        fail("prefill logits with the kernels disagree with the plain "
             "attention's")
    out["logits_err"], out["logits_span"] = err, span

    # replay: unbatched generate (batch 1) against the engine (batch 8)
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    match = 0
    for r in done[:REPLAY]:
        prompt = torch.from_numpy(r.prompt[None].astype(np.int64)).to(dev)
        toks = generate(params, cfg, prompt, max_new_tokens=MAX_NEW,
                        cache_len=SERVE["cache_len"])
        match += int((toks[0].cpu().numpy() == np.asarray(r.generated)).sum())
    replay = {ATTN[0]: attn_kernel.flash.launches,
              ATTN[1]: attn_kernel.decode.launches}
    print(f"replay: {match}/{REPLAY * MAX_NEW} tokens of {REPLAY} requests "
          f"through unbatched generate equal the engine's; launches "
          f"{replay}")
    if replay != {ATTN[0]: cfg.n_layers * REPLAY,
                  ATTN[1]: cfg.n_layers * REPLAY * (MAX_NEW - 1)}:
        fail(f"the replay launched {replay}")
    if match != REPLAY * MAX_NEW:
        fail("unbatched generate and the engine chose different tokens")
    out["replay_match"] = match

    # where the time goes: one prefill (the longest prompt) and one decode
    # step of the 8 slots, the device's kernels against the wall clock
    def one_prefill():
        prefill(params, cfg, toks, cache_len=SERVE["cache_len"],
                lengths=lengths)

    tok = torch.zeros(SERVE["num_slots"], 1, dtype=torch.int64, device=dev)
    pos = torch.from_numpy(engine.pos_buf).to(dev)

    def one_step():
        decode_step(params, cfg, tok, pos, engine.caches)

    toks = torch.zeros(1, bucket, dtype=torch.int64, device=dev)
    toks[0, bucket - req.prompt_len:] = torch.from_numpy(
        req.prompt.astype(np.int64))
    for name, fn, calls in (("prefill", one_prefill, 3),
                            ("decode step", one_step, 10)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
        busy, top = device_profile(fn)
        out[f"{name} wall_ms"], out[f"{name} device_ms"] = wall, busy
        print(f"{name}: {wall:.3f} ms wall, {busy:.3f} ms of kernels "
              f"(torch.profiler): the device idles {1 - busy / wall:.1%} of "
              f"it; top kernels (name, ms, calls): {top}")
    graphed = graph_ms(one_step)
    out["decode step graph_ms"] = graphed
    print(f"decode step as one CUDA graph: {graphed:.3f} ms on the device")
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generator that makes the inputs")
    args = p.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "GPU and never falls back to the CPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    label, bw, peak, peak_bf16 = datasheet(kind)
    print(f"bound rates: {label} data sheet, {bw / 1e12} TB/s HBM, "
          f"{peak / 1e12} TFLOP/s float32, {peak_bf16 / 1e12} TFLOP/s "
          f"bfloat16")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"built {name}: {'; '.join(ptxas)}")
    for name in KERNELS + ATTN:
        k = get_kernel(name)
        err = conformance.check_backend(name, k.native, device=dev)
        print(f"conformance case {name}[{k.native}] max abs err {err:.3g}")
    (pos8, dens8), _ = conformance.case_tensors("hartree_fock.twoel", dev)
    basis3 = hf_ref.sto_basis(3, device=dev)
    err = max_abs_err(
        hf_kernel.twoel_slab(hf_kernel.pad4(pos8), dens8, basis3, 2, 4),
        hf_ref.fock_build_slab(pos8, dens8, basis3, 2, 4), *HF_TOL,
        "conformance case hartree_fock.twoel_slab")
    print(f"conformance case {SLAB}[cuda] l in [2, 6) max abs err {err:.3g}")
    attention_sweep(dev)
    print(f"build + small cases: {time.perf_counter() - t0:.1f} s")

    # ---- inputs: made on the card from the seed ------------------------
    g = torch.Generator(device=dev).manual_seed(args.seed)
    a, b, c = (torch.randn(STREAM_N, generator=g, device=dev)
               for _ in range(3))
    u = torch.randn(STENCIL_L, STENCIL_L, STENCIL_L, generator=g, device=dev)
    coeffs = default_coefficients()
    stream_args = {"copy": (a,), "mul": (c,), "add": (a, b),
                   "triad": (b, c), "dot": (a, b)}
    slice1 = [registry_case(f"babelstream.{op}", f"babelstream.{op}", xs, {},
                            () if op == "dot" else tuple(xs[0].shape))
              for op, xs in stream_args.items()]
    slice1.append(registry_case("stencil7", "stencil7", (u, *coeffs), {},
                                tuple(u.shape)))
    deck = make_deck(**BUDE, seed=args.seed, device=dev)
    bude = [registry_case("minibude.fasten", "minibude.fasten", deck, {},
                          (BUDE["nposes"],))]
    hf, hf_inputs = [], {}
    for n, ngauss in HF_CASES:
        pos = hf_ref.helium_lattice(n, device=dev)
        dens = hf_ref.initial_density(n, device=dev)
        hf_inputs[n, ngauss] = (pos, dens)
        hf.append(registry_case(f"hartree_fock.twoel N={n} ngauss={ngauss}",
                                "hartree_fock.twoel", (pos, dens),
                                {"ngauss": ngauss}, (n, n),
                                hf_ops.least_flops(n, ngauss)))
    # the slabs of the N = 128 build, as one rank of a distributed build
    # calls the wrapper: (positions4, density, basis, l0, nl)
    n, ngauss = HF_CASES[0]
    pos, dens = hf_inputs[n, ngauss]
    pos4, basis = hf_kernel.pad4(pos), hf_ref.sto_basis(ngauss, device=dev)
    nl = n // SLABS
    slab_flops = 120.0 * float(n) ** 3 * nl * ngauss ** 4
    slabs = [Case(f"{SLAB} l in [{l0}, {l0 + nl})", SLAB,
                  hf_kernel.twoel_slab,
                  lambda p4, d, bs, l0_, nl_: hf_ref.fock_build_slab(
                      p4[:, :3], d, bs, l0_, nl_),
                  (pos4, dens, basis, l0, nl), {}, (n, n), slab_flops,
                  hf_ops.least_flops(n, ngauss, nl))
             for l0 in range(0, n, nl)]
    wrappers = {name: get_kernel(name).backend(get_kernel(name).native).fn
                for name in KERNELS}
    wrappers["hartree_fock.twoel"] = hf_kernel.twoel
    wrappers[SLAB] = hf_kernel.twoel_slab

    # ---- 2. main path, with the launch counts --------------------------
    outs, launches = {}, {}
    for phase, cases in (("slice 1", slice1), ("miniBUDE", bude),
                         ("Hartree-Fock", hf), ("Hartree-Fock slabs", slabs)):
        o, counts = drive(phase, cases, wrappers)
        outs.update(o)
        launches.update(counts)

    # ---- 3. check ------------------------------------------------------
    f = outs["stencil7"]
    faces = (f[0], f[-1], f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1])
    if any(bool(face.ne(0).any()) for face in faces):
        fail("stencil7: a boundary face is not zero")
    cases = slice1 + bude + hf + slabs
    for c in cases:
        out = outs[c.label]
        if not bool(torch.isfinite(out).all()):
            fail(f"{c.label}: non-finite values in the main path's output")
        if tuple(out.shape) != c.shape or out.dtype != torch.float32:
            fail(f"{c.label}: output {out.dtype}{tuple(out.shape)}, "
                 f"expected float32{c.shape}")
    for c in hf:
        err = max_abs_err(outs[c.label], outs[c.label].T, *HF_TOL,
                          f"{c.label}: F against its transpose")
        print(f"{c.label}: symmetric, max |F - F^T| {err:.3g}")
    errs: Dict[str, float] = {}
    for c in slice1 + bude + hf:
        k = get_kernel(c.record)
        e = k.validate(*c.args, backend=k.native, **c.kwargs)
        errs[c.label] = e
        print(f"{c.label}[{k.native}] vs torch at ORACLE_TOL "
              f"{conformance.ORACLE_TOL[c.record]}: max abs err {e:.3g}")
    # the slabs: each against its plain slab, their sum against the full
    # kernel's build
    full = outs[hf[0].label]
    for c in slabs:
        errs[c.label] = max_abs_err(outs[c.label], c.plain(*c.args),
                                    *HF_TOL, c.label)
        print(f"{c.label}[cuda] vs torch at ORACLE_TOL {HF_TOL}: max abs "
              f"err {errs[c.label]:.3g}")
    total = sum(outs[c.label] for c in slabs)
    err = max_abs_err(total, full, *HF_TOL, f"sum of the {SLABS} slabs")
    print(f"sum of the {SLABS} slabs vs the full N={n} build at ORACLE_TOL "
          f"{HF_TOL}: max abs err {err:.3g}")

    # ---- 4. timing -----------------------------------------------------
    measured: Dict[str, Dict[str, Any]] = {}
    # one slab stands for the slab record: they are the same work
    for c in slice1 + bude + hf + slabs[:1]:
        ms = time_call(c.kernel, *c.args, iters=ITERS, **c.kwargs) * 1e3
        plain_ms = time_call(c.plain, *c.args, iters=ITERS, **c.kwargs) * 1e3
        lib = LIBRARY[c.record]
        library_ms = (time_call(lib, *c.args, iters=ITERS) * 1e3
                      if lib is not None else None)
        # through the registry, as a user calls it; a few calls will do
        # where each takes a millisecond or more
        call = c.kernel if c.record == SLAB else get_kernel(c.record)
        host_ms = enqueue_ms(call, c.args, c.kwargs,
                             3 if ms >= LONG_CALL_S * 1e3 else ITERS)
        moved = sum(x.nbytes for x in c.args if isinstance(x, torch.Tensor))
        moved += outs[c.label].nbytes
        if c.record == SLAB:
            moved += basis.exponents.nbytes + basis.coefficients.nbytes
        t_bytes, t_ops = moved / bw * 1e3, c.least_flops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        gflops = c.flops / ms / 1e6
        if c.record in ("minibude.fasten",):
            fom = f"{gflops:.0f} GFLOP/s by Eq. 3"
        elif c.record.startswith("hartree_fock"):
            fom = f"wall clock, {gflops:.0f} GFLOP/s by 120 N^4 G^4"
        else:
            gbs = get_kernel(c.record).figure_of_merit(
                ms / 1e3, *c.args)["gbytes_per_s"]
            fom = (f"{gbs:.0f} GB/s by Eq. "
                   f"{1 if c.record == 'stencil7' else 2}")
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{c.label}: {ms:.4f} ms ({fom}, {bound_ms / ms:.1%} of the "
              f"{bound_ms:.4f} ms bound), plain {plain_ms:.4f} ms, library "
              f"{lib_txt}, host enqueue {host_ms:.4f} ms a call")
        measured[c.label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "gflops_per_s": gflops,
            "max_abs_err": errs[c.label]}

    records, terms, slab_term = [], [], None
    for name in RECORDS:
        mine = [c for c in cases if c.record == name]
        timed = [c for c in mine if c.label in measured]
        first = measured[timed[0].label]
        rec = {"name": name, "route": "cuda" if name == SLAB
               else get_kernel(name).native,
               "source": SOURCE[name], "replaces": REPLACES[name],
               "launches": launches[name],
               "max_abs_err": max(errs[c.label] for c in mine)}
        rec.update({key: first[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if len(timed) > 1:
            # every timed shape of a record with more than one
            rec["cases"] = [dict(case=c.label, **measured[c.label])
                            for c in timed]
        records.append(rec)
        term = Efficiency(kind, name, 1.0 / rec["ms"], 1.0 / rec["plain_ms"])
        if name == SLAB:
            slab_term = term
        else:
            terms.append(term)

    # ---- 5. Eq. 4 ------------------------------------------------------
    for t in terms:
        print(f"Eq.4 e_i {t.case}: {t.e:.3f} (torch baseline)")
    print(f"Eq.4 Phi-bar over {len(terms)} kernels: {phi_bar(terms):.3f}")
    print(f"e_i {SLAB}: {slab_term.e:.3f} (torch baseline; the "
          f"Hartree-Fock kernel again, so not in Phi-bar)")

    # ---- 6. attention at the serving shapes ----------------------------
    attn: Dict[str, Dict[str, Any]] = {}
    for c in attention_cases(dev, args.seed):
        k = get_kernel(c.name)
        if k.default_backend(*c.args, **c.kwargs) != k.native:
            fail(f"{c.name}: the default backend on CUDA tensors is not "
                 f"the hand-written {k.native!r}")
        err = attn_cases.hold_live(
            k(*c.args, **c.kwargs), c.plain(*c.args, **c.kwargs), c.live,
            *BF16_TOL, f"{c.name} at the serving shape")
        ms = time_call(k.backend(k.native).fn, *c.args, iters=ITERS,
                       **c.kwargs) * 1e3
        plain_ms = time_call(c.plain, *c.args, iters=ITERS, **c.kwargs) * 1e3
        library_ms = time_call(c.library, *c.args, iters=ITERS) * 1e3
        host_ms = enqueue_ms(k, c.args, c.kwargs, ITERS)
        # the same three calls with the host's enqueue time taken out
        dev_ms = {
            key: graph_ms(lambda f=f, kw=kw: f(*c.args, **kw))
            for key, f, kw in (("kernel", k.backend(k.native).fn, c.kwargs),
                               ("plain", c.plain, c.kwargs),
                               ("library", c.library, {}))}
        t_bytes = c.least_bytes / bw * 1e3
        t_ops = c.least_flops / peak_bf16 * 1e3
        bound_ms = max(t_bytes, t_ops)
        gflops = k.flops_model(*c.args, **c.kwargs) / ms / 1e6
        print(f"{c.name}[cuda] vs torch at {BF16_TOL}: max abs err "
              f"{err:.3g}; {ms:.4f} ms ({gflops:.0f} GFLOP/s by the "
              f"reference's model, {bound_ms / ms:.2%} of the "
              f"{bound_ms:.4f} ms bound: {c.least_flops:.4g} flops of "
              f"admitted pairs, {c.least_bytes / 1e6:.2f} MB of q, o, "
              f"positions and admitted K/V rows; the whole cache would be "
              f"{c.whole_bytes / 1e6:.2f} MB = {c.whole_bytes / bw * 1e3:.4f}"
              f" ms), plain {plain_ms:.4f} ms, library "
              f"(scaled_dot_product_attention) {library_ms:.4f} ms, host "
              f"enqueue {host_ms:.4f} ms a call")
        print(f"{c.name} device time (CUDA graph replay): kernel "
              f"{dev_ms['kernel']:.4f} ms = {bound_ms / dev_ms['kernel']:.2%}"
              f" of the bound, plain {dev_ms['plain']:.4f} ms, library "
              f"{dev_ms['library']:.4f} ms")
        attn[c.name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "library_ms": library_ms,
                        "graph_ms": dev_ms}
        print(f"e_i {c.name}: {plain_ms / ms:.3f} (torch baseline; a "
              f"serving kernel, not in the paper's Phi-bar)")

    # ---- 7. serving: the LM main path ----------------------------------
    served = serve(dev, args.seed)
    for name in ATTN:
        rec = {"name": name, "route": get_kernel(name).native,
               "source": SOURCE[name], "replaces": REPLACES[name],
               "launches": served["launches"][name]}
        rec.update(attn[name])
        records.append(rec)
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
