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
(8 slots, a 4096-slot KV cache, prefill buckets 512 and 2048) in both KV
layouts and both driver loops, whose every prefill runs the flash
attention kernel and every decode step, a replay of one CUDA graph, the
ring-buffer decode attention kernel, 40 launches a call each; then RWKV
serving: rwkv6-3b at full width and depth (32 layers, random bf16 weights
from ``--seed``) generating for 8 prompts of 2048 tokens as one batch
through ``serve_step.generate``, whose prefill and every decode step run the
chunked WKV kernel, 32 launches a call.

  1. build:     nvcc for every ``csrc/*.cu`` (all started together), then
                each kernel once on its small conformance case on the card,
                which compiles the Triton kernels and checks them;
  1b. tuning:  ``tune(search="auto")`` for every registered kernel at the
                shape its main path gives it (the science kernels at the
                paper's sizes, flash at both prefill buckets and decode at
                the engine's step, built by ``models/attention.py::
                kernel_args`` as the engine's calls are, the WKV at
                rwkv6-3b's prefill) into a cache in a temporary directory:
                every swept point printed with its time and its timer
                (CUDA-graph device time where the first point reads under
                ``tuning.GRAPH_TIMER_BELOW_S``), the best point and the
                declared default each timed by ``time_call`` and as a
                graph; until phase 7b every attention call misses the
                cache (``REPRO_TORCH_TUNING_CACHE`` names an empty file);
  2. main path: four paths — slice 1 (BabelStream, stencil), miniBUDE,
                Hartree-Fock, the Hartree-Fock slabs — each with every
                launch count set to 0 just before it and read just after;
                registry kernels go through ``get_kernel(name)`` with their
                default backend on CUDA tensors, which must be the
                hand-written one, and each kernel must have launched;
  3. check:     each kernel against its plain PyTorch version on the same
                inputs at the port's ORACLE_TOL; the stencil's boundary
                faces are zero, the Fock matrices symmetric, the four slabs
                sum to the full build, a second N = 128 build gives the
                same bits, and nothing is NaN;
  4. timing:    CUDA-event medians of the kernel, its plain version and the
                one PyTorch call computing the same function (where there
                is one), beside the least time the card could take, and
                the host's time to enqueue one call; for miniBUDE also
                the device time of each of its CUDA kernels (the pair table
                and the energies), a second call bit-identical to the
                first, every (ppwi, split) point checked and timed, bm1's
                atoms at 16 x its poses timed at every point, and the SASS
                instructions an interaction takes (its bound from
                ``minibude/ops.py::least_flops``, Eq. 3's GFLOP/s beside
                it); for Hartree-Fock also
                the device time of each of a build's three kernels, the
                integrals its tiling evaluates against the distinct ones
                (at most 1.10x), and every tunable point timed;
  5. Eq. 4:     e_i = plain time / kernel time and their mean, Phi-bar,
                over the registry's kernels; the slab, the Hartree-Fock
                kernel again, gets its e_i apart; then the same at the
                tuned points (the slab at the tuned team), with each
                kernel's device time as a graph and, for BabelStream, its
                ATen call's;
  6. attention: the two kernels on their float32 conformance cases (in 1),
                a sweep over the tunables each dtype is built for, head
                dims 64/128, ragged S/T, a window, a wrapped ring and a
                long left-padded prompt (in 1), then each in bfloat16 at
                the serving shapes against its plain version, timed beside
                ``scaled_dot_product_attention`` and its least-work bound
                (``flash_attention/ops.py::least_flops`` for prefill), with
                every bf16 flash tile point checked and timed as a CUDA
                graph, and flash's TFLOP/s on the admitted pairs; decode
                must be one CUDA launch a call (``torch.profiler``), and its
                split blocks live and empty at the serving fills and every
                bkv point (checked, timed as a CUDA graph) are printed, with
                the earlier kernels' times (PERF.md) beside the new ones;
  7. serving:   one trace of 16 greedy requests (prompts of 64-2048 tokens
                from the seed, 32 new tokens each, Poisson arrivals at 50
                a second) through three engines: contiguous and paged
                with ``run``, paged with ``run_threaded``, the paged ones
                on a pool a third the contiguous footprint
                (``PAGED_BLOCKS``), so that requests wait for pages.  Each
                engine captures its decode step once as a CUDA graph when
                it is built; the attention launch counts are set to 0 just
                before the engine is built and read just after its run:
                flash 40 x prefill calls, decode 2 x 40 (the warm-up and
                the capture: a replay does not run the wrapper), and
                ``decode_traces`` must be 1, every decode step a graph
                replay.  The trace is served again on each engine under
                ``torch.profiler``, which must show 40 decode kernels a
                replay and 40 flash kernels a prefill.  Every slot then
                filled from a probe trace, one engine step is profiled
                and must run 40 decode kernels; its wall time against its
                device time,
                the eager step on the same inputs and the largest logit
                difference between it and a replay, and for the paged
                layout the gather and the scatter.  The three engines'
                tokens must be equal, and two requests replayed through
                unbatched ``generate`` must give them; one prefill's
                logits against the plain attention's; where a
                2048-bucket prefill's time goes, flash's share included;
  7b. tuned:    the contiguous engine on the filled cache: its
                ``dispatch_log()`` must show a tuned provenance for prefill
                and decode, its tokens are held against the untuned run's
                (bitwise where every point the trace runs is a default) and
                a prefill's logits at each bucket against the untuned
                one's; a prefill's host enqueue with and without the
                lookups; then one engine with telemetry on: a Chrome trace
                and a JSONL (temporary directory), the summarize table,
                ``cuda.graph_capture == 1`` and the tokens equal to the run
                with telemetry off, tok/s on and off;
  8. rwkv:      the WKV kernel on its conformance case (in 1) and over its
                chunks at head dims 32 and 64, S = 1, ragged S and S = 2047
                from a random state (in 1), then at the serving shape (B 8,
                H 40, S 2048, Dh 64) and the decode step's (S 1, from a
                state) against the exact recurrence, timed beside it, the
                plain chunked form and the bound, with each CUDA kernel's
                time (``torch.profiler``: the one-token kernel at S 1, the
                state increments, the scan and the outputs at S 2048, and
                no other kernel), every chunk timed as a CUDA graph and
                the earlier kernel's times (PERF.md) beside the new ones;
                then rwkv6-3b generates 32 greedy tokens for 8 prompts of
                2048 tokens with the WKV launch count set to 0 just before
                and read just after (32 a call: 1024); on the same
                weights in float32, one row's prefill logits against the
                plain WKV's, and a 2047-token
                prefill plus one decode step against the 2048-token
                prefill, within 2% of the range; in bfloat16, where the
                plain WKV's own two forms disagree by ~5% of the range, the
                kernel against the plain chunked form and the kernel's
                handoff on two rows of 2048 tokens, each within twice the
                serial-against-chunked floor on the same rows;
                two rows replayed alone (printed, not gated).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(each record with its tuned points, their provenance and times),
and as its last line ``{"ok": true, "device": {...}}``.  With no CUDA
device, or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import inspect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch import _sass  # noqa: E402
import repro_torch.kernels  # noqa: E402,F401  (registers the kernels)
from repro_torch.core import (  # noqa: E402
    Efficiency, get_kernel, max_abs_err, phi_bar, time_call)
from repro_torch.core import conformance  # noqa: E402
from repro_torch.core import telemetry as tel  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.core.telemetry import cudamon  # noqa: E402
from repro_torch.core.portable import (  # noqa: E402
    LONG_CALL_S, time_graph)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.babelstream import kernel as bs_kernel  # noqa: E402,E501
from repro_torch.kernels.babelstream.ref import START_SCALAR  # noqa: E402
from repro_torch.kernels.flash_attention import cases as attn_cases  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_params, tree_map)
from repro_torch.serving import (  # noqa: E402
    RESERVED_BLOCKS, ServingEngine, gather_caches, latency_summary,
    scatter_decode, synthetic_trace)
from repro_torch.training.serve_step import (  # noqa: E402
    decode_step, generate, prefill)
from repro_torch.kernels.hartree_fock import kernel as hf_kernel  # noqa: E402
from repro_torch.kernels.hartree_fock import ops as hf_ops  # noqa: E402
from repro_torch.kernels.hartree_fock import ref as hf_ref  # noqa: E402
from repro_torch.kernels.minibude import kernel as bude_kernel  # noqa: E402
from repro_torch.kernels.minibude import ops as bude_ops  # noqa: E402
from repro_torch.kernels.minibude.ops import make_deck  # noqa: E402
from repro_torch.kernels.rwkv6 import cases as wkv_cases  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.kernels.stencil7.ref import default_coefficients  # noqa: E402

STREAM_N = 1 << 25     # the paper's BabelStream size
STENCIL_L = 512        # the paper's smaller stencil volume
BUDE = {"natpro": 938, "natlig": 26, "nposes": 65536}  # bm1's shape
HF_CASES = ((128, 3), (64, 6))  # (N, ngauss): the paper's Table 4 He systems
SLABS = 4              # l-slabs of the N = 128 build
ITERS = 20             # timed samples per median (time_call takes fewer
                       # for calls of a millisecond or more)
PROFILE_FILLER = 10000  # spin kernels ahead of each profiled block
FILLER_KERNEL = "spin_kernel"  # their name (torch.cuda._sleep)
PROFILE_LOSS: List[int] = []  # spin kernels each profile dropped
STREAM_OPS = ("copy", "mul", "add", "triad", "dot")
SLICE1 = tuple(f"babelstream.{op}" for op in STREAM_OPS) + ("stencil7",)
KERNELS = SLICE1 + ("minibude.fasten", "hartree_fock.twoel")  # registry
SLAB = "hartree_fock.twoel_slab"  # the slab wrapper, outside the registry
RECORDS = KERNELS + (SLAB,)
HF_TOL = conformance.ORACLE_TOL["hartree_fock.twoel"]
BUDE_TOL = conformance.ORACLE_TOL["minibude.fasten"]
#: the CUDA kernels of a miniBUDE call (csrc/minibude.cu): the pair table
#: and the energies
BUDE_STAGES = ("bude_pair_kernel", "fasten_kernel")
BUDE_MORE_POSES = 16   # bm1's atoms at 16 x its poses: 1,048,576, timed
BUDE_ATOMS = (BUDE["natpro"], BUDE["natlig"])
#: miniBUDE before this design (the first port's kernel: a thread's poses
#: against every atom pair, ppwi 1, block 128): ms by time_call at bm1
#: (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
BUDE_EARLIER_MS = 4.210879802703857
#: the three kernels of one Hartree-Fock build (csrc/hartree_fock.cu)
HF_STAGES = ("pair_table_kernel", "eri_kernel", "fock_gather_kernel")

ATTN = ("attention.flash", "attention.decode")   # slice 3's kernels
FLASH_KERNEL = "flash_wgmma_kernel"   # the bf16 prefill kernel's name
#: the serving path: granite-3-8b at full width and depth
ARCH = "granite-3-8b"
SERVE = {"num_slots": 8, "cache_len": 4096, "prefill_buckets": (512, 2048)}
REQUESTS, MIN_PROMPT, MAX_PROMPT, MAX_NEW = 16, 64, 2048, 32
REPLAY = 2          # requests replayed through unbatched generate
BLOCK = 16          # the paged engines' page, the engine's default
#: the paged engines' pool: 1.25 x the pages of ``num_slots`` requests of
#: the trace's mean length ((MIN_PROMPT + MAX_PROMPT) / 2 + MAX_NEW
#: tokens), plus the reserved pages: a third of the contiguous layout's
#: footprint, sized for the mean request and not the longest, so that
#: admission can wait for pages while a slot is free
PAGED_BLOCKS = RESERVED_BLOCKS + math.ceil(
    1.25 * SERVE["num_slots"]
    * math.ceil(((MIN_PROMPT + MAX_PROMPT) // 2 + MAX_NEW) / BLOCK))
#: the engines that serve the trace: (label, engine options, run_threaded)
PAGED = {"cache_layout": "paged", "block_size": BLOCK,
         "num_blocks": PAGED_BLOCKS}
SERVE_ENGINES = (("contiguous", {"cache_layout": "contiguous"}, False),
                 ("paged", PAGED, False),
                 ("paged, run_threaded", PAGED, True))
#: bfloat16 attention against its plain version: the reference's own bf16
#: tolerance (tests/test_kernels_lm.py::test_flash_bf16)
BF16_TOL = (2e-2, 2e-2)
#: one prefill's last-position logits with the kernels against the plain
#: attention's, over 40 bf16 layers: within this share of the logits' range
#: (read 1.08% on an H100, PERF.md)
LOGITS_TOL = 0.02

RWKV = "rwkv6.wkv"          # slice 4's kernel
#: the RWKV path: rwkv6-3b at full width and depth, 8 prompts of 2048
#: tokens as one batch through serve_step.generate, 32 greedy new tokens
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW = 8, 2048, 32
RWKV_REPLAY = 2     # rows replayed alone (batch 1): printed, not gated
RWKV_GATE_ROWS = 2  # rows of the handoff gate and of the bf16 gates
#: bfloat16 logits against the plain WKV: within this multiple of the plain
#: WKV's own spread (serial against chunked) on the same rows and tokens
BF16_FLOOR_X = 2.0
WKV_TOL = conformance.ORACLE_TOL[RWKV]
#: the CUDA kernels of a WKV call (csrc/rwkv6.cu): one token, and S > 1
WKV_STEP = ("wkv_step_kernel",)
WKV_CHUNKS = ("wkv_delta_kernel", "wkv_scan_kernel", "wkv_output_kernel")
DECODE_KERNEL = "decode_kernel"   # the one launch of a decode call
#: the kernels ATen runs for the paged gather's index_select (the pool's
#: pages along dim 1 of a segment leaf; the scatter's one small
#: ``tables.gather`` shares the second name)
GATHER_KERNELS = ("indexSelect", "_scatter_gather_elementwise_kernel")
#: the two kernels' times before this design, ms by time_call and [device
#: ms as a CUDA graph], as chip_smoke.py measured them on an NVIDIA H100
#: 80GB HBM3 at 700.00 W (PERF.md section 6): printed beside the new ones
EARLIER = {
    "attention.decode": (0.06889439821243286, 0.04816160053014755),
    "serving shape": (2.5222721099853516, 2.518734359741211),
    "decode step": (0.05361759960651398, 0.038540801405906676),
}

SOURCE = {name: "src/repro_torch/kernels/babelstream/kernel.py"
          for name in SLICE1[:5]}
SOURCE.update({
    "stencil7": "src/repro_torch/csrc/stencil7.cu",
    "minibude.fasten": "src/repro_torch/csrc/minibude.cu",
    "hartree_fock.twoel": "src/repro_torch/csrc/hartree_fock.cu",
    SLAB: "src/repro_torch/csrc/hartree_fock.cu",
    "attention.flash": "src/repro_torch/csrc/flash_attention.cu",
    "attention.decode": "src/repro_torch/csrc/flash_attention.cu",
    RWKV: "src/repro_torch/csrc/rwkv6.cu",
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
    RWKV: "src/repro/kernels/rwkv6/kernel.py:70",
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
#: the calls' names in the printout
LIBRARY_NAME = {
    "babelstream.copy": "clone",
    "babelstream.mul": "torch.mul",
    "babelstream.add": "torch.add",
    "babelstream.triad": "torch.add(b, c, alpha=s)",
    "babelstream.dot": "torch.dot",
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


def hartree_fock_report(c: Case, card: str) -> None:
    """One Hartree-Fock case: the device time of each of a build's three
    kernels (retaken while the profiler drops one), the contracted
    integrals its tiling evaluates against the
    distinct ones the build needs (failing above 1.10x), and, for a full
    build, every tunable point checked against the default's output and
    timed."""
    n = c.args[0].shape[0]
    l0, nl = (c.args[3], c.args[4]) if c.record == SLAB else (0, None)
    # the profiler here can drop records: a profile that misses one of the
    # three kernels is taken again, up to 5 times
    for _ in range(5):
        busy, top, _ = device_profile(
            lambda: c.kernel(*c.args, **c.kwargs), top=8)
        stages = {stage: ms for name, ms, _ in top for stage in HF_STAGES
                  if stage + "(" in name or stage + "<" in name}
        if set(stages) == set(HF_STAGES):
            break
    if set(stages) != set(HF_STAGES):
        fail(f"{c.label}: the profile shows {top}, not the three kernels "
             f"{HF_STAGES}")
    computed = hf_ops.computed_integrals(n, l0, nl)
    distinct = hf_ops.unique_integrals(n, nl)
    print(f"{c.label} device ms by kernel (torch.profiler, {busy:.4f} ms "
          f"of kernels in all) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; integrals evaluated {computed} against {distinct} distinct "
          f"({computed / distinct:.4f}x, tile {hf_kernel.TILE})")
    if computed > 1.10 * distinct:
        fail(f"{c.label}: the tiling evaluates {computed} integrals, more "
             f"than 1.10 x the {distinct} distinct ones")
    if c.record == SLAB:
        return
    want = c.kernel(*c.args, **c.kwargs)
    points = {}
    for pt in get_kernel(c.record).tunable_space("cuda").points():
        max_abs_err(c.kernel(*c.args, **c.kwargs, **pt), want, *HF_TOL,
                    f"{c.label} at {pt}")
        points[f"team {pt['team']}"] = time_call(
            c.kernel, *c.args, iters=ITERS, **c.kwargs, **pt) * 1e3
    print(f"{c.label} tunable points, ms (time_call) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in points.items())
          + f"; default team {hf_kernel.TEAM}, tile {hf_kernel.TILE}")


def bude_report(c: Case, card: str, seed: int) -> None:
    """miniBUDE at bm1: each CUDA kernel's device time, a second call
    bit-identical to the first (else it fails), every (ppwi, split) point
    against the plain version and timed, bm1's atoms at 16 x its poses
    timed at every point, and the SASS instructions an interaction takes in
    each instantiation of the energy loop."""
    fn = bude_kernel.fasten
    found = kernels_run(lambda: fn(*c.args), BUDE_STAGES, BUDE_STAGES)
    if set(found) != set(BUDE_STAGES):
        fail(f"miniBUDE: the profile shows {sorted(found)}, not "
             f"{BUDE_STAGES}")
    print(f"miniBUDE device ms by kernel (torch.profiler) on {card}: "
          + ", ".join(f"{k} {ms:.4f} ({n} a call)"
                      for k, (ms, n) in found.items()))
    first = fn(*c.args)
    if not torch.equal(first, fn(*c.args)):
        fail("miniBUDE: a second call differs from the first")
    print("miniBUDE: a second call is bit-identical to the first")
    want = c.plain(*c.args)
    points = list(get_kernel(c.record).tunable_space("cuda").points())
    sweep = {}
    for pt in points:
        key = f"ppwi {pt['ppwi']} split {pt['split']}"
        max_abs_err(fn(*c.args, **pt), want, *BUDE_TOL, f"miniBUDE at {key}")
        sweep[key] = time_call(fn, *c.args, iters=ITERS, **pt) * 1e3
    print(f"miniBUDE points at bm1, each within {BUDE_TOL} of the plain "
          f"version, ms (time_call) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sweep.items())
          + f"; fastest {min(sweep, key=sweep.get)}; default ppwi "
          f"{bude_kernel.PPWI} split {bude_kernel.SPLIT}; the earlier kernel "
          f"{BUDE_EARLIER_MS:.4f}")
    big = make_deck(BUDE["natpro"], BUDE["natlig"],
                    BUDE_MORE_POSES * BUDE["nposes"], seed=seed,
                    device=c.args[0].device)
    more = {}
    for pt in points:
        out = fn(*big, **pt)
        if out.shape != (big[4].shape[1],) or not bool(
                torch.isfinite(out).all()):
            fail(f"miniBUDE at {BUDE_MORE_POSES} x the poses, {pt}: "
                 f"{tuple(out.shape)} or non-finite values")
        more[f"ppwi {pt['ppwi']} split {pt['split']}"] = time_call(
            fn, *big, iters=ITERS, **pt) * 1e3
    print(f"miniBUDE at bm1's atoms and {big[4].shape[1]} poses, ms "
          f"(time_call) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in more.items())
          + f"; fastest {min(more, key=more.get)}")
    for name, loops in _sass.per_marker(_build.library_path("minibude"),
                                        "fasten_kernel").items():
        m = re.search(r"ILi(\d+)E", name)
        what = f"ppwi {m[1]}" if m else name
        print(f"fasten_kernel<{what}> innermost loops (SASS, _sass.py): "
              + "; ".join(f"{lp['instructions']} instructions, "
                          f"{lp['markers']} MUFU.RSQ, {lp['per_marker']:.2f} "
                          f"a sqrtf" for lp in loops))
    tools = [t for t in ("ncu", "nsys") if shutil.which(t) or Path(
        _build.nvcc_path()).with_name(t).exists()]
    print(f"profilers on this machine: {tools or 'neither ncu nor nsys'}")


# ---- slice 3: attention and serving ----------------------------------------
def graph_ms(fn: Callable[[], Any], iters: int = ITERS) -> float:
    """Device milliseconds per call of ``fn()``: one call captured in a CUDA
    graph and replayed in batches between CUDA events (``time_graph``), so
    that the host's time to enqueue the call (which ``time_call`` reads
    when it is the longer) drops out."""
    return time_graph(fn, iters=iters) * 1e3


@contextlib.contextmanager
def profiling():
    """``torch.profiler`` (host and CUDA activity) over the block.  The
    profiler can drop the first device records of a session, a count that
    grows as the process ages: late in this script that was once every
    record of ten one-token WKV calls, five sessions in a row.
    PROFILE_FILLER launches of ``torch.cuda._sleep``'s spin kernel go
    first and take the loss, which ``PROFILE_LOSS`` keeps a session;
    ``device_kernels`` leaves them out."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FILLER):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
    PROFILE_LOSS.append(PROFILE_FILLER - sum(
        e.count for e in prof.key_averages() if FILLER_KERNEL in e.key))


def device_kernels(prof) -> List[Any]:
    """The profile's device records by name (``key_averages``), without
    the spin kernels that ``profiling`` put ahead of the block."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and FILLER_KERNEL not in e.key]


def device_profile(fn: Callable[[], Any], top: int = 6, match: str = ""):
    """(device ms, top kernels, ms of ``match``) of one call of ``fn()``
    under ``torch.profiler``: the summed time of the kernels it ran, the
    ``top`` kernels by time as (name, ms, calls), and the summed time of
    the kernels whose name holds ``match``."""
    with profiling() as prof:
        fn()
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    matched = sum(e.self_device_time_total for e in kernels
                  if match and match in e.key) / 1e3
    return busy, [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                  for e in ranked], matched


def kernels_run(fn: Callable[[], Any], names, expect,
                tries: int = 5) -> Dict[str, Tuple[float, int]]:
    """{name: (device ms a call, launches a call)} of the kernels that
    ``fn()`` runs, each of whose profiled names must hold one of ``names``
    (else it fails), from ten calls under ``torch.profiler`` after one
    call outside it.  The profiler here can drop records, even whole calls,
    and once dropped every record of three calls of a 5 us kernel three
    times over: a kernel seen one to ten times counts as one launch a
    call, and the profile is taken again, up to ``tries`` times, until
    every name of ``expect`` shows."""
    calls = 10
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profiling() as prof:
            for _ in range(calls):
                fn()
        found = {}
        for e in device_kernels(prof):
            hits = [n for n in names if n + "<" in e.key or n + "(" in e.key]
            if not hits:
                fail(f"a call ran {e.key!r}, none of {names}")
            found[hits[0]] = (e.self_device_time_total / 1e3 / e.count,
                              -(-e.count // calls))
        if set(expect) <= set(found):
            break
    return found


def attention_sweep(dev) -> None:
    """Both kernels over their declared tunables at head dims 64 and 128,
    float32 at ORACLE_TOL and bfloat16 at BF16_TOL, on the shared sweep
    cases (``flash_attention/cases.py``): ragged S/T, GQA 4:1 and 1:1, a
    window, left pads, a wrapped ring (k_index_aligned False)."""
    rng = np.random.default_rng(11)
    worst = dict.fromkeys(ATTN, 0.0)
    calls = dict.fromkeys(ATTN, 0)

    def hold(name, fn, want, live, tol, what, args):
        # every declared point the inputs' dtype is built for
        for pt in get_kernel(name).tunable_space("cuda").valid_points(*args):
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
                    f"{mode} {dtype} dh={dh} S={s} T={t} window={window}",
                    (q, k, v))
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
                    f"{dtype} dh={dh} T={t} wrap={wrap} window={window}",
                    (q, k, v, qp, kp))
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
                        attn_ops.least_flops(qp, kp, h, dh, causal=True),
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


def decode_report(c: AttnCase, want: torch.Tensor, card: str
                  ) -> Dict[str, Any]:
    """Decode at the serving shape: the one CUDA launch a call makes
    (failing on any other), the split blocks that hold an admitted row
    against those that do not, and every declared bkv checked and timed
    as a CUDA graph."""
    q, k, v, qp, kp = c.args
    ran = kernels_run(lambda: attn_kernel.decode(*c.args), (DECODE_KERNEL,),
                      (DECODE_KERNEL,))
    if list(ran) != [DECODE_KERNEL] or ran[DECODE_KERNEL][1] != 1:
        fail(f"{c.name}: one call ran {ran}, not one {DECODE_KERNEL}")
    b, t, kv = k.shape[:3]
    ok = attn_ref.admitted(qp, kp, causal=True)[:, 0]          # (B, T)
    splits, sweep = {}, {}
    for pt in get_kernel(c.name).tunable_space("cuda").points():
        bkv = pt["bkv"]
        n = -(-t // bkv)
        live = int(F.pad(ok, (0, n * bkv - t)).reshape(b, n, bkv).any(-1)
                   .sum()) * kv
        splits[bkv] = {"live": live, "empty": b * n * kv - live}
        attn_cases.hold_live(attn_kernel.decode(*c.args, **pt), want, c.live,
                             *BF16_TOL, f"{c.name} at the serving shape {pt}")
        sweep[bkv] = graph_ms(lambda pt=pt: attn_kernel.decode(*c.args, **pt))
    print(f"{c.name}: one launch a call ({DECODE_KERNEL}, "
          f"{ran[DECODE_KERNEL][0]:.4f} ms by torch.profiler); split blocks "
          f"live / empty at the serving fills by bkv: {splits}")
    print(f"{c.name} bkv points at the serving shape, device ms (CUDA "
          f"graph) on {card}: {sweep}; default {attn_kernel.BKV}")
    return {"splits": splits, "bkv": sweep}


def engine_counts() -> Dict[str, int]:
    return {ATTN[0]: attn_kernel.flash.launches,
            ATTN[1]: attn_kernel.decode.launches}


def profiled_step(fn: Callable[[], Any], n_layers: int, device_ms: float,
                  tries: int = 5):
    """(device ms, top kernels, decode kernels, gather ms) of one call of
    ``fn()`` under ``torch.profiler``: the summed time of its kernels, the
    six largest as (name, ms, calls), how many ``decode_kernel`` launches
    it ran and the time of the kernels named in ``GATHER_KERNELS`` (the
    paged gather's ``index_select``).
    The profiler here can drop records: a profile that shows fewer than
    ``n_layers`` decode kernels, or kernels that add up to less than 90%
    of ``device_ms`` (the call's device time by CUDA events), is taken
    again, up to ``tries`` times.  More than ``n_layers`` fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profiling() as prof:
            fn()
        kernels = device_kernels(prof)
        decodes = sum(e.count for e in kernels if DECODE_KERNEL in e.key)
        if decodes > n_layers:
            fail(f"one engine step ran {decodes} {DECODE_KERNEL}s, more "
                 f"than its {n_layers} layers")
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        if decodes == n_layers and busy >= 0.9 * device_ms:
            break
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    gather = sum(e.self_device_time_total for e in kernels
                 if any(g in e.key for g in GATHER_KERNELS)) / 1e3
    return busy, [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                  for e in ranked], decodes, gather


def events_ms(fn: Callable[[], Any], iters: int = ITERS) -> float:
    """Milliseconds a call of ``fn()`` between CUDA events around ``iters``
    back-to-back calls, after one call: the device's time where ``fn``
    only replays a graph."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn: Callable[[], Any], calls: int) -> float:
    """Host milliseconds a call of ``fn()``, synchronised, after one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def engine_step_report(engine: ServingEngine, cfg, card: str, label: str,
                       seed: int) -> Dict[str, Any]:
    """Where one engine step's time goes, with every slot active: the 8
    requests of a probe trace admitted (8 prefills) and one step taken,
    then the same step repeated.  Its wall time (inputs copied, the replay,
    tokens to the host) against its device time (the replay alone between
    CUDA events, and the kernels by torch.profiler, which must show one
    decode kernel a layer); the eager step on the same inputs, the before
    figure; the largest logit difference between the eager step and a
    replay; for the paged layout the gather and the scatter, each timed
    apart as a CUDA graph on the engine's pool and tables."""
    ns, n = engine.num_slots, cfg.n_layers
    probe = synthetic_trace(ns, vocab_size=cfg.vocab_size,
                            min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                            max_new_tokens=MAX_NEW, seed=seed + 1)
    for req in probe:
        req.arrival_time = 0.0
        engine.submit(req)
    engine.step()
    if engine.active_count() != ns:
        fail(f"{label}: the probe left {engine.active_count()} of {ns} "
             f"slots active")
    out = {"step wall_ms": wall_ms(engine.decode_tokens, 10),
           "step replay_ms": events_ms(engine.decode_logits)}
    busy, top, decodes, gather_in_step = profiled_step(
        engine.decode_tokens, n, out["step replay_ms"])
    if decodes != n:
        fail(f"{label}: a profiled engine step ran {decodes} "
             f"{DECODE_KERNEL}s, not {n}")
    out.update({"step device_ms": busy, "step decode_kernels": decodes,
                # by CUDA events, which drop nothing
                "step idle": 1 - out["step replay_ms"] / out["step wall_ms"],
                "eager step wall_ms": wall_ms(
                    lambda: engine.decode_logits(eager=True), 3)})
    # the same inputs, eagerly and replayed: cuBLAS may choose other GEMM
    # algorithms under a capture
    eager = engine.decode_logits(eager=True)[0].float()[:, :cfg.vocab_size]
    graphed = engine.decode_logits()[0].float()[:, :cfg.vocab_size]
    out["eager vs replay max_abs_logit_diff"] = float(
        (eager - graphed).abs().max())
    out["eager vs replay same argmax"] = bool(
        eager.argmax(-1).eq(graphed.argmax(-1)).all())
    print(f"{label} engine step, 8 active slots (probe prompts "
          f"{sorted(r.prompt_len for r in probe)}), on {card}: "
          f"{out['step wall_ms']:.3f} ms wall (inputs copied, one replay, "
          f"tokens to the host), {out['step replay_ms']:.3f} ms a replay on "
          f"the device (CUDA events): the device idles "
          f"{out['step idle']:.1%} of the step; {busy:.3f} ms of kernels "
          f"(torch.profiler), {decodes} {DECODE_KERNEL}s in one profiled "
          f"step; top "
          f"kernels (name, ms, calls): {top}")
    print(f"{label}: the eager decode step on the same inputs (the step "
          f"before the capture) {out['eager step wall_ms']:.3f} ms wall; "
          f"eager step vs replay: max abs logit difference "
          f"{out['eager vs replay max_abs_logit_diff']:.4g}, same argmax "
          f"{out['eager vs replay same argmax']}")
    if engine.cache_layout == "paged":
        geo = dict(cache_len=engine.cache_len, block_size=engine.block_size)
        # the step's inputs, as the engine copies them before a replay
        tables = torch.from_numpy(engine.block_tables).long().to(
            engine.device)
        pos = torch.from_numpy(engine.pos_buf[:, 0]).to(engine.device)

        def gather():
            return gather_caches(engine.caches, tables, cfg, num_slots=ns,
                                 **geo)

        contig = gather()

        def scatter():
            scatter_decode(engine.caches, contig, pos, tables, cfg, **geo)

        out["gather ms"] = graph_ms(gather)
        out["scatter ms"] = graph_ms(scatter)
        out["gather ms in the step"] = gather_in_step
        view_gb = sum(t.nbytes for c in contig["segments"]
                      for t in c["self"].values()) / 1e9
        del contig
        print(f"{label}: the gather {out['gather ms']:.3f} ms and the "
              f"scatter {out['scatter ms']:.4f} ms on the device (each its "
              f"own CUDA graph, on the engine's pool and tables; "
              f"{view_gb:.2f} GB of contiguous view written, "
              f"{engine.pages_per_slot} pages of {engine.block_size} a "
              f"slot); the gather's kernels in the profiled step "
              f"{gather_in_step:.3f} ms ({GATHER_KERNELS})")
    return out


def profiled_run(engine: ServingEngine, trace: Callable[[], List[Any]],
                 threaded: bool, n_layers: int, label: str, tries: int = 3
                 ) -> Dict[str, int]:
    """The trace through ``engine`` once more, under ``torch.profiler``:
    the ``decode_kernel``s and ``flash_wgmma_kernel``s the card ran,
    against the engine's own counts of that run.  Each graph replay must
    run one decode kernel a layer, each prefill one flash kernel a layer,
    and every decode step must be a replay.  The profiler here can drop
    records: a run that shows fewer kernels is profiled again on a fresh
    trace, up to ``tries`` times; more fails."""
    keys = ("graph_replays", "decode_steps", "prefill_calls")
    for _ in range(tries):
        reqs = trace()
        before = {k: engine.stats[k] for k in keys}
        with profiling() as prof:
            if threaded:
                engine.run_threaded(reqs)
            else:
                engine.run(reqs)
        ran = {name: sum(e.count for e in device_kernels(prof)
                         if name in e.key)
               for name in (DECODE_KERNEL, FLASH_KERNEL)}
        d = {k: engine.stats[k] - before[k] for k in keys}
        want = {DECODE_KERNEL: n_layers * d["graph_replays"],
                FLASH_KERNEL: n_layers * d["prefill_calls"]}
        if d["graph_replays"] != d["decode_steps"]:
            fail(f"{label}: {d['decode_steps']} decode steps but "
                 f"{d['graph_replays']} graph replays")
        if any(ran[k] > want[k] for k in want):
            fail(f"{label}: the profiled run ran {ran}, more than {want}")
        if ran == want:
            return {**d, **ran}
    fail(f"{label}: the profiled run ran {ran}, not {want}, in {tries} "
         f"tries")


def granite(dev, seed: int):
    """granite-3-8b at full width and depth, random bf16 weights drawn on
    the card from ``seed``: (params, config, parameter GB)."""
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
    return params, cfg, param_gb


def serving_trace(cfg, seed: int):
    """The serving trace: 16 greedy requests, Poisson arrivals."""
    return synthetic_trace(REQUESTS, vocab_size=cfg.vocab_size,
                           min_prompt=MIN_PROMPT, max_prompt=MAX_PROMPT,
                           max_new_tokens=MAX_NEW, seed=seed)


def serve(params, cfg, param_gb: float, dev, seed: int, card: str
          ) -> Dict[str, Any]:
    """The serving path: granite-3-8b at full width and depth, one trace
    of 16 greedy requests through three engines (contiguous and paged with
    ``run``, paged with ``run_threaded``), each with the attention counts
    read around its construction (the decode step's capture) and its run;
    the engines' tokens must be equal, and two requests replayed through
    unbatched generate; then one prefill's logits against the plain
    attention's and where a prefill's time goes.  Every attention call
    misses the tuning cache here: the declared defaults."""

    def trace():
        return serving_trace(cfg, seed)

    first = trace()
    print(f"serving trace: {REQUESTS} requests arriving over "
          f"{first[-1].arrival_time * 1e3:.1f} ms (Poisson, 50 a second), "
          f"prompts {sorted(r.prompt_len for r in first)}, {MAX_NEW} new "
          f"tokens each, {SERVE}")
    out: Dict[str, Any] = {"param_gb": param_gb, "engines": {},
                           "launches": {name: 0 for name in ATTN},
                           "device_launches": {name: 0 for name in ATTN},
                           "replays": 0}
    tokens: Dict[str, Dict[int, List[int]]] = {}
    for label, options, threaded in SERVE_ENGINES:
        layout = options["cache_layout"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reqs = trace()
        attn_kernel.flash.launches = attn_kernel.decode.launches = 0
        t0 = time.perf_counter()
        engine = ServingEngine(params, cfg, **SERVE, **options)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if engine.attn_backends != {"prefill": "cuda", "decode": "cuda"}:
            fail(f"{label}: the engine's attention on CUDA weights resolved "
                 f"to {engine.attn_backends}, not the hand-written kernels")
        t0 = time.perf_counter()
        finished = engine.run_threaded(reqs) if threaded else engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = engine_counts()
        st = engine.stats
        # prefill runs eagerly, one flash call a layer a prefill; the
        # decode step is captured once, so its wrapper runs twice a layer
        # (the warm-up and the capture) and every step is a replay, which
        # the wrapper's counter does not see: profiled_run counts those
        expect = {ATTN[0]: cfg.n_layers * st["prefill_calls"],
                  ATTN[1]: 2 * cfg.n_layers}
        print(f"main path [serving, {label}] launches: {counts}; prefill "
              f"calls {st['prefill_calls']}, decode steps "
              f"{st['decode_steps']} (graph replays), decode_traces "
              f"{st['decode_traces']}, prefill_traces {st['prefill_traces']}"
              f"; the engine built and captured in {build_s:.1f} s")
        if counts != expect:
            fail(f"{label}: serving launched {counts}, not {expect}")
        if st["graph_replays"] != st["decode_steps"]:
            fail(f"{label}: {st['decode_steps']} decode steps but "
                 f"{st['graph_replays']} graph replays")
        if st["decode_traces"] != 1 or st["prefill_traces"] != 0:
            fail(f"{label}: decode_traces {st['decode_traces']}, "
                 f"prefill_traces {st['prefill_traces']}: the decode step "
                 f"must be captured exactly once, prefill never")
        done = sorted(finished, key=lambda r: r.uid)
        if len(done) != REQUESTS or any(
                len(r.generated) != MAX_NEW
                or not all(0 <= x < cfg.vocab_size for x in r.generated)
                for r in done):
            fail(f"{label}: a request did not finish with {MAX_NEW} tokens "
                 f"in the vocabulary")
        tokens[label] = {r.uid: list(r.generated) for r in done}
        summ = latency_summary(done)
        n_tok = st["tokens_generated"]
        o = {"tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
             "prefill_calls": st["prefill_calls"],
             "decode_steps": st["decode_steps"],
             "graph_replays": st["graph_replays"], "launches": counts,
             "build_s": build_s,
             "max_memory_allocated_gb":
                 torch.cuda.max_memory_allocated() / 1e9}
        o.update({k: summ[k] for k in ("p50_ttft_s", "p95_ttft_s",
                                       "p50_itl_s", "p50_latency_s")})
        for name in ATTN:
            out["launches"][name] += counts[name]
        kv_gb = sum(t.nbytes for c in engine.caches["segments"]
                    for t in c["self"].values()) / 1e9
        o["kv_gb"] = kv_gb
        print(f"serving [{label}] on {card}: {n_tok} tokens in {wall:.3f} s "
              f"= {o['tok_per_s']:.2f} tok/s; TTFT p50 "
              f"{summ['p50_ttft_s'] * 1e3:.1f} ms, p95 "
              f"{summ['p95_ttft_s'] * 1e3:.1f} ms; inter-token p50 "
              f"{summ['p50_itl_s'] * 1e3:.2f} ms; peak device memory "
              f"{o['max_memory_allocated_gb']:.2f} GB (parameters "
              f"{param_gb:.2f} GB, KV {layout} {kv_gb:.2f} GB)")
        if layout == "paged":
            full = SERVE["num_slots"] * SERVE["cache_len"] // BLOCK
            o.update(pool_pages=engine.balloc.capacity(),
                     pages_peak=st["pages_peak"],
                     page_waits=st["page_waits"])
            print(f"serving [{label}]: a pool of {o['pool_pages']} pages of "
                  f"{BLOCK} ({kv_gb:.2f} GB) against the contiguous "
                  f"layout's {full}; {st['pages_peak']} pages held at the "
                  f"most; {st['page_waits']} requests waited for pages "
                  f"with a slot free")
        prof = profiled_run(engine, trace, threaded, cfg.n_layers, label)
        o["profiled run"] = prof
        for name, kernel in zip(ATTN, (FLASH_KERNEL, DECODE_KERNEL)):
            out["device_launches"][name] += prof[kernel]
        out["replays"] += prof["graph_replays"]
        print(f"serving [{label}], the trace again under torch.profiler: "
              f"{prof[FLASH_KERNEL]} {FLASH_KERNEL}s in "
              f"{prof['prefill_calls']} prefills, {prof[DECODE_KERNEL]} "
              f"{DECODE_KERNEL}s in {prof['graph_replays']} graph replays "
              f"({prof['decode_steps']} decode steps): {cfg.n_layers} a "
              f"prefill and a replay")
        o.update(engine_step_report(engine, cfg, card, label, seed))
        out["engines"][label] = o
        del engine, finished, done, reqs
    ref = tokens[SERVE_ENGINES[0][0]]
    for label, toks in tokens.items():
        same = sum(toks[uid] == ref[uid] for uid in ref)
        print(f"tokens [{label}] equal the contiguous engine's for {same}/"
              f"{len(ref)} requests")
        if same != len(ref):
            fail(f"{label}: the engines chose different tokens")
    out["tokens"] = ref

    # replay: unbatched generate (batch 1) against the engines (batch 8)
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    match = 0
    for r in first[:REPLAY]:
        prompt = torch.from_numpy(r.prompt[None].astype(np.int64)).to(dev)
        toks = generate(params, cfg, prompt, max_new_tokens=MAX_NEW,
                        cache_len=SERVE["cache_len"])
        match += int((toks[0].cpu().numpy() == np.asarray(ref[r.uid])).sum())
    replay = engine_counts()
    print(f"replay: {match}/{REPLAY * MAX_NEW} tokens of {REPLAY} requests "
          f"through unbatched generate equal the engines'; launches "
          f"{replay}")
    if replay != {ATTN[0]: cfg.n_layers * REPLAY,
                  ATTN[1]: cfg.n_layers * REPLAY * (MAX_NEW - 1)}:
        fail(f"the replay launched {replay}")
    if match != REPLAY * MAX_NEW:
        fail("unbatched generate and the engines chose different tokens")
    out["replay_match"] = match

    # one prefill, kernels against the plain attention: the longest prompt
    req = max(first, key=lambda r: r.prompt_len)
    bucket = max(SERVE["prefill_buckets"])
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

    # where a prefill's time goes (the longest prompt)
    def one_prefill():
        prefill(params, cfg, toks, cache_len=SERVE["cache_len"],
                lengths=lengths)

    wall = wall_ms(one_prefill, 3)
    busy, top, flash_ms = device_profile(one_prefill, match=FLASH_KERNEL)
    out["prefill wall_ms"], out["prefill device_ms"] = wall, busy
    out["prefill flash_ms"] = flash_ms
    print(f"prefill: {wall:.3f} ms wall, {busy:.3f} ms of kernels "
          f"(torch.profiler): the device idles {1 - busy / wall:.1%} of it; "
          f"top kernels (name, ms, calls): {top}; the bf16 flash kernel "
          f"({FLASH_KERNEL}) {flash_ms:.3f} ms = {flash_ms / busy:.1%} of "
          f"the kernel time")
    return out


# ---- slice 10: tuning, the tuned Eq. 4 and telemetry ----------------------
@dataclasses.dataclass
class TuneJob:
    """One registered kernel at one main-path shape, to tune."""

    label: str
    record: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]


def declared_default(name: str, args) -> Dict[str, Any]:
    """The point a call without tunables runs: the hand-written backend's
    keyword defaults (flash's tiles follow the dtype)."""
    k = get_kernel(name)
    sig = inspect.signature(k.backend(k.native).fn).parameters
    point = {p: sig[p].default for p in k.tunable_space(k.native).params}
    if name == ATTN[0]:
        point["bq"], point["bk"] = attn_kernel.FLASH_DEFAULT[args[0].dtype]
    return point


def fmt_point(point: Dict[str, Any]) -> str:
    return " ".join(f"{k} {v}" for k, v in point.items())


def tune_jobs(dev, seed: int, stream_args, stencil_args, deck,
              hf_inputs) -> List[TuneJob]:
    """Every registered kernel at the shapes its main path gives it
    (PERF.md section 4): the science kernels at the paper's sizes, flash at
    both prefill buckets of the serving engine and decode at its step (the
    very (args, kwargs) ``models/attention.py::attend`` hands them, so the
    engine's lookups hit these entries), the WKV at rwkv6-3b's prefill."""
    jobs = [TuneJob(f"babelstream.{op}", f"babelstream.{op}", xs, {})
            for op, xs in stream_args.items()]
    jobs.append(TuneJob("stencil7", "stencil7", stencil_args, {}))
    jobs.append(TuneJob("minibude.fasten", "minibude.fasten", deck, {}))
    for (n, ngauss), (pos, dens) in hf_inputs.items():
        jobs.append(TuneJob(f"hartree_fock.twoel N={n} ngauss={ngauss}",
                            "hartree_fock.twoel", (pos, dens),
                            {"ngauss": ngauss}))
    cfg = get_config(ARCH)
    for bucket in sorted(SERVE["prefill_buckets"], reverse=True):
        drawn = attn_cases.serving_cases(
            seed, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, num_slots=SERVE["num_slots"],
            cache_len=SERVE["cache_len"], bucket=bucket,
            min_prompt=min(MIN_PROMPT, bucket), max_prompt=bucket,
            max_new=MAX_NEW, device=dev)
        q, k, v, qp, kp = drawn[ATTN[0]]["args"]
        args, kwargs = attention.kernel_args(
            "prefill", q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), qp, kp, causal=True)
        jobs.append(TuneJob(f"{ATTN[0]} bucket {bucket}", ATTN[0], args,
                            kwargs))
        if bucket == max(SERVE["prefill_buckets"]):
            args, kwargs = attention.kernel_args(
                "decode", *drawn[ATTN[1]]["args"], causal=True)
            jobs.append(TuneJob(f"{ATTN[1]} step", ATTN[1], args, kwargs))
    rcfg = get_config(RWKV_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    wkv_args, _ = wkv_cases.draw(gen, RWKV_BATCH, rcfg.d_model // 64,
                                 RWKV_PROMPT, 64, dev)
    jobs.append(TuneJob(f"{RWKV} S {RWKV_PROMPT}", RWKV, wkv_args, {}))
    return jobs


def tune_phase(jobs: List[TuneJob], cache: "tuning.TuningCache",
               card: str) -> Dict[str, Dict[str, Any]]:
    """``tune(search="auto")`` for each job into ``cache`` (a file in a
    temporary directory), every swept point printed with its time and its
    timer; then the best point and the declared default, each timed by
    ``time_call`` and as a CUDA graph.  Fails if a kernel is skipped."""
    out: Dict[str, Dict[str, Any]] = {}
    for job in jobs:
        k = get_kernel(job.record)
        t0 = time.perf_counter()
        r = tuning.tune(k, *job.args, backend=k.native, cache=cache,
                        search="auto", iters=ITERS, **job.kwargs)
        if r.skipped is not None or r.cached:
            fail(f"tuning {job.label}: skipped ({r.skipped}) or served "
                 f"from a cache that should be empty")
        tune_s = time.perf_counter() - t0
        fn = k.backend(k.native).fn
        default = declared_default(job.record, job.args)
        times = {}
        for which, point in (("best", r.params), ("default", default)):
            times[which] = (
                time_call(fn, *job.args, iters=ITERS, **job.kwargs,
                          **point) * 1e3,
                graph_ms(lambda p=point: fn(*job.args, **job.kwargs, **p)))
        print(f"tune {job.label}[{k.native}] on {card}: {r.search}, "
              f"{len(r.swept)} points ranked by {r.timer} "
              f"{'(CUDA graph)' if r.timer == 'graph' else '(time_call)'} "
              f"in {tune_s:.1f} s, ms: "
              + ", ".join(f"{fmt_point(p)} {sec * 1e3:.4f}"
                          for p, sec in r.swept))
        print(f"tune {job.label}: best {fmt_point(r.params)} "
              f"{times['best'][0]:.4f} ms [{times['best'][1]:.4f} as a "
              f"graph]; declared default {fmt_point(default)} "
              f"{times['default'][0]:.4f} ms [{times['default'][1]:.4f}]"
              f"{'; the default is the best' if r.params == default else ''}")
        out[job.label] = {
            "record": job.record, "params": r.params, "search": r.search,
            "timer": r.timer, "swept": [[p, sec * 1e3] for p, sec in r.swept],
            "ms": times["best"][0], "graph_ms": times["best"][1],
            "default": default, "default_ms": times["default"][0],
            "default_graph_ms": times["default"][1], "tune_s": tune_s}
    return out


def eq4_tuned(tuned: Dict[str, Dict[str, Any]], cases: List[Case],
              measured, terms, slabs, kind: str, card: str
              ) -> Dict[str, Any]:
    """Eq. 4 at the tuned points beside the untuned one of this run: e_i =
    the plain version's time (phase 4) / the kernel's at its tuned point,
    both by ``time_call``; the device times as graphs beside them, the
    ATen calls of rows 1-5 as graphs too; the slab at the tuned team."""
    tuned_terms = []
    for t in terms:
        job = next(j for j in tuned.values() if j["record"] == t.case)
        plain_ms = 1.0 / t.baseline_perf
        tuned_terms.append(Efficiency(kind, t.case, 1.0 / job["ms"],
                                      1.0 / plain_ms))
        lib = LIBRARY[t.case]
        first = next(c for c in cases if c.record == t.case)
        lib_graph = (graph_ms(lambda: lib(*first.args))
                     if lib is not None else None)
        job["library_graph_ms"] = lib_graph
        print(f"Eq.4 tuned {t.case} at {fmt_point(job['params'])}: "
              f"{job['ms']:.4f} ms [{job['graph_ms']:.4f} as a graph], "
              f"default {job['default_ms']:.4f} ms "
              f"[{job['default_graph_ms']:.4f}]"
              + (f", library {LIBRARY_NAME[t.case]} [{lib_graph:.4f} as a "
                 f"graph]" if lib_graph is not None else "")
              + f"; e_i {plain_ms / job['ms']:.3f} tuned, {t.e:.3f} untuned "
              f"(on {card})")
    phi_t, phi_u = phi_bar(tuned_terms), phi_bar(terms)
    print(f"Eq.4 Phi-bar over {len(terms)} kernels: {phi_t:.3f} at the "
          f"tuned points, {phi_u:.3f} at the declared defaults, this run "
          f"(time_call, torch baseline)")
    hf = next(j for j in tuned.values()
              if j["record"] == "hartree_fock.twoel")
    c = slabs[0]
    slab_ms = time_call(c.kernel, *c.args, iters=ITERS,
                        team=hf["params"]["team"]) * 1e3
    slab_graph = graph_ms(lambda: c.kernel(*c.args,
                                           team=hf["params"]["team"]))
    plain = measured[c.label]["plain_ms"]
    print(f"e_i {SLAB} at the tuned team {hf['params']['team']}: "
          f"{plain / slab_ms:.3f} ({slab_ms:.4f} ms [{slab_graph:.4f} as a "
          f"graph]); untuned {plain / measured[c.label]['ms']:.3f}")
    return {"phi_tuned": phi_t, "phi_untuned": phi_u,
            "slab": {"params": {"team": hf["params"]["team"]},
                     "ms": slab_ms, "graph_ms": slab_graph}}


def tuned_records(tuned: Dict[str, Dict[str, Any]], record: str
                  ) -> List[Dict[str, Any]]:
    """The ``kernels`` line's tuned entries of one record: each tuned case
    with its point, provenance, timer and times (the swept points are
    printed apart)."""
    return [dict(case=label, **{k: v for k, v in job.items()
                                if k not in ("record", "swept")})
            for label, job in tuned.items() if job["record"] == record]


def serve_tuned(params, cfg, dev, seed: int, card: str, untuned,
                tuned: Dict[str, Dict[str, Any]], tuned_path: Path,
                untuned_path: Path, tmp: Path) -> Dict[str, Any]:
    """The contiguous engine again, on the filled tuning cache: its
    dispatch log must show the tuned provenance for prefill and decode
    (the decode step looks its bkv up while it is captured); its tokens
    against the untuned run's (bitwise where every point the trace runs
    is the default; else the token match), and a prefill's logits at
    each bucket, tuned against untuned, within LOGITS_TOL of the range
    (the trace's prompts, 521-1986 tokens, all take the 2048 bucket: the
    512 bucket's is the longest prompt's first 500 tokens); a prefill's
    host enqueue with and without
    the lookup; then one engine with telemetry on: a Chrome trace and a
    JSONL, the summarize table, one graph capture, the tokens and tok/s
    against the run with telemetry off."""
    out: Dict[str, Any] = {}
    os.environ[tuning.CACHE_ENV] = str(tuned_path)

    def run_engine(label):
        gc.collect()
        torch.cuda.empty_cache()
        reqs = serving_trace(cfg, seed)
        engine = ServingEngine(params, cfg, **SERVE,
                               cache_layout="contiguous")
        t0 = time.perf_counter()
        done = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = engine.stats["tokens_generated"]
        toks = {r.uid: list(r.generated) for r in done}
        if len(toks) != REQUESTS or engine.stats["decode_traces"] != 1:
            fail(f"{label}: {len(toks)} requests finished, decode_traces "
                 f"{engine.stats['decode_traces']}")
        print(f"serving [{label}] on {card}: {n} tokens in {wall:.3f} s = "
              f"{n / wall:.2f} tok/s")
        return toks, n / wall

    attention.reset_dispatch_log()
    toks, out["tok_per_s"] = run_engine("contiguous, tuned")
    log = attention.dispatch_log()
    print(f"dispatch_log() of the tuned engine: {log}")
    for kind in ("prefill", "decode"):
        if log.get(kind, {}).get("tuning") in (None, "miss-default", "n/a"):
            fail(f"the tuned engine's {kind} ran {log.get(kind)}: not a "
                 f"tuned point")
    out["dispatch"] = log
    same = sum(toks[uid] == untuned[uid] for uid in untuned)
    trace = serving_trace(cfg, seed)
    # the jobs the trace runs: "attention.decode step" and the flash
    # buckets its prompts take
    used = {"step"} | {
        f"bucket {min(b for b in SERVE['prefill_buckets'] if b >= n)}"
        for n in (r.prompt_len for r in trace)}
    defaults = all(job["params"] == job["default"]
                   for label, job in tuned.items()
                   if job["record"] in ATTN and label.split(" ", 1)[1] in used)
    print(f"tokens [tuned] equal the untuned run's for {same}/{len(untuned)}"
          f" requests; every point the trace runs ({sorted(used)}) is the "
          f"default: {defaults}")
    if defaults and same != len(untuned):
        fail("the tuned engine ran the default points but chose other "
             "tokens")
    out["token_match"] = same

    # a prefill at each bucket, tuned against untuned
    req = max(trace, key=lambda r: r.prompt_len)
    out["logits_err"] = {}
    for bucket in SERVE["prefill_buckets"]:
        n = min(req.prompt_len, bucket - 12)
        tokens = torch.zeros(1, bucket, dtype=torch.int64, device=dev)
        tokens[0, bucket - n:] = torch.from_numpy(
            req.prompt[:n].astype(np.int64))
        lengths = torch.tensor([n], device=dev)

        def one_prefill():
            return prefill(params, cfg, tokens,
                           cache_len=SERVE["cache_len"],
                           lengths=lengths)[0].float()[:, :cfg.vocab_size]

        got = one_prefill()
        os.environ[tuning.CACHE_ENV] = str(untuned_path)
        want = one_prefill()
        os.environ[tuning.CACHE_ENV] = str(tuned_path)
        err = float((got - want).abs().max())
        span = float(want.max() - want.min())
        print(f"prefill logits (prompt {n}, bucket {bucket}), tuned vs "
              f"untuned: max abs err {err:.4g} against a range of "
              f"{span:.4g} (gate {LOGITS_TOL} of it); same argmax "
              f"{bool(got.argmax(-1).eq(want.argmax(-1)).all())}")
        if not err <= LOGITS_TOL * span:
            fail("the tuned prefill's logits disagree with the untuned "
                 "one's")
        out["logits_err"][bucket] = err

    def enqueue_ms():
        # the 2048 bucket's prompt, the loop's last
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cfg, tokens, cache_len=SERVE["cache_len"],
                lengths=lengths)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host * 1e3

    # with and without the lookups (the default tiles, which the 2048
    # bucket's tuned point is here), in turns
    real = attention._tuned_params
    with_lookup, without = [], []
    try:
        for _ in range(5):
            with_lookup.append(enqueue_ms())
            attention._tuned_params = lambda *a, **k: ({}, "miss-default")
            without.append(enqueue_ms())
            attention._tuned_params = real
    finally:
        attention._tuned_params = real
    with_lookup = float(np.median(with_lookup))
    without = float(np.median(without))
    kernel = get_kernel(ATTN[0])
    q = torch.empty(1, cfg.n_heads, bucket, cfg.head_dim,
                    dtype=torch.bfloat16, device=dev)
    kv = torch.empty(1, cfg.n_kv_heads, SERVE["cache_len"], cfg.head_dim,
                     dtype=torch.bfloat16, device=dev)
    pos = torch.empty(1, bucket, dtype=torch.int32, device=dev)
    kpos = torch.empty(1, SERVE["cache_len"], dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(1000):
        attention._tuned_params(kernel, q, kv, kv, pos, kpos, backend="cuda",
                                causal=True, window=0, k_index_aligned=True)
    lookup_us = (time.perf_counter() - t0) / 1000 * 1e6
    print(f"a 2048-bucket prefill's host enqueue, median of 5 in turns: "
          f"{with_lookup:.3f} ms with the tuned lookups, {without:.3f} ms "
          f"without (the host waits once the launch queue fills, so this "
          f"is near the device's time); one memoised lookup "
          f"{lookup_us:.2f} us on the host, {cfg.n_layers} a prefill: "
          f"{lookup_us * cfg.n_layers / 1e3:.3f} ms")
    out.update(enqueue_with_lookup_ms=with_lookup,
               enqueue_without_lookup_ms=without, lookup_us=lookup_us)

    # one trace with telemetry on
    rec = tel.configure("on")
    try:
        toks_on, out["tok_per_s_telemetry"] = run_engine(
            "contiguous, tuned, telemetry on")
        counters = rec.snapshot()["counters"]
        jsonl, chrome = tmp / "trace.jsonl", tmp / "trace.json"
        tel.write_jsonl(str(jsonl), rec)
        n_chrome = tel.write_chrome_trace(str(chrome), rec)
    finally:
        tel.configure("off")
    summary = tel.summarize_file(str(jsonl))
    print(f"telemetry trace: {summary['events']} events in the JSONL, "
          f"{n_chrome} in the Chrome trace ({tmp}):")
    print(tel.format_summary(summary))
    if counters.get(cudamon.GRAPH_CAPTURE) != 1:
        fail(f"the engine with telemetry on counted "
             f"{counters.get(cudamon.GRAPH_CAPTURE)} graph captures, not 1")
    if toks_on != toks:
        fail("telemetry on changed the engine's tokens")
    print(f"telemetry: {cudamon.GRAPH_CAPTURE} = 1, tokens equal with "
          f"telemetry on and off; {out['tok_per_s_telemetry']:.2f} tok/s "
          f"on against {out['tok_per_s']:.2f} off")
    out["counters"] = counters
    return out


# ---- slice 4: the RWKV6 WKV and RWKV serving -------------------------------
def wkv_sweep(dev) -> float:
    """The WKV kernel over every chunk at head dims 32 and 64,
    S = 1, 63, 200 and 2047, from a random state: y and the final state
    against the exact recurrence at ORACLE_TOL.  Returns the worst max abs
    error."""
    gen = torch.Generator(device=dev).manual_seed(13)
    worst, calls = 0.0, 0
    for dh in wkv_cases.SWEEP_DH:
        for s in wkv_cases.SWEEP_S:
            args, s0 = wkv_cases.draw(gen, 2, 4, s, dh, dev)
            want = wkv_ref.wkv_serial(*args, s0)
            for pt in wkv_cases.points():
                got = wkv_kernel.wkv(*args, s0.clone(), **pt)
                worst = max(worst, wkv_cases.hold(
                    got, want, *WKV_TOL, f"{RWKV} sweep dh={dh} S={s} {pt}"))
                calls += 1
    print(f"tunable sweep {RWKV}[cuda]: {calls} calls over chunk "
          f"{wkv_kernel.CHUNK_GRID}, Dh "
          f"{wkv_cases.SWEEP_DH}, S {wkv_cases.SWEEP_S} from a random state "
          f"(float32 at ORACLE_TOL {WKV_TOL}), worst max abs err {worst:.3g}")
    return worst


def wkv_checks(dev, seed: int, bw: float, peak: float,
               card: str) -> Dict[str, Any]:
    """The WKV at the serving shape (B 8, H 40, S 2048, Dh 64 from zeros:
    the prefill of the RWKV load) and at its decode step (S 1 from a state),
    each against the exact recurrence at ORACLE_TOL, timed with time_call
    and as a CUDA graph beside the plain versions and the bound.  The plain
    time is the serial oracle's, a loop of S steps whose time is mostly the
    host's launches; the plain chunked form, one chunk at a time, is timed
    beside it.  The bound counts the fewest flops (``ops.least_flops``),
    not the reference's model, which charges the chunk's whole C x C
    square; no single PyTorch call computes the WKV."""
    k = get_kernel(RWKV)
    cfg = get_config(RWKV_ARCH)
    h, dh = cfg.d_model // 64, 64
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    out: Dict[str, Any] = {}
    for label, s, from_state in (("serving shape", RWKV_PROMPT, False),
                                 ("decode step", 1, True)):
        args, s0 = wkv_cases.draw(gen, RWKV_BATCH, h, s, dh, dev)
        start = s0 if from_state else None
        state = None if start is None else start.clone()
        if k.default_backend(*args) != k.native:
            fail(f"{RWKV}: the default backend on CUDA tensors is not the "
                 f"hand-written {k.native!r}")
        got = wkv_kernel.wkv(*args, state)
        want = wkv_ref.wkv_serial(*args, start)
        err = wkv_cases.hold(got, want, *WKV_TOL, f"{RWKV} at the {label}")
        # the state goes in and out as it does in serving (in place)
        ms = time_call(wkv_kernel.wkv, *args, state, iters=ITERS) * 1e3
        dev_ms = graph_ms(lambda: wkv_kernel.wkv(*args, state))
        plain_ms = time_call(wkv_ref.wkv_serial, *args, start,
                             iters=ITERS) * 1e3
        chunked_ms = time_call(wkv_ref.wkv_chunked, *args, start,
                               iters=ITERS) * 1e3
        host_ms = enqueue_ms(k, args, {}, ITERS)
        moved = sum(x.nbytes for x in args) + got[0].nbytes \
            + got[1].nbytes * (2 if from_state else 1)
        ops = k.flops_model(*args)
        least = wkv_ops.least_flops(*args[0].shape, args[2].shape[-1])
        t_bytes, t_ops = moved / bw * 1e3, least / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"{RWKV} at the {label}: B {RWKV_BATCH}, H {h}, S {s}, Dh "
              f"{dh}, float32, from {'a state' if from_state else 'zeros'}; "
              f"vs the exact recurrence at {WKV_TOL}: max abs err {err:.3g} "
              f"(|y| up to {float(want[0].abs().max()):.4g}); {ms:.4f} ms "
              f"({ops / ms / 1e6:.0f} GFLOP/s by the reference's model, "
              f"{ops:.4g} flops), {bound_ms / ms:.2%} of the "
              f"{bound_ms:.4f} ms bound ({moved / 1e6:.2f} MB: "
              f"{t_bytes:.4f} ms; fewest flops {least:.4g}: {t_ops:.4f} "
              f"ms), device time (CUDA graph) {dev_ms:.4f} ms = "
              f"{bound_ms / dev_ms:.2%} of the bound; plain (serial) "
              f"{plain_ms:.4f} ms, plain chunked {chunked_ms:.4f} ms; "
              f"library: none exists; host enqueue {host_ms:.4f} ms a call")
        # which kernels ran, and their device time
        want_kernels = WKV_STEP if s == 1 else WKV_CHUNKS
        ran = kernels_run(lambda: wkv_kernel.wkv(*args, state),
                          WKV_STEP + WKV_CHUNKS, want_kernels)
        if sorted(ran) != sorted(want_kernels) or any(
                calls != 1 for _, calls in ran.values()):
            fail(f"{RWKV} at S {s} ran {ran}, not one launch each of "
                 f"{want_kernels}")
        print(f"{RWKV} at the {label}, device ms by kernel (torch.profiler) "
              f"on {card}: " + ", ".join(
                  f"{n} {ran[n][0]:.4f}" for n in want_kernels))
        before_ms, before_graph = EARLIER[label]
        print(f"{RWKV} at the {label}: now {ms:.4f} ms [{dev_ms:.4f} as a "
              f"graph], the earlier one-block-per-(b, h) kernel "
              f"{before_ms:.4f} ms [{before_graph:.4f}] (chip_smoke.py, "
              f"NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": None,
                      "graph_ms": dev_ms, "plain_chunked_ms": chunked_ms,
                      "by_kernel_ms": {n: ran[n][0] for n in ran}}
        if s > 1:
            # every chunk of the grid at the serving shape, as graphs
            chunks = {}
            for pt in wkv_cases.points():
                err = max(err, wkv_cases.hold(
                    wkv_kernel.wkv(*args, state.clone() if state is not None
                                   else None, **pt), want, *WKV_TOL,
                    f"{RWKV} at the {label} {pt}"))
                chunks[pt["chunk"]] = graph_ms(
                    lambda pt=pt: wkv_kernel.wkv(*args, state, **pt))
            print(f"{RWKV} at the {label}, device ms (CUDA graph) by chunk "
                  f"on {card}: {chunks}; default {wkv_kernel.CHUNK}")
            out[label]["chunks_graph_ms"] = chunks
            out[label]["max_abs_err"] = err
    return out


def handoff(params, cfg, prompt, cache_len, wkv_backend=None):
    """The last-position logits of a prefill of all but the last token and
    one decode step of the last, and the caches: the state's handoff from
    a ragged prefill to the decode step."""
    b, s = prompt.shape
    _, caches = prefill(params, cfg, prompt[:, :-1], cache_len=cache_len,
                        wkv_backend=wkv_backend)
    pos = torch.full((b, 1), s - 1, dtype=torch.int32, device=prompt.device)
    return decode_step(params, cfg, prompt[:, -1:], pos, caches,
                       wkv_backend=wkv_backend)


def serve_rwkv(dev, seed: int) -> Dict[str, Any]:
    """rwkv6-3b at full width and depth: ``generate`` for 8 prompts of 2048
    tokens as one batch, 32 greedy new tokens, with the WKV launch count
    read around the run; the logits gates in float32 and in bfloat16; a
    replay of two rows alone;
    where the time of a prefill and a decode step goes."""
    gc.collect()
    torch.cuda.empty_cache()       # granite's weights and caches are gone
    print(f"device memory before {RWKV_ARCH}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    cfg = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    param_gb = n_params * torch.finfo(cfg.cdtype()).bits / 8 / 1e9
    print(f"serving {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.d_model // 64} heads of 64, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}: {n_params / 1e9:.3f}e9 parameters "
          f"(count_params; the reference's total_params() says "
          f"{cfg.total_params() / 1e9:.3f}e9, counting the channel mix as "
          f"three d x d_ff matrices), {param_gb:.2f} GB in "
          f"{cfg.compute_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT))).to(dev)
    cache_len = RWKV_PROMPT + RWKV_NEW
    generate(params, cfg, prompt[:, :64], max_new_tokens=2,
             cache_len=cache_len)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wkv_kernel.wkv.launches = 0
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompt, max_new_tokens=RWKV_NEW,
                    cache_len=cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wkv_kernel.wkv.launches
    tokens = RWKV_BATCH * RWKV_NEW
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path [rwkv serving] launches: {{{RWKV!r}: {launches}}} "
          f"(1 prefill + {RWKV_NEW - 1} decode steps x {cfg.n_layers} "
          f"layers); {tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} "
          f"tok/s (the {RWKV_BATCH} x {RWKV_PROMPT}-token prefill included); "
          f"peak "
          f"device memory {peak_gb:.2f} GB (parameters {param_gb:.2f} GB)")
    if launches != cfg.n_layers * RWKV_NEW:
        fail(f"{RWKV}: generate launched the WKV kernel {launches} times, "
             f"not {cfg.n_layers} a prefill and a decode step: "
             f"{cfg.n_layers * RWKV_NEW}")
    if tuple(toks.shape) != (RWKV_BATCH, RWKV_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"rwkv serving: tokens {tuple(toks.shape)} not all in the "
             f"vocabulary")
    out = {"tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "launches": launches, "param_gb": param_gb,
           "max_memory_allocated_gb": peak_gb}

    def spread(got, want):
        got, want = got.float(), want.float()
        if not (bool(torch.isfinite(got).all())
                and bool(torch.isfinite(want).all())):
            fail("bfloat16 rwkv logits: non-finite values")
        return float((got - want).abs().max() / (want.max() - want.min()))

    def gate(got, want, what):
        got, want = got.float(), want.float()
        if not (bool(torch.isfinite(got).all())
                and bool(torch.isfinite(want).all())):
            fail(f"{what}: non-finite logits")
        err = float((got - want).abs().max())
        span = float(want.max() - want.min())
        same = int(got.argmax(-1).eq(want.argmax(-1)).sum())
        print(f"{what}: max abs err {err:.4g} against a logit range of "
              f"{span:.4g} (gate {LOGITS_TOL} of it); same argmax in "
              f"{same}/{got.shape[0]} rows")
        if not err <= LOGITS_TOL * span:
            fail(f"{what}: outside the gate")
        return err, span

    # The 2% gates run on the same weights widened to float32.  In bfloat16
    # the plain WKV's own two forms (serial and chunked) disagree by ~5% of
    # the logit range after 32 random-weight layers and 2048 tokens: a
    # rounding flip of a decay grows through the recurrence.  So the bf16
    # gates below are held to that floor, measured on the same rows.
    # Float32 matmuls run in full float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    row = prompt[:1]
    got = prefill(params32, cfg32, row, cache_len=cache_len)[0]
    want = prefill(params32, cfg32, row, cache_len=cache_len,
                   wkv_backend="torch")[0]
    out["logits_err"], out["logits_span"] = gate(
        got, want, f"float32 prefill logits (1 row of {RWKV_PROMPT}), "
        f"kernel vs plain WKV")
    # the state's handoff and a ragged tail: 2047 tokens, then one step
    rows = prompt[:RWKV_GATE_ROWS]
    step = handoff(params32, cfg32, rows, cache_len)[0]
    full = prefill(params32, cfg32, rows, cache_len=cache_len)[0]
    out["handoff_err"], out["handoff_span"] = gate(
        step, full, f"float32 {RWKV_PROMPT - 1}-token prefill + 1 decode "
        f"step vs {RWKV_PROMPT}-token prefill, last-position logits of "
        f"{RWKV_GATE_ROWS} rows")
    del params32, got, want, step, full
    gc.collect()
    torch.cuda.empty_cache()
    # bfloat16, last-position logits of the gate's rows at 2048 tokens: the
    # floor is the plain WKV's serial form (2047 tokens + 1 step, ~12 s of
    # launches) against its chunked form (the 2048-token prefill); the
    # kernel's prefill against the chunked form and the kernel's own
    # 2047 + 1 handoff against its prefill must each stay within
    # BF16_FLOOR_X times that floor
    chunked = prefill(params, cfg, rows, cache_len=cache_len,
                      wkv_backend="torch")[0]
    serial = handoff(params, cfg, rows, cache_len, wkv_backend="torch")[0]
    kern = prefill(params, cfg, rows, cache_len=cache_len)[0]
    step = handoff(params, cfg, rows, cache_len)[0]
    floor = spread(serial, chunked)
    out["bf16"] = {"floor": floor, "kernel_vs_plain": spread(kern, chunked),
                   "kernel_vs_serial": spread(kern, serial),
                   "kernel_handoff": spread(step, kern)}
    print(f"bfloat16, max abs err over the logit range ({RWKV_GATE_ROWS} "
          f"rows of {RWKV_PROMPT}, last position): the floor, plain serial "
          f"vs plain chunked, {floor:.2%}; kernel vs plain chunked "
          f"{out['bf16']['kernel_vs_plain']:.2%} and vs plain serial "
          f"{out['bf16']['kernel_vs_serial']:.2%}; the kernel's "
          f"{RWKV_PROMPT - 1} + 1 vs its {RWKV_PROMPT} "
          f"{out['bf16']['kernel_handoff']:.2%} (gates: kernel vs chunked "
          f"and the handoff within {BF16_FLOOR_X:g} x the floor, "
          f"{BF16_FLOOR_X * floor:.2%})")
    for key in ("kernel_vs_plain", "kernel_handoff"):
        if not out["bf16"][key] <= BF16_FLOOR_X * floor:
            fail(f"bfloat16 rwkv logits: {key} {out['bf16'][key]:.2%} "
                 f"outside {BF16_FLOOR_X:g} x the floor {floor:.2%}")
    del chunked, serial, kern, step
    caches = prefill(params, cfg, prompt, cache_len=cache_len)[1]

    # replay: rows alone (batch 1) against the batched run, not gated
    match = 0
    for i in range(RWKV_REPLAY):
        alone = generate(params, cfg, prompt[i:i + 1],
                         max_new_tokens=RWKV_NEW, cache_len=cache_len)
        match += int(alone[0].eq(toks[i]).sum())
    print(f"replay (not gated): {match}/{RWKV_REPLAY * RWKV_NEW} tokens of "
          f"{RWKV_REPLAY} rows generated alone equal the batched run's")
    out["replay_match"] = match

    # where the time goes: the batched prefill and one decode step
    tok = toks[:, -1:].to(torch.int64)
    pos = torch.full((RWKV_BATCH, 1), RWKV_PROMPT + RWKV_NEW - 1,
                     dtype=torch.int32, device=dev)

    def one_prefill():
        prefill(params, cfg, prompt, cache_len=cache_len)

    def one_step():
        decode_step(params, cfg, tok, pos, caches)

    for name, fn, calls in (("rwkv prefill", one_prefill, 2),
                            ("rwkv decode step", one_step, 10)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / calls * 1e3
        busy, top, _ = device_profile(fn)
        out[f"{name} wall_ms"], out[f"{name} device_ms"] = ms, busy
        print(f"{name}: {ms:.3f} ms wall, {busy:.3f} ms of kernels "
              f"(torch.profiler): the device idles {1 - busy / ms:.1%} of "
              f"it; top kernels (name, ms, calls): {top}")
    graphed = graph_ms(one_step)
    out["rwkv decode step graph_ms"] = graphed
    print(f"rwkv decode step as one CUDA graph: {graphed:.3f} ms on the "
          f"device")
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
    card = smi.stdout.strip()
    print(card)
    label, bw, peak, peak_bf16 = datasheet(kind)
    print(f"bound rates: {label} data sheet, {bw / 1e12} TB/s HBM, "
          f"{peak / 1e12} TFLOP/s float32, {peak_bf16 / 1e12} TFLOP/s "
          f"bfloat16")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    # the tuning caches live in a temporary directory, never in the repo or
    # in ~: every attention call misses (the declared defaults) until the
    # tuned engine reads the filled cache
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, tmp, True)
    untuned_path, tuned_path = tmp / "untuned.json", tmp / "tuning.json"
    os.environ[tuning.CACHE_ENV] = str(untuned_path)
    tel.configure("off")
    new_s: Dict[str, float] = {}

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"built {name}: {'; '.join(ptxas)}")
    case_errs = {}
    for name in KERNELS + ATTN + (RWKV,):
        k = get_kernel(name)
        err = case_errs[name] = conformance.check_backend(name, k.native,
                                                          device=dev)
        print(f"conformance case {name}[{k.native}] max abs err {err:.3g}")
    (pos8, dens8), _ = conformance.case_tensors("hartree_fock.twoel", dev)
    basis3 = hf_ref.sto_basis(3, device=dev)
    err = max_abs_err(
        hf_kernel.twoel_slab(hf_kernel.pad4(pos8), dens8, basis3, 2, 4),
        hf_ref.fock_build_slab(pos8, dens8, basis3, 2, 4), *HF_TOL,
        "conformance case hartree_fock.twoel_slab")
    print(f"conformance case {SLAB}[cuda] l in [2, 6) max abs err {err:.3g}")
    attention_sweep(dev)
    wkv_sweep_err = wkv_sweep(dev)
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
                          (BUDE["nposes"],),
                          bude_ops.least_flops(*BUDE_ATOMS, BUDE["nposes"]))]
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
    slab_least = hf_ops.least_flops(n, ngauss, nl)
    slabs = [Case(f"{SLAB} l in [{l0}, {l0 + nl})", SLAB,
                  hf_kernel.twoel_slab,
                  lambda p4, d, bs, l0_, nl_: hf_ref.fock_build_slab(
                      p4[:, :3], d, bs, l0_, nl_),
                  (pos4, dens, basis, l0, nl), {}, (n, n), slab_least,
                  slab_least)
             for l0 in range(0, n, nl)]
    # ---- 1b. tuning: every registered kernel at its main-path shape ----
    t0 = time.perf_counter()
    body = inspect.getmodule(tuning._unwrap_callable(bs_kernel._STREAM))
    print(f"Triton compiles are counted through "
          f"{cudamon.triton_route()}; the tuning hash reaches the "
          f"@triton.jit body in {body.__name__}")
    if body is not bs_kernel:
        fail("the tuning hash does not reach the Triton kernels' module")
    tuned = tune_phase(tune_jobs(dev, args.seed, stream_args, (u, *coeffs),
                                 deck, hf_inputs),
                       tuning.TuningCache(tuned_path), card)
    new_s["tuning"] = time.perf_counter() - t0
    print(f"tuning phase: {new_s['tuning']:.1f} s")

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
    again = get_kernel(hf[0].record)(*hf[0].args, **hf[0].kwargs)
    if not torch.equal(again, full):
        fail(f"{hf[0].label}: a second build differs from the first in "
             f"{int(again.ne(full).sum())} of {full.numel()} entries")
    print(f"{hf[0].label}: a second build is bit-identical to the first")

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
            fom = (f"{gflops:.0f} GFLOP/s by Eq. 3 ({c.flops:.6g} flops); "
                   f"least flops {c.least_flops:.6g} at "
                   f"{bude_ops.INTERACTION_FLOPS} an interaction, "
                   f"{c.least_flops / ms / 1e6:.0f} GFLOP/s")
        elif c.record.startswith("hartree_fock"):
            # wall clock only: the registry's 120 N^4 G^4 counts the gather
            # form's work, which the kernel does not do, so it is no rate
            gflops = None
            if c.record == SLAB:
                shape = (c.args[0].shape[0], c.args[2].ngauss, c.args[4])
            else:
                shape = (c.args[0].shape[0], c.kwargs["ngauss"], None)
            ref_flops = hf_ops.least_flops(*shape,
                                           hf_ops.REFERENCE_TERM_FLOPS)
            fom = (f"wall clock; least flops {c.least_flops:.6g} at "
                   f"{hf_ops.TERM_FLOPS} a pair-hoisted primitive term, "
                   f"{ref_flops:.6g} at the reference's "
                   f"{hf_ops.REFERENCE_TERM_FLOPS}")
        else:
            gbs = get_kernel(c.record).figure_of_merit(
                ms / 1e3, *c.args)["gbytes_per_s"]
            fom = (f"{gbs:.0f} GB/s by Eq. "
                   f"{1 if c.record == 'stencil7' else 2}")
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{c.label}: {ms:.4f} ms ({fom}, {bound_ms / ms:.1%} of the "
              f"{bound_ms:.4f} ms bound), plain {plain_ms:.4f} ms, library "
              f"{lib_txt}, host enqueue {host_ms:.4f} ms a call")
        if c.record.startswith(("hartree_fock", "minibude")):
            if bound_ms > ms:
                fail(f"{c.label}: {bound_ms / ms:.1%} of the bound: "
                     f"least_flops no longer counts the kernel's work")
        measured[c.label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "gflops_per_s": gflops,
            "max_abs_err": errs[c.label]}

    bude_report(bude[0], card, args.seed)
    for c in hf + slabs:
        hartree_fock_report(c, card)

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
    t0 = time.perf_counter()
    eq4 = eq4_tuned(tuned, slice1 + bude + hf, measured, terms, slabs, kind,
                    card)
    new_s["tuned Eq. 4"] = time.perf_counter() - t0
    for rec in records:
        rec["tuned"] = tuned_records(tuned, rec["name"])
        if rec["name"] == SLAB:
            rec["tuned"] = [dict(case=slabs[0].label, **eq4["slab"])]

    # ---- 6. attention at the serving shapes ----------------------------
    attn: Dict[str, Dict[str, Any]] = {}
    for c in attention_cases(dev, args.seed):
        k = get_kernel(c.name)
        if k.default_backend(*c.args, **c.kwargs) != k.native:
            fail(f"{c.name}: the default backend on CUDA tensors is not "
                 f"the hand-written {k.native!r}")
        want = c.plain(*c.args, **c.kwargs)
        err = attn_cases.hold_live(k(*c.args, **c.kwargs), want, c.live,
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
        if c.name == ATTN[0]:
            # every declared tile point of the bf16 kernel, as a graph
            tiles = {}
            for pt in k.tunable_space("cuda").valid_points(*c.args):
                attn_cases.hold_live(
                    attn_kernel.flash(*c.args, **c.kwargs, **pt), want,
                    c.live, *BF16_TOL, f"{c.name} at the serving shape {pt}")
                tiles[f"bq {pt['bq']} bk {pt['bk']}"] = graph_ms(
                    lambda pt=pt: attn_kernel.flash(*c.args, **c.kwargs,
                                                    **pt))
            print(f"{c.name} tile points at the serving shape, device ms "
                  f"(CUDA graph) on {card}: {tiles}; default "
                  f"{attn_kernel.FLASH_DEFAULT[torch.bfloat16]}")
            dev_ms["tiles"] = tiles
            print(f"{c.name}: {c.least_flops / dev_ms['kernel'] / 1e9:.1f} "
                  f"TFLOP/s on the admitted pairs (CUDA graph), library "
                  f"(scaled_dot_product_attention) "
                  f"{c.least_flops / dev_ms['library'] / 1e9:.1f}, on {card}")
        if c.name == ATTN[1]:
            dev_ms.update(decode_report(c, want, card))
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
        print(f"{c.name} device time (CUDA graph replay) on {card}: kernel "
              f"{dev_ms['kernel']:.4f} ms = {bound_ms / dev_ms['kernel']:.2%}"
              f" of the bound, plain {dev_ms['plain']:.4f} ms, library "
              f"{dev_ms['library']:.4f} ms")
        if c.name == ATTN[1]:
            before_ms, before_graph = EARLIER[c.name]
            print(f"{c.name}: now {ms:.4f} ms [{dev_ms['kernel']:.4f} as a "
                  f"graph], the earlier split and combine kernels "
                  f"{before_ms:.4f} ms "
                  f"[{before_graph:.4f}] (chip_smoke.py, NVIDIA H100 80GB "
                  f"HBM3, 700.00 W; PERF.md)")
        attn[c.name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations", "library_ms": library_ms,
                        "graph_ms": dev_ms}
        print(f"e_i {c.name}: {plain_ms / ms:.3f} (torch baseline; a "
              f"serving kernel, not in the paper's Phi-bar)")

    # ---- 7. serving: the LM main path ----------------------------------
    params, cfg, param_gb = granite(dev, args.seed)
    served = serve(params, cfg, param_gb, dev, args.seed, card)
    t0 = time.perf_counter()
    served_tuned = serve_tuned(params, cfg, dev, args.seed, card,
                               served["tokens"], tuned, tuned_path,
                               untuned_path, tmp)
    new_s["tuned engine and telemetry"] = time.perf_counter() - t0
    os.environ[tuning.CACHE_ENV] = str(untuned_path)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for name in ATTN:
        rec = {"name": name, "route": get_kernel(name).native,
               "source": SOURCE[name], "replaces": REPLACES[name],
               "launches": served["launches"][name],
               "device_launches": served["device_launches"][name]}
        if name == ATTN[1]:
            rec["graph_replays"] = served["replays"]
            rec["launches_counted"] = (
                "launches: wrapper calls while each engine is built and "
                "serves the trace, 40 in the warm-up step and 40 in the "
                "capture, which records the kernels into the graph and "
                "runs none; a replay runs no wrapper. device_launches: "
                "decode_kernels by torch.profiler in a second run of the "
                "trace on each engine, 40 in each of its graph_replays")
        else:
            rec["launches_counted"] = (
                "launches: wrapper calls, 40 a prefill; device_launches: "
                "flash_wgmma_kernels by torch.profiler in a second run of "
                "the trace on each engine")
        rec.update(attn[name])
        rec["tuned"] = tuned_records(tuned, name)
        if name == ATTN[0]:
            rec["tuned_dispatch"] = served_tuned["dispatch"]
        records.append(rec)

    # ---- 8. rwkv: the WKV and RWKV serving -----------------------------
    t0 = time.perf_counter()
    wkv = wkv_checks(dev, args.seed, bw, peak, card)
    rwkv = serve_rwkv(dev, args.seed)
    print(f"rwkv phase: {time.perf_counter() - t0:.1f} s")
    rec = {"name": RWKV, "route": get_kernel(RWKV).native,
           "source": SOURCE[RWKV], "replaces": REPLACES[RWKV],
           "launches": rwkv["launches"]}
    rec.update(wkv["serving shape"])
    rec["max_abs_err"] = max([case_errs[RWKV], wkv_sweep_err]
                             + [c["max_abs_err"] for c in wkv.values()])
    rec["cases"] = [dict(case=label, **c) for label, c in wkv.items()]
    rec["tuned"] = tuned_records(tuned, RWKV)
    records.append(rec)
    print(f"torch.profiler: {len(PROFILE_LOSS)} profiles dropped their "
          f"first {min(PROFILE_LOSS)}-{max(PROFILE_LOSS)} device records "
          f"(median {int(np.median(PROFILE_LOSS))}), of the "
          f"{PROFILE_FILLER} spin kernels ahead of each profiled block")
    print(f"new phases: {sum(new_s.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()) + ")")
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
