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
chunked WKV kernel, 32 launches a call; then the remaining model families,
each through the two attention kernels: deepseek-moe-16b (MoE, 28 layers,
33 GB of random bf16 weights) at full width and depth served by the
engine as granite is, and through ``serve_step.generate`` hymba-1.5b
(hybrid attention + SSM, a sliding window with global layers),
whisper-tiny (encoder-decoder: the encoder's non-causal self-attention and
the decoder's cross-attention), starcoder2-3b (12 query heads a kv head)
and stablelm-1.6b at full width and depth, and pixtral-12b (vision-stub
patches), llama4-scout-17b-a16e (MoE with patches) and deepseek-67b at
full width, cut in depth; then training: stablelm-1.6b at full width and
depth (random float32 masters from ``--seed``) through ``train_step`` on
the plain ``torch`` routes, which launch no hand-written kernel.  After
the science kernels' Eq. 4 (phase 5), phase 11 decomposes the same four
workloads over 2-8 shards on the one card (``repro_torch.distributed``)
and runs each hand-written kernel once per shard.

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
  11. domain:   (runs here, after 5) the domain decomposition on one card,
                every shard on it (``domain.placement``): first each sharded
                backend's conformance cell on the card (``torch_shard`` and
                the composite, each against the oracle and its
                ``BITWISE_TWIN``) and its comm-contract audit; then the
                composites of the hand-written kernels at the main path's
                shapes, each call a path of its own (its wrapper's launch
                count set to 0 just before, read just after, with the
                collectives it issued): the stencil through ``shard_cuda``
                as slabs of 2, 4 and 8, pencils (2, 2), (4, 2) and (2, 4),
                and one plane per shard (8 x 512 x 512 at 8 shards), each
                bitwise equal to the single-device kernel, one launch a
                shard, 2 (slab) or 4 (pencil) ppermutes; the five stream
                ops through ``shard_triton`` at 2, 4 and 8 shards (dot
                within ORACLE_TOL, one psum, two launches a shard);
                miniBUDE at 2, 4 and 8 shards of bm1's poses, bitwise;
                Hartree-Fock N = 128 at 2, 4 and 8 shards (``twoel_slab``
                a shard, one psum), within ORACLE_TOL of the single-device
                build, a second call bit-identical.  For each: the
                single-device kernel's device time, the composite's by
                ``time_call`` and as one CUDA graph (or why the capture
                failed), for the stencil the resident step (halo exchange
                + kernels on buffers already sharded) and the distribute
                and collect apart, the bound (phase 4's), and the
                composite's e_i apart from Phi-bar; then the card count,
                and with two or more cards the slab stencil and dot with
                their shards spread over the cards;
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
                ``cuda.graph_capture`` one a prefill bucket and one for the
                decode step, and the tokens equal to the run
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
                two rows replayed alone (printed, not gated);
  9. families:  the decode kernel at 12 and 16 query heads per kv head at
                the engine's step shape, and flash non-causal at
                whisper-tiny's encoder shape (8 x 1500 frames) and its
                cross-attention (1 and 16 queries against 1500 frames),
                each against its plain version on every row and timed as
                a CUDA graph beside its bound and one
                scaled_dot_product_attention call
                (``examples/torch_attention_layouts.py``);
                deepseek-moe-16b through the engine
                (the granite trace, contiguous ``run``): launch counts
                around the build and the run (28 flash a prefill, 2 x 28
                decode), one capture, every step a replay, a second run
                whose tokens must equal the first's, a step's wall against
                its replay and its top kernels (torch.profiler: 28 decode
                kernels in the replay), the eager step against a replay on
                the same inputs (within LOGITS_TOL of the range), each
                piece of a MoE layer (routing, dispatch and combine
                einsums, expert GEMMs, shared experts) as a CUDA graph at a
                step's 8 tokens and a 2048-bucket prefill; then each of the
                seven other archs (``FAMILIES``: rows, prompt, new tokens,
                and the depth cut, printed) through ``generate`` with the
                counts set to 0 just before and read just after (one flash
                a prefill layer, one decode a step layer, whisper's
                cross-attention a flash a layer in both), a second, timed
                run that must give the same tokens (tok/s, TTFT, the
                inter-token p50), and every arch's prefill logits on the
                kernels against the plain attention's within LOGITS_TOL of
                the range, nothing NaN, and every attention call of the
                kernels' prefill held against the plain version on its own
                inputs at BF16_TOL, every row (a row that admits no key
                included: the pad rows of a left-padded prefill take MoE
                capacity, and a prompt longer than hymba's window leaves
                such rows that a global layer reads); for MoE each layer's
                expert choice is pinned to the kernels' run (a top-k choice
                flips on rounding; the unpinned difference and the flipped
                choices are printed), and the attention check is the gate,
                the logits printed beside it (deepseek-moe-16b's 27 MoE
                layers carry the rounding to 1.85-2.37% of the range on an
                H100 SXM, pinned, over five seeds); deepseek-moe-16b's
                check runs at MOE_GATE_SEEDS seeds and must reject each
                fault in PLANTED (a causal mask off by one, a dropped kv
                head) planted in the kernels' attention.
                Each model's weights, and the engine with its graph, are
                freed before the next loads;
  10. training: stablelm-1.6b at full width and depth (24 layers, 1.644e9
                random float32 master parameters from the seed, bf16
                compute; 26.3 GB of masters, gradients and moments):
                ``train_step`` with 4 microbatches and remat, AdamW at
                the reference's defaults but ``warmup_steps=2``, on
                ``SyntheticLM`` batches of 8 x 4096 tokens, so every
                attention call takes the chunked path (4 q chunks, 10
                key-chunk steps causal); a warm-up step, then 5 timed
                steps (median wall, tokens/s, peak memory, the
                model-flops share 6 N D + the causal attention's flops
                over the step time x 989 TFLOP/s), one step under
                ``torch.profiler`` (its device-busy time, idle share and
                top device operations) and the chunked attention's share
                of a step (one call's forward and backward timed with CUDA
                events, times the calls a step makes).  Seven gates, each
                failing the script: (1) no hand-written kernel launches
                during a step, every attention dispatch record ``torch``,
                24 x 4 x 2 chunked calls; (2) ``forward`` on parameters
                that require grad on the default backends, and
                ``train_step`` under ``REPRO_ATTN_BACKEND=cuda``, raise the
                guard's error; (3) the loss and grad norm finite, every
                parameter leaf moved; (4) 8 steps on one repeated batch of
                2 x 4096 lower the loss; (5) 2 microbatches against 1 on
                it (``MICROBATCH_TOL``); (6) the chunked path against the
                full-matrix ``attend_torch`` on one step (``CHUNKED_TOL``);
                (7) a checkpoint saved after a step, 2 more steps, then the
                restore, ``seek`` and the same 2 steps (``RESUME_TOL``;
                bitwise equality printed).  Gates 2 and 4-7 run at 4 of
                the 24 layers, at full width.
  12. the roofline on the card (``core/roofline.py``, the op-cost walker
                ``core/op_cost.py``, the dry run ``launch/dryrun.py``):
                (a) ``detect_chip()`` must name ``NVIDIA_H100``; (b) four
                full-size dry-run cells on this machine's PyTorch, each on
                a fake world of 256 or 512 ranks (granite-3-8b
                ``decode_32k`` and ``train_4k`` on 16x16, deepseek-moe-16b
                ``train_4k`` on 2x16x16, rwkv6-3b ``long_500k`` on 16x16),
                their artifacts in ``build/dryrun/`` and each rank's bytes
                against the card's 80 GiB; (c) three real steps on the
                card counted ``kernel_adjusted`` by the walker, each
                against its twin on ``meta``: granite-3-8b's
                ``decode_step`` at the engine's shape (8 rows, every one of
                the 4096 cache slots filled; device time a CUDA-graph
                replay), a 2048-token ``prefill`` (CUDA events) and
                stablelm-1.6b's training step of phase 10 (its median
                step).  Each prints its ``RooflineTerms`` and its share,
                the bound over the measured time.  Gates: every share at
                most 1.0 (a bound above the measured time is a wrong
                count), and the walker's flops on each real step equal to
                those on its meta twin.
  13. the static auditor (``core/analysis/``): (a) every hand-written
                registry cell's launch plans (``launch_plan`` beside each
                wrapper), at its conformance case on the card, at the
                declared default and at phase 1b's tuned point, plus
                bfloat16 prefill and decode and the one-token WKV, held to
                the launches ``torch.profiler`` records: the kernel
                symbols in order, each one's grid and block; (b)
                ``audit_registry`` on this host (``detect_chip()`` must
                name ``nvidia-h100``), joined to phase 1b's tuning cache
                and (a)'s telemetry: no finding outside the drift pass and
                no skip in a hand-written cell; the drift pass's
                measured/predicted ratios printed, not gated; (c)
                ``tune(search="model")`` for stencil7 and miniBUDE at their
                main-path shapes: at most ``MODEL_TOP_K`` points timed and
                a valid pick, printed beside phase 1b's best point.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(each record with its tuned points, their provenance and times; a science
record's ``launches`` sums its main-path and phase-11 launches,
``launches_by_path`` holds each, and ``sharded`` its composite's cases),
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
sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))

from repro_torch import _build  # noqa: E402
from repro_torch import _sass  # noqa: E402
import repro_torch.kernels  # noqa: E402,F401  (registers the kernels)
from repro_torch.core import (  # noqa: E402
    Efficiency, get_kernel, max_abs_err, phi_bar, time_call)
from repro_torch.core import conformance  # noqa: E402
from repro_torch.core import telemetry as tel  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.core.telemetry import cudamon  # noqa: E402
from repro_torch.core.op_cost import measure, meta_twin  # noqa: E402
from repro_torch.core.roofline import (  # noqa: E402
    NVIDIA_H100, detect_chip, roofline_from_cost)
from repro_torch.core.roofline import model_flops as roofline_flops  # noqa: E402,E501
from repro_torch.distributed import collectives, domain  # noqa: E402
from repro_torch.core.portable import (  # noqa: E402
    LONG_CALL_S, time_graph)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.babelstream import kernel as bs_kernel  # noqa: E402,E501
from repro_torch.kernels.babelstream.ref import START_SCALAR  # noqa: E402
from repro_torch.kernels.flash_attention import cases as attn_cases  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, SyntheticLM, to_device)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.chunked_attention import attend_chunked  # noqa: E402,E501
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward, init_caches, init_params, tree_map)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import leaves as tree_leaves  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_train_state, train_step)
from repro_torch.serving import (  # noqa: E402
    RESERVED_BLOCKS, ServingEngine, gather_caches, latency_summary,
    scatter_decode, synthetic_trace)
from repro_torch.training.serve_step import (  # noqa: E402
    decode_step, generate, prefill, sample)
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
from repro_torch.kernels.stencil7 import kernel as s7_kernel  # noqa: E402
from repro_torch.kernels.stencil7.ref import default_coefficients  # noqa: E402
import torch_attention_layouts as layouts  # noqa: E402

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
# that occurs in the device name; the SXM card's HBM and bf16 rates are
# ``core/roofline.py``'s NVIDIA_H100
DATASHEET = (
    ("H100 PCIe", "H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100", "H100 SXM", NVIDIA_H100.hbm_bw, 67e12, NVIDIA_H100.peak_flops),
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
def profiling(host: bool = True):
    """``torch.profiler`` (host and CUDA activity, or with ``host=False``
    CUDA activity alone) over the block.  The profiler can drop the first
    device records of a session, a count that grows as the process ages:
    late in this script that was once every record of ten one-token WKV
    calls, five sessions in a row.  PROFILE_FILLER launches of
    ``torch.cuda._sleep``'s spin kernel go first and take the loss, which
    ``PROFILE_LOSS`` keeps a session; ``device_kernels`` leaves them out.
    The records are averaged by name once, into ``prof.averages``: that
    costs ~70 us a record on the host, minutes for a training step's host
    records, which ``host=False`` leaves out."""
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILE_FILLER):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
    prof.averages = prof.key_averages()
    PROFILE_LOSS.append(PROFILE_FILLER - sum(
        e.count for e in prof.averages if FILLER_KERNEL in e.key))


def device_kernels(prof) -> List[Any]:
    """The profile's device records by name (``key_averages``), without
    the spin kernels that ``profiling`` put ahead of the block."""
    return [e for e in prof.averages
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

    def hold(name, fn, want, tol, what, args):
        # every declared point the inputs' dtype is built for, every row
        for pt in get_kernel(name).tunable_space("cuda").valid_points(*args):
            err = max_abs_err(fn(**pt), want, *tol,
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
                hold(ATTN[0], lambda **pt: attn_kernel.flash(
                    q, k, v, *pos, causal=causal, window=window,
                    k_index_aligned=aligned, **pt),
                    want, tol,
                    f"{mode} {dtype} dh={dh} S={s} T={t} window={window}",
                    (q, k, v))
            for b, h, kv, t, wrap, fill, window in attn_cases.DECODE_SWEEP:
                q, k, v = attn_cases.draw(rng, (b, 1, h, dh), (b, t, kv, dh),
                                          dtype, dev)
                qp, kp = (torch.tensor(x, device=dev) for x in
                          attn_cases.decode_positions(b, t, wrap, fill))
                want = attn_ref.decode_ref(q, k, v, qp, kp, window=window)
                hold(ATTN[1], lambda **pt: attn_kernel.decode(
                    q, k, v, qp, kp, window=window, **pt),
                    want, tol,
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
    least_flops: float          # 4 Dh flops per admitted (query, key) pair
    least_bytes: float          # q, o, positions, the K rows admitted and
                                # the V rows the output needs (kv_bytes)
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
        row_bytes = kv * dh * k.element_size() * 2          # K and V
        fixed = 2 * q.nbytes + qp.nbytes + kp.nbytes        # q, o, positions
        return AttnCase(name, args, kwargs, plain, library(mask),
                        attn_ops.least_flops(qp, kp, h, dh, causal=True),
                        fixed + layouts.kv_bytes(
                            k, mask, 2 if name == ATTN[0] else 1),
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
        max_abs_err(attn_kernel.decode(*c.args, **pt), want, *BF16_TOL,
                    f"{c.name} at the serving shape {pt}")
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
    out["eager vs replay logits_span"] = float(eager.max() - eager.min())
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
        # each prefill bucket and the decode step are captured once, so
        # their wrappers run twice a layer a graph (the warm-up and the
        # capture) and every prefill and step is a replay, which the
        # wrappers' counters do not see: profiled_run counts those
        n_buckets = len(SERVE["prefill_buckets"])
        expect = {ATTN[0]: 2 * cfg.n_layers * n_buckets,
                  ATTN[1]: 2 * cfg.n_layers}
        print(f"main path [serving, {label}] launches: {counts}; prefill "
              f"calls {st['prefill_calls']}, decode steps "
              f"{st['decode_steps']} (graph replays), decode_traces "
              f"{st['decode_traces']}, prefill_traces {st['prefill_traces']}"
              f"; the engine built and captured in {build_s:.1f} s")
        if counts != expect:
            fail(f"{label}: serving launched {counts}, not {expect}")
        if st["graph_replays"] != st["decode_steps"] or \
                st["prefill_replays"] != st["prefill_calls"]:
            fail(f"{label}: {st['decode_steps']} decode steps but "
                 f"{st['graph_replays']} graph replays, "
                 f"{st['prefill_calls']} prefills but "
                 f"{st['prefill_replays']} prefill replays")
        if st["decode_traces"] != 1 or st["prefill_traces"] != n_buckets:
            fail(f"{label}: decode_traces {st['decode_traces']}, "
                 f"prefill_traces {st['prefill_traces']}: the decode step "
                 f"must be captured exactly once, each prefill bucket "
                 f"once")
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
    # the torch route takes the chunked path here (S 2048, T 4096), whose
    # keyless pad rows average v over the key chunks they reach, not all T;
    # the last position's logits do not read them
    chunked0 = attend_chunked.calls
    want = prefill(params, cfg, toks, cache_len=SERVE["cache_len"],
                   lengths=lengths, attn_backend="torch")[0].float()
    chunked = attend_chunked.calls - chunked0
    valid = want[:, :cfg.vocab_size]
    err = float((got - want)[:, :cfg.vocab_size].abs().max())
    span = float(valid.max() - valid.min())
    same = bool(got.argmax(-1).eq(want.argmax(-1)).all())
    print(f"prefill logits (prompt {req.prompt_len}, bucket {bucket}), "
          f"kernels vs plain attention ({chunked} of its {cfg.n_layers} "
          f"attention calls on the chunked path): max abs err {err:.4g} "
          f"against a logit range of {span:.4g} (gate {LOGITS_TOL} of it); "
          f"same argmax: {same}")
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
    captures = 1 + len(SERVE["prefill_buckets"])
    if counters.get(cudamon.GRAPH_CAPTURE) != captures:
        fail(f"the engine with telemetry on counted "
             f"{counters.get(cudamon.GRAPH_CAPTURE)} graph captures, not "
             f"{captures}")
    if toks_on != toks:
        fail("telemetry on changed the engine's tokens")
    print(f"telemetry: {cudamon.GRAPH_CAPTURE} = {captures}, tokens equal "
          f"with "
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
    _, caches, _ = prefill(params, cfg, prompt[:, :-1],
                           cache_len=cache_len, wkv_backend=wkv_backend)
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


# ---- slice 11: the remaining model families --------------------------------
#: deepseek-moe-16b at full width and depth, served by the engine on the
#: granite trace's settings (SERVE, REQUESTS, MAX_NEW, contiguous ``run``)
MOE_ARCH = "deepseek-moe-16b"
#: seeds whose weights and prompt the MoE prefill check reads (from --seed)
MOE_GATE_SEEDS = 5
#: faults planted in the kernels' attention that the MoE check must reject
PLANTED = ("causal off by one", "kv head 0 dropped")
#: the archs that run through ``serve_step.generate``: (arch, layers kept
#: (None: full depth), rows, prompt tokens, new tokens)
FAMILIES = (
    ("hymba-1.5b", None, 4, 2048, 32),
    ("whisper-tiny", None, 8, 16, 32),
    ("starcoder2-3b", None, 4, 512, 16),
    ("stablelm-1.6b", None, 4, 512, 16),
    ("pixtral-12b", 8, 4, 512, 16),
    ("llama4-scout-17b-a16e", 4, 4, 512, 16),
    ("deepseek-67b", 4, 4, 512, 16),
)
#: decode at more query heads per kv head than granite's 4, at the engine's
#: step shape: starcoder2-3b's 24 heads over 2 kv heads, and 16
#: (``examples/torch_attention_layouts.py``'s layouts)
DECODE_GROUPS = ("starcoder2-3b", "G = 16")


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def family_model(arch: str, layers, dev, seed: int):
    """An arch at full width, cut to ``layers`` layers if given, random
    bf16 weights drawn on the card from ``seed``: (params, config, what was
    cut, parameter GB)."""
    free_card()
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(
        full, n_layers=layers,
        global_layers=tuple(i for i in full.global_layers if i < layers))
    cut = ("none: full width and depth" if layers is None else
           f"{layers} of {full.n_layers} layers (full width; the whole "
           f"model is {full.total_params() / 1e9:.2f}e9 parameters, "
           f"{2 * full.total_params() / 1e9:.1f} GB in bf16)")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    n = count_params(params)
    gb = n * torch.finfo(cfg.cdtype()).bits / 8 / 1e9
    shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
             f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, "
             f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
    if cfg.is_moe:
        shape += (f", {cfg.n_experts} experts top-{cfg.top_k} + "
                  f"{cfg.n_shared_experts} shared, dense prefix "
                  f"{cfg.dense_prefix_layers}, capacity factor "
                  f"{cfg.moe_capacity_factor}")
    if cfg.ssm_state:
        shape += (f", SSM state {cfg.ssm_state}, window {cfg.window}, "
                  f"global layers {cfg.global_layers}")
    if cfg.is_encoder_decoder:
        shape += (f", {cfg.n_encoder_layers} encoder layers over "
                  f"{cfg.encoder_frames} frames")
    if cfg.n_patches:
        shape += f", {cfg.n_patches} patches"
    print(f"model family {arch}: {shape}; cut: {cut}; {n / 1e9:.3f}e9 "
          f"parameters (the reference's total_params() for this depth "
          f"{cfg.total_params() / 1e9:.3f}e9), {gb:.2f} GB in "
          f"{cfg.compute_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return params, cfg, cut, gb


def family_stubs(cfg, rows: int, dev, seed: int) -> Dict[str, torch.Tensor]:
    """The stub frontends' inputs at std 1, drawn on the card: an
    encoder-decoder's frame embeddings, a vision stub's patch embeddings."""
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn(rows, cfg.encoder_frames, cfg.d_model,
                                    generator=g, device=dev)
    if cfg.n_patches:
        out["patches"] = torch.randn(rows, cfg.n_patches, cfg.d_model,
                                     generator=g, device=dev)
    return out


def attention_layers(cfg) -> Dict[str, int]:
    """Attention kernel launches a prefill and a decode step make: one
    flash a self-attention layer a prefill (the encoder's included), one
    decode a layer a step, and an encoder-decoder's cross-attention one
    flash a layer in each (non-causal, so never decode)."""
    cross = cfg.n_layers if cfg.is_encoder_decoder else 0
    return {"prefill flash": cfg.n_layers + cross + cfg.n_encoder_layers,
            "step flash": cross, "step decode": cfg.n_layers}


def logits_gate(got: torch.Tensor, want: torch.Tensor, what: str,
                gated: bool = True):
    """The bf16 gate: the kernels' logits within LOGITS_TOL of the plain
    attention's range, nothing NaN; (err, span, rows with the same
    argmax).  Not ``gated``: the reading is printed, and only a NaN
    fails."""
    got, want = got.float(), want.float()
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        fail(f"{what}: non-finite logits")
    err = float((got - want).abs().max())
    span = float(want.max() - want.min())
    same = int(got.argmax(-1).eq(want.argmax(-1)).sum())
    print(f"{what}: max abs err {err:.4g} against a logit range of "
          f"{span:.4g} = {err / span:.2%} ("
          + (f"gate {LOGITS_TOL:.0%}" if gated else "not gated")
          + f"); same argmax in {same}/{got.shape[0]} rows")
    if gated and not err <= LOGITS_TOL * span:
        fail(f"{what}: outside the gate")
    return err, span, same


@contextlib.contextmanager
def routing(choices: List[torch.Tensor], replay: bool):
    """Record each MoE layer's top-k expert choice (``moe.top_k``) into
    ``choices``, in call order, or replay them: the gate values then come
    from the run's own router probabilities at the recorded experts."""
    real = moe.top_k
    recorded = iter(list(choices))

    def top_k(probs, k):
        if not replay:
            vals, idx = real(probs, k)
            choices.append(idx)
            return vals, idx
        idx = next(recorded)
        return probs.gather(-1, idx), idx

    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = real


@contextlib.contextmanager
def attention_held(out: Dict[str, Any]):
    """Hold every attention call of the block against the plain version on
    its own inputs, every row (those that admit no key included), at
    BF16_TOL: the kernels on the inputs the model really gives them, with
    no error carried from layer to layer.  ``out`` gets the call count,
    the worst error and how many calls lay outside the tolerance."""
    real = attention.attend
    out.update(calls=0, max_abs_err=0.0, outside=0)

    def attend(q, k, v, q_pos, k_pos, **kw):
        got = real(q, k, v, q_pos, k_pos, **kw)
        want = attention.attend_torch(
            q, k, v, q_pos, k_pos, n_kv_heads=kw["n_kv_heads"],
            causal=kw["causal"], window=kw.get("window", 0)).float()
        err = (got.float() - want).abs()
        out["calls"] += 1
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out["outside"] += not bool(
            (err <= BF16_TOL[1] + BF16_TOL[0] * want.abs()).all())
        return got

    attention.attend = attend
    try:
        yield out
    finally:
        attention.attend = real


@contextlib.contextmanager
def planted(fault: str):
    """A known fault in the kernels' attention, for showing that the gate
    rejects it: ``causal off by one`` lets each prefill query see the next
    key too (the queries' positions moved one on), ``kv head 0 dropped``
    writes 0 for the query heads of kv head 0."""
    real = attention.attend

    def attend(q, k, v, q_pos, k_pos, **kw):
        if fault == "causal off by one" and q.shape[1] > 1:
            q_pos = torch.where(q_pos >= 0, q_pos + 1, q_pos)
        out = real(q, k, v, q_pos, k_pos, **kw)
        if fault == "kv head 0 dropped":
            out = out.clone()
            out[:, :, :q.shape[2] // kw["n_kv_heads"]] = 0
        return out

    attention.attend = attend
    try:
        yield
    finally:
        attention.attend = real


def kernels_vs_plain(run: Callable[[Any], torch.Tensor], vocab: int,
                     what: str, faults: Tuple[str, ...] = ()):
    """The kernels' prefill (``run(None)``) against the plain attention's
    (``run("torch")``).  Gated: every attention call of the kernels' run
    against the plain version on its own inputs (``attention_held``), and
    in a dense model the last logits within LOGITS_TOL of the plain
    attention's range over the ``vocab`` real columns (the padded ones
    hold -1e9).  In a MoE model each layer's expert choice is pinned to
    the kernels' run (a top-k choice is discontinuous: bf16 rounding that
    differs between the two routes flips near-tied experts, a flip changes
    that token's output wholesale, and through the capacity which of its
    group's tokens drop), and even pinned, deepseek-moe-16b's 27 MoE layers
    carry the attention's rounding to 1.85-2.37% of the range (an H100
    SXM) over five seeds while every attention call agrees at BF16_TOL, so
    there the
    logits are printed beside the gate, with the unpinned difference and
    the count of flipped choices.  Each of ``faults`` is then planted in
    the kernels' attention: the attention check must reject it, and its
    logits are printed.  Returns (err, span, rows with the same argmax) of
    the logits."""
    chosen, free, held = [], [], {}
    with routing(chosen, replay=False), attention_held(held):
        got = run(None)[:, :vocab]
    print(f"{what}: each of the kernels' {held['calls']} attention calls "
          f"against the plain version on its own inputs, every row: max "
          f"abs err {held['max_abs_err']:.4g}, {held['outside']} outside "
          f"{BF16_TOL}")
    if held["outside"]:
        fail(f"{what}: {held['outside']} attention calls disagree with the "
             f"plain version")
    with routing(chosen, replay=True):
        want = run("torch")[:, :vocab]
    if chosen:
        with routing(free, replay=False):
            unpinned = run("torch")[:, :vocab]
        flips = sum(int(a.sort(-1).values.ne(b.sort(-1).values).any(-1)
                        .sum()) for a, b in zip(chosen, free))
        tokens = sum(a.shape[0] * a.shape[1] for a in chosen)
        print(f"{what}: the two routes chose different experts for {flips} "
              f"of {tokens} token-layers ({len(chosen)} MoE layers); "
              f"kernels vs plain attention, routing free: max abs err "
              f"{float((got.float() - unpinned.float()).abs().max()):.4g} "
              f"(not gated)")
    gate = logits_gate(got, want, f"{what}, kernels vs plain attention"
                       + (", routing pinned" if chosen else ""),
                       gated=not chosen)
    for fault in faults:
        bad_choices, bad_held = [], {}
        with routing(bad_choices, replay=False), planted(fault), \
                attention_held(bad_held):
            bad = run(None)[:, :vocab].float()
        with routing(bad_choices, replay=True):
            bad_want = run("torch")[:, :vocab].float()
        err = float((bad - bad_want).abs().max())
        span = float(bad_want.max() - bad_want.min())
        print(f"{what}, planted fault ({fault}): {bad_held['outside']} of "
              f"{bad_held['calls']} attention calls outside {BF16_TOL} (max "
              f"abs err {bad_held['max_abs_err']:.4g}); the logits "
              + ("(routing pinned) " if bad_choices else "")
              + f"{err / span:.2%} of the range")
        if not bad_held["outside"]:
            fail(f"{what}: the attention check passed a planted fault "
                 f"({fault})")
    return gate


def timed_generate(params, cfg, prompt, new: int, cache_len: int, stubs):
    """``serve_step.generate``'s loop through its public steps (prefill,
    sample, decode_step), synchronised after each, for the times: (tokens,
    TTFT ms, the inter-token ms)."""
    b, s = prompt.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, caches, memory = prefill(params, cfg, prompt, cache_len=cache_len,
                                   **stubs)
    tok = sample(last)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    out = [tok]
    for i in range(1, new):
        pos = torch.full((b, 1), s + i - 1, dtype=torch.int32,
                         device=prompt.device)
        logits, caches = decode_step(params, cfg, tok[:, None], pos, caches,
                                     memory=memory)
        tok = sample(logits)
        out.append(tok)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    return (torch.stack(out, 1), (stamps[0] - t0) * 1e3,
            list(np.diff(stamps) * 1e3))


def serve_family(arch: str, layers, rows: int, plen: int, new: int, dev,
                 seed: int, card: str) -> Dict[str, Any]:
    """One arch through ``serve_step.generate`` on the card: the attention
    launch counts set to 0 just before and read just after (one flash a
    prefill layer, one decode a step layer, and whisper's cross-attention
    flash in both), the tokens in the vocabulary, the same tokens from a
    second run (timed: TTFT, the inter-token p50, tok/s), and the
    prefill's last logits on the kernels against the plain attention's."""
    params, cfg, cut, gb = family_model(arch, layers, dev, seed)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (rows, plen))).to(dev)
    stubs = family_stubs(cfg, rows, dev, seed)
    cache_len = plen + new
    per = attention_layers(cfg)
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompt, max_new_tokens=new,
                    cache_len=cache_len, **stubs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = engine_counts()
    expect = {ATTN[0]: per["prefill flash"] + (new - 1) * per["step flash"],
              ATTN[1]: (new - 1) * per["step decode"]}
    inputs = "".join(f", {k} {tuple(v.shape)}" for k, v in stubs.items())
    print(f"main path [{arch} generate] launches: {counts} ({per} over one "
          f"prefill and {new - 1} decode steps); {rows} x {plen} prompt "
          f"tokens{inputs}, {new} new; the first run (builds and all) "
          f"{first_s:.2f} s")
    if counts != expect:
        fail(f"{arch}: generate launched {counts}, not {expect}")
    if tuple(toks.shape) != (rows, new) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{arch}: tokens {tuple(toks.shape)} not all in the vocabulary")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again, ttft, itl = timed_generate(params, cfg, prompt, new, cache_len,
                                      stubs)
    wall = time.perf_counter() - t0
    if not torch.equal(again, toks):
        fail(f"{arch}: a second run chose other tokens "
             f"({int(again.ne(toks).sum())} of {toks.numel()})")
    out = {"cut": cut, "param_gb": gb, "launches": counts,
           "tok_per_s": rows * new / wall, "wall_s": wall, "ttft_ms": ttft,
           "p50_itl_ms": float(np.median(itl)),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{arch} on {card}: {rows * new} tokens in {wall:.3f} s = "
          f"{out['tok_per_s']:.2f} tok/s (the {rows} x {plen} prefill "
          f"included); TTFT {ttft:.1f} ms; inter-token p50 "
          f"{out['p50_itl_ms']:.2f} ms; peak device memory "
          f"{out['max_memory_allocated_gb']:.2f} GB (parameters {gb:.2f} "
          f"GB); a second run's tokens equal the first's")
    out["logits_err"], out["logits_span"], _ = kernels_vs_plain(
        lambda backend: prefill(params, cfg, prompt, cache_len=cache_len,
                                attn_backend=backend, **stubs)[0],
        cfg.vocab_size, f"{arch} prefill logits ({rows} rows of {plen})")
    del params
    return out


def moe_breakdown(params, cfg, dev, bw: float, card: str
                  ) -> Dict[str, Any]:
    """Where a MoE layer's time goes, each piece as its own CUDA graph on
    the first MoE layer's weights: the router with the one-hot dispatch and
    combine tensors (``moe.route``), the dispatch einsum, the expert GEMMs
    (``moe.bank_ffn``), the combine einsum and the shared experts, at a
    decode step's 8 tokens and a 2048-bucket prefill's 2048."""
    p = params["segments"][0][0]["moe"]
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for label, t in (("decode step", SERVE["num_slots"]),
                     ("2048 prefill", max(SERVE["prefill_buckets"]))):
        gs = moe.routing_group(t)
        xt = torch.randn(t // gs, gs, cfg.d_model, generator=g, device=dev,
                         dtype=cfg.cdtype())
        kw = dict(n_experts=cfg.n_experts, k=cfg.top_k,
                  capacity_factor=cfg.moe_capacity_factor)
        dispatch, combine, _ = moe.route(p["router"], xt, **kw)
        x_e = torch.einsum("gtec,gtd->gecd", dispatch, xt)
        y_e = moe.bank_ffn(p["experts"], x_e, cfg.mlp)
        parts = {
            "route + one-hots": lambda: moe.route(p["router"], xt, **kw),
            "dispatch einsum": lambda: torch.einsum("gtec,gtd->gecd",
                                                    dispatch, xt),
            "expert GEMMs": lambda: moe.bank_ffn(p["experts"], x_e, cfg.mlp),
            "combine einsum": lambda: torch.einsum("gtec,gecd->gtd",
                                                   combine, y_e),
            "shared experts": lambda: moe.shared_ffn(p["shared"], xt,
                                                     cfg.mlp),
            "moe_apply": lambda: moe.moe_apply(
                p, xt.reshape(1, t, cfg.d_model), n_experts=cfg.n_experts,
                top_k=cfg.top_k, mlp_kind=cfg.mlp,
                capacity_factor=cfg.moe_capacity_factor)}
        ms = {k: graph_ms(fn) for k, fn in parts.items()}
        cap = moe.capacity(gs, cfg.n_experts, cfg.top_k,
                           cfg.moe_capacity_factor)
        # every expert's weights are read whatever the routing: the dense
        # dispatch runs each expert on its C capacity slots
        bank_gb = sum(w.nbytes for w in p["experts"].values()) / 1e9
        print(f"{MOE_ARCH} MoE layer at the {label} ({t} tokens, groups of "
              f"{gs}, capacity {cap}), device ms a layer (CUDA graphs) on "
              f"{card}: {ms}; the expert bank is {bank_gb:.3f} GB a layer "
              f"= {bank_gb * 1e9 / bw * 1e3:.3f} ms at the data sheet's "
              f"HBM rate; x "
              f"{cfg.n_layers - cfg.dense_prefix_layers} MoE layers")
        out[label] = ms
    return out


def serve_moe(dev, seed: int, bw: float, card: str) -> Dict[str, Any]:
    """deepseek-moe-16b at full width and depth through ``ServingEngine``
    on the granite trace's settings, contiguous ``run``: the launch counts
    around the engine's build and run, one capture, every step a replay,
    a second run's tokens against the first's, one step's wall against its
    device time and top kernels (one decode kernel a layer in the replay),
    the eager step against a replay on the same inputs, the MoE layer's
    pieces, and a 2048-bucket prefill's logits against the plain
    attention's."""
    t_start = time.perf_counter()
    params, cfg, cut, gb = family_model(MOE_ARCH, None, dev, seed)

    def trace():
        return serving_trace(cfg, seed)

    def lap(what: str) -> None:
        print(f"{MOE_ARCH}: {what} {time.perf_counter() - t_start:.1f} s "
              f"into the phase")

    reqs = trace()
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    t0 = time.perf_counter()
    engine = ServingEngine(params, cfg, **SERVE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if engine.attn_backends != {"prefill": "cuda", "decode": "cuda"}:
        fail(f"{MOE_ARCH}: the engine's attention resolved to "
             f"{engine.attn_backends}")
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, st = engine_counts(), engine.stats
    # the warm-up and the capture of each graph: every prefill and step
    # is a replay
    n_buckets = len(SERVE["prefill_buckets"])
    expect = {ATTN[0]: 2 * cfg.n_layers * n_buckets,
              ATTN[1]: 2 * cfg.n_layers}
    print(f"main path [{MOE_ARCH} serving, contiguous] launches: {counts}; "
          f"prefill calls {st['prefill_calls']}, decode steps "
          f"{st['decode_steps']} (graph replays {st['graph_replays']}), "
          f"decode_traces {st['decode_traces']}; built and captured in "
          f"{build_s:.1f} s")
    if counts != expect:
        fail(f"{MOE_ARCH}: serving launched {counts}, not {expect}")
    if st["decode_traces"] != 1 or st["graph_replays"] != st["decode_steps"]:
        fail(f"{MOE_ARCH}: decode_traces {st['decode_traces']}, "
             f"{st['graph_replays']} replays of {st['decode_steps']} steps: "
             f"the step must be captured once and every step replayed")
    if st["prefill_traces"] != n_buckets or \
            st["prefill_replays"] != st["prefill_calls"]:
        fail(f"{MOE_ARCH}: prefill_traces {st['prefill_traces']}, "
             f"{st['prefill_replays']} replays of {st['prefill_calls']} "
             f"prefills: each bucket must be captured once and every "
             f"prefill replayed")
    done = sorted(finished, key=lambda r: r.uid)
    if len(done) != REQUESTS or any(
            len(r.generated) != MAX_NEW
            or not all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in done):
        fail(f"{MOE_ARCH}: a request did not finish with {MAX_NEW} tokens "
             f"in the vocabulary")
    first = {r.uid: list(r.generated) for r in done}
    summ = latency_summary(done)
    n_tok = st["tokens_generated"]
    out = {"cut": cut, "param_gb": gb, "launches": counts,
           "tok_per_s": n_tok / wall, "wall_s": wall, "build_s": build_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    out.update({k: summ[k] for k in ("p50_ttft_s", "p95_ttft_s",
                                     "p50_itl_s", "p50_latency_s")})
    print(f"serving {MOE_ARCH} [contiguous] on {card}: {n_tok} tokens in "
          f"{wall:.3f} s = {out['tok_per_s']:.2f} tok/s; TTFT p50 "
          f"{summ['p50_ttft_s'] * 1e3:.1f} ms, p95 "
          f"{summ['p95_ttft_s'] * 1e3:.1f} ms; inter-token p50 "
          f"{summ['p50_itl_s'] * 1e3:.2f} ms; peak device memory "
          f"{out['max_memory_allocated_gb']:.2f} GB (parameters {gb:.2f} GB)")
    # the trace again: the same tokens, every step a replay of the graph
    before = dict(st)
    again = sorted(engine.run(trace()), key=lambda r: r.uid)
    same = sum(r.generated == first[r.uid] for r in again)
    steps = st["decode_steps"] - before["decode_steps"]
    print(f"{MOE_ARCH}, the trace again: its tokens equal the first run's "
          f"for {same}/{len(first)} requests; {steps} decode steps, "
          f"{st['graph_replays'] - before['graph_replays']} graph replays, "
          f"decode_traces {st['decode_traces']}")
    if same != len(first):
        fail(f"{MOE_ARCH}: two runs of the trace chose different tokens")
    if st["graph_replays"] != st["decode_steps"] or \
            st["decode_traces"] != 1:
        fail(f"{MOE_ARCH}: the second run took a step that was no replay")
    lap("served twice")
    step = engine_step_report(engine, cfg, card, MOE_ARCH, seed)
    out.update(step)
    span = step["eager vs replay logits_span"]
    if not step["eager vs replay max_abs_logit_diff"] <= LOGITS_TOL * span:
        fail(f"{MOE_ARCH}: the eager step and a replay disagree by "
             f"{step['eager vs replay max_abs_logit_diff']:.4g}, beyond "
             f"{LOGITS_TOL} of the logit range {span:.4g}")
    del engine, finished, done, reqs
    free_card()
    lap("the step measured")
    out["moe layer"] = moe_breakdown(params, cfg, dev, bw, card)
    lap("the MoE layer measured")
    # a 2048-bucket prefill of the longest prompt, kernels against plain
    req = max(trace(), key=lambda r: r.prompt_len)
    bucket = max(SERVE["prefill_buckets"])
    toks = torch.zeros(1, bucket, dtype=torch.int64, device=dev)
    toks[0, bucket - req.prompt_len:] = torch.from_numpy(
        req.prompt.astype(np.int64))
    lengths = torch.tensor([req.prompt_len], device=dev)
    out["logits_err"], out["logits_span"], _ = kernels_vs_plain(
        lambda backend: prefill(params, cfg, toks,
                                cache_len=SERVE["cache_len"],
                                lengths=lengths, attn_backend=backend)[0],
        cfg.vocab_size, f"{MOE_ARCH} prefill logits (prompt "
        f"{req.prompt_len}, bucket {bucket})", faults=PLANTED)
    lap("the logits gated")

    def one_prefill():
        prefill(params, cfg, toks, cache_len=SERVE["cache_len"],
                lengths=lengths)

    pwall = wall_ms(one_prefill, 3)
    busy, top, flash_ms = device_profile(one_prefill, match=FLASH_KERNEL)
    out["prefill wall_ms"], out["prefill device_ms"] = pwall, busy
    print(f"{MOE_ARCH} prefill (bucket {bucket}): {pwall:.3f} ms wall, "
          f"{busy:.3f} ms of kernels (torch.profiler); top kernels (name, "
          f"ms, calls): {top}; {FLASH_KERNEL} {flash_ms:.3f} ms")
    # the same prefill on the weights and a prompt of each of the next
    # seeds: the attention check gated, the pinned logits read
    ratios = {seed: out["logits_err"] / out["logits_span"]}
    del params
    for other in range(seed + 1, seed + MOE_GATE_SEEDS):
        params, cfg, _, _ = family_model(MOE_ARCH, None, dev, other)
        rng = np.random.default_rng(other)
        toks[0, bucket - req.prompt_len:] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, req.prompt_len))
        err, span, _ = kernels_vs_plain(
            lambda backend: prefill(params, cfg, toks,
                                    cache_len=SERVE["cache_len"],
                                    lengths=lengths, attn_backend=backend)[0],
            cfg.vocab_size, f"{MOE_ARCH} prefill logits, seed {other} "
            f"(prompt {req.prompt_len}, bucket {bucket})")
        ratios[other] = err / span
        del params
    out["logits_err_by_seed"] = ratios
    print(f"{MOE_ARCH}: the pinned logits' reading by seed (max abs err "
          f"over the logit range, not gated): "
          + ", ".join(f"{k}: {v:.2%}" for k, v in ratios.items()))
    lap("the seeds read")
    return out


def family_kernel_cases(dev, seed: int, bw: float, peak_bf16: float,
                        card: str) -> List[Dict[str, Any]]:
    """The two attention kernels at this slice's new shapes, bf16
    (``examples/torch_attention_layouts.py``): decode at 12 and 16 query
    heads per kv head at the engine's step shape, flash non-causal at
    whisper-tiny's encoder shape (8 x 1500 frames, 6 heads of 64) and its
    cross-attention (a decode step's one query and a 16-token prompt
    against 1500 frames).  Each against its plain version on every row at
    BF16_TOL, then timed as a CUDA graph beside the bound and one
    ``scaled_dot_product_attention`` call on the same inputs (GQA for
    decode), also a graph."""
    out = []
    for c in layouts.cases(seed, dev, DECODE_GROUPS, prefill=False) + \
            layouts.whisper_cases(seed, dev):
        rec = layouts.measure(c, iters=ITERS)
        t_ops, t_bytes = c.flops / peak_bf16, c.bytes / bw
        rec["bound_ms"] = max(t_ops, t_bytes) * 1e3
        rec["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        out.append(rec)
        print(f"{rec['case']}: vs plain max abs err {rec['max_abs_err']:.3g}"
              f" at {BF16_TOL}, every row; {rec['graph_ms']:.4f} ms on the "
              f"device (CUDA graph) on {card} against a "
              f"{rec['bound_ms']:.5f} ms bound ({rec['bound_by']}) = "
              f"{rec['bound_ms'] / rec['graph_ms']:.1%}; library "
              f"(scaled_dot_product_attention, a graph) "
              f"{rec['library_ms']:.4f} ms")
    return out


# ---- slice 12: training ----------------------------------------------------
TRAIN_ARCH = "stablelm-1.6b"
#: the timed run: 8 x 4096 tokens a step in 4 microbatches of 2 x 4096, so
#: every attention call takes the chunked path (S = T = 4096: 4 q chunks,
#: 10 key-chunk steps causal)
TRAIN = {"rows": 8, "seq": 4096, "microbatches": 4, "timed": 5}
#: the gates on one batch of 2 x 4096 (one microbatch's worth)
TRAIN_GATE_ROWS = 2
OVERFIT_STEPS = 8
#: depth of gates 2 and 4-7 (full width): each is a property of the step,
#: not of the depth, and the full depth's steps take ~2.4 s at 2 x 4096
TRAIN_CUT_LAYERS = 4
RESUME_AT, RESUME_STEPS = 1, 2
#: (relative) two microbatches against one: loss, grad norm
MICROBATCH_TOL = (1e-3, 1e-2)
#: (relative) the chunked path against the full-matrix attend_torch: loss,
#: grad norm (the full path rounds its probabilities to bf16, v's dtype,
#: before P.V; the chunked path keeps them float32)
CHUNKED_TOL = (1e-3, 2e-2)
#: (relative) resumed steps against the uninterrupted ones: loss
RESUME_TOL = 1e-4
#: hand-written wrappers whose launch counts must stay 0 in training
HAND_WRITTEN = ("attention.flash", "attention.decode", RWKV) + KERNELS
#: the torch route's test for the chunked path (gate 6 turns it off)
TAKES_CHUNKED = attention.takes_chunked


def launch_counters() -> Dict[str, Any]:
    """Every hand-written wrapper that counts its launches, by name."""
    out = {name: get_kernel(name).backend(get_kernel(name).native).fn
           for name in HAND_WRITTEN}
    out["hartree_fock.twoel"] = hf_kernel.twoel
    out[SLAB] = hf_kernel.twoel_slab
    return out


def kernel_label(key: str, width: int = 110) -> str:
    """A CUDA kernel's name without the namespaces and ``void``, cut to
    ``width``: an ATen elementwise kernel's functor then shows."""
    return re.sub(r"\bvoid |at::native::|\(anonymous namespace\)::|"
                  r"at::|std::", "", key)[:width]


def kernel_kind(key: str) -> str:
    """A CUDA kernel's kind, by its name: float32 GEMMs (in a training
    step, the chunked attention's float32 tiles), the other GEMMs (bf16),
    elementwise kernels, reductions, or other."""
    if "gemm" in key or "nvjet" in key:
        return "float32 GEMMs" if "f32f32" in key else "bf16 GEMMs"
    if "elementwise" in key:
        return "elementwise"
    if "reduce" in key:
        return "reductions"
    return "other"


def train_model(cfg, dev, seed: int):
    """(float32 master parameters drawn on the card from ``seed``, their
    count)."""
    free_card()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev, dtype=cfg.pdtype())
    return params, count_params(params)


def train_batch(cfg, rows: int, seq: int, seed: int, step: int, dev):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=rows, seed=seed))
    return to_device(data.batch_at(step), dev)


def moved_leaves(before, after) -> Tuple[int, int]:
    """(leaves of ``after`` that differ from ``before`` somewhere, leaves)."""
    pairs = list(zip(tree_leaves(before), tree_leaves(after)))
    return sum(bool(a.ne(b).any()) for a, b in pairs), len(pairs)


def model_flops(cfg, n_params: int, rows: int, seq: int) -> float:
    """6 N D (``core/roofline.py``) + the causal attention's
    12 L H Dh B S(S+1)/2: the forward and backward work of the model, the
    remat recompute not counted."""
    pairs = rows * seq * (seq + 1) / 2
    return (roofline_flops(n_params, rows * seq, "train")
            + 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs)


def chunked_share(cfg, dev, seed: int, step_ms: float, calls: int
                  ) -> Tuple[float, float, float]:
    """(forward ms, forward + backward ms, share of a step) of one
    ``attend_chunked`` call at a microbatch's shapes (bf16 q, k, v), timed
    with CUDA events: a layer runs it forward twice a step (remat's
    recompute) and backward once, ``calls`` / 2 layers' worth."""
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    b, s = TRAIN_GATE_ROWS, TRAIN["seq"]
    shape = (b, s, cfg.n_heads, cfg.head_dim)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    kw = dict(n_kv_heads=cfg.n_kv_heads, causal=True)
    w = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def fwd():
        return attend_chunked(q, k, v, pos, pos, **kw)

    def fwd_bwd():
        torch.autograd.grad((fwd() * w).float().sum(), (q, k, v))

    fwd_ms, both_ms = events_ms(fwd, iters=3), events_ms(fwd_bwd, iters=3)
    per_step = calls / 2 * (fwd_ms + both_ms)
    return fwd_ms, both_ms, per_step / step_ms


def guard_gates(cfg, params, batch, tcfg) -> None:
    """Gate 2: ``forward`` on the card with parameters that require grad
    and the default backends raises the guard's error, and so does
    ``train_step`` under ``REPRO_ATTN_BACKEND=cuda``."""
    leaves_rg = tree_map(lambda t: t.detach().requires_grad_(), params)
    try:
        forward(leaves_rg, cfg, batch["tokens"][:, :256])
    except RuntimeError as e:
        if "has no backward" not in str(e):
            raise
        print(f"training gate 2a: forward on grad-requiring parameters with "
              f"the default backends raised: {str(e)[:90]}...")
    else:
        fail("training: forward with grad-requiring parameters on the "
             "hand-written kernels did not raise")
    state = make_train_state(params, tcfg)
    os.environ[attention.ATTN_BACKEND_ENV] = "cuda"
    try:
        train_step(state, batch, cfg=cfg, tcfg=tcfg)
    except RuntimeError as e:
        if "has no backward" not in str(e):
            raise
        print(f"training gate 2b: train_step under REPRO_ATTN_BACKEND=cuda "
              f"raised: {str(e)[:90]}...")
    else:
        fail("training: train_step under REPRO_ATTN_BACKEND=cuda did not "
             "raise")
    finally:
        del os.environ[attention.ATTN_BACKEND_ENV]


def train_phase(dev, seed: int, card: str, peak_bf16: float,
                after_timed: Callable[..., Any] = None) -> Dict[str, Any]:
    """Phase 10: stablelm-1.6b trained at full width and depth (float32
    masters, bf16 compute, AdamW at the reference's defaults but
    ``warmup_steps=2``), with its seven gates.  ``after_timed(cfg, state,
    batch, tcfg, step_ms)``, when given, runs after the timed steps, on
    the model as it stands (phase 12's roofline); its result is the
    returned ``"after_timed"``."""
    t_start = time.perf_counter()

    def lap(what: str) -> None:
        print(f"training: {what} done {time.perf_counter() - t_start:.1f} s "
              f"into the phase")

    full = get_config(TRAIN_ARCH)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("training: torch.backends.cuda.matmul.allow_tf32 is on; the "
             "float32 GEMMs would run on TF32")
    rows, seq, mbs = TRAIN["rows"], TRAIN["seq"], TRAIN["microbatches"]
    tcfg = TrainConfig(microbatches=mbs, remat=True,
                       opt=AdamWConfig(warmup_steps=2))
    params, n = train_model(full, dev, seed)
    state_gb = 16 * n / 1e9
    logits_gb = 4 * TRAIN_GATE_ROWS * seq * full.padded_vocab / 1e9
    print(f"training {TRAIN_ARCH}: {full.n_layers} layers, d_model "
          f"{full.d_model}, {full.n_heads} heads of {full.head_dim}, d_ff "
          f"{full.d_ff}, vocab {full.vocab_size} (untied); {n / 1e9:.4f}e9 "
          f"float32 master parameters, compute {full.compute_dtype}; state "
          f"(masters, gradients, mu, nu) {state_gb:.2f} GB, a microbatch's "
          f"float32 logits {logits_gb:.2f} GB; {rows} x {seq} tokens a step "
          f"in {mbs} microbatches, remat on; AdamW {tcfg.opt}")
    counters = launch_counters()
    batches = [train_batch(full, rows, seq, seed, i, dev)
               for i in range(TRAIN["timed"] + 1)]

    # warm-up step: health (gate 3) and route (gate 1)
    state = make_train_state(params, tcfg)
    del params
    for w in counters.values():
        w.launches = 0
    attention.reset_dispatch_log()
    calls0 = attend_chunked.calls
    new, m = train_step(state, batches[0], cfg=full, tcfg=tcfg)
    torch.cuda.synchronize()
    chunked_calls = attend_chunked.calls - calls0
    records = attention.dispatch_records()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        fail(f"training gate 3: loss {loss}, grad norm {gnorm}")
    moved, total = moved_leaves(state["params"], new["params"])
    if moved != total:
        fail(f"training gate 3: {total - moved} of {total} parameter leaves "
             f"did not move")
    print(f"training gate 3: step 1 loss {loss:.6f}, grad norm "
          f"{gnorm:.6f}, lr {float(m['lr']):.3e}; {moved} of {total} "
          f"parameter leaves moved")
    state = new
    del new
    hand = {k: w.launches for k, w in counters.items()}
    want_calls = full.n_layers * mbs * 2
    routes = sorted({r["backend"] for r in records})
    print(f"training gate 1: hand-written kernel launches during the step "
          f"{hand}; {len(records)} attention dispatch records, backends "
          f"{routes}; {chunked_calls} chunked attention calls ({full.n_layers}"
          f" layers x {mbs} microbatches x (forward + remat recompute) = "
          f"{want_calls})")
    if any(hand.values()) or routes != ["torch"] \
            or len(records) != want_calls or chunked_calls != want_calls:
        fail("training gate 1: the step left the plain torch route")
    lap("the warm-up step (gates 1 and 3)")

    # the timed steps
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], [loss]
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg=full, tcfg=tcfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median(walls))
    tok_s = rows * seq / step_ms * 1e3
    flops = model_flops(full, n, rows, seq)
    mfu = flops / (step_ms / 1e3) / peak_bf16
    print(f"training {TRAIN_ARCH} on {card}: step wall ms {walls}, median "
          f"{step_ms:.1f}, {tok_s:.0f} tokens/s; losses {losses}; peak "
          f"memory {peak_gb:.2f} GB; model flops {flops:.4e} a step = 6 N D "
          f"+ 12 L H Dh B S(S+1)/2 (N {n}, D {rows * seq}, L {full.n_layers},"
          f" H {full.n_heads}, Dh {full.head_dim}, B {rows}, S {seq}; the "
          f"remat recompute not counted), model-flops share "
          f"{mfu:.2%} of {peak_bf16 / 1e12:.0f} TFLOP/s bf16")
    if not all(math.isfinite(x) for x in losses):
        fail(f"training: non-finite losses {losses}")
    lap("the timed steps")
    extra = None
    if after_timed is not None:
        extra = after_timed(full, state, batches[1], tcfg, step_ms)
        lap("phase 12's roofline of a step")

    # one step under torch.profiler (device records only: a step makes
    # ~10^5 host records)
    with profiling(host=False) as prof:
        t0 = time.perf_counter()
        state, m = train_step(state, batches[1], cfg=full, tcfg=tcfg)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(f"training step under torch.profiler: {prof_ms:.1f} ms wall, "
          f"{busy:.1f} ms of device records, idle share "
          f"{max(0.0, 1 - busy / prof_ms):.1%}; top device operations: "
          + "; ".join(f"{kernel_label(e.key)} {e.self_device_time_total /
                                               1e3:.1f} ms x{e.count}"
                      for e in top))
    kinds: Dict[str, float] = {}
    for e in kernels:
        kinds[kernel_kind(e.key)] = kinds.get(kernel_kind(e.key), 0.0) \
            + e.self_device_time_total / 1e3
    print("training step's device time by kind of kernel: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy:.1%})"
        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    fwd_ms, both_ms, share = chunked_share(full, dev, seed, step_ms,
                                           want_calls)
    print(f"chunked attention at a microbatch's shapes (B {TRAIN_GATE_ROWS},"
          f" S = T {seq}, {full.n_heads} heads of {full.head_dim}, float32 "
          f"tiles; CUDA events): forward {fwd_ms:.2f} ms, forward + backward "
          f"{both_ms:.2f} ms; {want_calls // 2} layer-microbatches x "
          f"(forward + forward + backward) = {share:.1%} of the "
          f"{step_ms:.1f} ms step")
    del state, batches
    free_card()
    lap("the profiled step and the chunked attention's share")

    # gates 2 and 4-7 at 4 of the 24 layers, on one batch of 2 x 4096
    gate_cfg = dataclasses.replace(tcfg, microbatches=1)
    cut = dataclasses.replace(full, n_layers=TRAIN_CUT_LAYERS)
    params, _ = train_model(cut, dev, seed)
    batch = train_batch(cut, TRAIN_GATE_ROWS, seq, seed, 0, dev)
    guard_gates(cut, params, batch, gate_cfg)
    free_card()
    lap("gate 2")
    both = {}
    for route, chunked in (("chunked", True), ("full", False)):
        if not chunked:
            attention.takes_chunked = lambda *a, **k: False
        try:
            calls0 = attend_chunked.calls
            _, m = train_step(make_train_state(params, gate_cfg), batch,
                              cfg=cut, tcfg=gate_cfg)
            both[route] = (float(m["loss"]), float(m["grad_norm"]),
                           attend_chunked.calls - calls0)
        finally:
            attention.takes_chunked = TAKES_CHUNKED
        free_card()
    errs = [abs(both["chunked"][i] - both["full"][i]) / abs(both["full"][i])
            for i in range(2)]
    print(f"training gate 6: chunked against full-matrix attention at "
          f"{TRAIN_CUT_LAYERS} of {full.n_layers} layers: loss "
          f"{both['chunked'][0]} vs {both['full'][0]}, grad norm "
          f"{both['chunked'][1]} vs {both['full'][1]}; relative "
          f"{errs[0]:.2e}, {errs[1]:.2e} (tolerances {CHUNKED_TOL}); chunked "
          f"calls {both['chunked'][2]} and {both['full'][2]}")
    if errs[0] > CHUNKED_TOL[0] or errs[1] > CHUNKED_TOL[1] \
            or both["chunked"][2] == 0 or both["full"][2] != 0:
        fail("training gate 6: the chunked path disagrees with the full "
             "matrix, or a route was not taken")
    lap("gate 6")

    # gates 4 and 5 on one batch of 2 x 4096
    state = make_train_state(params, gate_cfg)
    fit = []
    for _ in range(OVERFIT_STEPS):
        state, m = train_step(state, batch, cfg=cut, tcfg=gate_cfg)
        fit.append(float(m["loss"]))
    print(f"training gate 4: {OVERFIT_STEPS} steps on one batch of "
          f"{TRAIN_GATE_ROWS} x {seq} at {TRAIN_CUT_LAYERS} of "
          f"{full.n_layers} layers: losses {fit}")
    if not fit[-1] < fit[0]:
        fail("training gate 4: the loss did not fall on a repeated batch")
    del state
    free_card()
    split = {}
    for k in (1, 2):
        _, m = train_step(make_train_state(params, gate_cfg), batch,
                          cfg=cut, tcfg=dataclasses.replace(
                              gate_cfg, microbatches=k))
        split[k] = (float(m["loss"]), float(m["grad_norm"]))
        free_card()
    errs = [abs(split[2][i] - split[1][i]) / abs(split[1][i])
            for i in range(2)]
    print(f"training gate 5: microbatches 2 against 1 at {TRAIN_CUT_LAYERS}"
          f" layers: loss {split[2][0]} "
          f"vs {split[1][0]}, grad norm {split[2][1]} vs {split[1][1]}; "
          f"relative {errs[0]:.2e}, {errs[1]:.2e} (tolerances "
          f"{MICROBATCH_TOL})")
    if errs[0] > MICROBATCH_TOL[0] or errs[1] > MICROBATCH_TOL[1]:
        fail("training gate 5: microbatching changed the step")
    lap("gates 4 and 5")

    # gate 7: resume from a checkpoint
    data = SyntheticLM(DataConfig(vocab_size=cut.vocab_size, seq_len=seq,
                                  global_batch=TRAIN_GATE_ROWS, seed=seed))
    state = make_train_state(params, gate_cfg)
    del params
    it = iter(data)
    for _ in range(RESUME_AT):
        state, _ = train_step(state, to_device(next(it), dev), cfg=cut,
                              tcfg=gate_cfg)
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    t0 = time.perf_counter()
    mgr = CheckpointManager(str(ckpt), keep=1)
    mgr.save(RESUME_AT, state, metadata={"arch": cut.name})
    save_s = time.perf_counter() - t0
    straight = []
    for _ in range(RESUME_STEPS):
        state, m = train_step(state, to_device(next(it), dev), cfg=cut,
                              tcfg=gate_cfg)
        straight.append(float(m["loss"]))
    t0 = time.perf_counter()
    state, manifest = mgr.restore(state)
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    data.seek(manifest["step"])
    it = iter(data)
    resumed = []
    for _ in range(RESUME_STEPS):
        state, m = train_step(state, to_device(next(it), dev), cfg=cut,
                              tcfg=gate_cfg)
        resumed.append(float(m["loss"]))
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    print(f"training gate 7 at {TRAIN_CUT_LAYERS} layers: checkpoint at step "
          f"{RESUME_AT} ({save_s:.1f} s"
          f" to save, {restore_s:.1f} s to restore), then {RESUME_STEPS} "
          f"steps: straight {straight}, resumed {resumed}; relative "
          f"{err:.2e} (tolerance {RESUME_TOL}); bitwise equal: "
          f"{resumed == straight}")
    if err > RESUME_TOL:
        fail("training gate 7: the resumed steps differ")
    del state
    free_card()
    lap("gate 7")
    return {"step_ms": step_ms, "tok_per_s": tok_s, "peak_gb": peak_gb,
            "mfu": mfu, "chunked_share": share, "chunked_calls":
            chunked_calls, "seconds": time.perf_counter() - t_start,
            "after_timed": extra}


# ---- slice 14: the roofline on the card ------------------------------------
#: (arch, shape, multi-pod) of the full-size dry-run cells phase 12 runs
DRYRUN_CELLS = (("granite-3-8b", "decode_32k", False),
                ("granite-3-8b", "train_4k", False),
                ("deepseek-moe-16b", "train_4k", True),
                ("rwkv6-3b", "long_500k", False))
ROOFLINE_PREFILL = 2048   # tokens of phase 12's granite-3-8b prefill


def roofline_chip(card: str):
    """Phase 12 (a): the chip ``core/roofline.py`` names for this card."""
    chip = detect_chip()
    print(f"roofline chip: detect_chip() = {chip.name} ({chip.peak_flops:.4g}"
          f" FLOP/s bf16, {chip.hbm_bw:.4g} B/s HBM, {chip.ici_bw:.4g} B/s "
          f"a link, {chip.hbm_bytes / 2 ** 30:.0f} GiB) on {card}")
    if chip is not NVIDIA_H100:
        fail(f"detect_chip() names {chip.name}, not {NVIDIA_H100.name}")
    return chip


def dryrun_phase(card: str) -> List[Dict[str, Any]]:
    """Phase 12 (b): the full-size dry-run cells on this machine's PyTorch,
    each written to ``build/dryrun/<mesh>/``; fails on any cell that does
    not run."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hostsim import close_fake_world
    out = []
    try:
        for arch, shape, multi in DRYRUN_CELLS:
            tag = "multipod_2x16x16" if multi else "pod_16x16"
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, multi,
                                  os.path.join(dryrun.ARTIFACT_DIR, tag))
            secs = time.perf_counter() - t0
            if rec["status"] != "ok":
                fail(f"dry run {tag} {arch} {shape}: {rec['status']} "
                     f"{rec['reason']}")
            pc = rec["per_chip"]
            print(f"dry run {tag} {arch} {shape}: {secs:.1f} s on the host; "
                  f"per rank {pc['argument_bytes'] / 2 ** 30:.3f} GiB of "
                  f"arguments, peak {pc['peak_bytes'] / 2 ** 30:.3f} GiB "
                  f"against the card's {NVIDIA_H100.hbm_bytes / 2 ** 30:.0f}"
                  f" GiB (fits: {rec['fits_hbm']}); {pc['flops']:.4g} flops,"
                  f" {pc['hbm_bytes']:.4g} HBM bytes, "
                  f"{pc['collective_bytes']:.4g} collective bytes a rank; "
                  f"{rec['dominant']}-bound, {rec['bound_s'] * 1e3:.3f} ms;"
                  f" fallbacks {rec['fallbacks']}; kernel calls "
                  f"{rec['kernel_calls']}")
            out.append({"arch": arch, "shape": shape, "mesh": tag,
                        "seconds": secs, "bound_s": rec["bound_s"],
                        "dominant": rec["dominant"],
                        "peak_bytes": pc["peak_bytes"],
                        "argument_bytes": pc["argument_bytes"],
                        "fits_hbm": rec["fits_hbm"]})
    finally:
        close_fake_world()
    return out


def step_roofline(label: str, step: Callable[..., Any], args: Tuple[Any, ...],
                  measured_ms: float, how: str, card: str
                  ) -> Dict[str, Any]:
    """Phase 12 (c): one real step counted ``kernel_adjusted`` by the
    walker and its meta twin; the roofline's share of the measured time.
    Gates: the share at most 1.0, the flops equal."""
    t0 = time.perf_counter()
    _, cost = measure(step, *args, kernel_adjusted=True)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, twin = measure(step, *meta_twin(args), kernel_adjusted=True)
    meta_s = time.perf_counter() - t0
    terms = roofline_from_cost(cost, NVIDIA_H100)
    share = terms.bound_s / (measured_ms / 1e3)
    print(f"roofline {label} on {card}: {terms.flops:.6g} flops "
          f"({cost.matmul_flops:.6g} in matmuls), {terms.hbm_bytes:.6g} HBM "
          f"bytes, {cost.ops:.0f} ops, kernel calls "
          f"{dict(cost.kernel_calls)}; compute {terms.compute_s * 1e3:.4f} "
          f"ms, memory {terms.memory_s * 1e3:.4f} ms: {terms.dominant}-bound"
          f" at {terms.bound_s * 1e3:.4f} ms against {measured_ms:.4f} ms "
          f"measured ({how}) = {share:.2%}; the walker took {real_s:.1f} s "
          f"on the card, {meta_s:.1f} s on the meta twin "
          f"({twin.flops:.6g} flops)")
    if share > 1.0:
        fail(f"roofline {label}: the bound {terms.bound_s * 1e3:.4f} ms is "
             f"above the measured {measured_ms:.4f} ms: a wrong count")
    if twin.flops != cost.flops:
        fail(f"roofline {label}: the walker counts {cost.flops!r} flops on "
             f"the card and {twin.flops!r} on the meta twin")
    return {"terms": terms.to_json(), "measured_ms": measured_ms,
            "share": share, "how": how, "meta_flops": twin.flops}


def roofline_serving(params, cfg, dev, seed: int, card: str
                     ) -> Dict[str, Any]:
    """Phase 12 (c), serving: granite-3-8b's decode step at the engine's
    shape, every cache slot filled, and a 2048-token prefill, each on the
    hand-written kernels."""
    rows, cache_len = SERVE["num_slots"], SERVE["cache_len"]
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    caches = init_caches(cfg, rows, cache_len, dev)
    slots = torch.arange(cache_len, dtype=torch.int32, device=dev)

    def fill(t, name):
        if name == "pos":
            t.copy_(slots.expand_as(t))
        else:
            t.normal_(generator=g)

    for tree in [*caches["eager"].values(), *caches["segments"]]:
        for name in ("k", "v", "pos"):
            fill(tree["self"][name], name)
    tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=g,
                           device=dev, dtype=torch.int32)
    positions = torch.full((rows, 1), cache_len, dtype=torch.int32,
                           device=dev)

    def decode(p, c, tok, pos):
        return decode_step(p, cfg, tok, pos, c)[0]

    decode(params, caches, tokens, positions)        # the decode counters
    replay_ms = graph_ms(lambda: decode(params, caches, tokens, positions))
    out = {"decode": step_roofline(
        f"{cfg.name} decode_step ({rows} rows, {cache_len} slots filled)",
        decode, (params, caches, tokens, positions), replay_ms,
        "a CUDA-graph replay", card)}
    del caches

    prompt = torch.randint(0, cfg.vocab_size, (1, ROOFLINE_PREFILL),
                           generator=g, device=dev, dtype=torch.int32)

    def fill_cache(p, tok):
        return prefill(p, cfg, tok, cache_len=cache_len)[0]

    prefill_ms = events_ms(lambda: fill_cache(params, prompt), iters=5)
    out["prefill"] = step_roofline(
        f"{cfg.name} prefill (1 x {ROOFLINE_PREFILL} tokens, cache "
        f"{cache_len})", fill_cache, (params, prompt), prefill_ms,
        "CUDA events, 5 calls", card)
    return out


def roofline_training(cfg, state, batch, tcfg, step_ms: float, card: str
                      ) -> Dict[str, Any]:
    """Phase 12 (c), training: phase 10's step, against its median."""
    def step(st, b):
        return train_step(st, b, cfg=cfg, tcfg=tcfg)[1]["loss"]
    return step_roofline(f"{cfg.name} train_step ({TRAIN['rows']} x "
                         f"{TRAIN['seq']}, {tcfg.microbatches} microbatches,"
                         f" remat)", step, (state, batch), step_ms,
                         "phase 10's median step, synchronised wall", card)



# ---- slice 13: domain decomposition ----------------------------------------
#: the stencil's decompositions at 512^3: (label, registry kwargs, shards)
STENCIL_SHARDED = (
    [(f"slab {s}", {"decomp": "slab", "shard_grid": (s, 1)}, s)
     for s in (2, 4, 8)]
    + [(f"pencil {sz}x{sy}", {"decomp": "pencil", "shard_grid": (sz, sy)},
        sz * sy) for sz, sy in ((2, 2), (4, 2), (2, 4))])
#: one plane per shard: an 8 x 512 x 512 volume at 8 shards, where each
#: shard's padded block is its plane between two halo planes
ONE_PLANE = 8
SHARD_COUNTS = (2, 4, 8)
#: the composites of the hand-written kernels (``shard_cuda``,
#: ``shard_triton``) against their single-device backends
COMPOSITE = {name: "shard_triton" for name in SLICE1[:5]}
COMPOSITE.update({"stencil7": "shard_cuda", "minibude.fasten": "shard_cuda",
                  "hartree_fock.twoel": "shard_cuda"})
#: the composites' timed samples: Hartree-Fock calls take 10-30 ms
HF_SHARD_ITERS = 3


def sharded_path(fn: Callable[[], Any], wrapper) -> Tuple[Any, int,
                                                           Dict[str, int]]:
    """One composite call as a path of its own: the kernel wrapper's launch
    count set to 0 just before and read just after, with the collectives
    the call issued (``collectives.counting``)."""
    wrapper.launches = 0
    with collectives.counting() as counts:
        out = fn()
    torch.cuda.synchronize()
    return out, wrapper.launches, dict(counts)


def contract_for(name: str, backend: str, kwargs, args) -> Dict[str, int]:
    """The collectives the kernel's comm contract declares for a call with
    ``kwargs`` (the first declared variant whose settings the call has)."""
    contract = get_kernel(name).comm_contract(backend)
    if callable(contract):
        contract = next(expect for variant, expect in contract(*args)
                        if variant.items() <= kwargs.items())
    return {c: int(contract.get(c, 0)) for c in collectives.COLLECTIVES}


def composite_ms(fn, args, kwargs, iters: int = ITERS
                 ) -> Tuple[float, Any]:
    """A composite call's ms by ``time_call``, and as one CUDA graph (or why
    its capture failed)."""
    ms = time_call(fn, *args, iters=iters, **kwargs) * 1e3
    try:
        graph = graph_ms(lambda: fn(*args, **kwargs), iters=iters)
    except RuntimeError as err:
        graph = f"capture failed: {str(err).splitlines()[0]}"
    return ms, graph


def fmt_graph(graph: Any) -> str:
    return f"[{graph:.4f} as a graph]" if isinstance(graph, float) \
        else f"[{graph}]"


def domain_gate(label: str, launches: int, shards: int, counts, want,
                per_shard: int = 1) -> None:
    if launches != per_shard * shards:
        fail(f"domain {label}: {launches} kernel launches, expected "
             f"{per_shard} a shard for {shards} shards")
    if counts != want:
        fail(f"domain {label}: the call issued {counts}, its comm contract "
             f"says {want}")


def domain_stencil(dev, u, coeffs, measured, card: str
                   ) -> List[Dict[str, Any]]:
    """The stencil through ``shard_cuda`` at every decomposition: bitwise
    against the single-device kernel at the same tile point, one launch a
    shard, the contract's halo exchanges; the call, its resident step
    (halo exchange + kernels on buffers already sharded) and the
    distribute/collect apart."""
    k = get_kernel("stencil7")
    fn = k.backend("shard_cuda").fn
    def local(block):
        return s7_kernel.laplacian(block, *coeffs)
    bound = measured["stencil7"]["bound_ms"]
    plain_ms = measured["stencil7"]["plain_ms"]
    u1 = u[:ONE_PLANE].clone()
    cases = [(label, u, kw, s) for label, kw, s in STENCIL_SHARDED]
    cases.append((f"one plane per shard {ONE_PLANE}", u1,
                  {"decomp": "slab", "num_shards": ONE_PLANE}, ONE_PLANE))
    out = []
    for label, vol, kw, shards in cases:
        if not out or vol is u1:
            # the single-device kernel on this volume, at the same tile point
            want = s7_kernel.laplacian(vol, *coeffs)
            single_graph = graph_ms(lambda: s7_kernel.laplacian(vol, *coeffs))
        got, launches, counts = sharded_path(
            lambda: k(vol, *coeffs, backend="shard_cuda", **kw),
            s7_kernel.laplacian)
        if not torch.equal(got, want):
            fail(f"domain stencil7 {label}: {int(got.ne(want).sum())} "
                 f"cells differ from the single-device kernel")
        domain_gate(f"stencil7 {label}", launches, shards, counts,
                    contract_for("stencil7", "shard_cuda", kw, (vol,)))
        ms, graph = composite_ms(fn, (vol, *coeffs), kw)
        sz, sy = domain.stencil_grid(vol, kw.get("num_shards"), kw["decomp"],
                                     kw.get("shard_grid"))
        shards_ = domain.distribute_stencil(vol, sz, sy)
        kept = domain.stencil_step(shards_, local)
        resident = events_ms(lambda: domain.stencil_step(shards_, local))
        try:
            resident_graph = graph_ms(
                lambda: domain.stencil_step(shards_, local))
        except RuntimeError as err:
            resident_graph = f"capture failed: {str(err).splitlines()[0]}"
        dist = events_ms(lambda: domain.distribute_stencil(vol, sz, sy))
        coll = events_ms(lambda: domain.collect_stencil(shards_, kept))
        del shards_, kept
        scale = "" if vol is u else " (8 x 512 x 512: bound not scaled)"
        print(f"domain stencil7 {label} [shard_cuda] on {card}: bitwise "
              f"equal, {launches} launches, {counts['ppermute']} ppermutes; "
              f"single-device kernel {single_graph:.4f} ms (CUDA graph); "
              f"composite {ms:.4f} ms (time_call) {fmt_graph(graph)}; "
              f"resident step {resident:.4f} ms {fmt_graph(resident_graph)}"
              f", distribute {dist:.4f}, collect {coll:.4f}; bound "
              f"{bound:.4f} ms (PERF.md section 2){scale}; e_i "
              f"{plain_ms / ms:.3f}")
        out.append({"case": label, "launches": launches,
                    "collectives": counts, "single_graph_ms": single_graph,
                    "ms": ms, "graph_ms": graph, "resident_ms": resident,
                    "resident_graph_ms": resident_graph,
                    "distribute_ms": dist, "collect_ms": coll,
                    "bound_ms": bound if vol is u else None,
                    "e_i": plain_ms / ms})
    return out


def domain_streams(stream_args, measured, card: str
                   ) -> Dict[str, List[Dict[str, Any]]]:
    """The five stream ops through ``shard_triton`` at 2, 4 and 8 shards:
    copy/mul/add/triad bitwise against the single-device kernels, dot
    within ORACLE_TOL with one psum."""
    out = {}
    for op, xs in stream_args.items():
        name = f"babelstream.{op}"
        k = get_kernel(name)
        wrapper = getattr(bs_kernel, op)
        fn = k.backend("shard_triton").fn
        want = wrapper(*xs)
        single = graph_ms(lambda: wrapper(*xs))
        out[name] = []
        for s in SHARD_COUNTS:
            got, launches, counts = sharded_path(
                lambda: k(*xs, backend="shard_triton", num_shards=s),
                wrapper)
            if op == "dot":
                err = max_abs_err(got, want, *conformance.ORACLE_TOL[name],
                                  f"domain {name} {s} shards")
            elif not torch.equal(got, want):
                fail(f"domain {name} {s} shards: {int(got.ne(want).sum())} "
                     f"elements differ from the single-device kernel")
            else:
                err = 0.0
            domain_gate(f"{name} {s} shards", launches, s, counts,
                        contract_for(name, "shard_triton", {}, xs),
                        2 if op == "dot" else 1)
            ms, graph = composite_ms(fn, xs, {"num_shards": s})
            bound = measured[name]["bound_ms"]
            plain_ms = measured[name]["plain_ms"]
            match = f"max abs err {err:.3g}" if op == "dot" \
                else "bitwise equal"
            print(f"domain {name} {s} shards [shard_triton] on {card}: "
                  f"{match}, {launches} launches, {counts['psum']} psum; "
                  f"single-device kernel {single:.4f} ms (CUDA graph); "
                  f"composite {ms:.4f} ms (time_call) {fmt_graph(graph)}; "
                  f"bound {bound:.4f} ms (PERF.md section 2); e_i "
                  f"{plain_ms / ms:.3f}")
            out[name].append({"case": f"{s} shards", "launches": launches,
                              "collectives": counts, "max_abs_err": err,
                              "single_graph_ms": single, "ms": ms,
                              "graph_ms": graph, "bound_ms": bound,
                              "e_i": plain_ms / ms})
    return out


def domain_bude(deck, measured, card: str) -> List[Dict[str, Any]]:
    """miniBUDE through ``shard_cuda`` at 2, 4 and 8 shards of bm1's poses:
    bitwise against the single-device kernel."""
    name = "minibude.fasten"
    k = get_kernel(name)
    fn = k.backend("shard_cuda").fn
    want = bude_kernel.fasten(*deck)
    single = graph_ms(lambda: bude_kernel.fasten(*deck))
    out = []
    for s in SHARD_COUNTS:
        got, launches, counts = sharded_path(
            lambda: k(*deck, backend="shard_cuda", num_shards=s),
            bude_kernel.fasten)
        if not torch.equal(got, want):
            fail(f"domain {name} {s} shards: {int(got.ne(want).sum())} poses "
                 f"differ from the single-device kernel")
        domain_gate(f"{name} {s} shards", launches, s, counts,
                    contract_for(name, "shard_cuda", {}, deck))
        ms, graph = composite_ms(fn, deck, {"num_shards": s})
        bound = measured[name]["bound_ms"]
        plain_ms = measured[name]["plain_ms"]
        print(f"domain {name} {s} shards [shard_cuda] on {card}: bitwise "
              f"equal, {launches} launches ({BUDE['nposes'] // s} poses a "
              f"shard); single-device kernel {single:.4f} ms (CUDA graph); "
              f"composite {ms:.4f} ms (time_call) {fmt_graph(graph)}; bound "
              f"{bound:.4f} ms (PERF.md section 2); e_i {plain_ms / ms:.3f}")
        out.append({"case": f"{s} shards", "launches": launches,
                    "collectives": counts, "single_graph_ms": single,
                    "ms": ms, "graph_ms": graph, "bound_ms": bound,
                    "e_i": plain_ms / ms})
    return out


def domain_hf(hf_inputs, measured, card: str) -> List[Dict[str, Any]]:
    """Hartree-Fock N = 128 STO-3G through ``shard_cuda`` (each shard's
    ``twoel_slab`` over its l range, one psum) at 2, 4 and 8 shards:
    within ORACLE_TOL of the single-device build, a second call the same
    bits."""
    name = "hartree_fock.twoel"
    n, ngauss = HF_CASES[0]
    pos, dens = hf_inputs[n, ngauss]
    k = get_kernel(name)
    fn = k.backend("shard_cuda").fn
    want = k(pos, dens, ngauss=ngauss, backend="cuda")
    single = graph_ms(lambda: k(pos, dens, ngauss=ngauss, backend="cuda"),
                      iters=HF_SHARD_ITERS)
    label = f"{name} N={n} ngauss={ngauss}"
    bound = measured[label]["bound_ms"]
    plain_ms = measured[label]["plain_ms"]
    out = []
    for s in SHARD_COUNTS:
        kw = {"ngauss": ngauss, "num_shards": s}
        got, launches, counts = sharded_path(
            lambda: k(pos, dens, backend="shard_cuda", **kw),
            hf_kernel.twoel_slab)
        err = max_abs_err(got, want, *HF_TOL, f"domain {label} {s} shards")
        again = k(pos, dens, backend="shard_cuda", **kw)
        if not torch.equal(again, got):
            fail(f"domain {label} {s} shards: a second call differs in "
                 f"{int(again.ne(got).sum())} entries")
        domain_gate(f"{label} {s} shards", launches, s, counts,
                    contract_for(name, "shard_cuda", {}, (pos, dens)))
        ms, graph = composite_ms(fn, (pos, dens), kw, iters=HF_SHARD_ITERS)
        print(f"domain {label} {s} shards [shard_cuda] on {card}: max abs "
              f"err {err:.3g} against the single-device build, a second "
              f"call bit-identical, {launches} twoel_slab launches, "
              f"{counts['psum']} psum; single-device build {single:.4f} ms "
              f"(CUDA graph); composite {ms:.4f} ms (time_call) "
              f"{fmt_graph(graph)}; bound {bound:.4f} ms (PERF.md section "
              f"2); e_i {plain_ms / ms:.3f}")
        out.append({"case": f"N={n} {s} shards", "launches": launches,
                    "collectives": counts, "max_abs_err": err,
                    "single_graph_ms": single, "ms": ms, "graph_ms": graph,
                    "bound_ms": bound, "e_i": plain_ms / ms})
    return out


def domain_cards(dev, u, coeffs, stream_args) -> None:
    """The card count, and with two or more cards the slab stencil and dot
    with their shards spread over the cards (one shard a card)."""
    cards = torch.cuda.device_count()
    print(f"domain decomposition: torch.cuda.device_count() = {cards}")
    if cards < 2:
        print("domain decomposition: shards spread over distinct cards were "
              "not exercised (one card: every shard above shared it)")
        return
    s = domain.resolve_num_shards(STENCIL_L, None,
                                  domain.mesh_device_count(dev))
    got, launches, counts = sharded_path(
        lambda: get_kernel("stencil7")(u, *coeffs, backend="shard_cuda",
                                       num_shards=s), s7_kernel.laplacian)
    if not torch.equal(got, s7_kernel.laplacian(u, *coeffs)):
        fail(f"domain stencil7 slab {s} over {cards} cards: not bitwise "
             f"equal to the single-device kernel")
    domain_gate(f"stencil7 slab {s} over {cards} cards", launches, s, counts,
                {**domain.NO_COLLECTIVES, "ppermute": 2})
    a, b = stream_args["dot"]
    s = domain.resolve_num_shards(STREAM_N, None,
                                  domain.mesh_device_count(dev))
    got, launches, counts = sharded_path(
        lambda: get_kernel("babelstream.dot")(a, b, backend="shard_triton",
                                              num_shards=s), bs_kernel.dot)
    err = max_abs_err(got, bs_kernel.dot(a, b),
                      *conformance.ORACLE_TOL["babelstream.dot"],
                      f"domain babelstream.dot {s} shards over {cards} cards")
    domain_gate(f"babelstream.dot {s} over {cards} cards", launches, s,
                counts, domain.ONE_PSUM, 2)
    print(f"domain decomposition over {cards} cards: stencil7 slab {s} "
          f"bitwise equal, babelstream.dot max abs err {err:.3g}")


def domain_phase(dev, u, coeffs, stream_args, deck, hf_inputs, measured,
                 card: str) -> Dict[str, Any]:
    """Phase 11: every science kernel's composite on the card (all shards on
    one card: ``domain.placement``), after the conformance cells of the
    sharded backends and their comm-contract audits on the small cases."""
    for name in KERNELS:
        k = get_kernel(name)
        for backend in ("torch_shard", COMPOSITE[name]):
            err = conformance.check_backend(name, backend, device=dev)
            args, kwargs = conformance.case_tensors(name, dev)
            audit = k.audit_comm_contract(*args, backend=backend, **kwargs)
            twin = conformance.BITWISE_TWIN.get((name, backend))
            print(f"conformance case {name}[{backend}] max abs err "
                  f"{err:.3g}" + (f", bitwise equal to {twin}" if twin
                                  else "")
                  + f"; comm contract held in {len(audit)} variant(s): "
                  + "; ".join(f"{v or 'default'} {c}" for v, c in audit))
    with domain.placement([dev]):
        out = {"stencil7": domain_stencil(dev, u, coeffs, measured, card),
               **domain_streams(stream_args, measured, card),
               "minibude.fasten": domain_bude(deck, measured, card),
               SLAB: domain_hf(hf_inputs, measured, card)}
    domain_cards(dev, u, coeffs, stream_args)
    return out


# ---- slice 15: the static auditor ------------------------------------------
#: the hand-written kernels' symbols, as a launch plan spells them without
#: template arguments; a profiled kernel of any other name (an ATen copy
#: around a composite's shards) is not the plan's
PLAN_SYMBOLS = (
    "stencil7_kernel", "stream_kernel", "dot_kernel", "bude_pair_kernel",
    "fasten_kernel", "pair_table_kernel", "eri_kernel", "fock_gather_kernel",
    "flash_kernel", "flash_wgmma_kernel", "decode_kernel", "wkv_step_kernel",
    "wkv_delta_kernel", "wkv_scan_kernel", "wkv_output_kernel")
#: the kernels ``tune(search="model")`` runs for at their main-path shape
MODEL_SEARCH = ("stencil7", "minibude.fasten")
#: the registry backends that launch a hand-written kernel
HAND_BACKENDS = ("cuda", "triton", "shard_cuda", "shard_triton")


def kernel_symbol(name: str) -> str:
    """A profiled kernel's name as a launch plan spells it: no return type,
    no anonymous namespace, no parameter list; a Triton kernel's name
    without a specialisation suffix (``stream_kernel_0d1d2d``)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    base = name.split("<")[0]
    if base not in PLAN_SYMBOLS:
        for sym in PLAN_SYMBOLS:
            if base.startswith(sym + "_"):
                return sym
    return name


def profiled_launches(fn: Callable[[], Any], tmp: Path
                      ) -> List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]]:
    """(symbol, grid, block) of each hand-written kernel that ``fn()``
    launched, in launch order, from one profile's Chrome trace (Kineto's
    kernel records carry their grid and block); other kernels (an ATen
    copy around a composite's shards) are left out."""
    with profiling(host=False) as prof:
        fn()
    path = tmp / "plan_profile.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and FILLER_KERNEL not in e.get("name", "")),
                     key=lambda e: e["ts"])
    return [(kernel_symbol(e["name"]), tuple(e["args"]["grid"]),
             tuple(e["args"]["block"])) for e in kernels
            if kernel_symbol(e["name"]).split("<")[0] in PLAN_SYMBOLS]


def hold_plans(calls, tmp: Path, tries: int = 3) -> int:
    """Hold each call's plan to the profiler's launches: every call once
    (builds and Triton compiles stay out of the profile), then all of them
    in one profile, its launches cut into each call's in turn.  A profile
    that lost records (``profiling``) is taken again.  Returns the
    launches held."""
    for _, _, fn, args, call in calls:
        fn(*args, **call)
    torch.cuda.synchronize()
    plans = [plan for _, plan, _, _, _ in calls]
    want = [launch for plan in plans for launch in plan]
    for _ in range(tries):
        got = profiled_launches(
            lambda: [fn(*args, **call) for _, _, fn, args, call in calls],
            tmp)
        if got == want:
            return len(want)
    at = 0
    for label, plan, _, _, _ in calls:
        if got[at:at + len(plan)] != plan:
            fail(f"{label}: the plan says {plan}, the profiler recorded "
                 f"{got[at:at + len(plan)]}")
        at += len(plan)
    fail(f"the profiler recorded {len(got)} launches, the plans {len(want)}")


def plan_points(k, backend: str, args, kwargs,
                tuned: Dict[str, Dict[str, Any]]) -> Dict[str, Dict]:
    """The default call and phase 1b's tuned point of ``k`` (its tunables
    that ``backend``'s space has), where a valid point of the space at
    these inputs agrees with it."""
    points = {"default": {}}
    best = next((t["params"] for t in tuned.values()
                 if t["record"] == k.name), None)
    space = k.tunable_space(backend)
    if best and space is not None:
        point = {n: v for n, v in best.items() if n in space.params}
        valid = space.valid_points(*args, **kwargs)
        if point and any(all(p[n] == v for n, v in point.items())
                         for p in valid):
            points["tuned"] = point
    return points


def audit_phase(dev, card: str, tuned: Dict[str, Dict[str, Any]],
                tuned_path: Path, tmp: Path,
                main_args: Dict[str, Tuple[Tuple[Any, ...], Dict[str, Any]]]
                ) -> Dict[str, Any]:
    """Phase 13: the static auditor (``core/analysis/``) on the card's host.

    (a) every hand-written cell's launch plans against the launches the
    profiler records, at its conformance case on the card, at the declared
    default and at phase 1b's tuned point: the kernel symbols, in order,
    and each one's grid and block must equal the plan's (the one check
    that the Python plans follow the C launchers' arithmetic), each cell
    timed by ``time_backend`` with telemetry on; (b) ``audit_registry``,
    joined to phase 1b's tuning cache and (a)'s telemetry: no finding that
    is not waived outside the drift pass, no skip in a hand-written cell,
    the chip ``nvidia-h100``; the drift pass's ratios and findings
    printed, not gated;
    (c) ``tune(search="model")`` for stencil7 and miniBUDE at their
    main-path shapes: at most ``MODEL_TOP_K`` points timed, the pick a
    valid point, its time printed beside phase 1b's best point."""
    from repro_torch.core import analysis
    from repro_torch.core.analysis import trace as plan_trace
    from repro_torch.core.portable import registry
    chip = detect_chip()
    if chip.name != "nvidia-h100":
        fail(f"detect_chip() names {chip.name}, not nvidia-h100")
    cells = []
    for kernel, backend in analysis.audit_pairs():
        if backend in HAND_BACKENDS:
            args, kwargs = conformance.case_tensors(kernel, dev)
            cells.append((kernel, backend, "", get_kernel(kernel).backend(
                backend).fn, args, kwargs))
    # the plans the float32 cases do not reach: bfloat16 prefill (the
    # wgmma kernel's grid) and decode, and the one-token WKV with a state
    for name in ATTN:
        args, kwargs = conformance.case_tensors(name, dev)
        cells.append((name, "cuda", " bfloat16",
                      get_kernel(name).backend("cuda").fn, tuple(
                          a.to(torch.bfloat16) if a.is_floating_point()
                          else a for a in args), kwargs))
    r, k_, v, lw, u = conformance.case_tensors(RWKV, dev)[0]
    state = torch.zeros(r.shape[0], r.shape[1], r.shape[3], r.shape[3],
                        device=dev)
    cells.append((RWKV, "cuda", " S = 1", wkv_kernel.wkv, tuple(
        x[:, :, :1] for x in (r, k_, v, lw)) + (u, state), {}))
    calls = []
    for kernel, backend, what, fn, args, kwargs in cells:
        k = registry.get(kernel)
        for label, point in plan_points(k, backend, args, kwargs,
                                        tuned).items():
            call = {**kwargs, **point}
            plan = [(launch.symbol, tuple(launch.grid), tuple(launch.block))
                    for _, launch in plan_trace.trace(fn, args,
                                                      call).launches]
            label = (f"plan {kernel}[{backend}]{what} {label} "
                     f"{fmt_point(point) or '(declared defaults)'}")
            print(f"{label}: " + ", ".join(f"{sym} grid {g} block {b}"
                                           for sym, g, b in plan))
            calls.append((label, plan, fn, args, call))
    t0 = time.perf_counter()
    held = hold_plans(calls, tmp)
    print(f"launch plans: {held} launches of {len(calls)} calls held to the "
          f"profiler's symbols, grids and blocks on {card} "
          f"({time.perf_counter() - t0:.1f} s)")
    rec = tel.configure("on")
    try:
        for kernel, backend, what, fn, args, kwargs in cells:
            if not what:
                registry.get(kernel).time_backend(*args, backend=backend,
                                                  iters=5, **kwargs)
        jsonl = tmp / "audit_telemetry.jsonl"
        tel.write_jsonl(str(jsonl), rec)
    finally:
        tel.configure("off")

    t0 = time.perf_counter()
    report = analysis.audit_registry(tuning_cache=str(tuned_path),
                                     telemetry_trace=str(jsonl))
    audit_s = time.perf_counter() - t0
    s = report["summary"]
    print(f"static audit on {card}: chip {report['chip']}, {s['cells']} "
          f"cells, {s['audited']} audited, {s['findings']} finding(s), "
          f"{s['waived']} waived, {s['skips']} skip(s), {audit_s:.1f} s")
    gated = [f for f in report["findings"] if f["pass_name"] != "drift"]
    for f in report["findings"]:
        print(f"  FINDING {f['kernel']}[{f['backend']}] {f['pass_name']}/"
              f"{f['code']}: {f['message']}"
              + (" (not gated)" if f["pass_name"] == "drift" else ""))
    if gated:
        fail(f"the static audit has {len(gated)} finding(s) outside the "
             f"drift pass")
    hand_skips = [x for x in report["skips"]
                  if x["backend"] in HAND_BACKENDS]
    if hand_skips:
        fail(f"the static audit skipped hand-written cells: {hand_skips}")
    drift = report["drift"]
    print(f"drift on {card}: {drift['joined']} of {drift['measurements']} "
          f"measurements joined, calibration {drift['calibration']}, band "
          f"{drift['band']}x (not gated)")
    for r in drift["records"]:
        if r["backend"] in HAND_BACKENDS:
            print(f"  drift {r['kernel']}[{r['backend']}] {r['source']} "
                  f"{r['shape'][:60]} {r['params']}: measured "
                  f"{r['seconds'] * 1e3:.5f} ms, predicted "
                  f"{(r['predicted_s'] or 0) * 1e3:.5f} ms, ratio "
                  f"{r.get('ratio')}, relative {r.get('relative')}")
    for f in report["waived"]:
        print(f"  waived {f['kernel']}[{f['backend']}] {f['code']}: "
              f"{f['waive_reason']}")

    searched = {}
    for name in MODEL_SEARCH:
        k = get_kernel(name)
        args, kwargs = main_args[name]
        cache = tuning.TuningCache(tmp / f"model_{name}.json")
        t0 = time.perf_counter()
        r = tuning.tune(k, *args, backend=k.native, cache=cache,
                        search="model", iters=ITERS, **kwargs)
        valid = k.tunable_space(k.native).valid_points(*args, **kwargs)
        if r.skipped is not None or r.params not in valid:
            fail(f"tune(search='model') {name}: skipped ({r.skipped}) or "
                 f"picked {r.params}, not a valid point")
        if len(r.swept) > tuning.MODEL_TOP_K:
            fail(f"tune(search='model') {name} timed {len(r.swept)} points, "
                 f"more than {tuning.MODEL_TOP_K}")
        best = tuned[name]
        print(f"model search {name}[{k.native}] on {card}: "
              f"{len(r.swept)} of {len(valid)} points timed "
              f"({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{fmt_point(p)} {sec * 1e3:.4f} ms"
                          for p, sec in r.swept)
              + f"; pick {fmt_point(r.params)} {r.seconds * 1e3:.4f} ms "
              f"against phase 1b's best ({best['search']}) "
              f"{fmt_point(best['params'])} {best['ms']:.4f} ms by time_call "
              f"({best['graph_ms']:.4f} as a graph; ranked by "
              f"{best['timer']})")
        searched[name] = {"params": r.params, "ms": r.seconds * 1e3,
                          "timed": len(r.swept), "points": len(valid),
                          "phase_1b": best["params"],
                          "phase_1b_search": best["search"],
                          "phase_1b_ms": best["ms"]}
    return {"launches_held": held, "findings": len(gated),
            "drift_findings": s["findings"] - len(gated),
            "drift": {"joined": drift["joined"],
                      "calibration": drift["calibration"]},
            "model_search": searched, "audit_s": audit_s}


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

    # ---- 11. domain decomposition --------------------------------------
    t0 = time.perf_counter()
    sharded = domain_phase(dev, u, coeffs, stream_args, deck, hf_inputs,
                           measured, card)
    new_s["domain decomposition"] = time.perf_counter() - t0
    print(f"domain decomposition phase: "
          f"{new_s['domain decomposition']:.1f} s")
    for rec in records:
        mine = sharded.get(rec["name"])
        if mine is None:    # Hartree-Fock's composite runs the slab wrapper
            continue
        phase11 = sum(c["launches"] for c in mine)
        rec["launches_by_path"] = {"main path": rec["launches"],
                                   "domain decomposition": phase11}
        rec["launches"] += phase11
        kernel = "hartree_fock.twoel" if rec["name"] == SLAB \
            else rec["name"]
        rec["sharded"] = {"kernel": kernel, "backend": COMPOSITE[kernel],
                          "cases": mine}

    # ---- 6. attention at the serving shapes ----------------------------
    attn: Dict[str, Dict[str, Any]] = {}
    for c in attention_cases(dev, args.seed):
        k = get_kernel(c.name)
        if k.default_backend(*c.args, **c.kwargs) != k.native:
            fail(f"{c.name}: the default backend on CUDA tensors is not "
                 f"the hand-written {k.native!r}")
        want = c.plain(*c.args, **c.kwargs)
        err = max_abs_err(k(*c.args, **c.kwargs), want, *BF16_TOL,
                          f"{c.name} at the serving shape")
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
                max_abs_err(attn_kernel.flash(*c.args, **c.kwargs, **pt),
                            want, *BF16_TOL,
                            f"{c.name} at the serving shape {pt}")
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
              f"positions, admitted K rows and needed V rows; the whole cache would be "
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
    # phase 12 (c), serving: the roofline of two real steps on these weights
    t0 = time.perf_counter()
    roofline_chip(card)
    roofline = roofline_serving(params, cfg, dev, args.seed, card)
    new_s["roofline"] = time.perf_counter() - t0
    os.environ[tuning.CACHE_ENV] = str(untuned_path)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    attn_recs = {}
    for name in ATTN:
        rec = attn_recs[name] = {"name": name,
                                 "route": get_kernel(name).native,
               "source": SOURCE[name], "replaces": REPLACES[name],
               "launches": served["launches"][name],
               "device_launches": served["device_launches"][name]}
        if name == ATTN[1]:
            rec["graph_replays"] = served["replays"]
            rec["launches_counted"] = (
                "launches: wrapper calls on every main path "
                "(launches_by_path): while each granite-3-8b engine and "
                "the deepseek-moe-16b engine is built and serves the "
                "trace, a layer's in the warm-up step and in the capture, "
                "which records the kernels into the graph and runs none (a "
                "replay runs no wrapper), and a layer's in each decode "
                "step of the archs served through generate. "
                "device_launches: decode_kernels by torch.profiler in a "
                "second run of the trace on each granite-3-8b engine, 40 "
                "in each of its graph_replays")
        else:
            rec["launches_counted"] = (
                "launches: wrapper calls on every main path "
                "(launches_by_path): while each granite-3-8b engine and "
                "the deepseek-moe-16b engine is built, a layer's in the "
                "warm-up and in the capture of each prefill bucket (a "
                "replay runs no wrapper); on the archs served through "
                "generate, a self-attention layer's a prefill "
                "(whisper-tiny's encoder layers included) and a "
                "cross-attention layer's a prefill and a decode step; "
                "device_launches: flash_wgmma_kernels by torch.profiler in "
                "a second run of the trace on each granite-3-8b engine")
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

    # ---- 9. the remaining model families --------------------------------
    t0 = time.perf_counter()
    by_path = {"granite-3-8b engines": dict(served["launches"])}
    families = {MOE_ARCH: serve_moe(dev, args.seed, bw, card)}
    for arch, layers, rows, plen, new in FAMILIES:
        families[arch] = serve_family(arch, layers, rows, plen, new, dev,
                                      args.seed, card)
    free_card()
    cases9 = family_kernel_cases(dev, args.seed, bw, peak_bf16, card)
    new_s["model families"] = time.perf_counter() - t0
    print(f"model families phase: {new_s['model families']:.1f} s")

    # ---- 10. training ---------------------------------------------------
    t0 = time.perf_counter()
    free_card()
    trained = train_phase(
        dev, args.seed, card, peak_bf16,
        after_timed=lambda *a: roofline_training(*a, card=card))
    roofline["train"] = trained.pop("after_timed")
    new_s["training"] = time.perf_counter() - t0
    print(f"training {TRAIN_ARCH}: {json.dumps(trained)}")
    print(f"training phase: {new_s['training']:.1f} s")
    for arch, fam in families.items():
        by_path[arch] = fam["launches"]
        summary = {k: fam[k] for k in ("cut", "param_gb", "launches",
                                       "tok_per_s", "logits_err",
                                       "logits_span",
                                       "max_memory_allocated_gb")}
        print(f"model family {arch}: {json.dumps(summary)}")
    for name, rec in attn_recs.items():
        rec["launches"] = sum(counts[name] for counts in by_path.values())
        rec["launches_by_path"] = {path: counts[name]
                                   for path, counts in by_path.items()}
        rec["family_cases"] = [c for c in cases9 if c["case"].startswith(
            "decode" if name == ATTN[1] else "flash")]
    # ---- 12. the roofline: the dry run's full-size cells -----------------
    t0 = time.perf_counter()
    cells = dryrun_phase(card)
    new_s["roofline"] += time.perf_counter() - t0
    # ---- 13. the static auditor ------------------------------------------
    t0 = time.perf_counter()
    free_card()
    audited = audit_phase(
        dev, card, tuned, tuned_path, tmp,
        {"stencil7": ((u, *coeffs), {}), "minibude.fasten": (deck, {})})
    new_s["static audit"] = time.perf_counter() - t0
    print(f"static audit: {json.dumps(audited)}")
    print(f"static audit phase: {new_s['static audit']:.1f} s")
    print("roofline shares on " + card + ": " + ", ".join(
        f"{k} {v['share']:.2%} ({v['terms']['dominant']})"
        for k, v in roofline.items()))
    print(json.dumps({"roofline": {k: {"share": v["share"],
                                       "measured_ms": v["measured_ms"],
                                       "bound_s": v["terms"]["bound_s"],
                                       "flops": v["terms"]["flops"],
                                       "hbm_bytes": v["terms"]["hbm_bytes"],
                                       "dominant": v["terms"]["dominant"]}
                                   for k, v in roofline.items()},
                      "dryrun": cells}))
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
