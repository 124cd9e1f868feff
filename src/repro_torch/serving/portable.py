"""The serving engine as a registry entry: ``serving.engine``.

The port of ``repro/serving/portable.py`` for the contiguous layout.  The
"kernel" is a host-side serving loop, and what conformance checks is its
token stream on a fixed trace (the reference's ``conformance_trace``):

  * ``unbatched`` (oracle) — each request decoded alone through
    ``training.serve_step.generate``;
  * ``engine_contiguous`` — the synchronous engine loop over one
    (num_slots, cache_len) KV row a slot.

The engine must reproduce the oracle's greedy tokens exactly
(``ORACLE_TOL["serving.engine"] = "bitwise"``): continuous batching is a
scheduling concern that may never change a token.  The paged and threaded
backends come with the paged layout (ROADMAP).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.core.portable import register_kernel

ARCH = "granite-3-8b"
NUM_SLOTS = 2
CACHE_LEN = 32
PREFILL_BUCKETS = (8, 16)
MAX_NEW = 4
PROMPT_LENS = (3, 9, 12, 5, 16, 1)


def conformance_trace(cfg) -> List[Any]:
    """Fresh deterministic request trace (engines mutate requests): the
    reference's, draw for draw."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(42)
    return [
        Request(uid=i,
                prompt=rng.integers(2, cfg.vocab_size, L).astype(np.int32),
                max_new_tokens=MAX_NEW, arrival_time=0.0)
        for i, L in enumerate(PROMPT_LENS)]


def case_args() -> Tuple[Any, Any]:
    """(params, cfg) of the conformance case: smoke-sized random weights
    from a fixed generator, on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(ARCH, smoke=True)
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg


def _tokens(finished, n_expected: int) -> torch.Tensor:
    if len(finished) != n_expected:
        raise AssertionError(
            f"engine drained {len(finished)}/{n_expected} requests")
    rows = [r.generated for r in sorted(finished, key=lambda r: r.uid)]
    return torch.tensor(rows, dtype=torch.int32)   # (n_requests, MAX_NEW)


def unbatched(params, cfg) -> torch.Tensor:
    from repro_torch.training.serve_step import generate
    device = params["embed"].device
    rows = [generate(params, cfg,
                     torch.from_numpy(r.prompt[None].astype(np.int64))
                     .to(device),
                     max_new_tokens=MAX_NEW, cache_len=CACHE_LEN)[0].cpu()
            for r in conformance_trace(cfg)]
    return torch.stack(rows)


def engine_contiguous(params, cfg) -> torch.Tensor:
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, num_slots=NUM_SLOTS,
                        cache_len=CACHE_LEN,
                        prefill_buckets=PREFILL_BUCKETS)
    trace = conformance_trace(cfg)
    return _tokens(eng.run(trace), len(trace))


kernel = register_kernel(
    "serving.engine", oracle="unbatched",
    doc="continuous-batching serving engine: greedy token streams must "
        "equal unbatched decode")
kernel.add_backend("unbatched", unbatched)
kernel.add_backend("engine_contiguous", engine_contiguous)
