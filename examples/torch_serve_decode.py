"""Serving driver for the PyTorch port: continuous batching on the slot
engine, each prefill bucket and the decode step captured once as CUDA
graphs.

    PYTHONPATH=src python examples/torch_serve_decode.py                # GPU
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
    PYTHONPATH=src python examples/torch_serve_decode.py --full \\
        --cache-layout paged --threaded

The port's counterpart of ``examples/serve_decode.py``.  Requests arrive
on a Poisson trace with ragged prompt lengths and are admitted into freed
KV-cache slots between decode steps.  The engine runs two call shapes that
never change as requests arrive and finish: a prefill a bucket of the
prefill ladder and one (num_slots, 1) decode step.  On the GPU each is
captured once as a CUDA graph when the engine is built and replayed at
every admission and step (``decode_traces == 1`` and every prefill a
replay, asserted on the GPU).  On the CPU both run eagerly.

``--cache-layout paged`` serves from a page pool with per-slot block
tables; ``--threaded`` runs ``run_threaded`` (an injector thread, an
admission thread, the decode loop on this thread).  ``--full`` serves
granite-3-8b at full width and depth (random bf16 weights, 16.75 GB;
8 slots, a 4096-slot cache, buckets 512 and 2048), else its smoke config.
After serving, two finished requests are replayed through unbatched
``serve_step.generate`` and must give the same greedy tokens.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving import (ServingEngine, latency_summary,
                                 synthetic_trace)
from repro_torch.training import serve_step as SS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true",
                    help="full width and depth, at chip_smoke.py's serving "
                         "shapes (needs the GPU)")
    ap.add_argument("--cache-layout", default="contiguous",
                    choices=["contiguous", "paged"])
    ap.add_argument("--threaded", action="store_true",
                    help="serve with run_threaded")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="mean request arrival rate (requests/second)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "engine eagerly on the CPU")
    dev = torch.device(args.device)
    if args.full:
        shape = dict(num_slots=8, cache_len=4096, prefill_buckets=(512, 2048))
        requests, min_prompt, max_prompt, max_new = 16, 64, 2048, 32
    else:
        shape = dict(num_slots=4, cache_len=128, prefill_buckets=(8, 16))
        requests, min_prompt, max_prompt, max_new = 12, 4, 16, 16
    requests = args.requests or requests
    cfg = get_config(args.arch, smoke=not args.full)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    t0 = time.perf_counter()
    engine = ServingEngine(params, cfg, cache_layout=args.cache_layout,
                           **shape)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    loop = "run_threaded" if args.threaded else "run"
    print(f"{cfg.name} on {card}: {args.cache_layout} layout, {loop}, "
          f"{shape}; attention prefill={engine.attn_backends['prefill']} "
          f"decode={engine.attn_backends['decode']}; engine built in "
          f"{time.perf_counter() - t0:.2f} s")

    trace = synthetic_trace(requests, vocab_size=cfg.vocab_size,
                            rate=args.rate, min_prompt=min_prompt,
                            max_prompt=max_prompt, max_new_tokens=max_new,
                            seed=args.seed)
    t_start = time.perf_counter()
    done = engine.run_threaded(trace) if args.threaded else engine.run(trace)
    dt = time.perf_counter() - t_start

    for req in sorted(done, key=lambda r: r.uid):
        print(f"req {req.uid:3d} prompt_len {req.prompt_len:4d} "
              f"latency {req.latency() * 1e3:8.1f} ms "
              f"tokens {req.generated[:8]}...")
    lat = latency_summary(done)
    s = engine.stats
    print(f"\nserved {len(done)} requests, {s['tokens_generated']} tokens "
          f"in {dt:.2f}s ({s['tokens_generated'] / dt:.1f} tok/s)")
    print(f"latency p50 {lat['p50_latency_s'] * 1e3:.1f} ms "
          f"p95 {lat['p95_latency_s'] * 1e3:.1f} ms; "
          f"ttft p50 {lat['p50_ttft_s'] * 1e3:.1f} ms "
          f"p95 {lat['p95_ttft_s'] * 1e3:.1f} ms"
          + (f"; itl p50 {lat['p50_itl_s'] * 1e3:.2f} ms "
             f"p95 {lat['p95_itl_s'] * 1e3:.2f} ms"
             if "p95_itl_s" in lat else ""))
    print(f"captured shapes: prefill x{s['prefill_traces']} "
          f"({s['prefill_replays']} replays of {s['prefill_calls']} calls) "
          f"decode x{s['decode_traces']} ({s['decode_steps']} steps)")
    if len(done) != requests:
        raise SystemExit(f"the engine drained {len(done)}/{requests}")
    if dev.type == "cuda" and s["decode_traces"] != 1:
        raise SystemExit(f"decode_traces {s['decode_traces']}: the decode "
                         f"step must be captured exactly once")
    if dev.type == "cuda" and s["prefill_replays"] != s["prefill_calls"]:
        raise SystemExit(f"{s['prefill_replays']} of {s['prefill_calls']} "
                         f"prefills replayed a bucket's graph")

    # two finished requests replayed alone through unbatched generate
    for req in sorted(done, key=lambda r: r.uid)[:2]:
        want = SS.generate(params, cfg, torch.from_numpy(
            np.asarray(req.prompt, np.int64)[None]).to(dev),
            max_new_tokens=len(req.generated),
            cache_len=shape["cache_len"])[0].tolist()
        match = req.generated == want
        print(f"tokens equal unbatched generate (req {req.uid}): "
              f"{'OK' if match else 'MISMATCH'}")
        if not match:
            raise SystemExit("batched decode diverged from unbatched")


if __name__ == "__main__":
    main()
