"""End-to-end training script for the PyTorch port, on one device.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300            # GPU
    PYTHONPATH=src python examples/torch_train_lm.py --resume               # restart
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --full --steps 10      # GPU

The port of ``examples/train_lm.py`` without the mesh and the sharding
policy: a ~100M-parameter variant of an arch (or, with ``--full``,
stablelm-1.6b at full width and depth: 8 x 4096 tokens a step in 4
microbatches), float32 masters with bf16 compute, the deterministic
seekable data pipeline with prefetch, checkpoint and restart (preemption
safe), straggler monitoring, a heartbeat and gradient accumulation.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (DataConfig, Prefetcher, SyntheticLM,
                                       to_device)
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     StragglerMonitor)
from repro_torch.models import transformer as T
from repro_torch.models.common import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import (TrainConfig, make_train_state,
                                             train_step)

FULL_ARCH = "stablelm-1.6b"


def scale_config(cfg, d_model=512, n_layers=8):
    """~100M-parameter variant of an assigned arch (same family)."""
    heads = max(d_model // 128, 4)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=heads,
        n_kv_heads=max(heads // 4, 1), d_ff=d_model * 3,
        head_dim=d_model // heads, vocab_size=32768,
        global_layers=tuple(g for g in cfg.global_layers if g < n_layers))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--full", action="store_true",
                    help=f"train {FULL_ARCH} at full width and depth "
                         f"(8 x 4096 tokens, 4 microbatches)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU")
    device = torch.device(args.device)

    if args.full:
        cfg = get_config(FULL_ARCH)
        args.batch, args.seq, args.microbatches = 8, 4096, 4
    else:
        cfg = scale_config(get_config(args.arch), args.d_model, args.layers)
    tcfg = TrainConfig(
        microbatches=args.microbatches, remat=True,
        opt=AdamWConfig(lr_peak=3e-4, warmup_steps=min(20, args.steps),
                        decay_steps=args.steps))

    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device, dtype=cfg.pdtype())
    print(f"arch={cfg.name} params={count_params(params) / 1e6:.1f}M "
          f"({cfg.param_dtype} masters, {cfg.compute_dtype} compute) "
          f"device={device}")

    state = make_train_state(params, tcfg)
    del params
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=args.seed))
    data.seek(start_step)                 # replay-free restart
    pipe = Prefetcher(data, depth=2)

    guard = PreemptionGuard().install()
    hb = Heartbeat(os.path.join(args.ckpt_dir, "heartbeat"), interval_s=10.0)
    straggler = StragglerMonitor()
    step = start_step
    for batch_np in pipe:
        if step >= args.steps or guard.should_stop:
            break
        t0 = time.perf_counter()
        state, metrics = train_step(state, to_device(batch_np, device),
                                    cfg=cfg, tcfg=tcfg)
        loss = float(metrics["loss"])     # synchronises with the device
        dt = time.perf_counter() - t0
        if straggler.observe(step, dt):
            print(f"[straggler] step {step} took {dt:.2f}s "
                  f"(ema {straggler.ema:.2f}s)")
        hb.beat(step)
        step += 1
        if step % 10 == 0 or args.full:
            print(f"step {step:4d} loss {loss:7.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:7.1f}ms "
                  f"{args.batch * args.seq / dt:.0f} tok/s")
        if step % args.ckpt_every == 0 or guard.should_stop:
            mgr.save(step, state, metadata={"arch": cfg.name},
                     blocking=False)
    pipe.close()
    mgr.wait()
    mgr.save(step, state, metadata={"arch": cfg.name})
    print(f"finished at step {step}; checkpoint in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
