"""Quickstart for the PyTorch port: the paper's portable-kernel workflow.

    PYTHONPATH=src python examples/torch_quickstart.py                # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``:

1. Run a science kernel (BabelStream triad) through the portable registry
   on two backends: ``torch`` (the oracle) and ``triton`` (the kernel
   written by hand for Hopper).
2. Validate the kernel against the oracle (the paper's C1), then tune it
   (``tune_registered``: every declared ``block`` x ``num_warps`` point,
   persisted in the tuning cache, ``$REPRO_TORCH_TUNING_CACHE`` or
   ``~/.cache/repro_torch/tuning.json``).
3. Time both backends, the kernel at its tuned point, and compute the
   performance-portability metric Phi-bar (Eq. 4, the paper's C3).
4. Take one train step on the granite-3-8b smoke config (float32 masters,
   AdamW, remat, the plain ``torch`` attention), then generate a few
   tokens from the updated masters, as the reference's step 4 does.

On the CPU (``--device cpu``) the hand-written backend cannot run: steps
1-3 say why (the availability probe's reason) and time only the oracle,
and Phi-bar is not measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels  # noqa: F401  (registers the kernels)
from repro_torch.configs import get_config
from repro_torch.core import Efficiency, get_kernel, phi_bar
from repro_torch.core.tuning import TuningCache, tune_registered
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.models import transformer as T
from repro_torch.training.serve_step import generate
from repro_torch.training.train_step import (TrainConfig, make_train_state,
                                             train_step)


def science_kernels(device: torch.device, cache: TuningCache) -> None:
    print("== 1-3. portable kernels, validation, tuning, Phi-bar ==")
    rng = np.random.default_rng(0)
    n = 1 << 24 if device.type == "cuda" else 1 << 18
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)

    triad = get_kernel("babelstream.triad")
    print("backends:", sorted(triad.backends), "on", device)
    t_ref = triad.time_backend(b, c, backend="torch")
    print(f"torch: {t_ref * 1e3:.4f} ms, Eq.2 FoM "
          f"{triad.figure_of_merit(t_ref, b, c)}")
    reason = triad.backend("triton").unavailable_reason()
    if reason is None and device.type != "cuda":
        reason = "the triton kernel runs on CUDA tensors"
    if reason is not None:
        print(f"triton: not run here ({reason}); Phi-bar not measured")
        r = tune_registered("babelstream.triad", b, c, backend="triton",
                            cache=cache)
        print(f"tune_registered: skipped ({r.skipped})")
        return
    err = triad.validate(b, c, backend="triton")
    print(f"triad validated against torch; max abs err {err:.3g}")
    r = tune_registered("babelstream.triad", b, c, backend="triton",
                        cache=cache)
    how = "from the cache" if r.cached else (
        f"{len(r.swept)} points, {r.search}, ranked by {r.timer}")
    print(f"tuned ({how}, {cache.path}): {r.params}")
    t_default = triad.time_backend(b, c, backend="triton")
    t_tuned = triad.time_backend(b, c, backend="triton", **r.params)
    print(f"triton on {torch.cuda.get_device_name(device)}: "
          f"{t_default * 1e3:.4f} ms at the declared defaults, "
          f"{t_tuned * 1e3:.4f} ms at the tuned point")
    out = triad(b, c, tuned=True, tuning_cache=cache)
    assert torch.equal(out, triad(b, c, backend="triton", **r.params))
    e = Efficiency(torch.cuda.get_device_name(device), "triad", 1 / t_tuned,
                   1 / t_ref)
    print(f"Eq.4 Phi-bar (single kernel, tuned): {phi_bar([e]):.3f}")


def lm_steps(device: torch.device) -> None:
    print("\n== 4. LM: a train step + generation on the granite-3-8b smoke "
          "config ==")
    cfg = get_config("granite-3-8b", smoke=True)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device, dtype=cfg.pdtype())
    tcfg = TrainConfig(microbatches=2)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4)).batch_at(0)
    state, metrics = train_step(make_train_state(params, tcfg),
                                to_device(batch, device), cfg=cfg, tcfg=tcfg)
    print(f"train step: loss {float(metrics['loss']):.4f}, grad norm "
          f"{float(metrics['grad_norm']):.4f}, lr {float(metrics['lr']):.2e}")
    # generate from the float32 masters: each layer casts them at use
    params = state["params"]
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))).to(
        device)
    toks = generate(params, cfg, prompt, max_new_tokens=8, cache_len=64)
    print("generated token ids:", toks[0].tolist())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tuning-cache", default=None,
                    help="tuning cache file (default: "
                         "$REPRO_TORCH_TUNING_CACHE or "
                         "~/.cache/repro_torch/tuning.json)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    device = torch.device(args.device)
    science_kernels(device, TuningCache(args.tuning_cache))
    lm_steps(device)
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
