"""Multi-pod dry run: every (arch x shape x mesh) cell, costed per rank.

The port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell for 512 forced host devices and reads the compiled
program, the port builds each cell on ``meta`` tensors, distributes it by
the sharding policy (``distributed/sharding.py``) as DTensors over a fake
world of 256 or 512 ranks (``launch/hostsim.py``, ``launch/mesh.py``), and
runs the step once under the op-cost walker (``core/op_cost.py``), on the
``torch`` routes:

  * the 16x16 single-pod mesh and the 2x16x16 multi-pod mesh, every
    applicable cell; a cell that ``cell_applicable`` refuses records the
    reason, and any other failure names the op and fails the cell;
  * each repeated unit (a segment's layers, the encoder's layers, a train
    step's microbatches) is traced short and multiplied
    (``op_cost.with_multiplicity``), so a 95-layer cell stays tractable;
  * per rank: the argument bytes of the placements, the walker's peak of
    the storage the step allocates, and the roofline on ``NVIDIA_H100``
    (the reference names the chip it is written for, ``TPU_V5E``).

The record keeps the reference's keys: ``lower_s`` is the seconds spent
building and distributing the cell, ``compile_s`` those of the walker's
traces.  It adds ``fallbacks`` (ops DTensor failed on, with how each ran:
on contiguous blocks or replicated on which mesh dims) and their shapes,
``kernel_calls`` and ``kernel_costing`` (how the registry calls were
costed), and ``traces``.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

Artifacts land in build/dryrun/<mesh>/<arch>__<shape>.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.op_cost import OpCost, measure, with_multiplicity
from repro_torch.core.roofline import (NVIDIA_H100, RooflineTerms,
                                       model_flops, roofline_from_cost)
from repro_torch.distributed.sharding import (ShardingPolicy,
                                              tree_local_bytes)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import forward, layer_plan
from repro_torch.training.serve_step import decode_step
from repro_torch.training.train_step import TrainConfig, train_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../build/dryrun")


def tcfg_for(cfg: ModelConfig, shape: ShapeConfig, dp: int) -> TrainConfig:
    """Microbatching heuristic: bound live activations to ~1 row/chip for the
    widest models, 2 rows otherwise."""
    b = shape.global_batch
    # widest models, MoE (dispatch/combine tensors) and SSM-hybrid
    # (associative-scan intermediates, (B,S,Di,N) fp32) get 1 row/chip
    rows_per_chip = 1 if (cfg.d_model >= 8192 or cfg.is_moe
                          or cfg.ssm_state > 0) else 2
    micro = max(dp * rows_per_chip, 1)
    microbatches = max(1, b // micro) if b % micro == 0 else 1
    while b % microbatches:
        microbatches //= 2
    return TrainConfig(microbatches=max(microbatches, 1), remat=True)


# --------------------------------------------------------------------------
# repeated units
# --------------------------------------------------------------------------
def repeat_units(cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: Optional[TrainConfig] = None) -> Dict[str, int]:
    """The repeated units of a cell and their counts: ``segments/<i>``
    (a scan segment's layers), ``encoder`` (an encoder's layers) and, for
    a train cell, ``microbatches``."""
    units: Dict[str, int] = {}
    seg = 0
    for tag, arg in layer_plan(cfg):
        if tag == "scan":
            units[f"segments/{seg}"] = arg[1] - arg[0]
            seg += 1
    if cfg.is_encoder_decoder:
        units["encoder"] = cfg.n_encoder_layers
    if shape.kind == "train" and tcfg is not None:
        units["microbatches"] = tcfg.microbatches
    return units


def cut_layers(tree: Any, depths: Dict[str, int]) -> Any:
    """``tree`` (parameters, a train state or caches) with segment ``i``
    cut to ``depths["segments/<i>"]`` layers and the encoder to
    ``depths["encoder"]``: a list of layers is sliced, a stacked cache
    leaf is sliced on its leading layer axis."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cut_layers(v, depths) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cut_layers(v, depths) for v in tree)
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "segments":
            out[k] = [_cut(s, depths.get(f"segments/{i}"))
                      for i, s in enumerate(v)]
        elif k == "encoder" and isinstance(v, dict) and "layers" in v:
            out[k] = {**v, "layers": _cut(v["layers"],
                                          depths.get("encoder"))}
        else:
            out[k] = cut_layers(v, depths)
    return out


def _cut(seg: Any, depth: Optional[int]) -> Any:
    if depth is None:
        return seg
    if isinstance(seg, list):
        return seg[:depth]
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t[:depth], seg)


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------
def build_cell(cfg: ModelConfig, shape: ShapeConfig, policy: ShardingPolicy,
               depths: Optional[Dict[str, int]] = None
               ) -> Tuple[Any, Tuple[Any, ...], int]:
    """(fn, args, tokens per step): the cell's step and its arguments as
    DTensors placed by ``policy``, every repeated unit cut to ``depths``
    (all of it by default)."""
    depths = depths or {}
    hints = policy.hints()
    if shape.kind == "train":
        tcfg = tcfg_for(cfg, shape, policy.dp_size)
        m = depths.get("microbatches", tcfg.microbatches)
        rows = shape.global_batch // tcfg.microbatches * m
        state = cut_layers(S.train_state_specs(cfg, tcfg), depths)
        batch = S.train_batch_specs(
            cfg, dataclasses.replace(shape, global_batch=rows))
        fn = functools.partial(
            train_step, cfg=cfg,
            tcfg=dataclasses.replace(tcfg, microbatches=m), hints=hints)
        args = (policy.tree_shardings(state), policy.batch_shardings(batch))
        return fn, args, shape.global_batch * shape.seq_len

    params = policy.tree_shardings(cut_layers(S.params_specs(cfg), depths))
    if shape.kind == "prefill":
        inp = policy.batch_shardings(S.prefill_input_specs(cfg, shape))

        def prefill_fn(params_, inputs):
            logits, _, _ = forward(params_, cfg, inputs["tokens"],
                                   frames=inputs.get("frames"),
                                   patches=inputs.get("patches"),
                                   hints=hints, last_only=True,
                                   attn_backend="torch", wkv_backend="torch")
            return logits[:, -1]
        return prefill_fn, (params, inp), shape.global_batch * shape.seq_len

    inp = S.decode_input_specs(cfg, shape)
    caches = policy.cache_shardings(cut_layers(inp.pop("caches"), depths))
    inp = policy.batch_shardings(inp)

    def decode_fn(params_, inputs, caches_):
        return decode_step(params_, cfg, inputs["tokens"],
                           inputs["positions"], caches_,
                           memory=inputs.get("memory"), hints=hints,
                           attn_backend="torch", wkv_backend="torch")
    return decode_fn, (params, inp, caches), shape.global_batch


@contextlib.contextmanager
def _quiet_dtensor():
    """DTensor warns at every redistribution it splits into several
    collectives; a cell makes thousands.  Errors still print."""
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


def cost_cell(cfg: ModelConfig, shape: ShapeConfig, policy: ShardingPolicy,
              kernel_adjusted: bool = False) -> Dict[str, Any]:
    """The walker's figures of one cell: ``{"total", "base"}`` (OpCost with
    and without multiplicity), ``argument_bytes`` (one rank's share of the
    full-size arguments), ``tokens``, ``traces``, ``lower_s``,
    ``compile_s``."""
    from torch.distributed.tensor.experimental import implicit_replication
    tcfg = tcfg_for(cfg, shape, policy.dp_size) \
        if shape.kind == "train" else None
    units = repeat_units(cfg, shape, tcfg)
    t0 = time.perf_counter()
    _, full_args, tokens = build_cell(cfg, shape, policy)
    arg_bytes = tree_local_bytes(full_args)
    del full_args
    lower_s = time.perf_counter() - t0
    traces = []

    def trace(depths: Dict[str, int]) -> OpCost:
        fn, args, _ = build_cell(cfg, shape, policy, depths)
        with implicit_replication(), _quiet_dtensor():
            out, cost = measure(fn, *args, kernel_adjusted=kernel_adjusted)
        cost.output_bytes = tree_local_bytes(out)
        traces.append(dict(depths))
        return cost

    t1 = time.perf_counter()
    # a train step of one microbatch skips the accumulation: trace two
    base = {"microbatches": min(2, units["microbatches"])} \
        if "microbatches" in units else {}
    total, first = with_multiplicity(trace, units, base_depths=base)
    return {"total": total, "base": first, "argument_bytes": arg_bytes,
            "tokens": tokens, "traces": len(traces), "lower_s": lower_s,
            "compile_s": time.perf_counter() - t1}


VARIANTS = {
    # cfg overrides; the special "_kernel_adjusted" key costs the registry
    # kernels' calls by their own least flops and bytes
    "baseline": {},
    "attn_bf16": {"attn_bf16_intermediates": True},
    "zero1": {"zero1_weights": True},
    "stopgrad": {"moe_stopgrad_dispatch": True},
    "bf16_norm": {"norm_bf16_mul": True},
    "flash": {"_kernel_adjusted": True},
    "opt": {"attn_bf16_intermediates": True, "zero1_weights": True,
            "moe_stopgrad_dispatch": True, "norm_bf16_mul": True,
            "_kernel_adjusted": True},
}


def _write(out_dir: str, record: Dict[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str, variant: str = "baseline", *,
             mesh: Any = None, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Cost one cell, write its artifact, return its record.  ``mesh``,
    ``cfg`` and ``shape`` replace the production mesh, ``get_config(arch)``
    and ``SHAPES[shape_name]`` (smoke cells)."""
    cfg = cfg or get_config(arch)
    overrides = dict(VARIANTS.get(variant, {}))
    kernel_adjusted = overrides.pop("_kernel_adjusted", False)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    mesh_tag = "multipod_2x16x16" if multi_pod else "pod_16x16"
    if mesh is not None:
        mesh_tag = "x".join(str(s) for s in mesh.shape)
    ok, reason = cell_applicable(cfg, shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "variant": variant,
        "kind": shape.kind, "status": "skipped", "reason": reason,
    }
    if not ok:
        _write(out_dir, record)
        return record

    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    n_chips = mesh.size()
    policy = ShardingPolicy(mesh, cfg)
    c = cost_cell(cfg, shape, policy, kernel_adjusted)
    total = c["total"]
    terms = roofline_from_cost(total, NVIDIA_H100, base=c["base"],
                               argument_bytes=c["argument_bytes"],
                               output_bytes=int(total.output_bytes))
    kind = "train" if shape.kind == "train" else "serve"
    mflops = model_flops(cfg.active_params(), c["tokens"],
                         "train" if kind == "train" else "serve")
    useful_ratio = mflops / (terms.flops * n_chips) if terms.flops else 0.0
    record.update(_record_body(terms, total, n_chips, mflops, useful_ratio,
                               c, kernel_adjusted))
    _write(out_dir, record)
    return record


def _record_body(terms: RooflineTerms, total: OpCost, n_chips: int,
                 mflops: float, useful_ratio: float, c: Dict[str, Any],
                 kernel_adjusted: bool) -> Dict[str, Any]:
    return {
        "status": "ok",
        "n_chips": n_chips,
        "chip": NVIDIA_H100.name,
        "lower_s": round(c["lower_s"], 2),
        "compile_s": round(c["compile_s"], 2),
        "per_chip": {
            "flops": terms.flops,
            "hbm_bytes": terms.hbm_bytes,
            "collective_bytes": terms.collective_bytes,
            "argument_bytes": terms.argument_bytes,
            "output_bytes": terms.output_bytes,
            "temp_bytes": terms.temp_bytes,
            "peak_bytes": terms.peak_bytes,
            "xla_flops_flat": terms.xla_flops,
            "xla_bytes_flat": terms.xla_bytes,
            "unknown_trip_loops": terms.unknown_trip_loops,
        },
        "roofline_s": {
            "compute": terms.compute_s,
            "memory": terms.memory_s,
            "collective": terms.collective_s,
        },
        "dominant": terms.dominant,
        "bound_s": terms.bound_s,
        "collectives": terms.collectives,
        "model_flops_total": mflops,
        "useful_flops_ratio": useful_ratio,
        "tokens_per_step": c["tokens"],
        "fits_hbm": terms.peak_bytes <= NVIDIA_H100.hbm_bytes,
        "fallbacks": {k: int(v) for k, v in
                      sorted(total.fallbacks.items())},
        "fallback_shapes": sorted(total.fallback_shapes),
        "kernel_calls": {k: int(v) for k, v in
                         sorted(total.kernel_calls.items())},
        "kernel_costing": ("kernel_adjusted: each registry call costed by "
                           "its kernel's least_flops and its inputs' and "
                           "outputs' bytes" if kernel_adjusted else
                           "baseline: each registry call's plain version "
                           "traced op by op (the WKV chunk by chunk)"),
        "traces": c["traces"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()
    if args.variant != "baseline":
        args.out = args.out.rstrip("/") + f"_{args.variant}"

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    t_all = time.perf_counter()
    for multi in meshes:
        tag = "multipod_2x16x16" if multi else "pod_16x16"
        out_dir = os.path.join(args.out, tag)
        for arch in archs:
            for shape in shapes:
                t0 = time.perf_counter()
                try:
                    rec = run_cell(arch, shape, multi, out_dir,
                                   args.variant)
                except Exception as e:  # a failing cell is a bug: surface it
                    traceback.print_exc()
                    failures.append((tag, arch, shape, repr(e)))
                    print(f"FAIL  {tag:18s} {arch:24s} {shape:12s} {e!r}",
                          flush=True)
                    continue
                if rec["status"] == "skipped":
                    print(f"SKIP  {tag:18s} {arch:24s} {shape:12s} "
                          f"{rec['reason'][:60]}", flush=True)
                else:
                    pb = rec["per_chip"]["peak_bytes"] / 2 ** 30
                    print(f"OK    {tag:18s} {arch:24s} {shape:12s} "
                          f"dom={rec['dominant']:10s} "
                          f"bound={rec['bound_s']*1e3:10.2f}ms "
                          f"peak={pb:7.2f}GiB "
                          f"fallbacks={sum(rec['fallbacks'].values())} "
                          f"{time.perf_counter() - t0:6.1f}s", flush=True)
    print(f"\n{time.perf_counter() - t_all:.1f} s in all")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", *f)
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
