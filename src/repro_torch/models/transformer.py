"""Model assembly: the dense decoder-only LM over a *layer plan*.

The port of the dense decoder-only part of ``repro/models/transformer.py``.
The reference stacks homogeneous runs of layers and drives them with
``lax.scan``; here a scan segment is a Python loop over its layers, whose
parameters are a list of per-layer dicts.  Caches keep the reference's
layout — ``{"eager": {id: cache}, "segments": [stacked cache]}``, a segment's
leaves stacked on a leading layer axis — so a slot of the serving engine is
one row of a few tensors, and each layer writes its view of them in place.

Weights are held once in the compute dtype (the reference casts every layer
to it at each call, ``cast_tree``, which gives the same values); the final
norm's scale stays in the parameter dtype, as the reference uses it uncast.

RWKV layers (``models/rwkv.py``) keep their recurrent state in the cache:
``{"wkv": (B, H, 64, 64) float32, "tm_last", "cm_last": (B, 1, d)}`` a
layer, stacked like the K/V of an attention segment, and written in place.

MoE, SSM, cross-attention and encoder branches wait for later slices of the
port and raise ``NotImplementedError`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (Params, apply_mlp, apply_norm,
                                       dense_init, embed_init, mlp_init,
                                       norm_init)


# --------------------------------------------------------------------------
# layer plan
# --------------------------------------------------------------------------
def eager_layer_ids(cfg: ModelConfig) -> Tuple[int, ...]:
    ids = set()
    if cfg.is_moe and cfg.dense_prefix_layers:
        ids.update(range(cfg.dense_prefix_layers))
    ids.update(cfg.global_layers)
    return tuple(sorted(ids))


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, Any]]:
    eager = eager_layer_ids(cfg)
    plan: List[Tuple[str, Any]] = []
    lo = 0
    for e in eager:
        if e > lo:
            plan.append(("scan", (lo, e)))
        plan.append(("eager", e))
        lo = e + 1
    if lo < cfg.n_layers:
        plan.append(("scan", (lo, cfg.n_layers)))
    return plan


def layer_kind(cfg: ModelConfig, idx: int) -> Dict[str, Any]:
    """Structural description of layer ``idx``."""
    is_global = idx in cfg.global_layers
    use_moe = cfg.is_moe and idx >= cfg.dense_prefix_layers
    window = 0 if (is_global or not cfg.window) else cfg.window
    return {"moe": use_moe, "window": window,
            "cross": cfg.is_encoder_decoder, "rwkv": cfg.rwkv,
            "ssm": cfg.ssm_state > 0}


def _require_dense(cfg: ModelConfig, kind: Dict[str, Any]) -> None:
    missing = [k for k in ("moe", "ssm", "cross") if kind[k]]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the {'/'.join(missing)} layer branch is not ported "
            f"yet (ROADMAP.md, Queue 1 item 8); the port runs dense "
            f"decoder-only attention layers and RWKV layers")


# --------------------------------------------------------------------------
# single decoder layer
# --------------------------------------------------------------------------
def layer_init(gen: torch.Generator, cfg: ModelConfig, idx: int,
               device) -> Params:
    kind = layer_kind(cfg, idx)
    _require_dense(cfg, kind)
    d, dt = cfg.d_model, cfg.cdtype()
    if kind["rwkv"]:
        # rwkv keeps its pre-norms with the block, as the reference's
        # init_params adds them
        return {**rwkv_mod.rwkv_layer_init(gen, d, cfg.d_ff, d // 64, dt,
                                           device, cfg.n_layers),
                "ln_tm": norm_init(d, cfg.norm, dt, device),
                "ln_cm": norm_init(d, cfg.norm, dt, device)}
    return {
        "ln1": norm_init(d, cfg.norm, dt, device),
        "attn": attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, dt, device, cfg.n_layers),
        "ln2": norm_init(d, cfg.norm, dt, device),
        "mlp": mlp_init(gen, d, cfg.dense_ff(), cfg.mlp, dt, device,
                        cfg.n_layers),
    }


def _rwkv_layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      cache: Optional[Params],
                      wkv_backend: Optional[str]) -> torch.Tensor:
    """Time mix + channel mix; writes the state and last tokens into
    ``cache`` in place (the WKV kernel writes its state there itself)."""
    st = cache or {}
    h, (wkv, tm_last) = rwkv_mod.time_mix_apply(
        p["tm"], apply_norm(p["ln_tm"], x, cfg.norm,
                            bf16_mul=cfg.norm_bf16_mul), cfg.d_model // 64,
        state=st.get("wkv"), last_x=st.get("tm_last"),
        use_chunked=x.shape[1] > 1, wkv_backend=wkv_backend)
    x = x + h
    h2, cm_last = rwkv_mod.channel_mix_apply(
        p["cm"], apply_norm(p["ln_cm"], x, cfg.norm,
                            bf16_mul=cfg.norm_bf16_mul),
        last_x=st.get("cm_last"))
    if cache is not None:
        if wkv is not cache["wkv"]:
            cache["wkv"].copy_(wkv)
        cache["tm_last"].copy_(tm_last)
        cache["cm_last"].copy_(cm_last)
    return x + h2


def layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                kind: Dict[str, Any], *, positions: torch.Tensor,
                cache: Optional[Params] = None,
                wkv_backend: Optional[str] = None) -> torch.Tensor:
    """One pre-norm layer (attention + MLP, or RWKV time + channel mix);
    writes ``cache`` in place.  ``wkv_backend`` picks the RWKV layers' WKV
    (``models/rwkv.py::resolve_wkv_backend``)."""
    _require_dense(cfg, kind)
    if kind["rwkv"]:
        return _rwkv_layer_apply(p, x, cfg, cache, wkv_backend)
    h = apply_norm(p["ln1"], x, cfg.norm, bf16_mul=cfg.norm_bf16_mul)
    a_out, _ = attn.attention_apply(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions, use_rope=cfg.use_rope,
        rope_theta=cfg.rope_theta, causal=True, window=kind["window"],
        cache=None if cache is None else cache["self"],
        backend=cfg.attn_backend)
    x = x + a_out
    h = apply_norm(p["ln2"], x, cfg.norm, bf16_mul=cfg.norm_bf16_mul)
    return x + apply_mlp(p["mlp"], h, cfg.mlp)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn from ``generator`` on ``device``, in the
    compute dtype (tables padded to ``cfg.padded_vocab``)."""
    if cfg.is_encoder_decoder:
        _require_dense(cfg, layer_kind(cfg, 0))
    dt = cfg.cdtype()
    params: Params = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt,
                            device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.pdtype(), device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dt, device)
    plan = layer_plan(cfg)
    params["eager"] = {str(i): layer_init(generator, cfg, i, device)
                       for kind, i in plan if kind == "eager"}
    params["segments"] = [
        [layer_init(generator, cfg, i, device) for i in range(lo, hi)]
        for kind, (lo, hi) in ((k, a) for k, a in plan if k == "scan")]
    return params


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts and lists (a tuple comes
    back as a list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _first_leaf(tree: Any) -> Any:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree


def params_from_jax(tree: Params, cfg: ModelConfig,
                    device="cpu") -> Params:
    """The reference's ``init_params`` pytree (numpy arrays, or anything
    ``numpy.asarray`` takes) -> the port's parameters on ``device``.

    Stacked ``segments`` leaves are split into per-layer dicts; every array
    is cast to the compute dtype, except the final norm's scale, which
    keeps the parameter dtype, so both packages compute the same thing.
    """
    def leaf(dtype):
        def conv(a):
            # through float32: numpy has no bfloat16 that torch reads
            arr = np.array(a, dtype=np.float32)      # a writable copy
            return torch.from_numpy(arr).to(device=device, dtype=dtype)
        return conv

    cdt = cfg.cdtype()
    out: Params = {"embed": leaf(cdt)(tree["embed"]),
                   "final_norm": tree_map(leaf(cfg.pdtype()),
                                          tree["final_norm"])}
    if "unembed" in tree:
        out["unembed"] = leaf(cdt)(tree["unembed"])
    out["eager"] = {k: tree_map(leaf(cdt), v)
                    for k, v in tree["eager"].items()}
    out["segments"] = []
    for seg in tree["segments"]:
        stacked = tree_map(leaf(cdt), seg)
        out["segments"].append(
            [tree_map(lambda t, i=i: t[i].clone(), stacked)
             for i in range(len(_first_leaf(stacked)))])
    return out


def leftpad_positions(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Positions for left-padded prompts: (B,) true lengths -> (B, S) int32.

    Pad tokens get position -1, which the position-based attention mask
    treats as "empty": pad keys are never attended, pad queries produce
    garbage that callers must ignore, and their KV-cache writes are dropped.
    Real tokens get positions 0..L-1, so decode continues at position L.
    """
    idx = torch.arange(seq_len, dtype=torch.int32, device=lengths.device)
    pos = idx[None, :] - (seq_len - lengths.to(torch.int32))[:, None]
    return torch.where(pos >= 0, pos, -1)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _run_layers(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, caches: Optional[Params] = None,
                wkv_backend: Optional[str] = None) -> torch.Tensor:
    """Execute the layer plan; each layer writes its cache view in place."""
    seg_i = 0
    for tag, arg in layer_plan(cfg):
        if tag == "eager":
            c = None if caches is None else caches["eager"][str(arg)]
            x = layer_apply(params["eager"][str(arg)], x, cfg,
                            layer_kind(cfg, arg), positions=positions,
                            cache=c, wkv_backend=wkv_backend)
            continue
        kind = layer_kind(cfg, arg[0])    # homogeneous within a segment
        seg_cache = None if caches is None else caches["segments"][seg_i]
        for i, lp in enumerate(params["segments"][seg_i]):
            # layer i's views of the segment's stacked leaves
            c = None if seg_cache is None else tree_map(
                lambda t, i=i: t[i], seg_cache)
            x = layer_apply(lp, x, cfg, kind, positions=positions, cache=c,
                            wkv_backend=wkv_backend)
        seg_i += 1
    return x


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None, last_only: bool = False,
            lengths: Optional[torch.Tensor] = None,
            attn_backend: Optional[str] = None,
            wkv_backend: Optional[str] = None
            ) -> Tuple[torch.Tensor, Optional[Params]]:
    """tokens (B, S) -> (logits (B, S, V), caches).

    ``caches`` (from ``init_caches``) are written in place and returned.
    ``last_only`` projects logits for the final position only (prefill
    serving).  ``lengths`` (B,) are true prompt lengths of a left-padded
    batch (pads masked via position -1, see ``leftpad_positions``), ignored
    when ``positions`` are given.  ``attn_backend`` overrides
    ``cfg.attn_backend`` for this call, ``wkv_backend`` picks the RWKV
    layers' WKV (``models/rwkv.py::resolve_wkv_backend``).  Padded vocab
    columns get -1e9.
    The reference's third result, the MoE auxiliary loss, comes with MoE.
    """
    if attn_backend is not None:
        cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
    if cfg.is_encoder_decoder:
        _require_dense(cfg, layer_kind(cfg, 0))
    b, s = tokens.shape
    if positions is None:
        if lengths is not None:
            positions = leftpad_positions(lengths, s)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
    x = params["embed"][tokens]
    if not cfg.use_rope and not cfg.rwkv:
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    x = _run_layers(params, x, cfg, positions=positions, caches=caches,
                    wkv_backend=wkv_backend)
    x = apply_norm(params["final_norm"], x, cfg.norm,
                   bf16_mul=cfg.norm_bf16_mul)
    if last_only:
        x = x[:, -1:]
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ unembed
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits, caches


def cache_seq_lens(cfg: ModelConfig, seq_len: int) -> Dict[str, Any]:
    """Per-plan-entry KV sequence lengths of ``init_caches(cfg, _,
    seq_len)``: ``{"eager": {id: len}, "segments": [len]}``.  A
    sliding-window layer's ring buffer is ``min(window, seq_len)`` long;
    everything else stores the full ``seq_len``."""
    def one(idx: int) -> int:
        kind = layer_kind(cfg, idx)
        return min(kind["window"], seq_len) if kind["window"] else seq_len

    out: Dict[str, Any] = {"eager": {}, "segments": []}
    for tag, arg in layer_plan(cfg):
        if tag == "eager":
            out["eager"][str(arg)] = one(arg)
        else:
            out["segments"].append(one(arg[0]))  # homogeneous segment
    return out


def init_caches(cfg: ModelConfig, batch: int, seq_len: int,
                device) -> Params:
    """Decode caches per the layer plan (ring buffers for SWA layers),
    K/V in the compute dtype; an RWKV layer's state float32 and its last
    tokens in the compute dtype.  A segment's leaves are stacked on a
    leading layer axis."""
    lens = cache_seq_lens(cfg, seq_len)

    def one(n_layers: int, cache_len: int) -> Params:
        if cfg.rwkv:
            shape = (n_layers, batch)
            d, cdt = cfg.d_model, cfg.cdtype()
            return {"wkv": torch.zeros(*shape, d // 64, 64, 64,
                                       dtype=torch.float32, device=device),
                    "tm_last": torch.zeros(*shape, 1, d, dtype=cdt,
                                           device=device),
                    "cm_last": torch.zeros(*shape, 1, d, dtype=cdt,
                                           device=device)}
        c = attn.init_cache(n_layers * batch, cache_len, cfg.n_kv_heads,
                            cfg.head_dim, cfg.cdtype(), device)
        return {"self": {k: t.view(n_layers, batch, *t.shape[1:])
                         for k, t in c.items()}}

    caches: Params = {"eager": {}, "segments": []}
    seg_i = 0
    for tag, arg in layer_plan(cfg):
        _require_dense(cfg, layer_kind(cfg, arg if tag == "eager"
                                       else arg[0]))
        if tag == "eager":
            c = one(1, lens["eager"][str(arg)])
            caches["eager"][str(arg)] = tree_map(lambda t: t[0], c)
        else:
            caches["segments"].append(
                one(arg[1] - arg[0], lens["segments"][seg_i]))
            seg_i += 1
    return caches
