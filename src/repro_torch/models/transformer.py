"""Model assembly: decoder-only and encoder-decoder LMs over a *layer plan*.

The port of ``repro/models/transformer.py``.  The reference stacks
homogeneous runs of layers and drives them with ``lax.scan``; here a scan
segment is a Python loop over its layers, whose parameters are a list of
per-layer dicts.  Layers that differ structurally (deepseek-moe's dense
first layer, hymba's global-attention layers) run as eager entries with
their own parameters, as in the reference.  Caches keep the reference's
layout — ``{"eager": {id: cache}, "segments": [stacked cache]}``, a
segment's leaves stacked on a leading layer axis — so a slot of the
serving engine is one row of a few tensors, and each layer writes its view
of them in place.

Each layer's parameters are cast to the compute dtype where the layer
uses them (``cast_tree``), the embedding rows after the gather and the
unembedding at the logits, as the reference casts them; the final norms'
scales (the decoder's and the encoder's) are used uncast, as there.  So a
trainer keeps float32 masters (``init_params(..., dtype=torch.float32)``,
``params_from_jax(..., dtype=cfg.pdtype())``) and autograd carries the
gradients through the casts to them.  Serving holds its weights in the
compute dtype (the default), and there every cast is the identity: ``.to``
returns the tensor itself, so no copy is made and a captured CUDA graph
reads the weights it always read.  ``remat=True`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does.

A layer is one of:

  * attention + MLP (dense decoder-only archs, and the encoder's layers,
    which attend non-causally);
  * attention + MoE (``models/moe.py``), after ``dense_prefix_layers``
    dense layers; ``forward`` returns the summed load-balance aux loss;
  * hymba's hybrid: attention and an SSM head (``models/ssm.py``) on the
    same normed input, fused as the mean of the two normed outputs; the
    SSM keeps ``{"ssm": (B, Di, N) float32, "conv": (B, 3, Di)}`` in the
    cache beside the K/V, written in place;
  * an encoder-decoder's decoder layer: self-attention, then
    cross-attention to the encoder memory (its K/V recomputed from the
    memory at every call, as the reference does), then the MLP;
  * RWKV (``models/rwkv.py``), whose recurrent state lives in the cache:
    ``{"wkv": (B, H, 64, 64) float32, "tm_last", "cm_last": (B, 1, d)}``.

Vision-stub archs take ``patches`` (B, P, D), added to the first P token
embeddings; audio-stub (encoder-decoder) archs take ``frames`` (B, T, D),
or the ``memory`` that ``encode`` made of them.

``hints`` (``ShardingHints``) are the reference's sharding points: the
residual stream after every sublayer, the logits, and the MoE buffers.
``NO_HINTS`` leaves every tensor as it is; ``distributed/sharding.py``
gives hints that place DTensors on a device mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Params, apply_mlp, apply_norm,
                                       cast_tree, dense_init, embed_init,
                                       mlp_init, norm_init)


# --------------------------------------------------------------------------
# sharding hints (kept abstract so models never import mesh machinery)
# --------------------------------------------------------------------------
def _same(x: Any) -> Any:
    return x


@dataclasses.dataclass(frozen=True)
class ShardingHints:
    """Optional sharding points; the identity by default."""

    activation: Callable[[torch.Tensor], torch.Tensor] = _same
    logits: Callable[[torch.Tensor], torch.Tensor] = _same
    # ZeRO-1 lever: the compute copy of the params with the data and pod
    # axes stripped, so the FSDP gather happens once a step
    params_compute: Callable[[Any], Any] = _same
    # MoE expert-parallel guidance: (G, E, C, D) expert buffers ("gecd") and
    # (G, gs, E, C) dispatch tensors ("gtec")
    moe_constraint: Callable[[torch.Tensor, str], torch.Tensor] = \
        moe_mod.no_constraint


NO_HINTS = ShardingHints()


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
            "ssm": cfg.ssm_state > 0, "causal": True}


# --------------------------------------------------------------------------
# single decoder layer
# --------------------------------------------------------------------------
#: the layer kind of an encoder layer: non-causal attention + dense MLP
ENCODER_KIND = {"moe": False, "window": 0, "cross": False, "rwkv": False,
                "ssm": False, "causal": False}


def layer_init(gen: torch.Generator, cfg: ModelConfig, idx: int, device, *,
               encoder: bool = False,
               dtype: Optional[torch.dtype] = None) -> Params:
    kind = ENCODER_KIND if encoder else layer_kind(cfg, idx)
    d, dt = cfg.d_model, cfg.cdtype() if dtype is None else dtype
    if kind["rwkv"]:
        # rwkv keeps its pre-norms with the block, as the reference's
        # init_params adds them
        return {**rwkv_mod.rwkv_layer_init(gen, d, cfg.d_ff, d // 64, dt,
                                           device, cfg.n_layers),
                "ln_tm": norm_init(d, cfg.norm, dt, device),
                "ln_cm": norm_init(d, cfg.norm, dt, device)}
    p: Params = {
        "ln1": norm_init(d, cfg.norm, dt, device),
        "attn": attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, dt, device, cfg.n_layers),
        "ln2": norm_init(d, cfg.norm, dt, device),
    }
    if kind["moe"]:
        p["moe"] = moe_mod.moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                    cfg.n_shared_experts, cfg.mlp, dt,
                                    device, cfg.n_layers)
    else:
        ff = cfg.d_ff if encoder else cfg.dense_ff()
        p["mlp"] = mlp_init(gen, d, ff, cfg.mlp, dt, device, cfg.n_layers)
    if kind["ssm"]:
        p["ssm"] = ssm_mod.ssm_init(gen, d, cfg.n_heads * cfg.head_dim,
                                    cfg.ssm_state, dt, device, cfg.n_layers)
        p["ln_attn_br"] = norm_init(d, cfg.norm, dt, device)
        p["ln_ssm_br"] = norm_init(d, cfg.norm, dt, device)
    if kind["cross"]:
        p["ln_cross"] = norm_init(d, cfg.norm, dt, device)
        p["cross"] = attn.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                         cfg.head_dim, dt, device,
                                         cfg.n_layers)
    return p


def _rwkv_layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      cache: Optional[Params], wkv_backend: Optional[str],
                      hints: ShardingHints) -> torch.Tensor:
    """Time mix + channel mix; writes the state and last tokens into
    ``cache`` in place (the WKV kernel writes its state there itself)."""
    st = cache or {}
    h, (wkv, tm_last) = rwkv_mod.time_mix_apply(
        p["tm"], apply_norm(p["ln_tm"], x, cfg.norm,
                            bf16_mul=cfg.norm_bf16_mul), cfg.d_model // 64,
        state=st.get("wkv"), last_x=st.get("tm_last"),
        use_chunked=x.shape[1] > 1, wkv_backend=wkv_backend)
    x = hints.activation(x + h)
    h2, cm_last = rwkv_mod.channel_mix_apply(
        p["cm"], apply_norm(p["ln_cm"], x, cfg.norm,
                            bf16_mul=cfg.norm_bf16_mul),
        last_x=st.get("cm_last"))
    if cache is not None:
        if wkv is not cache["wkv"]:
            cache["wkv"].copy_(wkv)
        cache["tm_last"].copy_(tm_last)
        cache["cm_last"].copy_(cm_last)
    return hints.activation(x + h2)


def layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                kind: Dict[str, Any], *, positions: torch.Tensor,
                cache: Optional[Params] = None,
                memory: Optional[torch.Tensor] = None,
                memory_pos: Optional[torch.Tensor] = None,
                wkv_backend: Optional[str] = None,
                hints: ShardingHints = NO_HINTS
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-norm layer of ``kind`` (``layer_kind``, or ``ENCODER_KIND``
    for an encoder layer, whose self-attention is not causal) -> (x, its
    MoE aux loss or None); writes ``cache`` in place.  ``memory`` (B, T, D)
    at ``memory_pos`` feeds the cross-attention of an encoder-decoder's
    decoder layer.  ``wkv_backend`` picks the RWKV layers' WKV
    (``models/rwkv.py::resolve_wkv_backend``); ``hints`` place the residual
    stream after each sublayer and the MoE buffers."""
    if kind["rwkv"]:
        return _rwkv_layer_apply(p, x, cfg, cache, wkv_backend, hints), None
    norm = dict(kind=cfg.norm, bf16_mul=cfg.norm_bf16_mul)
    h = apply_norm(p["ln1"], x, **norm)
    a_out, _ = attn.attention_apply(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions, use_rope=cfg.use_rope,
        rope_theta=cfg.rope_theta, causal=kind["causal"],
        window=kind["window"],
        cache=None if cache is None else cache["self"],
        bf16_intermediates=cfg.attn_bf16_intermediates,
        backend=cfg.attn_backend)
    if kind["ssm"]:
        s_out, (ssm_state, conv_state) = ssm_mod.ssm_apply(
            p["ssm"], h, state=None if cache is None else cache["ssm"],
            conv_state=None if cache is None else cache["conv"])
        # hymba fusion: mean of the two normalized branch outputs
        a_out = 0.5 * (apply_norm(p["ln_attn_br"], a_out, **norm)
                       + apply_norm(p["ln_ssm_br"], s_out, **norm))
        if cache is not None:
            cache["ssm"].copy_(ssm_state)
            cache["conv"].copy_(conv_state)
    x = hints.activation(x + a_out)
    if kind["cross"] and memory is not None:
        h = apply_norm(p["ln_cross"], x, **norm)
        # the cross K/V are projected from the memory at every call, as the
        # reference does (it notes a cross K/V cache as an optimisation)
        mk, mv = attn.cross_kv(p["cross"], memory, cfg.n_kv_heads,
                               cfg.head_dim)
        c_out, _ = attn.attention_apply(
            p["cross"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions, causal=False,
            use_rope=False, memory_kv=(mk, mv), memory_pos=memory_pos,
            backend=cfg.attn_backend)
        x = hints.activation(x + c_out)
    h = apply_norm(p["ln2"], x, **norm)
    if kind["moe"]:
        m_out, aux = moe_mod.moe_apply(
            p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            mlp_kind=cfg.mlp, capacity_factor=cfg.moe_capacity_factor,
            stopgrad_dispatch=cfg.moe_stopgrad_dispatch,
            constraint=hints.moe_constraint)
        return hints.activation(x + m_out), aux
    return hints.activation(x + apply_mlp(p["mlp"], h, cfg.mlp)), None


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights drawn from ``generator`` on ``device``, in the
    compute dtype (tables padded to ``cfg.padded_vocab``); the final norms'
    scales in the parameter dtype.  ``dtype`` puts every leaf in that
    dtype instead: ``cfg.pdtype()`` gives a trainer's float32 masters."""
    dt = cfg.cdtype() if dtype is None else dtype
    ndt = cfg.pdtype() if dtype is None else dtype
    params: Params = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt,
                            device),
        "final_norm": norm_init(cfg.d_model, cfg.norm, ndt, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dt, device)
    plan = layer_plan(cfg)
    params["eager"] = {str(i): layer_init(generator, cfg, i, device,
                                          dtype=dtype)
                       for kind, i in plan if kind == "eager"}
    params["segments"] = [
        [layer_init(generator, cfg, i, device, dtype=dtype)
         for i in range(lo, hi)]
        for kind, (lo, hi) in ((k, a) for k, a in plan if k == "scan")]
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [layer_init(generator, cfg, i, device, encoder=True,
                                  dtype=dtype)
                       for i in range(cfg.n_encoder_layers)],
            "final_norm": norm_init(cfg.d_model, cfg.norm, ndt, device)}
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


def params_from_jax(tree: Params, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's ``init_params`` pytree (numpy arrays, or anything
    ``numpy.asarray`` takes) -> the port's parameters on ``device`` (the
    card unless the caller asks for another).

    Stacked ``segments`` leaves (and the encoder's stacked layers) are split
    into per-layer dicts; every array is cast to the compute dtype, except
    the final norms' scales, which keep the parameter dtype, so both
    packages compute the same thing.  ``dtype`` puts every leaf in that
    dtype instead: ``dtype=cfg.pdtype()`` carries the reference's float32
    parameters across as a trainer's float32 masters.
    """
    def leaf(dtype):
        def conv(a):
            # through float32: numpy has no bfloat16 that torch reads
            arr = np.array(a, dtype=np.float32)      # a writable copy
            return torch.from_numpy(arr).to(device=device, dtype=dtype)
        return conv

    def unstack(seg):
        stacked = tree_map(leaf(cdt), seg)
        return [tree_map(lambda t, i=i: t[i].clone(), stacked)
                for i in range(len(_first_leaf(stacked)))]

    cdt = cfg.cdtype() if dtype is None else dtype
    ndt = cfg.pdtype() if dtype is None else dtype
    out: Params = {"embed": leaf(cdt)(tree["embed"]),
                   "final_norm": tree_map(leaf(ndt), tree["final_norm"])}
    if "unembed" in tree:
        out["unembed"] = leaf(cdt)(tree["unembed"])
    out["eager"] = {k: tree_map(leaf(cdt), v)
                    for k, v in tree["eager"].items()}
    out["segments"] = [unstack(seg) for seg in tree["segments"]]
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": unstack(enc["layers"]),
                          "final_norm": tree_map(leaf(ndt),
                                                 enc["final_norm"])}
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


def _layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
           kind: Dict[str, Any], **kwargs: Any
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``layer_apply`` on the layer's parameters cast to the compute
    dtype (inside a checkpointed layer, so the cast copies are recomputed
    in the backward pass, not kept)."""
    return layer_apply(cast_tree(lp, cfg.cdtype()), x, cfg, kind, **kwargs)


def _run_layers(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, caches: Optional[Params] = None,
                memory: Optional[torch.Tensor] = None,
                memory_pos: Optional[torch.Tensor] = None,
                wkv_backend: Optional[str] = None,
                hints: ShardingHints = NO_HINTS, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Execute the layer plan; each layer writes its cache view in place.
    ``remat`` recomputes each layer in the backward pass.  Returns (x, the
    sum of the MoE layers' aux losses, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seg_i = 0
    for tag, arg in layer_plan(cfg):
        if tag == "eager":
            layers = [(arg, params["eager"][str(arg)],
                       None if caches is None else caches["eager"][str(arg)])]
        else:
            seg_cache = None if caches is None else caches["segments"][seg_i]
            # layer i's views of the segment's stacked leaves
            layers = [(arg[0], lp, None if seg_cache is None else tree_map(
                lambda t, i=i: t[i], seg_cache))
                for i, lp in enumerate(params["segments"][seg_i])]
            seg_i += 1
        for idx, lp, c in layers:       # homogeneous within a segment
            kwargs = dict(positions=positions, cache=c, memory=memory,
                          memory_pos=memory_pos, wkv_backend=wkv_backend,
                          hints=hints)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    _layer, lp, x, cfg, layer_kind(cfg, idx),
                    use_reentrant=False, **kwargs)
            else:
                x, a = _layer(lp, x, cfg, layer_kind(cfg, idx), **kwargs)
            if a is not None:
                aux = aux + a
    return x, aux


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           hints: ShardingHints = NO_HINTS
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whisper-style encoder over stub frame embeddings (B, T, D) ->
    (memory (B, T, D), its positions (B, T) int32)."""
    b, t, _ = frames.shape
    cdt = cfg.cdtype()
    pos = torch.arange(t, dtype=torch.int32,
                       device=frames.device).expand(b, t)
    x = frames.to(cdt) + _sinusoidal(pos, cfg.d_model).to(cdt)
    enc = params["encoder"]
    for lp in enc["layers"]:
        x, _ = _layer(lp, x, cfg, ENCODER_KIND, positions=pos, hints=hints)
    return apply_norm(enc["final_norm"], x, cfg.norm,
                      bf16_mul=cfg.norm_bf16_mul), pos


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None, last_only: bool = False,
            lengths: Optional[torch.Tensor] = None,
            attn_backend: Optional[str] = None,
            wkv_backend: Optional[str] = None, remat: bool = False,
            hints: ShardingHints = NO_HINTS
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), caches, aux).

    ``caches`` (from ``init_caches``) are written in place and returned.
    ``frames`` (B, T, D): the audio stub's frame embeddings, which an
    encoder-decoder encodes into its memory; ``memory`` (B, T, D): that
    memory, precomputed (decode steps pass it, so as not to re-encode).
    ``patches`` (B, P, D): the vision stub's patch embeddings, added to the
    first P token embeddings (early fusion).  ``last_only`` projects logits
    for the final position only (prefill serving).  ``lengths`` (B,) are
    true prompt lengths of a left-padded batch (pads masked via position
    -1, see ``leftpad_positions``), ignored when ``positions`` are given.
    ``attn_backend`` overrides ``cfg.attn_backend`` for this call,
    ``wkv_backend`` picks the RWKV layers' WKV
    (``models/rwkv.py::resolve_wkv_backend``).  ``remat`` recomputes each
    decoder layer in the backward pass (training).  ``hints`` place the
    residual stream and the logits (``ShardingHints``).  Padded vocab columns
    get -1e9.  ``aux`` is the MoE layers' summed load-balance loss (float32;
    0 without MoE layers).
    """
    if attn_backend is not None:
        cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
    b, s = tokens.shape
    if positions is None:
        if lengths is not None:
            positions = leftpad_positions(lengths, s)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
    cdt = cfg.cdtype()
    # the rows cast after the gather: the same values as the reference's
    # cast of the whole table, and a new tensor (added to in place)
    x = params["embed"][tokens].to(cdt)
    if patches is not None:
        x[:, :patches.shape[1]] += patches.to(cdt)
    if not cfg.use_rope and not cfg.rwkv:
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
    x = hints.activation(x)

    memory_pos = None
    if cfg.is_encoder_decoder:
        if memory is None:
            if frames is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                                 f"`frames` or `memory`")
            memory, memory_pos = encode(params, cfg, frames, hints)
        else:
            t = memory.shape[1]
            memory_pos = torch.arange(t, dtype=torch.int32,
                                      device=memory.device).expand(
                                          memory.shape[0], t)
    else:
        memory = None

    x, aux = _run_layers(params, x, cfg, positions=positions, caches=caches,
                         memory=memory, memory_pos=memory_pos,
                         wkv_backend=wkv_backend, hints=hints, remat=remat)
    x = apply_norm(params["final_norm"], x, cfg.norm,
                   bf16_mul=cfg.norm_bf16_mul)
    if last_only:
        x = x[:, -1:]
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = hints.logits(x @ unembed.to(cdt))
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits, caches, aux


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
    K/V in the compute dtype; a hybrid layer's SSM state float32 and its
    conv state in the compute dtype; an RWKV layer's state float32 and its
    last tokens in the compute dtype.  A segment's leaves are stacked on a
    leading layer axis."""
    lens = cache_seq_lens(cfg, seq_len)
    cdt = cfg.cdtype()

    def one(idx: int, n_layers: int, cache_len: int) -> Params:
        shape = (n_layers, batch)
        if cfg.rwkv:
            d = cfg.d_model
            return {"wkv": torch.zeros(*shape, d // 64, 64, 64,
                                       dtype=torch.float32, device=device),
                    "tm_last": torch.zeros(*shape, 1, d, dtype=cdt,
                                           device=device),
                    "cm_last": torch.zeros(*shape, 1, d, dtype=cdt,
                                           device=device)}
        c = attn.init_cache(n_layers * batch, cache_len, cfg.n_kv_heads,
                            cfg.head_dim, cdt, device)
        out = {"self": {k: t.view(*shape, *t.shape[1:])
                        for k, t in c.items()}}
        if layer_kind(cfg, idx)["ssm"]:
            di = cfg.n_heads * cfg.head_dim
            out["ssm"] = torch.zeros(*shape, di, cfg.ssm_state,
                                     dtype=torch.float32, device=device)
            out["conv"] = torch.zeros(*shape, ssm_mod.CONV_WIDTH - 1, di,
                                      dtype=cdt, device=device)
        return out

    caches: Params = {"eager": {}, "segments": []}
    seg_i = 0
    for tag, arg in layer_plan(cfg):
        if tag == "eager":
            c = one(arg, 1, lens["eager"][str(arg)])
            caches["eager"][str(arg)] = tree_map(lambda t: t[0], c)
        else:
            caches["segments"].append(
                one(arg[0], arg[1] - arg[0], lens["segments"][seg_i]))
            seg_i += 1
    return caches
