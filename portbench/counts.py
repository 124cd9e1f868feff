"""The benchmark's own arithmetic: chip peaks, model flops, attention bounds.

Frozen copies, so that a change to the program cannot move the yardstick:

  * ``attention_flops`` is ``repro_torch/kernels/flash_attention/ops.py::
    least_flops`` / ``decode_least_flops`` (4 Dh a (query, key) pair the
    mask admits, over the query heads), counted from lengths, not masks;
  * ``flash_bytes`` / ``decode_bytes`` are the byte counts of
    ``examples/torch_attention_layouts.py::kv_bytes`` and
    ``chip_smoke.py::attention_cases``: q and the output once, the
    positions, each admitted K row once and the V rows the output needs
    (a kv head's every slot for a row that admits no key, whose output is
    the average of them all);
  * ``token_flops`` counts a token's matrix products through the model
    (2 flops a multiply-add), with only the experts it is routed to.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 and HBM3.
"""

from __future__ import annotations

from typing import Any, Dict

PEAK_BF16_FLOPS = 989e12     # tensor cores, dense, bf16
PEAK_HBM_BYTES = 3.35e12     # bytes/s
BF16 = 2                     # bytes an element
INT32 = 4


def moe_layers(arch: Dict[str, Any]) -> int:
    if not arch.get("n_experts"):
        return 0
    return arch["n_layers"] - arch.get("dense_prefix_layers", 0)


def dense_ff(arch: Dict[str, Any]) -> int:
    """Width of a dense MLP layer (a MoE arch's leading dense layers are
    ``d_ff * (top_k + max(n_shared, 1))`` wide in the port)."""
    if not arch.get("n_experts"):
        return arch["d_ff"]
    return arch["d_ff"] * (arch["top_k"] + max(arch.get("n_shared_experts",
                                                        0), 1))


def layer_params_per_token(arch: Dict[str, Any]) -> float:
    """Weights a token multiplies by in all layers together (attention
    projections, the dense MLPs, and in MoE layers the router, its top-k
    routed experts and the shared experts)."""
    d, hd = arch["d_model"], arch["head_dim"]
    attn = (d * arch["n_heads"] * hd + 2 * d * arch["n_kv_heads"] * hd
            + arch["n_heads"] * hd * d)
    mult = 3 if arch.get("mlp", "swiglu") == "swiglu" else 2
    n_moe = moe_layers(arch)
    n_dense = arch["n_layers"] - n_moe
    total = arch["n_layers"] * attn + n_dense * mult * d * dense_ff(arch)
    if n_moe:
        active = arch["top_k"] + arch.get("n_shared_experts", 0)
        total += n_moe * (d * arch["n_experts"]
                          + active * mult * d * arch["d_ff"])
    return float(total)


def attention_flops(arch: Dict[str, Any], pairs: float) -> float:
    """4 Dh flops (q.k and p.v) for each admitted (query, key) pair, over
    the query heads, in one layer."""
    return 4.0 * arch["head_dim"] * arch["n_heads"] * pairs


def logits_flops(arch: Dict[str, Any]) -> float:
    return 2.0 * arch["d_model"] * arch["vocab_size"]


def prefill_flops(arch: Dict[str, Any], length: int) -> float:
    """Useful flops of a prefill of ``length`` prompt tokens (pads not
    counted): every token through the layers, causal attention over the
    prompt, the last position's logits."""
    pairs = length * (length + 1) / 2.0
    return (2.0 * layer_params_per_token(arch) * length
            + arch["n_layers"] * attention_flops(arch, pairs)
            + logits_flops(arch))


def decode_token_flops(arch: Dict[str, Any], position: int) -> float:
    """Useful flops of one decoded token whose input sits at ``position``
    (it admits ``position + 1`` keys): the layers, attention, its logits."""
    return (2.0 * layer_params_per_token(arch)
            + arch["n_layers"] * attention_flops(arch, position + 1)
            + logits_flops(arch))


def flash_bytes(arch: Dict[str, Any], length: int, bucket: int,
                cache_len: int) -> float:
    """Least bytes of one layer's prefill attention: a prompt of
    ``length`` left-padded to ``bucket`` against a fresh ``cache_len``-slot
    cache that holds the prompt's keys (kernel layout, bf16)."""
    h, kv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    row = kv * dh * BF16                        # one slot, all kv heads
    fixed = 2 * bucket * h * dh * BF16 + (bucket + cache_len) * INT32
    v_rows = cache_len if length < bucket else length
    return float(fixed + (length + v_rows) * row)


def flash_flops(arch: Dict[str, Any], length: int) -> float:
    return attention_flops(arch, length * (length + 1) / 2.0)


def decode_bytes(arch: Dict[str, Any], slots: int, rows: int,
                 cache_len: int) -> float:
    """Least bytes of one layer's decode attention over ``slots`` rows
    that admit ``rows`` cache slots in all (each row admits at least its
    own new key, so every V row read is needed)."""
    h, kv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    fixed = 2 * slots * h * dh * BF16 + slots * INT32 \
        + slots * cache_len * INT32
    return float(fixed + 2 * rows * kv * dh * BF16)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time on the chip: the larger of the two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
