"""The benchmark's weights: drawn from the seed into the port's layout.

Every leaf is a view of one flat buffer in the serving dtype (bf16),
filled with standard normals from one ``torch.Generator`` on the device in
a few large calls, then scaled in place: a dense weight by 1 / sqrt(fan
in), an output projection by a further 1 / sqrt(2 n_layers), the
embedding by 0.02, as the port's initialisers scale theirs; each norm's
scale is 1 + 0.1 N(0, 1), so a norm that drops its scale shows.  The final
norm's scale is float32, the port's parameter dtype for it.

The layout is the port's ``models/transformer.py`` parameter tree
(``embed``, ``unembed``, ``final_norm``, ``eager`` layers by id,
``segments`` as lists of per-layer dicts), built from the config's sizes
here; nothing of the port's ``init_params`` is called.  The reference
reads the same tensors.  A configuration with a layout of its own
(``spec.module``) gives ``draw`` its own leaves, drawn alike.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

#: elements a normal_ call fills
CHUNK = 1 << 28
#: leaf offsets are rounded up to this many elements (256-byte aligned)
ALIGN = 128


def padded_vocab(arch: Dict[str, Any]) -> int:
    m = arch.get("vocab_pad_multiple", 256)
    return -(-arch["vocab_size"] // m) * m


def dense_prefix(arch: Dict[str, Any]) -> int:
    return arch.get("dense_prefix_layers", 0) if arch.get("n_experts") else 0


def _layer_leaves(arch: Dict[str, Any], idx: int
                  ) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path within the layer, shape, scale) of layer ``idx``; scale None
    marks a norm scale."""
    d, hd, L = arch["d_model"], arch["head_dim"], arch["n_layers"]
    h, kv = arch["n_heads"], arch["n_kv_heads"]
    out = 1.0 / math.sqrt(2 * L)
    leaves = [("ln1.scale", (d,), None),
              ("attn.wq", (d, h * hd), 1 / math.sqrt(d)),
              ("attn.wk", (d, kv * hd), 1 / math.sqrt(d)),
              ("attn.wv", (d, kv * hd), 1 / math.sqrt(d)),
              ("attn.wo", (h * hd, d), out / math.sqrt(h * hd)),
              ("ln2.scale", (d,), None)]
    if arch.get("n_experts") and idx >= dense_prefix(arch):
        e, ff = arch["n_experts"], arch["d_ff"]
        leaves.append(("moe.router", (d, e), 1 / math.sqrt(d)))
        banks = [("experts", e)]
        if arch.get("n_shared_experts"):
            banks.append(("shared", arch["n_shared_experts"]))
        for bank, n in banks:
            leaves += [(f"moe.{bank}.w_up", (n, d, ff), 1 / math.sqrt(d)),
                       (f"moe.{bank}.w_down", (n, ff, d),
                        out / math.sqrt(ff)),
                       (f"moe.{bank}.w_gate", (n, d, ff), 1 / math.sqrt(d))]
    else:
        ff = arch["d_ff"]
        if arch.get("n_experts"):
            ff *= arch["top_k"] + max(arch.get("n_shared_experts", 0), 1)
        leaves += [("mlp.w_gate", (d, ff), 1 / math.sqrt(d)),
                   ("mlp.w_up", (d, ff), 1 / math.sqrt(d)),
                   ("mlp.w_down", (ff, d), out / math.sqrt(ff))]
    return leaves


def leaves(arch: Dict[str, Any]) -> List[Tuple[Tuple[Any, ...],
                                               Tuple[int, ...], float]]:
    """Every bf16 leaf as (path in the tree, shape, scale)."""
    if arch.get("global_layers") or arch.get("window"):
        raise ValueError("this layout holds a dense prefix and one segment")
    d, v = arch["d_model"], padded_vocab(arch)
    out = [(("embed",), (v, d), 0.02), (("unembed",), (d, v),
                                         1 / math.sqrt(d))]
    pre = dense_prefix(arch)
    for i in range(arch["n_layers"]):
        where = ("eager", str(i)) if i < pre else ("segments", 0, i - pre)
        for path, shape, scale in _layer_leaves(arch, i):
            out.append((where + tuple(path.split(".")), shape, scale))
    return out


#: ``draw``'s default leaves (its argument ``leaves`` hides the function)
layout = leaves


def _put(tree: Dict[str, Any], path: Tuple[Any, ...], value: Any) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def draw(arch: Dict[str, Any], seed: int, device,
         leaves: Optional[List[Tuple[Tuple[Any, ...], Tuple[int, ...],
                                     Optional[float]]]] = None
         ) -> Dict[str, Any]:
    """The parameter tree for ``arch`` drawn on ``device`` from ``seed``:
    ``leaves`` (path, shape, scale; ``layout(arch)`` by default), then the
    final norm's scale."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    specs = layout(arch) if leaves is None else leaves
    offsets, total = [], 0
    for _, shape, _ in specs:
        offsets.append(total)
        n = math.prod(shape)
        total += -(-n // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    params: Dict[str, Any] = {"eager": {}, "segments": []}
    for (path, shape, scale), off in zip(specs, offsets):
        t = flat[off:off + math.prod(shape)].view(shape)
        if scale is None:                       # a norm's scale
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(scale)
        _put(params, path, t)
    final = torch.empty(arch["d_model"], dtype=torch.float32, device=device)
    final.normal_(generator=gen).mul_(0.1).add_(1.0)
    params["final_norm"] = {"scale": final}
    return params
