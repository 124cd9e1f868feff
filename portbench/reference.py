"""The plain reference: the served model's forward pass in float32.

Plain PyTorch, TF32 off, no kernel, no cache, one request at a time.  It
imports nothing of the program.  It takes the benchmark's weights (the
same bf16 tensors the program serves, cast up a layer at a time), a
request's prompt and the tokens the program served, and gives the logits
at every served position: the sequence is fed whole, teacher-forced.

What the program's timed path derives, it works out again:

  * the left-padded prefill: the prompt left-padded to its bucket with
    token 0 at position -1.  A pad query admits no key, so it takes the
    average of v over the cache's ``cache_len`` slots (the prompt's rows;
    the rest are empty), as the program's kernels define it; pads matter
    only through the MoE layer's capacity, which they take first;
  * the routing (MoE layers): the router's softmax in float32, the top k
    (ties to the lower index), the gates renormalised over the k, and in
    the prefill GShard's capacity per group of up to 1024 tokens
    (``max(ceil(group * k / E * factor), k)`` slots an expert, the choices
    ranked slot-major, then by token), the shared experts on every token.
    Decoded tokens are routed one at a time and drop nothing: a decode
    step's capacity is shared with the other requests in the batch, which
    this request-by-request reference does not know (PERF.md);
  * the cache: a decoded token attends to the prompt and the tokens
    before it, by position.

A configuration whose attention differs gives ``served_logits`` its own
sublayer (``attention``); the norms, the routing, the MoE layer, the
shared experts and the unembedding stay these.

``mode="fp8"`` is the control: every matrix product takes its inputs
rounded to float8 e4m3, the weights scaled per output column and the
activations per row, as an fp8 deployment would, and accumulates in
float32.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

GROUP_SIZE = 1024          # the port's routing group
EPS = 1e-6                 # the port's norm epsilon
FP8_MAX = 448.0            # largest float8 e4m3 value


def plain_precision() -> None:
    """float32 products in float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linear:
    """x @ w in the reference's precision."""

    def __init__(self, mode: str):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown reference mode {mode!r}")
        self.mode = mode

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, dim=-2) if self.mode == "fp8" else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            x = _fp8(x, dim=-1)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """GPT-NeoX half rotation; x (S, H, Dh), pos (S,)."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = pos.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, p: Dict[str, torch.Tensor], lin: Linear,
              arch: Dict[str, Any], pos: torch.Tensor, n_prompt_end: int,
              cache_len: int, block: int = 512) -> torch.Tensor:
    """Causal GQA self-attention by position over one request's sequence
    x (S, D); positions -1 are pads: they are no key, and as queries they
    take the average of the prompt's v over ``cache_len`` slots (the
    prompt ends at sequence index ``n_prompt_end``)."""
    s = x.shape[0]
    h, kv, dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    theta = float(arch.get("rope_theta", 10000.0))
    q = rope(lin(x, p["wq"]).view(s, h, dh), pos, theta)
    k = rope(lin(x, p["wk"]).view(s, kv, dh), pos, theta)
    v = lin(x, p["wv"]).view(s, kv, dh)
    real = pos >= 0
    kr, vr, pr = k[real], v[real], pos[real]
    g = h // kv
    kh = kr.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, T, Dh)
    vh = vr.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty(s, h, dh, dtype=torch.float32, device=x.device)
    scale = 1.0 / math.sqrt(dh)
    for a in range(0, s, block):
        qb = q[a:a + block].transpose(0, 1)                   # (H, b, Dh)
        logits = qb @ kh.transpose(1, 2) * scale              # (H, b, T)
        ok = pr[None, :] <= pos[a:a + block, None]            # (b, T)
        logits = logits.masked_fill(~ok[None], float("-inf"))
        w = torch.softmax(logits, dim=-1)
        out[a:a + block] = (w @ vh).transpose(0, 1)
    pads = ~real
    if pads.any():
        in_prompt = real.clone()
        in_prompt[n_prompt_end:] = False
        mean_v = v[in_prompt].sum(0) / cache_len                 # (Kv, Dh)
        out[pads] = mean_v.repeat_interleave(g, dim=0)
    return lin(out.reshape(s, h * dh), p["wo"])


#: ``served_logits``'s default sublayer (its argument ``attention`` hides
#: the function)
gqa_attention = attention


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, lin: Linear) -> torch.Tensor:
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def capacity(gs: int, n_experts: int, k: int, factor: float) -> int:
    return max(int(math.ceil(gs * k / n_experts * factor)), k)


def routing_group(t: int) -> int:
    gs = min(GROUP_SIZE, t)
    if t % gs:
        gs = math.gcd(t, gs)
    return gs


def route(logits: torch.Tensor, k: int, groups: Sequence[Tuple[int, int]],
          factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing of S tokens: (expert ids (S, k), gates (S, k)) with the gate
    of a choice dropped at capacity set to 0.  ``groups`` are (start, end)
    token ranges that share capacity; tokens outside them drop nothing."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / vals.sum(-1, keepdim=True)
    for a, b in groups:
        gi = idx[a:b]                                         # (gs, k)
        onehot = F.one_hot(gi.t().reshape(-1), e)             # slot-major
        rank = (onehot.cumsum(0) - 1).gather(
            1, gi.t().reshape(-1, 1))[:, 0].view(k, b - a).t()
        cap = capacity(b - a, e, k, factor)
        gates[a:b] = torch.where(rank < cap, gates[a:b], 0.0)
    return idx, gates


def moe(x: torch.Tensor, p: Dict[str, Any], lin: Linear,
        arch: Dict[str, Any], groups: Sequence[Tuple[int, int]]
        ) -> torch.Tensor:
    """The MoE layer on one request's tokens x (S, D)."""
    k = arch["top_k"]
    idx, gates = route(lin(x, p["router"]), k, groups,
                       float(arch.get("moe_capacity_factor", 1.25)))
    out = torch.zeros_like(x)
    bank = p["experts"]
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        gate = gates[tok, slot]
        keep = gate != 0
        tok, gate = tok[keep], gate[keep]
        if not len(tok):
            continue
        y = swiglu(x[tok], bank["w_gate"][e], bank["w_up"][e],
                   bank["w_down"][e], lin)
        out.index_add_(0, tok, y * gate[:, None])
    if "shared" in p:
        sh = p["shared"]
        for e in range(sh["w_up"].shape[0]):
            out += swiglu(x, sh["w_gate"][e], sh["w_up"][e],
                          sh["w_down"][e], lin)
    return out


def cast(tree: Any, lin: Linear) -> Any:
    """A layer's weights in the reference's precision (norm scales, 1-D,
    in float32)."""
    if isinstance(tree, dict):
        return {k: cast(v, lin) for k, v in tree.items()}
    return tree.float() if tree.dim() == 1 else lin.weight(tree)


def layer_params(params: Dict[str, Any], arch: Dict[str, Any],
                 i: int) -> Dict[str, Any]:
    pre = arch.get("dense_prefix_layers", 0) if arch.get("n_experts") else 0
    if i < pre:
        return params["eager"][str(i)]
    return params["segments"][0][i - pre]


def sequence(prompt: Sequence[int], served: Sequence[int], bucket: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, positions) of the teacher-forced sequence: the prompt
    left-padded to ``bucket``, then every served token but the last."""
    n_pad = bucket - len(prompt)
    toks = [0] * n_pad + list(prompt) + list(served[:-1])
    pos = [-1] * n_pad + list(range(len(prompt) + len(served) - 1))
    return (torch.tensor(toks, dtype=torch.long),
            torch.tensor(pos, dtype=torch.long))


@torch.no_grad()
def served_logits(params: Dict[str, Any], arch: Dict[str, Any],
                  items: Sequence[Tuple[Sequence[int], Sequence[int], int]],
                  cache_len: int, mode: str = "f32",
                  attention: Optional[Callable[..., torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """For each (prompt, served tokens, bucket): the logits (n_served,
    vocab) float32 whose row i scores served token i.  Layer by layer over
    all items, so each layer's weights are cast up once.  ``attention``
    is the sublayer, called as ``gqa_attention`` is (the default)."""
    attend = gqa_attention if attention is None else attention
    plain_precision()
    lin = Linear(mode)
    dev = params["embed"].device
    vocab = arch["vocab_size"]
    seqs = [sequence(pr, sv, b) for pr, sv, b in items]
    xs = [params["embed"][t.to(dev)].float() for t, _ in seqs]
    poss = [p.to(dev) for _, p in seqs]
    moe_from = (arch.get("dense_prefix_layers", 0) if arch.get("n_experts")
                else arch["n_layers"])
    for i in range(arch["n_layers"]):
        lp = cast(layer_params(params, arch, i), lin)
        for j, ((prompt, _, bucket), pos) in enumerate(zip(items, poss)):
            x = xs[j]
            x = x + attend(rmsnorm(x, lp["ln1"]["scale"]), lp["attn"],
                           lin, arch, pos, bucket, cache_len)
            h = rmsnorm(x, lp["ln2"]["scale"])
            if i >= moe_from:
                gs = routing_group(bucket)
                groups = [(a, a + gs) for a in range(0, bucket, gs)]
                x = x + moe(h, lp["moe"], lin, arch, groups)
            else:
                m = lp["mlp"]
                x = x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"], lin)
            xs[j] = x
        del lp
    unembed = lin.weight(params["unembed"][:, :vocab])
    out = []
    for (prompt, served, bucket), x in zip(items, xs):
        rows = x[bucket - 1:bucket - 1 + len(served)]
        out.append(lin(rmsnorm(rows, params["final_norm"]["scale"]),
                       unembed))
    return out
