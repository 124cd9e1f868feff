"""Mixture-of-Experts layer: fine-grained routed experts + shared experts.

The port of ``repro/models/moe.py``: GShard-style capacity-based dense
dispatch.  Routing is one-hot dispatch and combine tensors contracted with
``torch.einsum``, as the reference's einsums are; no token is gathered or
scattered by index.  Every shape follows from the input's shape and the
config alone (the capacity is a Python int), and nothing reads a value back
to the host, so a decode step that runs this layer captures as one CUDA
graph.  The reference computes all of it in plain jnp, outside any Pallas
kernel; so does the port, in plain PyTorch.

Numerics follow the reference: the router's logits in the compute dtype,
then float32 softmax; ``top_k`` breaks ties towards the lower expert index,
as ``jax.lax.top_k`` does (a stable descending sort); slot-major priority
within an expert's capacity; the tanh GELU, ``jax.nn.gelu``'s default.
It trains as it serves: autograd differentiates the same einsums.
``stopgrad_dispatch`` detaches the one-hot masks, as the reference's lever
does (``cfg.moe_stopgrad_dispatch``): they are built from integer
comparisons, so no gradient reaches them either way, and the router learns
through the gate values in ``combine``.  ``constraint(x, kind)`` is the
reference's sharding hook, applied at its points: the dispatch and combine
tensors and the shared experts' hidden ("gtec"), the expert buffers in and
out ("gecd").  The identity by default; ``distributed/sharding.py`` gives
the one that places DTensors.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init

GROUP_SIZE = 1024  # tokens per routing group (GShard-style locality)

#: a sharding constraint: (tensor, kind "gecd" | "gtec") -> tensor
Constraint = Callable[[torch.Tensor, str], torch.Tensor]


def no_constraint(x: torch.Tensor, kind: str) -> torch.Tensor:
    return x


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             n_shared: int, mlp_kind: str, dtype: torch.dtype, device,
             n_layers_scale: int = 1) -> Params:
    out_scale = 1.0 / math.sqrt(2 * n_layers_scale)

    def normal(*shape, scale):
        w = torch.randn(*shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def expert_bank(n):
        bank = {"w_up": normal(n, d, d_ff, scale=1 / math.sqrt(d)),
                "w_down": normal(n, d_ff, d,
                                 scale=out_scale / math.sqrt(d_ff))}
        if mlp_kind == "swiglu":
            bank["w_gate"] = normal(n, d, d_ff, scale=1 / math.sqrt(d))
        return bank

    p = {"router": dense_init(gen, d, n_experts, dtype, device),
         "experts": expert_bank(n_experts)}
    if n_shared:
        p["shared"] = expert_bank(n_shared)
    return p


def _act(up: torch.Tensor, gate, mlp_kind: str) -> torch.Tensor:
    if mlp_kind == "swiglu":
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")   # jax.nn.gelu's default


def bank_ffn(bank: Params, x_e: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """x_e (G, E, C, D) -> same, through per-expert FFNs (the expert
    GEMMs, batched over the experts)."""
    up = torch.einsum("gecd,edf->gecf", x_e, bank["w_up"])
    gate = (torch.einsum("gecd,edf->gecf", x_e, bank["w_gate"])
            if mlp_kind == "swiglu" else None)
    return torch.einsum("gecf,efd->gecd", _act(up, gate, mlp_kind),
                        bank["w_down"])


def shared_ffn(bank: Params, xt: torch.Tensor, mlp_kind: str,
               constraint: Constraint = no_constraint) -> torch.Tensor:
    """The shared experts on every token of xt (G, gs, D): direct einsums
    over the (small) expert dim, summed over it."""
    up = torch.einsum("gtd,edf->gtef", xt, bank["w_up"])
    gate = (torch.einsum("gtd,edf->gtef", xt, bank["w_gate"])
            if mlp_kind == "swiglu" else None)
    h_sh = constraint(_act(up, gate, mlp_kind), "gtec")
    return torch.einsum("gtef,efd->gtd", h_sh, bank["w_down"])


def routing_group(t: int, group_size: int = GROUP_SIZE) -> int:
    """Tokens per routing group for ``t`` tokens (the reference's rule)."""
    gs = min(group_size, t)
    # at very long prefills the (G, gs, E, C) routing tensors outgrow HBM:
    # shrink the group (capacity scales with it)
    if t > 131072:
        gs = min(gs, 64)
    if t % gs:
        gs = math.gcd(t, gs)
    return gs


def capacity(gs: int, n_experts: int, k: int,
             capacity_factor: float) -> int:
    """Slots an expert takes in a routing group of ``gs`` tokens."""
    return max(int(math.ceil(gs * k / n_experts * capacity_factor)), k)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest of the last dim, in
    ``jax.lax.top_k``'s order: largest first, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xt: torch.Tensor, *, n_experts: int,
          k: int, capacity_factor: float, stopgrad_dispatch: bool = False,
          constraint: Constraint = no_constraint
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (G, gs, D) -> (dispatch, combine (G, gs, E, C) in xt's dtype, the
    Switch aux load-balance loss, a float32 scalar).  ``stopgrad_dispatch``
    detaches the one-hot masks; ``constraint`` places dispatch and
    combine."""
    g, gs, _ = xt.shape
    dt, dev = xt.dtype, xt.device
    probs = torch.softmax((xt @ router).float(), dim=-1)     # (G, gs, E)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    cap = capacity(gs, n_experts, k, capacity_factor)

    # one-hot expert masks per routing slot, priority = slot-major order
    experts = torch.arange(n_experts, device=dev)
    mask = (gate_idx[..., None] == experts).to(torch.int32)  # (G,gs,k,E)
    mask_flat = mask.transpose(1, 2).reshape(g, k * gs, n_experts)
    pos = mask_flat.cumsum(dim=1) - 1
    pos = pos.reshape(g, k, gs, n_experts).transpose(1, 2)
    pos_in_expert = (pos * mask).sum(-1)                     # (G,gs,k)
    keep = pos_in_expert < cap

    kept_mask = (mask * keep[..., None]).to(dt)              # (G,gs,k,E)
    # a dropped slot's row is all zero (the reference's out-of-range one_hot)
    slot = torch.where(keep, pos_in_expert, cap)
    poh = (slot[..., None] == torch.arange(cap, device=dev)).to(dt)
    if stopgrad_dispatch:
        kept_mask, poh = kept_mask.detach(), poh.detach()
    # contract k without materialising (G, gs, k, E, C)
    dispatch = constraint(torch.einsum("gtke,gtkc->gtec", kept_mask, poh),
                          "gtec")
    combine = constraint(
        torch.einsum("gtke,gtkc->gtec",
                     kept_mask * gate_vals.to(dt)[..., None], poh), "gtec")

    # load-balance aux loss (Switch form): E * sum_e f_e * p_e
    t = g * gs
    importance = probs.reshape(t, n_experts).mean(dim=0)
    load = mask.amax(dim=2).reshape(t, n_experts).float().mean(dim=0)
    aux = n_experts * (importance * load).sum()
    return dispatch, combine, aux


def moe_apply(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
              mlp_kind: str, capacity_factor: float = 1.25,
              group_size: int = GROUP_SIZE, stopgrad_dispatch: bool = False,
              constraint: Constraint = no_constraint
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss (scalar)).

    Tokens are routed within fixed-size groups (GShard): capacity and the
    dispatch/combine one-hot contractions are per group, so dispatch memory
    is O(T E C_g) with C_g = ceil(group k / E cf), linear in tokens.
    Overflow tokens beyond capacity drop that expert's contribution.
    ``stopgrad_dispatch`` detaches the routing one-hots (``route``);
    ``constraint`` is the sharding hook (see the module's docstring).
    """
    b, s, d = x.shape
    t = b * s
    gs = routing_group(t, group_size)
    xt = x.reshape(t // gs, gs, d)
    dispatch, combine, aux = route(p["router"], xt, n_experts=n_experts,
                                   k=top_k, capacity_factor=capacity_factor,
                                   stopgrad_dispatch=stopgrad_dispatch,
                                   constraint=constraint)
    x_e = constraint(torch.einsum("gtec,gtd->gecd", dispatch, xt),
                     "gecd")                                 # (G,E,C,D)
    y_e = constraint(bank_ffn(p["experts"], x_e, mlp_kind), "gecd")
    out = torch.einsum("gtec,gecd->gtd", combine, y_e)
    if "shared" in p:
        out = out + shared_ffn(p["shared"], xt, mlp_kind, constraint)
    return out.reshape(b, s, d), aux
