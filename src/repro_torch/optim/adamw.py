"""AdamW with float32 moments, decoupled weight decay and global-norm
clipping.

The port of ``repro/optim/adamw.py``.  Parameters, gradients and moments
are trees of dicts and lists of tensors (the port's parameter trees); each
moment is shaped like its parameter.  The step counter, the learning rate,
the gradient norm and the clip scale stay 0-d tensors on the parameters'
device, so a step reads nothing back to the host.  ``apply_updates`` runs
under ``torch.no_grad()`` and does the reference's per-leaf arithmetic one
leaf at a time, so its temporaries are one leaf's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    lr_min_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    mu: Any               # float32, param-shaped
    nu: Any               # float32, param-shaped


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in the order
    ``unflatten`` puts them back (dict keys sorted, as ``jax.tree`` orders
    them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def unflatten(template: Any, flat: List[torch.Tensor]) -> Any:
    """A tree shaped like ``template`` holding the tensors of ``flat`` (in
    ``leaves``' order); tuples come back as lists."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more tensors than the template has leaves")
    return out


def init_state(params: Any) -> OptState:
    device = leaves(params)[0].device
    mu = unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                            for p in leaves(params)])
    nu = unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                            for p in leaves(params)])
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=mu, nu=nu)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr_peak``, then a cosine decay to
    ``lr_min_ratio * lr_peak`` at ``decay_steps`` (a float32 tensor)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: OptState,
                  cfg: AdamWConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics).

    New tensors throughout, as the reference's functional update gives:
    the inputs are left as they were.
    """
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        update = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), mu, nu

    flat_p, flat_g = leaves(params), leaves(grads)
    flat_mu, flat_nu = leaves(state.mu), leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu):
        raise ValueError("params, grads and moments differ in structure")
    # leaf by leaf: the temporaries of one leaf at a time
    out = [upd(*leaf) for leaf in zip(flat_p, flat_g, flat_mu, flat_nu)]
    new_p = [o[0] for o in out]
    mu = [o[1] for o in out]
    nu = [o[2] for o in out]
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (unflatten(params, new_p),
            OptState(step=step, mu=unflatten(params, mu),
                     nu=unflatten(params, nu)),
            metrics)
