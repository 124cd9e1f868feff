"""Training step: remat + microbatch gradient accumulation + AdamW.

The port of ``repro/training/train_step.py`` on one device.  The
reference's microbatch ``lax.scan`` is a Python loop here: one microbatch's
activations live at a time, and its gradients are added into float32
accumulators.  The model runs through autograd on the plain PyTorch
routes: ``forward`` gets ``attn_backend="torch"`` and ``wkv_backend=
"torch"``, which are the reference's own training routes (``attend_xla``
and its chunked path, the jnp ``wkv_chunked``), not a fallback.  The
hand-written kernels have no backward and refuse tensors that require grad
(``REPRO_ATTN_BACKEND=cuda`` still overrides the attention route, and then
the step raises).  ``hints`` (``models/transformer.py::ShardingHints``)
reach the model, and ``hints.params_compute`` places the compute copy of the
parameters once a step, as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import cast_tree
from repro_torch.models.transformer import NO_HINTS, ShardingHints, forward
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import leaves, unflatten
from repro_torch.training.losses import softmax_xent

#: the metrics a step returns beside the optimizer's
METRICS = ("nll", "accuracy", "z_loss", "loss", "moe_aux")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    moe_aux_weight: float = 0.01
    z_loss: float = 1e-4
    compress_pod_grads: bool = False
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def make_train_state(params: Any, tcfg: TrainConfig) -> Dict[str, Any]:
    state = {"params": params, "opt": adamw.init_state(params)}
    if tcfg.compress_pod_grads:
        state["residual"] = compression.init_residual(params)
    return state


def loss_fn(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            tcfg: TrainConfig, hints: ShardingHints = NO_HINTS
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss + moe_aux_weight * aux, metrics) of one batch."""
    logits, _, aux = forward(
        params, cfg, batch["tokens"], frames=batch.get("frames"),
        patches=batch.get("patches"), remat=tcfg.remat,
        attn_backend="torch", wkv_backend="torch", hints=hints)
    loss, metrics = softmax_xent(logits, batch["targets"],
                                 batch.get("mask"), z_loss=tcfg.z_loss)
    total = loss + tcfg.moe_aux_weight * aux
    metrics = dict(metrics, loss=loss, moe_aux=aux)
    return total, metrics


def _split_microbatches(batch: Dict[str, torch.Tensor],
                        k: int) -> List[Dict[str, torch.Tensor]]:
    """k microbatches of ``batch``, each a view of every array's rows
    [i * B/k, (i + 1) * B/k)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(k)]
    for name, a in batch.items():
        b = a.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible into {k} "
                             f"microbatches")
        for i, part in enumerate(a.reshape(k, b // k, *a.shape[1:])):
            out[i][name] = part
    return out


def _grads(params: Any, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
           tcfg: TrainConfig, hints: ShardingHints = NO_HINTS
           ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """(the gradients of ``loss_fn`` with respect to the leaves of
    ``params``, in ``leaves``' order; the metrics, detached)."""
    flat = leaves(params)
    leaf_params = unflatten(params, [p.detach().requires_grad_()
                                     for p in flat])
    with torch.enable_grad():
        total, metrics = loss_fn(leaf_params, cfg, batch, tcfg, hints)
        grads = torch.autograd.grad(total, leaves(leaf_params),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return grads, {k: v.detach() for k, v in metrics.items()}


def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor], *,
               cfg: ModelConfig, tcfg: TrainConfig,
               hints: ShardingHints = NO_HINTS
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step over ``batch`` (the global batch on axis 0).

    Returns (the new state, metrics): new tensors, the input state left as
    it was.  The metrics are 0-d tensors on the device (nothing is read
    back to the host): the loss's parts, ``loss``, ``moe_aux``,
    ``grad_norm`` and ``lr``.
    """
    params = state["params"]
    if cfg.zero1_weights:
        # one cast a step, hoisted out of the microbatch loop; the
        # gradients are those of the cast copy, in the compute dtype, as
        # the reference's are
        compute_params = hints.params_compute(
            cast_tree(params, cfg.cdtype()))
    else:
        compute_params = params

    if tcfg.microbatches > 1:
        # placed like the parameters (a DTensor's accumulator is one)
        g_acc = [torch.zeros_like(p, dtype=torch.float32)
                 for p in leaves(params)]
        m_acc = {k: torch.zeros((), dtype=torch.float32,
                                device=g_acc[0].device) for k in METRICS}
        for mb in _split_microbatches(batch, tcfg.microbatches):
            # a microbatch's rows go back to the batch's sharding (the
            # identity on plain tensors)
            mb = {k: hints.activation(v) for k, v in mb.items()}
            grads, metrics = _grads(compute_params, cfg, mb, tcfg, hints)
            for a, g in zip(g_acc, grads):
                a.add_(g.float())
            del grads
            for k in METRICS:
                m_acc[k] = m_acc[k] + metrics[k]
        inv = 1.0 / tcfg.microbatches
        flat_g = [g.mul_(inv) for g in g_acc]
        metrics = {k: v * inv for k, v in m_acc.items()}
    else:
        flat_g, metrics = _grads(compute_params, cfg, batch, tcfg, hints)
    grads = unflatten(params, flat_g)

    if tcfg.compress_pod_grads:
        grads, new_residual = compression.ef_compress_tree(
            grads, state["residual"])

    new_params, new_opt, opt_metrics = adamw.apply_updates(
        params, grads, state["opt"], tcfg.opt)
    new_state = {"params": new_params, "opt": new_opt}
    if tcfg.compress_pod_grads:
        new_state["residual"] = new_residual
    return new_state, dict(metrics, **opt_metrics)
