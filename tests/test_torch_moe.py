"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) on the CPU.

The same weights (the reference's ``moe_init``, carried across as numpy)
and the same numpy inputs go through both ``moe_apply``s: the output and
the aux load-balance loss in float32 at (1e-4, 1e-4) and in bfloat16 at
(5e-2, 5e-2), as ``test_torch_lm_serving.py`` states them, for
deepseek-moe's top-6 with 2 shared experts, llama4-scout's top-1 with one
shared expert, and a capacity factor of 1.25 with groups small enough that
experts overflow and drop tokens.  The reference's own MoE tests
(``tests/test_models.py``) are mirrored: capacity saturation, top-1 is the
argmax expert's FFN, a uniform router's aux loss is 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as M

F32_TOL = (1e-4, 1e-4)
BF16_TOL = (5e-2, 5e-2)


@dataclasses.dataclass
class Case:
    name: str
    d: int
    d_ff: int
    n_experts: int
    n_shared: int
    top_k: int
    mlp: str
    capacity_factor: float
    group_size: int = M.GROUP_SIZE


CASES = (
    # deepseek-moe-16b's routing at smoke width: 64 experts, top-6, 2 shared
    Case("top6-shared2", 32, 16, 64, 2, 6, "swiglu", 8.0),
    # llama4-scout-17b-a16e's: 16 experts, top-1, 1 shared
    Case("top1-shared1", 32, 24, 16, 1, 1, "swiglu", 8.0),
    # drops: groups of 8 tokens, capacity max(ceil(8 * 2 / 8 * 1.25), 2) = 3
    Case("cf1.25-drops", 16, 32, 8, 0, 2, "gelu", 1.25, group_size=8),
)


def _weights(c: Case, dtype=jnp.float32):
    return JM.moe_init(jax.random.PRNGKey(7), c.d, c.d_ff, c.n_experts,
                       c.n_shared, c.mlp, dtype)


def _to_torch(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(dtype), tree)


def _kw(c: Case):
    return dict(n_experts=c.n_experts, top_k=c.top_k, mlp_kind=c.mlp,
                capacity_factor=c.capacity_factor, group_size=c.group_size)


def _x(c: Case, b=3, s=16, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, s, c.d))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("c", CASES, ids=lambda c: c.name)
def test_moe_apply_equals_the_reference(c, dtype, tol):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(lambda a: a.astype(jdt), _weights(c))
    x = _x(c)
    want, want_aux = JM.moe_apply(jp, jnp.asarray(x, jdt), **_kw(c))
    got, aux = M.moe_apply(_to_torch(jp, dtype),
                           torch.from_numpy(x).to(dtype), **_kw(c))
    assert got.dtype == dtype and aux.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), *tol)
    np.testing.assert_allclose(float(aux), float(want_aux), *tol)


def test_the_drop_case_drops_and_the_capacity_is_the_references():
    c = CASES[-1]
    gs = M.routing_group(3 * 16, c.group_size)
    cap = M.capacity(gs, c.n_experts, c.top_k, c.capacity_factor)
    assert (gs, cap) == (8, 3)
    xt = torch.from_numpy(_x(c)).reshape(-1, gs, c.d)
    router = _to_torch(_weights(c), torch.float32)["router"]
    dispatch, combine, _ = M.route(router, xt, n_experts=c.n_experts,
                                   k=c.top_k,
                                   capacity_factor=c.capacity_factor)
    kept = int(dispatch.sum())
    assert kept < xt.shape[0] * gs * c.top_k      # some slots dropped
    assert int(dispatch.amax()) == 1
    # each expert's capacity slot holds one token at most
    assert int(dispatch.sum(dim=1).amax()) == 1
    assert bool((combine <= dispatch).all())
    # deepseek-moe-16b at full width: a decode step's group of 8 slots and
    # a 2048-token prefill's groups of 1024
    assert M.capacity(8, 64, 6, 1.25) == 6
    assert M.capacity(M.routing_group(2048), 64, 6, 1.25) == 120


def test_routing_groups_follow_the_reference_rule():
    assert M.routing_group(8) == 8
    assert M.routing_group(3 * 16) == 48
    assert M.routing_group(2048) == 1024
    assert M.routing_group(1500) == 4         # gcd(1500, 1024)
    assert M.routing_group(200_000) == 64


def test_moe_capacity_saturation():
    c = Case("sat", 32, 16, 8, 0, 2, "swiglu", 8.0)
    p = _to_torch(_weights(c), torch.float32)
    x = torch.from_numpy(_x(c, b=2, s=16, seed=1))
    y1, _ = M.moe_apply(p, x, **_kw(c))
    y2, _ = M.moe_apply(p, x, **_kw(dataclasses.replace(
        c, capacity_factor=64.0)))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_top1_selects_single_expert():
    """With top_k=1 and huge capacity, output == the argmax expert's FFN."""
    c = Case("top1", 16, 32, 4, 0, 1, "gelu", 32.0)
    p = _to_torch(_weights(c), torch.float32)
    x = torch.from_numpy(_x(c, b=1, s=8, seed=2))
    y, _ = M.moe_apply(p, x, **_kw(c))
    xf = x.reshape(-1, c.d)
    eidx = (xf @ p["router"]).argmax(-1)
    for t in range(8):
        e = int(eidx[t])
        he = torch.nn.functional.gelu(xf[t] @ p["experts"]["w_up"][e],
                                      approximate="tanh")
        ye = he @ p["experts"]["w_down"][e]
        np.testing.assert_allclose(y.reshape(-1, c.d)[t].numpy(),
                                   ye.numpy(), rtol=1e-4, atol=1e-4)


def test_top_k_breaks_ties_to_the_lower_index_as_jax_does():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = M.top_k(probs, 3)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_moe_aux_loss_uniform_router_is_one():
    """A uniform router ties every expert: both packages break the ties
    towards expert 0, so every token routes there and aux = E * (1/E) * 1."""
    c = Case("uniform", 16, 32, 8, 0, 1, "gelu", 1.25)
    jp = dict(_weights(c), router=jnp.zeros((c.d, c.n_experts)))
    x = np.random.default_rng(0).standard_normal((4, 64, c.d)).astype(
        np.float32)
    _, want = JM.moe_apply(jp, jnp.asarray(x), **_kw(c))
    _, got = M.moe_apply(_to_torch(jp, torch.float32), torch.from_numpy(x),
                         **_kw(c))
    assert float(got) == pytest.approx(1.0) == float(want)
