"""The port's selective SSM head (``repro_torch/models/ssm.py``) against the
JAX package's (``repro/models/ssm.py``) on the CPU.

The same weights (the reference's ``ssm_init``, carried across as numpy)
and the same numpy inputs: ``ssm_apply``'s output and its two states in
float32 at (1e-4, 1e-4) and in bfloat16 at (5e-2, 5e-2), from no state and
from a handed-over SSM state and conv state.  The port's doubling scan
sums in another order than ``jax.lax.associative_scan``'s tree, so it
matches at float32 rounding, not bit for bit.  A prefill split in two
equals the whole, and the scan equals the stepwise O(1) update
(the reference's ``tests/test_models.py::test_ssm_scan_vs_stepwise``, at
its tolerance, 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S

F32_TOL = (1e-4, 1e-4)
BF16_TOL = (5e-2, 5e-2)
D_MODEL, D_INNER, N = 16, 32, 4


def _weights(dtype=jnp.float32):
    return JS.ssm_init(jax.random.PRNGKey(1), D_MODEL, D_INNER, N, dtype)


def _to_torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(a, np.float32)).to(dtype)
            for k, a in tree.items()}


def _x(b, s, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, s, D_MODEL))
            * 0.3).astype(np.float32)


def _states(b, seed=5):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, D_INNER, N)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, S.CONV_WIDTH - 1, D_INNER))
             * 0.3).astype(np.float32))


@pytest.mark.parametrize("s", [1, 7, 24])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)],
                         ids=["float32", "bfloat16"])
def test_ssm_apply_equals_the_reference(dtype, tol, with_state, s):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: a.astype(jdt) for k, a in _weights().items()}
    x = _x(2, s)
    state, conv = _states(2) if with_state else (None, None)
    want, (w_state, w_conv) = JS.ssm_apply(
        jp, jnp.asarray(x, jdt),
        state=None if state is None else jnp.asarray(state),
        conv_state=None if conv is None else jnp.asarray(conv, jdt))
    got, (g_state, g_conv) = S.ssm_apply(
        _to_torch(jp, dtype), torch.from_numpy(x).to(dtype),
        state=None if state is None else torch.from_numpy(state),
        conv_state=None if conv is None else torch.from_numpy(conv).to(dtype))
    assert got.dtype == dtype and g_state.dtype == torch.float32
    assert g_conv.dtype == dtype
    for a, b in ((got, want), (g_state, w_state), (g_conv, w_conv)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), *tol)


def test_a_prefill_split_in_two_equals_the_whole():
    p = _to_torch(_weights())
    x = torch.from_numpy(_x(2, 30, seed=3))
    y_all, (st_all, cv_all) = S.ssm_apply(p, x)
    y1, (st, cv) = S.ssm_apply(p, x[:, :13])
    y2, (st, cv) = S.ssm_apply(p, x[:, 13:], state=st, conv_state=cv)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), *F32_TOL)
    np.testing.assert_allclose(st.numpy(), st_all.numpy(), *F32_TOL)
    np.testing.assert_array_equal(cv.numpy(), cv_all.numpy())


def test_ssm_scan_vs_stepwise():
    p = _to_torch(_weights())
    x = torch.from_numpy(_x(1, 24, seed=4))
    y_all, (state_all, _) = S.ssm_apply(p, x)
    state = conv = None
    ys = []
    for t in range(24):
        y, (state, conv) = S.ssm_apply(p, x[:, t:t + 1], state=state,
                                       conv_state=conv)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state.numpy(), state_all.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("s", [1, 2, 3, 8, 33, 100])
def test_linear_scan_equals_the_recurrence(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3, 4)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 3, 4)).astype(
        np.float32))
    h, want = torch.zeros(2, 3, 4), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(S.linear_scan(a, b).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_causal_conv_equals_the_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, D_INNER)).astype(np.float32)
    w = rng.standard_normal((S.CONV_WIDTH, D_INNER)).astype(np.float32)
    st = rng.standard_normal((2, S.CONV_WIDTH - 1, D_INNER)).astype(
        np.float32)
    for state in (None, st):
        want, w_st = JS._causal_conv(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        got, g_st = S.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  None if state is None
                                  else torch.from_numpy(state))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), *F32_TOL)
        np.testing.assert_array_equal(g_st.numpy(), np.asarray(w_st))


def test_init_makes_the_reference_leaves():
    ours = S.ssm_init(torch.Generator().manual_seed(0), D_MODEL, D_INNER, N,
                      torch.bfloat16, "cpu")
    theirs = _weights(jnp.bfloat16)
    assert sorted(ours) == sorted(theirs)
    for k, a in theirs.items():
        assert tuple(ours[k].shape) == a.shape and \
            ours[k].dtype == torch.bfloat16, k
    for k in ("dt_bias", "a_log", "d_skip"):   # deterministic leaves
        np.testing.assert_array_equal(ours[k].float().numpy(),
                                      np.asarray(theirs[k], np.float32))
