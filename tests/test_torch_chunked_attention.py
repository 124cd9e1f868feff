"""The port's chunked attention held against the JAX package on the CPU.

``models/chunked_attention.py::attend_chunked`` against the reference's on
the same numpy inputs: causal, windowed and non-causal, GQA and one kv head
a query head, chunk sizes that divide S and T, and left-padded rows whose
pads admit no key; float32 at (1e-5, 1e-5), ``bf16_intermediates`` at
(1e-2, 1e-2) (bfloat16 inputs in both packages).  The gradients of
sum(out * w) with respect to q, k and v, ``jax.grad`` against autograd, at
(1e-4, 1e-5).  ``models/attention.py::attend``'s ``torch`` route at the
threshold (S = T = 2048) takes the chunked path, records a ``torch``
dispatch and agrees with the reference's ``attend_xla``; below it, or on a
wrapped ring, it does not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import chunked_attention as jchunk
from repro_torch.models import attention as A
from repro_torch.models import chunked_attention as C

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
GRAD = dict(rtol=1e-4, atol=1e-5)


@dataclasses.dataclass
class Inputs:
    q: np.ndarray
    k: np.ndarray
    v: np.ndarray
    q_pos: np.ndarray
    k_pos: np.ndarray


def _inputs(b, s, t, h, kv, dh, seed=0, pad=0):
    """Index-aligned positions (token i at position i); ``pad`` leading
    pads in row 0 (position -1) as a left-padded prefill has."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    k_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    if pad:
        q_pos[0, :pad] = -1
        k_pos[0, :pad] = -1
    return Inputs(q, k, v, q_pos, k_pos)


def _j(x, dtype=None):
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _t(x, dtype=None):
    a = torch.from_numpy(np.ascontiguousarray(x))
    return a if dtype is None else a.to(dtype)


CASES = [
    # (name, b, s, t, h, kv, dh, causal, window, q_chunk, k_chunk, pad)
    ("causal gqa", 2, 256, 256, 4, 2, 16, True, 0, 64, 64, 0),
    ("causal 1:1", 1, 128, 128, 2, 2, 32, True, 0, 32, 64, 0),
    ("causal q chunk > k chunk", 1, 128, 128, 2, 1, 16, True, 0, 64, 32, 0),
    ("window", 2, 256, 256, 4, 1, 16, True, 48, 64, 32, 0),
    ("window non-causal", 1, 128, 128, 2, 1, 16, False, 40, 32, 32, 0),
    ("non-causal s != t", 2, 64, 192, 4, 2, 16, False, 0, 32, 64, 0),
    ("left pads", 2, 128, 128, 2, 1, 16, True, 0, 32, 32, 40),
    ("one chunk", 1, 64, 64, 2, 1, 16, True, 0, 1024, 1024, 0),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attend_chunked_matches_reference(case):
    _, b, s, t, h, kv, dh, causal, window, qc, kc, pad = case
    x = _inputs(b, s, t, h, kv, dh, pad=pad)
    kw = dict(n_kv_heads=kv, causal=causal, window=window, q_chunk=qc,
              k_chunk=kc)
    want = jchunk.attend_chunked(_j(x.q), _j(x.k), _j(x.v), _j(x.q_pos),
                                 _j(x.k_pos), **kw)
    got = C.attend_chunked(_t(x.q), _t(x.k), _t(x.v), _t(x.q_pos),
                           _t(x.k_pos), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_attend_chunked_bf16_intermediates(causal, window):
    x = _inputs(2, 256, 256, 4, 2, 32, seed=1)
    kw = dict(n_kv_heads=2, causal=causal, window=window, q_chunk=64,
              k_chunk=64, bf16_intermediates=True)
    bf = jnp.bfloat16
    want = jchunk.attend_chunked(_j(x.q, bf), _j(x.k, bf), _j(x.v, bf),
                                 _j(x.q_pos), _j(x.k_pos), **kw)
    got = C.attend_chunked(_t(x.q, torch.bfloat16), _t(x.k, torch.bfloat16),
                           _t(x.v, torch.bfloat16), _t(x.q_pos),
                           _t(x.k_pos), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)
    # and within the same tolerance of the float32 tiles
    f32 = C.attend_chunked(_t(x.q), _t(x.k), _t(x.v), _t(x.q_pos),
                           _t(x.k_pos), **dict(kw, bf16_intermediates=False))
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(), **BF16)


def test_attend_chunked_refuses_ragged_chunks():
    x = _inputs(1, 96, 96, 2, 1, 16)
    with pytest.raises(ValueError):
        C.attend_chunked(_t(x.q), _t(x.k), _t(x.v), _t(x.q_pos),
                         _t(x.k_pos), n_kv_heads=1, causal=True,
                         q_chunk=64, k_chunk=64)


@pytest.mark.parametrize("causal,window,kv", [(True, 0, 2), (True, 96, 1),
                                              (False, 0, 4)])
def test_attend_chunked_gradients_match_jax(causal, window, kv):
    x = _inputs(2, 256, 256, 4, kv, 16, seed=2)
    w = np.random.default_rng(3).standard_normal(
        (2, 256, 4, 16)).astype(np.float32)
    kw = dict(n_kv_heads=kv, causal=causal, window=window, q_chunk=64,
              k_chunk=64)

    def jloss(q, k, v):
        out = jchunk.attend_chunked(q, k, v, _j(x.q_pos), _j(x.k_pos), **kw)
        return jnp.sum(out * _j(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(_j(x.q), _j(x.k), _j(x.v))
    q, k, v = (_t(a).requires_grad_() for a in (x.q, x.k, x.v))
    out = C.attend_chunked(q, k, v, _t(x.q_pos), _t(x.k_pos), **kw)
    (out * _t(w)).sum().backward()
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


def test_attend_torch_route_takes_chunked_at_threshold():
    """S = T = 2048, 2 heads of 16: the reference's ``attend_xla`` hands
    off to its chunked path, and so does the port's ``torch`` route."""
    s = A.CHUNKED_THRESHOLD
    x = _inputs(1, s, s, 2, 1, 16, seed=4)
    want = jattn.attend_xla(_j(x.q), _j(x.k), _j(x.v), _j(x.q_pos),
                            _j(x.k_pos), n_kv_heads=1, causal=True)
    A.reset_dispatch_log()
    before = C.attend_chunked.calls
    got = A.attend(_t(x.q), _t(x.k), _t(x.v), _t(x.q_pos), _t(x.k_pos),
                   n_kv_heads=1, causal=True, backend="torch")
    assert C.attend_chunked.calls == before + 1
    assert A.dispatch_log() == {"prefill": {
        "backend": "torch", "kernel": "attention.flash", "tuning": "n/a",
        "params": {}}}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("s,t,aligned,chunked", [
    (2048, 2048, True, True), (4096, 4096, True, True),
    (2048, 4096, True, True), (1024, 4096, True, False),
    (2048, 3072, True, True), (2048, 2560, True, False),
    (2560, 3072, True, True), (2304, 3072, True, False),
    (2048, 4096, False, False)])
def test_takes_chunked_is_the_reference_condition(s, t, aligned, chunked):
    assert A.takes_chunked(s, t, aligned) is chunked


def test_wrapped_ring_stays_on_the_full_matrix(monkeypatch):
    """k_index_aligned=False (a wrapped ring) keeps the torch route off the
    chunked path, which skips key chunks by index."""
    called = []
    monkeypatch.setattr(A, "attend_chunked",
                        lambda *a, **k: called.append(1))
    x = _inputs(1, 2048, 2048, 2, 1, 16, seed=5)
    A.attend(_t(x.q), _t(x.k), _t(x.v), _t(x.q_pos), _t(x.k_pos),
             n_kv_heads=1, causal=True, backend="torch",
             k_index_aligned=False)
    assert called == []
    A.attend(_t(x.q), _t(x.k), _t(x.v), _t(x.q_pos), _t(x.k_pos),
             n_kv_heads=1, causal=True, backend="torch")
    assert called == [1]
