"""The port's RWKV6 path, held against the JAX package on the CPU.

The plain WKV (``repro_torch/kernels/rwkv6/ref.py``: y and the final state)
against the reference's ``wkv_serial`` and ``wkv_chunked`` and its Pallas
kernel in interpret mode, on the same numpy inputs, at the reference's
``ORACLE_TOL`` (3e-4, 3e-4).  rwkv6-3b SMOKE weights come from the
reference's ``init_params`` and are carried across by ``params_from_jax``:
logits in float32 at (1e-4, 1e-4), as ``test_torch_lm_serving.py`` holds
granite; in bfloat16 at (1e-1, 1e-1), looser than granite's (5e-2, 5e-2)
because an RWKV layer rounds to bfloat16 at about twenty places (token
shift, five lerps, the LoRA and decay paths) against an attention layer's
few, and the two frameworks round some of them differently (measured: at
most 0.082 on logits of magnitude up to 4.5, about three bfloat16 ulps
there).  Greedy tokens, the caches, and decode against prefill follow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rwkv6.ops import wkv_pallas
from repro.models import rwkv as jax_rwkv
from repro.models import transformer as JT
from repro.training import serve_step as JS
import repro_torch.kernels  # noqa: F401
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import conformance, get_kernel
from repro_torch.core.portable import BackendUnavailableError
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ref
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.serving import ServingEngine
from repro_torch.training import serve_step as SS

ARCH = "rwkv6-3b"
TOL = conformance.ORACLE_TOL["rwkv6.wkv"]
F32_TOL = (1e-4, 1e-4)
BF16_TOL = (1e-1, 1e-1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0, b=2, h=3, s=128, dh=32):
    """r, k, v, log-decays, u and a state, drawn as the reference's
    conformance case draws them (log-decays -exp(clip(n, -8, 1)))."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((b, h, s, dh)) * 0.5).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(np.clip(rng.standard_normal((b, h, s, dh)), -8, 1)
                 ).astype(np.float32)
    u = (rng.standard_normal((h, dh)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return (r, k, v, lw, u), s0


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol[0],
                               atol=tol[1])


# ---- the plain WKV ---------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True], ids=["S0=0", "S0"])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_wkv_matches_the_reference(chunk, with_state):
    args, s0 = _inputs()
    state = s0 if with_state else None
    jargs = [jnp.asarray(a) for a in args]
    jstate = None if state is None else jnp.asarray(state)
    want_y, want_s = jax_rwkv.wkv_serial(*jargs, jstate)
    for got_y, got_s in (
            ref.wkv_serial(*_t(args), None if state is None else
                           torch.from_numpy(state)),
            ref.wkv_chunked(*_t(args), None if state is None else
                            torch.from_numpy(state), chunk)):
        _close(got_y, want_y)
        _close(got_s, want_s)
    # the reference's chunked form, and its Pallas kernel (from S = 0)
    cy, cs = jax_rwkv.wkv_chunked(*jargs, jstate, chunk)
    got_y, got_s = ref.wkv_chunked(*_t(args), None if state is None else
                                   torch.from_numpy(state), chunk)
    _close(got_y, cy)
    _close(got_s, cs)
    if not with_state:
        _close(got_y, wkv_pallas(*jargs, chunk=chunk, interpret=True))


@pytest.mark.parametrize("s", [1, 37, 100])
def test_plain_chunked_takes_a_ragged_tail(s):
    """Any S >= 1 with an initial state, against the reference's exact
    recurrence: the padded tail changes neither y nor the state."""
    args, s0 = _inputs(seed=1, s=100)
    args = [a[:, :, :s] if a.ndim == 4 else a for a in args]
    want_y, want_s = jax_rwkv.wkv_serial(*map(jnp.asarray, args),
                                         jnp.asarray(s0))
    for chunk in (16, 64):
        got_y, got_s = ref.wkv_chunked(*_t(args), torch.from_numpy(s0),
                                       chunk)
        assert got_y.shape == (2, 3, s, 32)
        _close(got_y, want_y)
        _close(got_s, want_s)


def test_plain_versions_leave_their_inputs_alone():
    args, s0 = _inputs(s=40)
    tensors, state = _t(args), torch.from_numpy(s0.copy())
    for fn in (ref.wkv_serial, lambda *a: ref.wkv_chunked(*a, 16)):
        fn(*tensors, state)
        np.testing.assert_array_equal(state.numpy(), s0)


def test_wrapper_on_cpu_runs_the_chunked_plain_version_in_place():
    args, s0 = _inputs(s=70)
    tensors = _t(args)
    before = wkv_kernel.wkv.launches
    want_y, want_s = ref.wkv_chunked(*tensors, torch.from_numpy(s0), 32)
    state = torch.from_numpy(s0.copy())
    y, out = wkv_kernel.wkv(*tensors, state, chunk=32)
    assert out is state                       # updated in place
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)
    y0, fresh = wkv_kernel.wkv(*tensors)      # None: zeros, a new tensor
    torch.testing.assert_close(y0, ref.wkv_chunked(*tensors)[0], rtol=0,
                               atol=0)
    assert fresh.shape == (2, 3, 32, 32)
    # the plain version launches nothing
    assert wkv_kernel.wkv.launches == before


def test_wrapper_rejects_what_it_cannot_run():
    (r, k, v, lw, u), s0 = _inputs(s=8)
    r, k, v, lw, u = _t((r, k, v, lw, u))
    with pytest.raises(ValueError, match="one shape"):
        wkv_kernel.wkv(r, k, v[..., :16], lw, u)
    with pytest.raises(ValueError, match="u "):
        wkv_kernel.wkv(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="state"):
        wkv_kernel.wkv(r, k, v, lw, u, torch.zeros(2, 3, 32, 16))
    with pytest.raises(ValueError, match="chunk"):
        wkv_kernel.wkv(r, k, v, lw, u, chunk=48)
    with pytest.raises(ValueError, match="one device"):
        wkv_kernel.wkv(r, k, v, lw.to("meta"), u)
    with pytest.raises(ValueError, match="at least one token"):
        wkv_kernel.wkv(*(x[:, :, :0] for x in (r, k, v, lw)), u)


# ---- the plain mirrors of the kernels' decomposition -----------------------
MIRROR_S = (1, 2, 15, 16, 17, 63, 64, 128, 200)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("s", MIRROR_S)
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mirrors_of_the_kernels_match_the_reference(chunk, s, dh):
    """``wkv_chunk_parallel`` (the three chunk kernels: state increments,
    the scan, the outputs with the triangle factored at sub-chunk edges)
    and, at S = 1, ``wkv_step`` (the one-token kernel), from a random
    state, against the reference's exact recurrence, its chunked form where
    S is a multiple of the chunk, and its Pallas kernel in interpret mode
    from a zero state there.  The log-decays reach -e a step, so that at
    chunk 64 a chunk's cumulative decay passes float32's exp range: an
    intra-chunk factor split as exp(lw_before) * exp(-lw_cum) would be inf
    here."""
    args, s0 = _inputs(seed=s + dh, b=1, h=2, s=s, dh=dh)
    jargs = [jnp.asarray(a) for a in args]
    want_y, want_s = jax_rwkv.wkv_serial(*jargs, jnp.asarray(s0))
    state = torch.from_numpy(s0)
    got_y, got_s = ref.wkv_chunk_parallel(*_t(args), state, chunk)
    assert got_y.shape == (1, 2, s, dh)
    _close(got_y, want_y)
    _close(got_s, want_s)
    np.testing.assert_array_equal(state.numpy(), s0)   # inputs untouched
    if s == 1:
        step_y, step_s = ref.wkv_step(*_t(args), state)
        _close(step_y, want_y)
        _close(step_s, want_s)
    if chunk == 64 and s >= 64:
        lw_cum = np.cumsum(args[3][:, :, :64], axis=2)
        assert np.isinf(np.exp(-lw_cum.astype(np.float32))).any()
    if s % chunk == 0:
        cy, cs = jax_rwkv.wkv_chunked(*jargs, jnp.asarray(s0), chunk)
        _close(got_y, cy)
        _close(got_s, cs)
        zero_y, _ = ref.wkv_chunk_parallel(*_t(args), None, chunk)
        _close(zero_y, wkv_pallas(*jargs, chunk=chunk, interpret=True))


# ---- the registry cell -----------------------------------------------------
def test_registry_cell_on_the_conformance_case():
    k = get_kernel("rwkv6.wkv")
    assert k.native == "cuda" and k.oracle == "torch"
    assert list(k.tunable_space("cuda").points()) == [
        {"chunk": c} for c in (16, 32, 64)]
    assert conformance.check_backend("rwkv6.wkv", "torch") == 0.0
    arrays, _ = conformance.CASES["rwkv6.wkv"]()
    got = k(*conformance.as_tensors(arrays, "cpu"))
    want, _ = jax_rwkv.wkv_serial(*map(jnp.asarray, arrays))
    _close(got, want)
    # the reference's flops model, unchanged
    from repro.kernels.rwkv6 import ops as jax_ops
    for chunk in (16, 64):
        assert k.flops_model(*arrays, chunk=chunk) == \
            jax_ops._flops_model(*arrays, chunk=chunk)


@pytest.mark.parametrize("b,h,s,dh", [(1, 2, 64, 32), (2, 3, 200, 64),
                                      (8, 40, 2048, 64)])
def test_least_flops_is_below_the_chunked_model(b, h, s, dh):
    """The bound's count (4 Dh Dv + 3 Dh + 2 Dv a token and head) stays
    under the reference's model at every chunk, which adds the C x C
    square on top of the same state work."""
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    least = wkv_ops.least_flops(b, h, s, dh, dh)
    assert least == b * h * s * (4 * dh * dh + 5 * dh)
    shaped = [np.zeros((b, h, s, dh), np.float32)] * 4 + [
        np.zeros((h, dh), np.float32)]
    for chunk in wkv_kernel.CHUNK_GRID:
        assert least < get_kernel("rwkv6.wkv").flops_model(*shaped,
                                                            chunk=chunk)


# ---- the model -------------------------------------------------------------
def _both(compute_dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype=compute_dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu")
    return jcfg, jparams, cfg, params


def test_config_fields_and_counts_equal_the_reference():
    for smoke in (False, True):
        ours, theirs = get_config(ARCH, smoke), jax_get_config(ARCH, smoke)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.total_params() == theirs.total_params()
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == \
        (32, 2560, 8960, 65536) and cfg.rwkv and not cfg.use_rope


def test_params_carried_across_layer_for_layer():
    jcfg, jparams, cfg, params = _both()
    assert len(params["segments"]) == 1
    layers = params["segments"][0]
    assert len(layers) == cfg.n_layers
    for i, layer in enumerate(layers):
        np.testing.assert_array_equal(
            layer["tm"]["wr"].numpy(),
            np.asarray(jparams["segments"][0]["tm"]["wr"][i]))
    assert set(layers[0]) == {"tm", "cm", "ln_tm", "ln_cm"}
    # the port's own init draws the same tree of shapes
    own = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda tree: T.tree_map(lambda t: tuple(t.shape), tree)
    assert shapes(own) == shapes(params)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("s", [12, 64], ids=["serial", "chunked"])
def test_forward_logits_match_the_reference(compute_dtype, tol, s):
    jcfg, jparams, cfg, params = _both(compute_dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, s))
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(toks))
    got, caches, _ = T.forward(params, cfg, torch.from_numpy(toks))
    assert caches is None and got.shape == (3, s, cfg.padded_vocab)
    _close(got.float().numpy(), np.asarray(want, np.float32), tol)


def test_init_caches_equal_the_reference():
    jcfg, jparams, cfg, params = _both("bfloat16")
    ours = T.init_caches(cfg, 3, 16, "cpu")
    theirs = JT.init_caches(jcfg, 3, 16)
    assert ours["eager"] == theirs["eager"] == {}
    for name in ("wkv", "tm_last", "cm_last"):
        mine = ours["segments"][0][name]
        ref_leaf = theirs["segments"][0][name]
        assert tuple(mine.shape) == ref_leaf.shape
        assert str(mine.dtype).split(".")[1] == str(ref_leaf.dtype)
        assert not mine.any()
    assert ours["segments"][0]["wkv"].shape == (2, 3, 2, 64, 64)


def test_prefill_caches_equal_the_reference():
    """The state and last tokens the prefill writes in place equal the
    reference's returned caches."""
    jcfg, jparams, cfg, params = _both("float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 64))
    want_logits, want_caches, _ = JS.prefill(jparams, jcfg,
                                             jnp.asarray(toks), cache_len=80)
    got_logits, caches, _ = SS.prefill(params, cfg, torch.from_numpy(toks),
                                       cache_len=80)
    _close(got_logits.numpy(), np.asarray(want_logits), F32_TOL)
    for name in ("wkv", "tm_last", "cm_last"):
        _close(caches["segments"][0][name].numpy(),
               np.asarray(want_caches["segments"][0][name]), TOL)


def test_greedy_generate_equals_the_reference():
    jcfg, jparams, cfg, params = _both("float32")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    want = JS.generate(jparams, jcfg, jnp.asarray(prompt), max_new_tokens=4,
                       cache_len=68)
    got = SS.generate(params, cfg, torch.from_numpy(prompt),
                      max_new_tokens=4, cache_len=68)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_prefill():
    """The reference's ``test_decode_matches_prefill`` bound (0.15) on the
    SMOKE model in its own dtype (bfloat16): S one-token steps through the
    cache against one forward of S."""
    cfg = get_config(ARCH, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, s)))
    full, _, _ = T.forward(params, cfg, toks)
    caches = T.init_caches(cfg, 1, 32, "cpu")
    outs = []
    for t in range(s):
        lg, caches, _ = T.forward(params, cfg, toks[:, t:t + 1],
                                  positions=torch.full((1, 1), t),
                                  caches=caches)
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1).float() - full.float()).abs().max())
    assert err < 0.15, err


def test_wkv_backend_choice_and_no_fallback():
    cfg = get_config(ARCH, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros(1, 4, dtype=torch.int64)
    assert R.resolve_wkv_backend(None, "cpu") == "torch"
    assert R.resolve_wkv_backend("torch", "cpu") == "torch"
    with pytest.raises(BackendUnavailableError, match="CUDA tensors"):
        T.forward(params, cfg, toks, wkv_backend="cuda")
    with pytest.raises(KeyError, match="unknown WKV backend"):
        SS.generate(params, cfg, toks, max_new_tokens=2, cache_len=8,
                    wkv_backend="pallas")
    a, _, _ = T.forward(params, cfg, toks)
    b, _, _ = T.forward(params, cfg, toks, wkv_backend="torch")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_engine_refuses_rwkv_as_the_reference_does():
    cfg = get_config(ARCH, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="recurrent"):
        ServingEngine(params, cfg)
