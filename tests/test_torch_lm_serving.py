"""The port's LM serving path, held against the JAX package on the CPU.

granite-3-8b SMOKE weights come from the reference's ``init_params`` and are
carried across by ``params_from_jax``; both packages then compute the same
logits (float32 compute at (1e-4, 1e-4); bfloat16 at (5e-2, 5e-2), where the
two frameworks round activations at different places over two layers) and
the same greedy tokens on the reference's ``conformance_trace``.  The port's
engine equals its own unbatched ``generate`` token for token.  The
reference runs on its default XLA attention path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jax_common
from repro.models import transformer as JT
from repro.serving import portable as jax_serving_portable
from repro.serving import trace as jax_trace
from repro.serving.request import Request as JaxRequest
from repro.training import serve_step as JS
import repro_torch.kernels  # noqa: F401
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import conformance, get_kernel
from repro_torch.models import transformer as T
from repro_torch.serving import (Request, RequestQueue, ServingEngine,
                                 SlotAllocator, latency_summary,
                                 synthetic_trace)
from repro_torch.serving import portable as serving_portable
from repro_torch.training import serve_step as SS

F32_TOL = (1e-4, 1e-4)
BF16_TOL = (5e-2, 5e-2)
ARCH = "granite-3-8b"


def _configs(compute_dtype="float32", **changes):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype=compute_dtype, **changes)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype=compute_dtype, **changes)
    return jcfg, cfg


def _both(compute_dtype="float32", **changes):
    jcfg, cfg = _configs(compute_dtype, **changes)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu")
    return jcfg, jparams, cfg, params


# ---- configs ----------------------------------------------------------------
def test_config_fields_and_counts_equal_the_reference():
    for smoke in (False, True):
        ours = get_config(ARCH, smoke=smoke)
        theirs = jax_get_config(ARCH, smoke=smoke)
        assert [f.name for f in dataclasses.fields(ModelConfig)] == \
            [f.name for f in dataclasses.fields(type(theirs))]
        for f in dataclasses.fields(ModelConfig):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.padded_vocab == theirs.padded_vocab
        assert ours.dense_ff() == theirs.dense_ff()
        assert ours.active_params() == theirs.active_params()
        assert ours.total_params() == theirs.total_params()
    cfg = get_config(ARCH)
    assert cfg.pdtype() == torch.float32 and cfg.cdtype() == torch.bfloat16
    # granite-3-8b at full width: 8.37e9 parameters (16.7 GB in bf16)
    assert 8.3e9 < cfg.total_params() < 8.4e9


def test_unported_archs_raise_naming_the_roadmap():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


# ---- model ------------------------------------------------------------------
def test_weights_held_once_in_the_compute_dtype():
    jcfg, jparams, cfg, params = _both("bfloat16")
    layer0 = jax.tree.map(lambda a: a[0], jparams["segments"][0])
    cast = jax_common.cast_tree(layer0, jcfg.cdtype())
    ours = params["segments"][0][0]
    for path in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down"),
                 ("ln1", "scale")):
        got = ours[path[0]][path[1]]
        want = np.asarray(cast[path[0]][path[1]], np.float32)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert params["final_norm"]["scale"].dtype == torch.float32
    assert len(params["segments"][0]) == cfg.n_layers


@pytest.mark.parametrize("compute_dtype,tol", [("float32", F32_TOL),
                                               ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("changes", [{}, {"norm": "layernorm",
                                          "mlp": "gelu", "use_rope": False}],
                         ids=["granite", "layernorm-gelu-sinusoidal"])
def test_forward_logits_match_the_reference(compute_dtype, tol, changes):
    jcfg, jparams, cfg, params = _both(compute_dtype, **changes)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (3, 12))
    lengths = np.array([12, 7, 1])
    for kw in ({}, {"lengths": lengths}):
        want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(toks),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        got, caches, _ = T.forward(params, cfg, torch.from_numpy(toks),
                                **{k: torch.from_numpy(v)
                                   for k, v in kw.items()})
        assert caches is None and got.shape == (3, 12, cfg.padded_vocab)
        rows = np.ones((3, 12), bool)
        if kw:   # pad rows are garbage by contract
            rows = T.leftpad_positions(torch.from_numpy(lengths),
                                       12).numpy() >= 0
        np.testing.assert_allclose(got.float().numpy()[rows],
                                   np.asarray(want, np.float32)[rows],
                                   rtol=tol[0], atol=tol[1])


def test_leftpad_positions_and_cache_shapes_equal_the_reference():
    lengths = np.array([5, 1, 8, 3])
    np.testing.assert_array_equal(
        T.leftpad_positions(torch.from_numpy(lengths), 8).numpy(),
        np.asarray(JT.leftpad_positions(jnp.asarray(lengths), 8)))
    for window in (0, 6):
        jcfg, cfg = _configs(window=window)
        assert T.cache_seq_lens(cfg, 16) == JT.cache_seq_lens(jcfg, 16)
        assert T.layer_plan(cfg) == JT.layer_plan(jcfg)
        ours = T.init_caches(cfg, 3, 16, "cpu")["segments"][0]["self"]
        theirs = JT.init_caches(jcfg, 3, 16)["segments"][0]["self"]
        for name in ("k", "v", "pos"):
            assert tuple(ours[name].shape) == theirs[name].shape
            np.testing.assert_array_equal(ours[name].float().numpy(),
                                          np.asarray(theirs[name],
                                                     np.float32))


def test_sliding_window_ring_decode_matches_the_reference():
    # a window of 6 over 9 prompt tokens: the ring wraps in the prefill and
    # again while decoding
    jcfg, jparams, cfg, params = _both(window=6)
    prompt = np.random.default_rng(3).integers(2, cfg.vocab_size, (1, 9))
    want = np.asarray(JS.generate(jparams, jcfg, jnp.asarray(prompt),
                                  max_new_tokens=6, cache_len=16))
    got = SS.generate(params, cfg, torch.from_numpy(prompt),
                      max_new_tokens=6, cache_len=16)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- serving ------------------------------------------------------------------
def test_greedy_tokens_on_the_conformance_trace_equal_the_reference():
    jcfg, jparams, cfg, params = _both("float32")
    ours = [r.prompt for r in serving_portable.conformance_trace(cfg)]
    theirs = [r.prompt for r in jax_serving_portable.conformance_trace(jcfg)]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jax_serving_portable._unbatched(jparams, jcfg))
    got = serving_portable.unbatched(params, cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        serving_portable.engine_contiguous(params, cfg).numpy(), want)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_engine_equals_unbatched_generate(compute_dtype):
    if compute_dtype == "bfloat16":     # the conformance case, as it is
        args, _ = conformance.case_tensors("serving.engine")
    else:
        _, cfg = _configs("float32")
        args = (T.init_params(cfg, torch.Generator().manual_seed(1), "cpu"),
                cfg)
    k = get_kernel("serving.engine")
    assert k.oracle == "unbatched"
    if compute_dtype == "bfloat16":
        assert conformance.check_backend("serving.engine",
                                         "engine_contiguous") == 0.0
    else:
        assert k.validate(*args, backend="engine_contiguous") == 0.0


def _engine(**kw):
    cfg = get_config(ARCH, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw.setdefault("num_slots", 2)
    kw.setdefault("cache_len", 32)
    return ServingEngine(params, cfg, **kw), cfg


def _req(uid, n, max_new=3, cfg=None, arrival=0.0):
    prompt = np.random.default_rng(uid).integers(2, 200, n).astype(np.int32)
    return Request(uid=uid, prompt=prompt, max_new_tokens=max_new,
                   arrival_time=arrival)


def test_prefill_bucket_choice_and_rejections():
    eng, _ = _engine(prefill_buckets=(16, 4, 8))
    assert eng.prefill_buckets == (4, 8, 16) and eng.prefill_len == 16
    assert [eng._bucket_for(n) for n in (1, 4, 5, 8, 9, 16)] == \
        [4, 4, 8, 8, 16, 16]
    with pytest.raises(ValueError, match="outside"):
        eng.submit(_req(0, 17))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.submit(_req(1, 16, max_new=17))
    with pytest.raises(ValueError, match="fit in cache_len"):
        _engine(prefill_buckets=(64,))
    with pytest.raises(ValueError, match="positive"):
        _engine(prefill_buckets=(0, 8))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), rwkv=True)
        ServingEngine({"embed": torch.zeros(1)}, cfg)


def test_engine_reuses_slots_and_drains():
    eng, cfg = _engine(prefill_buckets=(8, 16))
    reqs = [_req(i, n, max_new=m) for i, (n, m) in
            enumerate([(3, 1), (9, 4), (12, 2), (5, 3), (16, 2)])]
    finished = eng.run(reqs)
    assert sorted(r.uid for r in finished) == list(range(5))
    assert eng.slots.available() == 2 and eng.active_count() == 0
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)
    assert eng.stats["prefill_calls"] == 5
    assert eng.stats["tokens_generated"] == sum(r.max_new_tokens
                                                for r in reqs)
    # a request that finishes on its prefill token never takes a step
    assert len(reqs[0].t_tokens) == 1
    for r in reqs:
        assert r.t_admitted <= r.t_first_token <= r.t_done
    summ = latency_summary(finished)
    assert summ["requests"] == summ["submitted"] == 5
    assert summ["unfinished"] == 0 and "p50_itl_s" in summ


def test_slot_allocator_and_queue():
    slots = SlotAllocator(3)
    assert [slots.alloc() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="no free"):
        slots.alloc()
    slots.free(1)
    with pytest.raises(ValueError, match="already free"):
        slots.free(1)
    with pytest.raises(ValueError, match="out of range"):
        slots.free(3)
    assert slots.alloc() == 1 and slots.in_use() == 3
    q = RequestQueue()
    q.submit(_req(0, 2, arrival=0.5))
    with pytest.raises(ValueError, match="arrival order"):
        q.submit(_req(1, 2, arrival=0.1))
    assert q.peek_ready(0.4) is None and q.next_arrival() == 0.5
    assert q.pop_ready(0.5).uid == 0 and not q


def test_trace_and_summary_equal_the_reference():
    ours = synthetic_trace(6, vocab_size=300, rate=20.0, min_prompt=3,
                           max_prompt=9, max_new_tokens=4, seed=5)
    theirs = jax_trace.synthetic_trace(6, vocab_size=300, rate=20.0,
                                       min_prompt=3, max_prompt=9,
                                       max_new_tokens=4, seed=5)
    for a, b in zip(ours, theirs):
        assert a.arrival_time == b.arrival_time and a.uid == b.uid
        np.testing.assert_array_equal(a.prompt, b.prompt)
    done = []
    for i, (a, b) in enumerate(zip(ours, theirs)):
        for r in (a, b):
            r.t_first_token = r.arrival_time + 0.1 * (i + 1)
            r.t_tokens = [r.t_first_token + 0.01 * j for j in range(3)]
            r.t_done = r.t_tokens[-1]
        done.append(b)
    assert latency_summary(ours) == jax_trace.latency_summary(done)
    assert latency_summary([]) == {"requests": 0, "submitted": 0,
                                   "unfinished": 0}
    assert isinstance(theirs[0], JaxRequest)


def test_sampling():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 2.0, -1.0]])
    assert SS.sample(logits).tolist() == [1, 0]
    assert SS.sample_per_slot(logits, [None, None]).tolist() == [1, 0]
    draws = [SS.sample(logits, torch.Generator().manual_seed(7),
                       temperature=1.0).tolist() for _ in range(2)]
    assert draws[0] == draws[1]            # one generator, one stream
    top1 = SS.sample(logits, torch.Generator().manual_seed(0),
                     temperature=5.0, top_k=1)
    assert top1.tolist()[0] == 1
    rows = SS.sample_per_slot(logits, [torch.Generator().manual_seed(1),
                                       None], temperature=1.0)
    assert rows.dtype == torch.int32 and rows[1] == 0
