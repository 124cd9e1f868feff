"""The ten reference archs in the port, held against the JAX package on the
CPU.

For every arch of the reference's ``ARCH_IDS``: the config fields and the
parameter counts, full and smoke; then the SMOKE model with the reference's
``init_params`` weights carried across by ``params_from_jax`` — logits in
float32 at (1e-4, 1e-4) and bfloat16 at (5e-2, 5e-2), as
``test_torch_lm_serving.py`` holds granite (rwkv6-3b's bfloat16 at its own
(1e-1, 1e-1), ``test_torch_rwkv.py``; hymba-1.5b's at rtol 5e-2 with atol
1e-1: its layers round to bfloat16 on an SSM branch and two branch norms
besides the attention, and the frameworks round some of those places
differently — measured on six seeds, at most 0.0635 absolute, on logits
near 0, while float32 agrees at 1e-4), with the stub frontends' ``frames``
and ``patches`` where the arch has them, and the MoE aux loss; greedy
``generate`` tokens; a decode step's logits against the prefill's last
position.  The reference runs on its plain XLA attention path.  The serving
engine admits the MoE archs (deepseek-moe-16b's engine equals its own
``generate``) and refuses the SSM and encoder-decoder archs, as the
reference's does.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.training import serve_step as JS
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.models import transformer as T
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import serve_step as SS

F32_TOL = (1e-4, 1e-4)
#: bfloat16 tolerances other than (5e-2, 5e-2); the docstring says why
#: (rtol, atol)
BF16_TOL = {"rwkv6-3b": (1e-1, 1e-1), "hymba-1.5b": (5e-2, 1e-1)}
MOE = ("deepseek-moe-16b", "llama4-scout-17b-a16e")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, compute_dtype):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype=compute_dtype)
    return jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0))


def _both(arch, compute_dtype="float32"):
    jcfg, jparams = _jax_params(arch, compute_dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute_dtype)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu")
    return jcfg, jparams, cfg, params


def _inputs(cfg, b=2, s=12, seed=0):
    """tokens (B, S) and the frontend stubs' inputs, as numpy; frames and
    patches at std 1."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _stubs(inputs, to):
    return {k: to(v) for k, v in inputs.items() if k != "tokens"}


def test_the_port_has_every_reference_arch():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_fields_and_counts_equal_the_reference(arch):
    for smoke in (False, True):
        ours = get_config(arch, smoke=smoke)
        theirs = jax_get_config(arch, smoke=smoke)
        assert [f.name for f in dataclasses.fields(ModelConfig)] == \
            [f.name for f in dataclasses.fields(type(theirs))]
        for f in dataclasses.fields(ModelConfig):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.padded_vocab == theirs.padded_vocab
        assert ours.dense_ff() == theirs.dense_ff()
        assert ours.active_params() == theirs.active_params()
        assert ours.total_params() == theirs.total_params()


def test_deepseek_moe_16b_fits_one_card_in_bf16():
    # 1.688e10 parameters, 33.8 GB in bf16: the largest arch one 80 GB
    # card serves whole
    n = get_config("deepseek-moe-16b").total_params()
    assert 1.68e10 < n < 1.69e10 and 2 * n < 34e9


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_smoke_logits_and_aux_equal_the_reference(arch, compute_dtype):
    jcfg, jparams, cfg, params = _both(arch, compute_dtype)
    tol = F32_TOL if compute_dtype == "float32" else \
        BF16_TOL.get(arch, (5e-2, 5e-2))
    inp = _inputs(cfg)
    want, _, want_aux = JT.forward(jparams, jcfg,
                                   jnp.asarray(inp["tokens"]),
                                   **_stubs(inp, jnp.asarray))
    got, caches, aux = T.forward(params, cfg,
                                 torch.from_numpy(inp["tokens"]),
                                 **_stubs(inp, torch.from_numpy))
    assert caches is None and got.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), *tol)
    assert aux.dtype == torch.float32 and aux.shape == ()
    # the aux loss is float32 of the router's logits in the compute dtype
    np.testing.assert_allclose(float(aux), float(want_aux), *tol)
    assert (float(aux) > 0) == (arch in MOE)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_greedy_generate_equals_the_reference(arch):
    jcfg, jparams, cfg, params = _both(arch)
    inp = _inputs(cfg, s=10, seed=1)
    want = JS.generate(jparams, jcfg, jnp.asarray(inp["tokens"]),
                       max_new_tokens=6, cache_len=24,
                       **_stubs(inp, jnp.asarray))
    got = SS.generate(params, cfg, torch.from_numpy(inp["tokens"]),
                      max_new_tokens=6, cache_len=24,
                      **_stubs(inp, torch.from_numpy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_decode_step_equals_the_prefills_last_position(arch):
    """A prefill of S - 1 tokens and one decode step give the logits of a
    prefill of all S at its last position (hymba's SSM state and conv
    state, whisper's encoder memory and the MoE routing carried across)."""
    _, _, cfg, params = _both(arch)
    inp = _inputs(cfg, s=11, seed=2)
    toks = torch.from_numpy(inp["tokens"])
    stubs = _stubs(inp, torch.from_numpy)
    full, _, _ = SS.prefill(params, cfg, toks, cache_len=24, **stubs)
    _, caches, memory = SS.prefill(params, cfg, toks[:, :-1], cache_len=24,
                                   **stubs)
    assert (memory is not None) == cfg.is_encoder_decoder
    step, _ = SS.decode_step(params, cfg, toks[:, -1:],
                             torch.full((2, 1), 10, dtype=torch.int32),
                             caches, memory=memory)
    np.testing.assert_allclose(step.numpy(), full.numpy(), *F32_TOL)


def test_caches_equal_the_reference_in_layout_and_after_a_prefill():
    """hymba's caches: ring and full K/V, and the SSM and conv state,
    stacked per segment as the reference's; after the same prefill each
    leaf holds the reference's values."""
    jcfg, jparams, cfg, params = _both("hymba-1.5b")
    toks = _inputs(cfg, s=20, seed=3)["tokens"]
    _, want, _ = JS.prefill(jparams, jcfg, jnp.asarray(toks), cache_len=24)
    _, got, _ = SS.prefill(params, cfg, torch.from_numpy(toks), cache_len=24)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert flat
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_allclose(node.float().numpy(),
                                   np.asarray(leaf, np.float32), *F32_TOL,
                                   err_msg=str(path))


def test_params_from_jax_carries_the_encoder_and_defaults_to_the_card():
    assert inspect.signature(T.params_from_jax).parameters[
        "device"].default == "cuda"
    _, jparams, cfg, params = _both("whisper-tiny", "bfloat16")
    enc = params["encoder"]
    assert len(enc["layers"]) == cfg.n_encoder_layers
    assert enc["final_norm"]["scale"].dtype == torch.float32
    assert enc["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        enc["layers"][1]["mlp"]["w_up"].float().numpy(),
        np.asarray(jparams["encoder"]["layers"]["mlp"]["w_up"][1]
                   .astype(jnp.bfloat16), np.float32))
    # the port's own init makes the same tree
    ours = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = T.tree_map(lambda t: tuple(t.shape), ours)
    assert shapes == T.tree_map(lambda t: tuple(t.shape), params)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_init_params_makes_the_reference_tree(arch):
    """The port's random init: the same leaves, shapes and dtypes as the
    reference's weights carried across."""
    cfg = get_config(arch, smoke=True)
    ours = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, _, _, carried = _both(arch, cfg.compute_dtype)
    assert T.tree_map(lambda t: (tuple(t.shape), t.dtype), ours) == \
        T.tree_map(lambda t: (tuple(t.shape), t.dtype), carried)


def test_engine_serves_deepseek_moe_as_its_generate():
    cfg = get_config("deepseek-moe-16b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 4), (9, 3), (3, 5), (12, 2),
                                        (7, 4)])]
    eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                        prefill_buckets=(8, 16))
    eng.run(reqs)
    for r in reqs:
        want = SS.generate(params, cfg, torch.from_numpy(
            r.prompt.astype(np.int64))[None], max_new_tokens=r.max_new_tokens,
            cache_len=32)
        assert r.generated == want[0].tolist(), r.uid


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-tiny", "rwkv6-3b"])
def test_engine_refuses_recurrent_and_encoder_state(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine({"embed": torch.zeros(1)}, cfg)


def test_encoder_decoder_needs_frames_or_memory():
    _, _, cfg, params = _both("whisper-tiny")
    with pytest.raises(ValueError, match="frames"):
        T.forward(params, cfg, torch.zeros(1, 4, dtype=torch.int64))
