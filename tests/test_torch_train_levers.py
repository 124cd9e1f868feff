"""The port's training levers and guards on the CPU.

On SMOKE configs with float32 masters: remat on and off give equal
gradients (bit for bit on the CPU); two microbatches against one (dense
and hybrid) agree at
(1e-5, 1e-6) on the loss and metrics, 1e-5 on the grad norm and 1e-2 of
the learning rate on the updates (AdamW ``eps`` 1e-3, as
``test_torch_train_step.py`` says why); ``zero1_weights`` against the
baseline within 1e-2 on the loss, as the reference's
``tests/test_perf_levers.py`` holds it, and against the reference's own
zero1 step at (2e-3, 1e-4); MoE ``stopgrad_dispatch`` gives the baseline's
step bit for bit (its one-hots carry no gradient either way) and the
router still learns; the loss falls on an overfit batch; a train state
restored from a checkpoint gives the same next step bit for bit.  The
casts to the compute dtype are the identity on bfloat16 weights (same
``data_ptr``; the serving logits and greedy tokens equal those with no
cast at all).  The guard: every hand-written kernel refuses a tensor that
requires grad, in grad mode, with a ``RuntimeError`` that names it, also
on the RWKV layer's direct call, and nothing falls back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.training import train_step as JS
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.portable import BackendUnavailableError, no_grad_kernel
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.kernels.babelstream import kernel as bs_kernel
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.kernels.hartree_fock import kernel as hf_kernel
from repro_torch.kernels.hartree_fock import ref as hf_ref
from repro_torch.kernels.minibude import kernel as bude_kernel
from repro_torch.kernels.minibude.ops import make_deck
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.stencil7 import kernel as st_kernel
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as T
from repro_torch.models.common import cast_tree
from repro_torch.optim.adamw import AdamWConfig, leaves
from repro_torch.training import train_step as TS
from repro_torch.training.serve_step import generate

OPT = AdamWConfig(warmup_steps=1, eps=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, **over):
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def _masters(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu",
                         dtype=cfg.pdtype())


def _batch(cfg, b=4, s=16, step=0):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b, seed=1, mean_doc_len=8))
    return to_device(data.batch_at(step), "cpu")


def _step(cfg, params, batch, **tkw):
    tcfg = TS.TrainConfig(opt=OPT, **tkw)
    return TS.train_step(TS.make_train_state(params, tcfg), batch, cfg=cfg,
                         tcfg=tcfg)


def test_remat_on_and_off_give_equal_grads():
    cfg = _cfg("granite-3-8b", compute_dtype="float32")
    params, batch = _masters(cfg), _batch(cfg)
    tcfg = TS.TrainConfig(opt=OPT)
    g_on, m_on = TS._grads(params, cfg, batch,
                           dataclasses.replace(tcfg, remat=True))
    g_off, m_off = TS._grads(params, cfg, batch,
                             dataclasses.replace(tcfg, remat=False))
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)


@pytest.mark.parametrize("arch", ["granite-3-8b", "hymba-1.5b"])
def test_two_microbatches_match_one(arch):
    """Not MoE: its routing groups, and so its capacity drops and aux loss,
    follow the microbatch's token count, by design."""
    cfg = _cfg(arch, compute_dtype="float32")
    params, batch = _masters(cfg), _batch(cfg)
    s1, m1 = _step(cfg, params, batch, microbatches=1, remat=False)
    s2, m2 = _step(cfg, params, batch, microbatches=2, remat=False)
    for k in m1:
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    lr = float(m1["lr"])
    for a, b, p0 in zip(leaves(s2["params"]), leaves(s1["params"]),
                        leaves(params)):
        assert float(((a - p0) - (b - p0)).abs().max()) <= 1e-2 * lr


def test_zero1_weights_matches_baseline_and_reference():
    cfg0 = get_config("granite-3-8b", smoke=True)       # bfloat16 compute
    jcfg0 = jax_get_config("granite-3-8b", smoke=True)
    jparams = JT.init_params(jcfg0, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg0,
                               "cpu", dtype=cfg0.pdtype())
    batch = _batch(cfg0)
    losses = {}
    for name, over in (("base", {}), ("zero1", {"zero1_weights": True})):
        s, m = _step(dataclasses.replace(cfg0, **over), params, batch,
                     microbatches=2)
        losses[name] = float(m["loss"])
        assert all(p.dtype == torch.float32 for p in leaves(s["params"]))
    assert abs(losses["base"] - losses["zero1"]) < 1e-2
    jcfg = dataclasses.replace(jcfg0, zero1_weights=True)
    jt = JS.TrainConfig(microbatches=2, opt=JAdamW(warmup_steps=1, eps=1e-3))
    _, jm = jax.jit(lambda s, b: JS.train_step(s, b, cfg=jcfg, tcfg=jt))(
        JS.make_train_state(jparams, jt),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(losses["zero1"], float(jm["loss"]),
                               rtol=2e-3, atol=1e-4)


def test_moe_stopgrad_dispatch_matches_baseline_and_router_learns():
    cfg0 = _cfg("deepseek-moe-16b", compute_dtype="float32")
    params, batch = _masters(cfg0, seed=1), _batch(cfg0, b=2)
    outs = {}
    for name, over in (("base", {}), ("sg", {"moe_stopgrad_dispatch": True})):
        outs[name] = _step(dataclasses.replace(cfg0, **over), params, batch,
                           remat=False)
    assert float(outs["base"][1]["loss"]) == float(outs["sg"][1]["loss"])
    for a, b in zip(leaves(outs["base"][0]["params"]),
                    leaves(outs["sg"][0]["params"])):
        assert torch.equal(a, b)
    seg = outs["sg"][0]["params"]["segments"][0][0]["moe"]["router"]
    r0 = params["segments"][0][0]["moe"]["router"]
    assert float((seg - r0).abs().max()) > 0


def test_loss_falls_on_an_overfit_batch():
    cfg = _cfg("granite-3-8b")
    tcfg = TS.TrainConfig(microbatches=2, opt=AdamWConfig(
        lr_peak=3e-3, warmup_steps=2))
    state = TS.make_train_state(_masters(cfg), tcfg)
    batch = _batch(cfg)
    losses = []
    for _ in range(8):
        state, m = TS.train_step(state, batch, cfg=cfg, tcfg=tcfg)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses


def test_resumed_state_gives_the_same_next_step(tmp_path):
    cfg = _cfg("hymba-1.5b")
    tcfg = TS.TrainConfig(microbatches=2, opt=OPT)
    state = TS.make_train_state(_masters(cfg), tcfg)
    state, _ = TS.train_step(state, _batch(cfg, step=0), cfg=cfg, tcfg=tcfg)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, state, metadata={"arch": cfg.name})
    want_state, want = TS.train_step(state, _batch(cfg, step=1), cfg=cfg,
                                     tcfg=tcfg)
    template = TS.make_train_state(_masters(cfg, seed=9), tcfg)
    restored, manifest = mgr.restore(template)
    assert manifest["step"] == 1 and int(restored["opt"].step) == 1
    got_state, got = TS.train_step(restored, _batch(cfg, step=1), cfg=cfg,
                                   tcfg=tcfg)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for a, b in zip(leaves(got_state), leaves(want_state)):
        assert torch.equal(a, b)


def test_casts_are_the_identity_on_bf16_weights(monkeypatch):
    cfg = _cfg("granite-3-8b")                          # bfloat16 weights
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = params["segments"][0][0]
    cast = cast_tree(lp, cfg.cdtype())
    for a, b in zip(leaves(cast), leaves(lp)):
        assert a is b or a.data_ptr() == b.data_ptr()
    assert params["embed"].to(cfg.cdtype()) is params["embed"]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        logits, _, _ = T.forward(params, cfg, tokens)
        toks = generate(params, cfg, tokens, max_new_tokens=4, cache_len=32)
        monkeypatch.setattr(T, "cast_tree", lambda tree, dtype: tree)
        bare, _, _ = T.forward(params, cfg, tokens)
        bare_toks = generate(params, cfg, tokens, max_new_tokens=4,
                             cache_len=32)
    assert torch.equal(logits, bare) and torch.equal(toks, bare_toks)


# --------------------------------------------------------------------------
# the guard
# --------------------------------------------------------------------------
def test_guard_raises_on_a_tensor_that_requires_grad():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="the attention.flash kernel has "
                                           "no backward.*'torch' backend"):
        no_grad_kernel("attention.flash", torch.ones(2), x)
    no_grad_kernel("attention.flash", torch.ones(2), None, 3)
    with torch.no_grad():
        no_grad_kernel("attention.flash", x)
    no_grad_kernel("attention.flash", x.detach())


def _requires_grad(*ts):
    return tuple(t.clone().requires_grad_() if t.is_floating_point() else t
                 for t in ts)


def test_every_hand_written_wrapper_refuses_grad():
    """On CPU tensors too: the guard comes before the wrapper's choice of
    the plain version, so the CPU tests see what the card would."""
    q = torch.randn(1, 2, 8, 16)
    kv = torch.randn(1, 1, 8, 16)
    pos = torch.arange(8, dtype=torch.int32)[None]
    he2 = (hf_kernel.pad4(hf_ref.helium_lattice(2, device="cpu")),
           hf_ref.initial_density(2, device="cpu"))
    basis = hf_ref.sto_basis(3, device="cpu")
    calls = {
        "attention.flash": lambda: attn_kernel.flash(
            *_requires_grad(q), kv, kv),
        "attention.decode": lambda: attn_kernel.decode(
            *_requires_grad(torch.randn(1, 1, 2, 16)),
            kv.transpose(1, 2), kv.transpose(1, 2), pos[:, -1:], pos),
        "rwkv6.wkv": lambda: wkv_kernel.wkv(
            *_requires_grad(torch.randn(1, 2, 4, 64)),
            torch.randn(1, 2, 4, 64), torch.randn(1, 2, 4, 64),
            -torch.rand(1, 2, 4, 64), torch.randn(2, 64)),
        "stencil7": lambda: st_kernel.laplacian(
            *_requires_grad(torch.randn(4, 4, 4))),
        "babelstream.triad": lambda: bs_kernel.triad(
            *_requires_grad(torch.randn(8), torch.randn(8))),
        "babelstream.dot": lambda: bs_kernel.dot(
            *_requires_grad(torch.randn(8)), torch.randn(8)),
        "minibude.fasten": lambda: bude_kernel.fasten(
            *_requires_grad(*make_deck(4, 2, 8, seed=0, device="cpu"))),
        "hartree_fock.twoel": lambda: hf_kernel.twoel(
            *_requires_grad(*he2), basis),
        "hartree_fock.twoel_slab": lambda: hf_kernel.twoel_slab(
            *_requires_grad(*he2), basis, 0, 1),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"the {name} kernel has no "
                                               f"backward"):
            call()
    for name in ("copy", "mul", "add"):
        fn = getattr(bs_kernel, name)
        args = _requires_grad(*((torch.randn(8),) * (2 if name == "add"
                                                     else 1)))
        with pytest.raises(RuntimeError, match=f"babelstream.{name}"):
            fn(*args)


def test_rwkv_layer_direct_kernel_call_raises(monkeypatch):
    """``time_mix_apply`` calls the WKV wrapper around the registry: with
    the kernel's route chosen, parameters that require grad raise there,
    and no plain WKV runs instead."""
    cfg = _cfg("rwkv6-3b", compute_dtype="float32")
    params = _masters(cfg)
    lp = params["segments"][0][0]
    lp["tm"] = {k: v.requires_grad_() if isinstance(v, torch.Tensor)
                else v for k, v in lp["tm"].items()}
    monkeypatch.setattr(rwkv_mod, "resolve_wkv_backend",
                        lambda backend, device: "cuda")
    ran = []
    monkeypatch.setattr(rwkv_mod.ref, "wkv_chunked",
                        lambda *a, **k: ran.append(1))
    x = torch.randn(2, 64, cfg.d_model)
    with pytest.raises(RuntimeError, match="the rwkv6.wkv kernel has no "
                                           "backward"):
        rwkv_mod.time_mix_apply(lp["tm"], x, cfg.d_model // 64)
    assert ran == []


def test_train_step_under_the_cuda_attention_env_raises(monkeypatch):
    """``REPRO_ATTN_BACKEND`` overrides the step's ``torch`` route, as it
    overrides every explicit backend; on CPU tensors the kernel's route is
    refused before the guard (on the card the guard raises:
    ``tests/test_torch_on_card.py``)."""
    cfg = _cfg("granite-3-8b")
    monkeypatch.setenv("REPRO_ATTN_BACKEND", "cuda")
    with pytest.raises(BackendUnavailableError):
        _step(cfg, _masters(cfg), _batch(cfg))
