"""The port's ``train_step`` held against the JAX package's on the CPU.

One optimizer step from the same parameters (the reference's float32
``init_params`` carried across as float32 masters, ``params_from_jax(...,
dtype=cfg.pdtype())``) on the same batch, for one SMOKE arch of each family:
dense (granite-3-8b), MoE (deepseek-moe-16b), hybrid SSM (hymba-1.5b),
RWKV (rwkv6-3b), encoder-decoder with frames (whisper-tiny) and the vision
stub with patches (pixtral-12b); two microbatches, remat on.  The reference
trains on its plain XLA attention and jnp WKV; the port on its ``torch``
routes.

Compared: the loss and every metric, the grad norm, the updated
parameters and both moments.  With ``compute_dtype="float32"`` the loss
and metrics agree at (1e-5, 1e-6) relative/absolute, the grad norm at
5e-5 relative, each moment leaf within 5e-4 of its largest entry, and each
parameter's update within 1e-2 of the learning rate (measured: 1.65e-5 on
rwkv6-3b's grad norm and 2.5e-4 on its moments, where the WKV's decays
compound float32 rounding; at most 1.6e-7, 3.4e-6 and 4e-4 elsewhere).  The AdamW ``eps`` is 1e-3 here, not 1e-8: at
the first step Adam's update is g / (|g| + eps), which for eps = 1e-8 is
+-1 for every entry but the near-zero gradients, where it turns on
float32 rounding noise (measured: 17% of the learning rate on one rwkv6
leaf); a larger eps makes the update a smooth function of the gradient,
so the comparison sees the gradient.  One bfloat16 case (granite-3-8b)
at (2e-3, 1e-4) on the loss and metrics, 1e-3 on the grad norm, 0.1 of a
moment leaf's largest entry and 0.5 of the learning rate on the updates
(measured: 2e-4, 9e-5, 3.7e-2 and 0.25).  The EF int8 compression runs in
one step against the reference's too, in float32, on granite-3-8b SMOKE
cut to one layer: the compression's scale is per tensor, and the
reference stacks a segment's layers into one tensor where the port keeps
a tensor a layer, so only one-layer segments give both the same tensors.
There an entry whose (grad + residual) / scale lies within rounding of a
half rounds the other way in one package (each such flip moves its
residual by a whole quantization step), so the moments are held at 5e-2
of a leaf's largest entry and the updates at 0.1 of the learning rate,
and at most 0.1% of the residual's entries may differ by more than 1e-2
of their leaf's largest.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.training import train_step as JS
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, leaves
from repro_torch.training import train_step as TS

FAMILIES = {"dense": "granite-3-8b", "moe": "deepseek-moe-16b",
            "hybrid": "hymba-1.5b", "rwkv": "rwkv6-3b",
            "encoder-decoder": "whisper-tiny", "vision": "pixtral-12b"}
OPT = dict(warmup_steps=1, eps=1e-3)
#: (metrics rtol, atol; grad-norm rtol; moment fraction; update fraction
#: of the learning rate)
TOL = {"float32": (1e-5, 1e-6, 5e-5, 5e-4, 1e-2),
       "bfloat16": (2e-3, 1e-4, 1e-3, 0.1, 0.5),
       "ef": (1e-5, 1e-6, 5e-5, 5e-2, 0.1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, compute_dtype, n_layers=None):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype=compute_dtype)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0))


def batch_np(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _masters(tree, cfg):
    return T.params_from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu",
                             dtype=cfg.pdtype())


def _step_both(arch, compute_dtype, n_layers=None, **tkw):
    jcfg, jparams = _jax_params(arch, compute_dtype, n_layers)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute_dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = _masters(jparams, cfg)
    batch = batch_np(cfg)
    jt = JS.TrainConfig(opt=JAdamW(**OPT), **tkw)
    tt = TS.TrainConfig(opt=AdamWConfig(**OPT), **tkw)
    jstate, jm = jax.jit(lambda s, b: JS.train_step(s, b, cfg=jcfg, tcfg=jt))(
        JS.make_train_state(jparams, jt), jax.tree.map(jnp.asarray, batch))
    tstate, tm = TS.train_step(
        TS.make_train_state(params, tt),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg=cfg, tcfg=tt)
    return cfg, params, (jstate, jm), (tstate, tm)


def _check(cfg, params, ref, port, tol):
    (jstate, jm), (tstate, tm) = ref, port
    m_rtol, m_atol, gn_rtol, mom, upd = TOL[tol]
    assert set(tm) == set(jm)
    for k in jm:
        rtol = gn_rtol if k == "grad_norm" else m_rtol
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   atol=m_atol, err_msg=k)
    assert all(v.dim() == 0 for v in tm.values())
    lr = float(jm["lr"])
    want_p = _masters(jstate["params"], cfg)
    for got, want, p0 in zip(leaves(tstate["params"]), leaves(want_p),
                             leaves(params)):
        assert got.dtype == torch.float32
        err = float(((got - p0) - (want - p0)).abs().max())
        assert err <= upd * lr, (err, lr)
    for name in ("mu", "nu"):
        want_m = _masters(getattr(jstate["opt"], name), cfg)
        for got, want in zip(leaves(getattr(tstate["opt"], name)),
                             leaves(want_m)):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= mom * scale + 1e-30
    assert int(tstate["opt"].step) == int(jstate["opt"].step) == 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_reference_float32(family):
    arch = FAMILIES[family]
    cfg, params, ref, port = _step_both(arch, "float32", microbatches=2,
                                        remat=True)
    _check(cfg, params, ref, port, "float32")


def test_train_step_matches_reference_bfloat16():
    cfg, params, ref, port = _step_both("granite-3-8b", "bfloat16",
                                        microbatches=2, remat=True)
    _check(cfg, params, ref, port, "bfloat16")


def test_train_step_ef_compression_matches_reference():
    cfg, params, ref, port = _step_both("granite-3-8b", "float32",
                                        n_layers=1, compress_pod_grads=True,
                                        remat=False)
    _check(cfg, params, ref, port, "ef")
    want_r = _masters(ref[0]["residual"], cfg)
    off = total = 0
    for got, want in zip(leaves(port[0]["residual"]), leaves(want_r)):
        assert got.dtype == torch.float32
        off += int(((got - want).abs() > 1e-2 * want.abs().max()).sum())
        total += want.numel()
    assert off <= 1e-3 * total, (off, total)
