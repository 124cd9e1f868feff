"""The port's training substrate held against the JAX package on the CPU.

Losses, AdamW, the int8 error-feedback compression, the data pipeline, the
checkpoint manager and the fault-tolerance classes: the same numpy inputs
from a seed go through the reference's function and the port's.
Tolerances: float32 values at (1e-6, 1e-6) relative/absolute, five AdamW
steps at (1e-6, 1e-7); the int8 payloads and their scales, ``SyntheticLM``
and ``BinaryCorpus`` batches bit for bit.  The checkpoint tests mirror
``tests/test_substrate.py``'s on the port's tensors, and a port state's npz
is read back with numpy alone.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.data import pipeline as jdata
from repro.distributed import fault_tolerance as jft
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.training import losses as jlosses
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as tdata
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import leaves
from repro_torch.training.losses import softmax_xent

F32 = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or F32))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_matches_reference(masked, z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    # plant a few right answers so accuracy is not 0
    targets[0, :3] = logits[0, :3].argmax(-1)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want, wm = jlosses.softmax_xent(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask), z_loss=z_loss)
    got, gm = softmax_xent(_t(logits), _t(targets),
                           None if mask is None else _t(mask), z_loss=z_loss)
    _close(got, want)
    assert set(gm) == set(wm) == {"nll", "accuracy", "z_loss"}
    for k in wm:
        _close(gm[k], wm[k])


def test_softmax_xent_bf16_logits_and_grad():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32)
    targets = rng.integers(0, 33, (2, 5)).astype(np.int32)
    lb = jnp.asarray(logits, jnp.bfloat16)
    want = jax.grad(lambda x: jlosses.softmax_xent(
        x.astype(jnp.float32), jnp.asarray(targets))[0])(
            lb.astype(jnp.float32))
    x = _t(logits).to(torch.bfloat16).float().requires_grad_()
    loss, _ = softmax_xent(x.to(torch.bfloat16), _t(targets))
    ref_loss, _ = jlosses.softmax_xent(lb, jnp.asarray(targets))
    _close(loss, ref_loss)
    loss.backward()
    _close(x.grad, want, rtol=1e-2, atol=1e-3)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def test_cosine_lr_matches_reference():
    cfg = dict(lr_peak=1e-3, warmup_steps=10, decay_steps=100,
               lr_min_ratio=0.1)
    jc, tc = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        _close(adamw.cosine_lr(tc, torch.tensor(step, dtype=torch.int32)),
               jadamw.cosine_lr(jc, jnp.asarray(step, jnp.int32)))


def _tree(rng):
    return {"b": [rng.standard_normal((4,)).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32)],
            "a": {"w": rng.standard_normal((5, 6)).astype(np.float32)}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(2))
    _close(adamw.global_norm(_map(_t, tree)),
           jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))


def test_leaves_order_is_jax_tree_order():
    tree = _tree(np.random.default_rng(3))
    for got, want in zip(leaves(_map(_t, tree)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_apply_updates_five_steps_match_reference():
    rng = np.random.default_rng(4)
    params = _tree(rng)
    cfg = dict(lr_peak=1e-2, warmup_steps=2, decay_steps=10, grad_clip=0.5)
    jc, tc = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp, tp = jax.tree.map(jnp.asarray, params), _map(_t, params)
    js, ts = jadamw.init_state(jp), adamw.init_state(tp)
    for _ in range(5):
        grads = _tree(rng)
        jp, js, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray,
                                                           grads), js, jc)
        tp, ts, tm = adamw.apply_updates(tp, _map(_t, grads), ts, tc)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])
        for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for got, want in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
                _close(got, want, rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 5
    assert ts.step.dtype == torch.int32


def test_apply_updates_leaves_inputs_and_reads_nothing_back():
    p = {"w": torch.ones(3)}
    st = adamw.init_state(p)
    new_p, new_st, m = adamw.apply_updates(p, {"w": torch.ones(3)}, st,
                                           adamw.AdamWConfig())
    assert torch.equal(p["w"], torch.ones(3)) and int(st.step) == 0
    assert not torch.equal(new_p["w"], p["w"]) and int(new_st.step) == 1
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in m.values())


def test_adamw_quadratic_converges():
    cfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=5, decay_steps=200,
                            weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(params)
    for _ in range(150):
        params, state, _ = adamw.apply_updates(
            params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_quantize_int8_bitwise(scale):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4097) * scale).astype(np.float32)
    # exact halves on the grid, where round-half-to-even decides
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                     np.float32) * (np.abs(x).max() / 127.0)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, tsc = compression.quantize_int8(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compression.dequantize_int8(tq, tsc).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


def test_ef_compress_tree_rounds_match_reference():
    rng = np.random.default_rng(6)
    params = _tree(rng)
    jr = jcomp.init_residual(jax.tree.map(jnp.asarray, params))
    tr = compression.init_residual(_map(_t, params))
    total_g, total_applied = None, None
    for _ in range(6):
        grads = _tree(rng)
        jd, jr = jcomp.ef_compress_tree(jax.tree.map(jnp.asarray, grads), jr)
        td, tr = compression.ef_compress_tree(_map(_t, grads), tr)
        for got, want in zip(leaves(td) + leaves(tr),
                             jax.tree.leaves(jd) + jax.tree.leaves(jr)):
            _close(got, want, rtol=1e-6, atol=1e-7)
        g = torch.cat([x.flatten() for x in leaves(_map(_t, grads))])
        d = torch.cat([x.flatten() for x in leaves(td)])
        total_g = g if total_g is None else total_g + g
        total_applied = d if total_applied is None else total_applied + d
    # error feedback: the applied sum trails the true sum by the residual
    r = torch.cat([x.flatten() for x in leaves(tr)])
    torch.testing.assert_close(total_applied + r, total_g, rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_synthetic_lm_bitwise(n_hosts, host_id):
    kw = dict(vocab_size=50_000, seq_len=64, global_batch=4, seed=3,
              n_hosts=n_hosts, host_id=host_id, mean_doc_len=16)
    want = jdata.SyntheticLM(jdata.DataConfig(**kw))
    got = tdata.SyntheticLM(tdata.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        w, g = want.batch_at(step), got.batch_at(step)
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    got.seek(7)
    np.testing.assert_array_equal(next(iter(got))["tokens"],
                                  want.batch_at(7)["tokens"])
    assert got.step == 8


def test_binary_corpus_bitwise(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(7).integers(0, 30_000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(vocab_size=30_000, seq_len=32, global_batch=4, n_hosts=2,
              host_id=1)
    want = jdata.BinaryCorpus(str(path), jdata.DataConfig(**kw))
    got = tdata.BinaryCorpus(str(path), tdata.DataConfig(**kw))
    for step in (0, 3, 40):
        w, g = want.batch_at(step), got.batch_at(step)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    got.seek(3)
    np.testing.assert_array_equal(next(iter(got))["targets"],
                                  want.batch_at(3)["targets"])


def test_prefetcher_yields_in_order():
    cfg = tdata.DataConfig(vocab_size=100, seq_len=8, global_batch=2)
    want = [tdata.SyntheticLM(cfg).batch_at(i)["tokens"] for i in range(4)]
    pf = tdata.Prefetcher(tdata.SyntheticLM(cfg), depth=2)
    got = [next(pf)["tokens"] for _ in range(4)]
    pf.close()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    finite = tdata.Prefetcher([{"x": 1}, {"x": 2}])
    assert [b["x"] for b in finite] == [1, 2]


def test_to_device_cpu():
    batch = tdata.SyntheticLM(tdata.DataConfig(
        vocab_size=100, seq_len=8, global_batch=2)).batch_at(0)
    out = tdata.to_device(batch, "cpu")
    for k, v in batch.items():
        assert out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)


# --------------------------------------------------------------------------
# checkpoint
# --------------------------------------------------------------------------
def _state():
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "layers": [{"b": torch.ones(2, dtype=torch.bfloat16)},
                         {"b": torch.full((2,), 3.0, dtype=torch.bfloat16)}]}
    return {"params": params, "opt": adamw.init_state(params)}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    state["opt"] = state["opt"]._replace(
        step=torch.tensor(7, dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, state, metadata={"arch": "test"})
    template = _state()
    restored, manifest = mgr.restore(template)
    assert manifest["step"] == 7 and manifest["arch"] == "test"
    assert isinstance(restored["opt"], adamw.OptState)
    for got, want, tmpl in zip(leaves(restored), leaves(state),
                               leaves(template)):
        assert got.dtype == tmpl.dtype and got.device == tmpl.device
        assert torch.equal(got, want)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.latest_step() == 4
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_0000000003", "step_0000000004"]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones(4)
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1)        # the snapshot was taken at save
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.ones(4))


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones((3, 3))})
    with pytest.raises(KeyError):
        mgr.restore({"v": torch.ones((2, 2))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_checkpoint_npz_keys_read_with_numpy_alone(tmp_path):
    state = _state()
    CheckpointManager(str(tmp_path)).save(3, state, metadata={"arch": "x"})
    d = tmp_path / "step_0000000003"
    assert sorted(os.listdir(d)) == ["host_0.npz", "manifest.json"]
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "host_0.npz") as z:
        files = sorted(z.files)
        np.testing.assert_array_equal(z["params/w"], np.arange(6).reshape(2, 3))
        np.testing.assert_array_equal(z["params/layers/1/b"], [3.0, 3.0])
        assert z["opt/step"].dtype == np.int32
    assert files == sorted(
        ["params/w", "params/layers/0/b", "params/layers/1/b", "opt/step",
         "opt/mu/w", "opt/mu/layers/0/b", "opt/mu/layers/1/b",
         "opt/nu/w", "opt/nu/layers/0/b", "opt/nu/layers/1/b"])
    assert manifest["n_leaves"] == len(files) and manifest["step"] == 3


def test_checkpoint_keys_match_reference_names(tmp_path):
    """The same tree through both managers writes the same npz keys."""
    tree = {"params": {"a": [np.ones(2, np.float32), np.zeros(3, np.float32)],
                       "b": np.ones((2, 2), np.float32)},
            "step": np.asarray(4, np.int32)}
    jckpt.CheckpointManager(str(tmp_path / "j")).save(
        4, jax.tree.map(jnp.asarray, tree))
    CheckpointManager(str(tmp_path / "t")).save(4, _map(_t, tree))
    keys = []
    for sub in ("j", "t"):
        with np.load(tmp_path / sub / "step_0000000004" / "host_0.npz") as z:
            keys.append(sorted(z.files))
    assert keys[0] == keys[1]


# --------------------------------------------------------------------------
# fault tolerance
# --------------------------------------------------------------------------
def test_straggler_monitor_matches_reference():
    times = [1.0, 1.2, 0.9, 1.1, 1.0, 5.0, 1.0, 3.0, 1.05, 9.0]
    a, b = jft.StragglerMonitor(warmup=3), tft.StragglerMonitor(warmup=3)
    flags = [(a.observe(i, t), b.observe(i, t)) for i, t in enumerate(times)]
    assert all(x == y for x, y in flags) and any(x for x, _ in flags)
    assert a.events == b.events and a.ema == b.ema


def test_preemption_guard_and_heartbeat(tmp_path):
    g = tft.PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    assert not g.should_stop
    os.kill(os.getpid(), signal.SIGUSR1)
    assert g.should_stop
    signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    hb = tft.Heartbeat(str(tmp_path / "hb"), interval_s=0.0)
    hb.beat(12)
    assert (tmp_path / "hb").read_text().startswith("12 ")


@pytest.mark.parametrize("n", [1, 3, 8, 12, 96, 255, 256, 4096])
def test_elastic_mesh_shape_matches_reference(n):
    assert tft.elastic_mesh_shape(n) == jft.elastic_mesh_shape(n)
    assert tft.elastic_mesh_shape(n, 4) == jft.elastic_mesh_shape(n, 4)
