"""The serving prefill captured as one CUDA graph per bucket.

On the card, ``ServingEngine`` captures each bucket's prefill in its
constructor and replays it for every admission.  Held here against the
eager path on fresh caches (``forward``, then ``sample``): the first token
and the last position's logits, greedy and at a temperature with the same
generator seed, for both cache layouts and on a dense and an MoE smoke
model; two admissions in a row into different slots, whose cache rows
must equal the eager path's; the counters of a run; and the profile of one
replay, which must run ``flash_wgmma_kernel`` once a layer.

The same equalities run on the CPU, where nothing is captured and the
prefill stays eager.  The card's cases are marked ``gpu`` and skip
elsewhere with a reason; this file imports no jax:

    PYTHONPATH=src python -m pytest -m gpu \
        tests/test_torch_prefill_graph_on_card.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import forward, init_caches, init_params
from repro_torch.serving import ServingEngine, gather_caches
from repro_torch.serving import portable as serving_portable
from repro_torch.serving.request import Request
from repro_torch.training.serve_step import sample

#: a dense and an MoE model, at their smoke sizes
ARCHS = ["granite-3-8b", "deepseek-moe-16b"]
BUCKETS = (8, 16)
CACHE_LEN = 32
BLOCK = 8
#: a prompt length in each bucket, admitted in this order
PROMPTS = ((BUCKETS[1], 13), (BUCKETS[0], 5))
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _device(name: str) -> torch.device:
    # decided here, never at import: every xdist worker collects the same
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefill is captured as a CUDA "
                    "graph only on the card")
    return torch.device(name)


def _model(arch: str, device: torch.device,
           compute_dtype: str = "bfloat16"):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute_dtype)
    return init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device), cfg


def _engine(params, cfg, layout: str, temperature: float = 0.0):
    return ServingEngine(params, cfg, num_slots=2, cache_len=CACHE_LEN,
                         prefill_buckets=BUCKETS, cache_layout=layout,
                         block_size=BLOCK, temperature=temperature)


def _eager(params, cfg, prompt: np.ndarray, bucket: int,
           temperature: float, seed: int):
    """The eager prefill on a fresh single-row cache: (the last position's
    logits, the first token, the cache)."""
    device = params["embed"].device
    n = len(prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=device)
    toks[0, bucket - n:] = torch.from_numpy(prompt.astype(np.int64))
    small = init_caches(cfg, 1, CACHE_LEN, device)
    logits, small, _ = forward(params, cfg, toks, caches=small,
                               lengths=torch.tensor([n], device=device),
                               last_only=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = sample(logits[:, -1], gen, temperature)
    return logits[:, -1], int(tok[0]), small


def _rows(caches, slot: int):
    """Each K/V/position leaf's row of ``slot``, by path."""
    out = {}
    for key, c in caches["eager"].items():
        for name, t in c["self"].items():
            out[("eager", key, name)] = t[slot]
    for i, c in enumerate(caches["segments"]):
        for name, t in c["self"].items():
            out[("segments", i, name)] = t[:, slot]
    return out


def _slot_rows(eng: ServingEngine, slot: int):
    if eng.cache_layout == "contiguous":
        return _rows(eng.caches, slot)
    tables = torch.from_numpy(eng.block_tables).long().to(eng.device)
    return _rows(gather_caches(eng.caches, tables, eng.cfg,
                               num_slots=eng.num_slots,
                               cache_len=eng.cache_len,
                               block_size=eng.block_size), slot)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temp"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_admitted_prefill_equals_the_eager_forward(device, arch, layout,
                                                   temperature):
    """Two admissions in a row, one a bucket, into slots 0 and 1: each
    first token and last-position logits equal the eager path's, and after
    both, each slot's cache rows equal its eager cache's."""
    dev = _device(device)
    params, cfg = _model(arch, dev)
    eng = _engine(params, cfg, layout, temperature)
    captured = len(BUCKETS) if dev.type == "cuda" else 0
    assert eng.stats["prefill_traces"] == captured
    rng = np.random.default_rng(3)
    want_rows = {}
    for uid, (bucket, n) in enumerate(PROMPTS):
        seed = 100 + uid
        req = Request(uid=uid, prompt=rng.integers(2, cfg.vocab_size, n)
                      .astype(np.int32), max_new_tokens=4, arrival_time=0.0)
        req.generator = torch.Generator(device=dev).manual_seed(seed)
        eng.submit(req)
        eng._admit(eng.queue.pop_ready(0.0), 0.0, [])
        slot = eng.slot_req.index(req)
        assert slot == uid
        logits, tok0, small = _eager(params, cfg, req.prompt, bucket,
                                     temperature, seed)
        assert req.generated == [tok0]
        # the bucket's graph again on the inputs it was given (its outputs
        # are overwritten by the next prefill)
        got, greedy = eng.prefill_logits(bucket)
        assert torch.equal(got, logits), float((got - logits).abs().max())
        assert int(greedy[0]) == int(logits.argmax(-1)[0])
        want_rows[slot] = _rows(small, 0)
    assert eng.stats["prefill_calls"] == len(PROMPTS)
    assert eng.stats["prefill_replays"] == (
        2 * len(PROMPTS) if dev.type == "cuda" else 0)
    for slot, want in want_rows.items():
        got = _slot_rows(eng, slot)
        for path, t in want.items():
            assert torch.equal(got[path], t), (slot, path)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("arch", ARCHS)
def test_a_run_replays_every_prefill(device, arch):
    """A trace through the synchronous loop: on the card one capture a
    bucket and every prefill a replay, on the CPU no capture and no
    replay; greedy tokens equal unbatched generate's for the dense model
    (the MoE layer's capacity depends on the batch), in float32, so that
    batch-1 and batch-2 GEMMs (other cuBLAS kernels) leave them alone."""
    dev = _device(device)
    params, cfg = _model(arch, dev, "float32")
    eng = _engine(params, cfg, "contiguous")
    trace = serving_portable.conformance_trace(cfg)
    done = eng.run(trace)
    st = eng.stats
    assert st["prefill_calls"] == len(trace)
    if dev.type == "cuda":
        assert st["prefill_traces"] == len(eng.prefill_buckets)
        assert st["prefill_replays"] == st["prefill_calls"]
    else:
        assert st["prefill_traces"] == st["prefill_replays"] == 0
    got = torch.tensor([r.generated for r in sorted(done,
                                                    key=lambda r: r.uid)],
                       dtype=torch.int32)
    assert got.shape == (len(trace), serving_portable.MAX_NEW)
    if cfg.n_experts == 0:
        assert torch.equal(got, serving_portable.unbatched(params, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_a_replay_runs_the_flash_kernel_once_a_layer(arch):
    """One replay of each bucket's graph under ``torch.profiler``: one
    ``flash_wgmma_kernel`` a layer, as the eager prefill ran.  The
    profiler drops a session's first records, so spin kernels go first,
    and a profile that shows fewer is taken again, up to five times."""
    dev = _device("cuda")
    params, cfg = _model(arch, dev)
    eng = _engine(params, cfg, "contiguous")
    for bucket in BUCKETS:
        best = 0
        for _ in range(5):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10000):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                eng.prefill_logits(bucket)
                torch.cuda.synchronize()
            ran = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "flash_wgmma_kernel" in e.key)
            assert ran <= cfg.n_layers, (bucket, ran)
            best = max(best, ran)
            if best == cfg.n_layers:
                break
        assert best == cfg.n_layers, (bucket, best)
