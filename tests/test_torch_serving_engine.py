"""The port's serving engine v2, held against the JAX package on the CPU.

The paged KV pool (``serving/paged.py``, ``BlockAllocator``), the paged and
threaded engines and ``run_threaded``.  granite-3-8b SMOKE weights come
from the reference's ``init_params`` and are carried across by
``params_from_jax`` (float32 compute, so that both frameworks pick the same
greedy tokens); pools, tables and positions are drawn with numpy from a
seed and handed to both packages.  The pool functions are compared bit for
bit: they only move data.  On the CPU the engine's decode step runs
eagerly; ``tests/test_torch_on_card.py`` holds the captured step.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serving import paged as jax_paged
from repro.serving import portable as jax_serving_portable
from repro.serving import slots as jax_slots
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.core import conformance, get_kernel
from repro_torch.models import transformer as T
from repro_torch.serving import (RESERVED_BLOCKS, SENTINEL_BLOCK, TRASH_BLOCK,
                                 BlockAllocator, Request, ServingEngine,
                                 check_paged_geometry, gather_caches,
                                 init_paged_caches, scatter_decode,
                                 scatter_prefill, scatter_slot_cache)
from repro_torch.serving import portable as serving_portable
from repro_torch.training import serve_step as SS

ARCH = "granite-3-8b"
#: a window over every layer but one global layer: the eager layer pages
#: (batch axis 0), the windowed segment keeps its ring (batch axis 1)
WINDOWED = {"window": 6, "global_layers": (1,)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one torch thread per test worker, so parallel
    workers' thread pools do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**changes):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               compute_dtype="float32", **changes)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32", **changes)
    return jcfg, cfg


def _both(**changes):
    jcfg, cfg = _configs(**changes)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu")
    return jcfg, jparams, cfg, params


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_numpy(tree):
    return T.tree_map(lambda t: np.asarray(t), tree)


def _leaves(tree):
    """(path, leaf) of a cache tree, in a fixed order."""
    out = [(f"eager/{i}/{n}", t) for i, c in sorted(tree["eager"].items())
           for n, t in sorted(c["self"].items())]
    out += [(f"segments/{s}/{n}", t) for s, c in enumerate(tree["segments"])
            for n, t in sorted(c["self"].items())]
    return out


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _random_pool(cfg, rng, *, num_slots, cache_len, block_size, num_blocks):
    """A numpy pool in the paged layout with random K/V and positions
    everywhere but the sentinel page, which holds its invariant."""
    pool = _to_numpy(init_paged_caches(
        cfg, num_slots=num_slots, cache_len=cache_len,
        block_size=block_size, num_blocks=num_blocks, device="cpu"))
    lens = T.cache_seq_lens(cfg, cache_len)
    paged_of = {f"eager/{i}": n == cache_len
                for i, n in lens["eager"].items()}
    paged_of.update({f"segments/{s}": n == cache_len
                     for s, n in enumerate(lens["segments"])})
    for path, leaf in _leaves(pool):
        if leaf.dtype == np.int32:
            leaf[...] = rng.integers(0, cache_len, leaf.shape)
        else:
            leaf[...] = rng.standard_normal(leaf.shape)
        if paged_of[path.rsplit("/", 1)[0]]:
            axis = 0 if path.startswith("eager") else 1
            sentinel = np.take(leaf, SENTINEL_BLOCK, axis=axis)
            sentinel[...] = -1 if leaf.dtype == np.int32 else 0
            if axis == 0:
                leaf[SENTINEL_BLOCK] = sentinel
            else:
                leaf[:, SENTINEL_BLOCK] = sentinel
    return pool


def _tables(rng, num_slots, pages, num_blocks, inactive=()):
    """Random distinct owned pages per slot; inactive rows all trash."""
    ids = rng.permutation(np.arange(RESERVED_BLOCKS, num_blocks))
    tables = ids[:num_slots * pages].reshape(num_slots, pages).astype(
        np.int32)
    for s in inactive:
        tables[s] = TRASH_BLOCK
    return tables


# ---- BlockAllocator ------------------------------------------------------
def test_block_constants_equal_the_reference():
    assert (SENTINEL_BLOCK, TRASH_BLOCK, RESERVED_BLOCKS) == (
        jax_slots.SENTINEL_BLOCK, jax_slots.TRASH_BLOCK,
        jax_slots.RESERVED_BLOCKS)


@pytest.mark.parametrize("num_blocks,block_size", [(6, 8), (11, 3)])
def test_block_allocator_follows_the_reference(num_blocks, block_size):
    ours = BlockAllocator(num_blocks, block_size)
    theirs = jax_slots.BlockAllocator(num_blocks, block_size)

    def both(op, *args):
        results = []
        for a in (ours, theirs):
            try:
                results.append(("ok", getattr(a, op)(*args)))
            except (RuntimeError, ValueError) as exc:
                results.append((type(exc).__name__, None))
        assert results[0] == results[1], (op, args, results)
        assert ours.available() == theirs.available()
        assert ours.in_use() == theirs.in_use()
        return results[0][1]

    assert both("capacity") == num_blocks - RESERVED_BLOCKS
    for prompt_len, new in [(1, 1), (8, 1), (8, 2), (3, 6), (17, 9)]:
        both("blocks_for", prompt_len, new)
    a = both("alloc", 2)
    assert a == [RESERVED_BLOCKS, RESERVED_BLOCKS + 1]    # lowest first
    both("alloc", num_blocks)                 # exhausted
    both("alloc", -1)
    b = both("alloc", 1)
    both("free", a)
    both("free", [a[0]])                      # double free
    both("free", [SENTINEL_BLOCK])            # reserved
    both("free", [num_blocks])                # out of range
    assert both("alloc", 3)[:2] == a          # freed ids come back first
    both("free", b)
    with pytest.raises(ValueError, match="reserved"):
        BlockAllocator(RESERVED_BLOCKS, 8)
    with pytest.raises(ValueError, match="block_size"):
        BlockAllocator(8, 0)


# ---- the page pool -------------------------------------------------------
@pytest.mark.parametrize("cache_len,block_size,num_blocks", [
    (32, 8, 10), (32, 5, 10), (32, 8, 2), (32, 0, 10)])
def test_paged_geometry_checks_equal_the_reference(cache_len, block_size,
                                                   num_blocks):
    outcome = []
    for fn in (check_paged_geometry, jax_paged.check_paged_geometry):
        try:
            outcome.append(fn(cache_len, block_size, num_blocks))
        except ValueError as exc:
            outcome.append(str(exc))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("changes", [{}, WINDOWED], ids=["full", "window"])
def test_init_paged_caches_shapes_and_sentinel(changes):
    jcfg, cfg = _configs(**changes)
    kw = dict(num_slots=3, cache_len=32, block_size=8, num_blocks=14)
    ours = init_paged_caches(cfg, device="cpu", **kw)
    _assert_trees_equal(_to_numpy(ours), _to_numpy(
        jax.tree.map(np.asarray, jax_paged.init_paged_caches(jcfg, **kw))))
    lens = T.cache_seq_lens(cfg, 32)
    for path, leaf in _leaves(ours):
        assert bool((leaf == (-1 if leaf.dtype == torch.int32 else 0)).all())
    # the layout: paged entries hold pages, a window's ring its slots
    if changes:
        assert lens == {"eager": {"1": 32}, "segments": [6]}
        assert tuple(ours["eager"]["1"]["self"]["k"].shape[:2]) == (14, 8)
        assert tuple(ours["segments"][0]["self"]["k"].shape[1:3]) == (3, 6)
    else:
        assert tuple(ours["segments"][0]["self"]["pos"].shape) == (
            cfg.n_layers, 14, 8)


@pytest.mark.parametrize("changes", [{}, WINDOWED], ids=["full", "window"])
def test_gather_caches_equals_the_reference(changes):
    jcfg, cfg = _configs(**changes)
    rng = np.random.default_rng(0)
    geo = dict(num_slots=3, cache_len=32, block_size=8)
    pool = _random_pool(cfg, rng, num_blocks=16, **geo)
    tables = _tables(rng, 3, 4, 16, inactive=(1,))
    tables[2, 3] = SENTINEL_BLOCK
    want = jax_paged.gather_caches(jax.tree.map(jnp.asarray, pool),
                                   jnp.asarray(tables), jcfg, **geo)
    got = gather_caches(_to_torch(pool), torch.from_numpy(tables).long(),
                        cfg, **geo)
    _assert_trees_equal(_to_numpy(got), jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("changes", [{}, WINDOWED], ids=["full", "window"])
def test_scatter_prefill_equals_the_reference_and_keeps_the_sentinel(
        changes):
    jcfg, cfg = _configs(**changes)
    rng = np.random.default_rng(1)
    cache_len, bs, nb = 32, 8, 16
    pool = _random_pool(cfg, rng, num_slots=3, cache_len=cache_len,
                        block_size=bs, num_blocks=nb)
    # a fresh single-row cache holding 11 prompt positions: K/V 0 and pos
    # -1 past them, as the engine's emptied prefill cache is
    small = _to_numpy(T.init_caches(cfg, 1, cache_len, "cpu"))
    for path, leaf in _leaves(small):
        axis = 1 if path.startswith("eager") else 2
        n = min(11, leaf.shape[axis])          # a window's ring is 6
        idx = [slice(None)] * leaf.ndim
        idx[axis] = slice(0, n)
        if leaf.dtype == np.int32:
            leaf[tuple(idx)] = np.arange(n)
        else:
            leaf[tuple(idx)] = rng.standard_normal(leaf[tuple(idx)].shape)
    # two owned pages, then the sentinel twice: duplicate indices
    row = np.array([5, 9, SENTINEL_BLOCK, SENTINEL_BLOCK], np.int32)
    want = jax_paged.scatter_prefill(
        jax.tree.map(jnp.asarray, pool), jax.tree.map(jnp.asarray, small),
        jnp.asarray(row), 2, jcfg, cache_len=cache_len, block_size=bs)
    got = _to_torch(pool)
    assert scatter_prefill(got, _to_torch(small),
                           torch.from_numpy(row).long(), 2, cfg,
                           cache_len=cache_len, block_size=bs) is None
    _assert_trees_equal(_to_numpy(got), jax.tree.map(np.asarray, want))
    # the sentinel page is still all-empty: every duplicate write to it
    # was the same empty page
    for path, leaf in _leaves(got):
        if leaf.shape[0 if path.startswith("eager") else 1] == nb:
            page = leaf.select(0 if path.startswith("eager") else 1,
                               SENTINEL_BLOCK)
            assert bool((page == (-1 if leaf.dtype == torch.int32
                                  else 0)).all()), path


def test_scatter_prefill_then_gather_gives_the_contiguous_cache():
    """Real prefills into two slots: the pool gathered through the tables
    equals, bit for bit, the contiguous engine's cache after the same
    inserts (a pool page per 8 positions, the rest on the sentinel)."""
    _, _, cfg, params = _both()
    cache_len, bs, nb, slots = 32, 8, 12, 3
    pool = init_paged_caches(cfg, num_slots=slots, cache_len=cache_len,
                             block_size=bs, num_blocks=nb, device="cpu")
    contig = T.init_caches(cfg, slots, cache_len, "cpu")
    tables = np.full((slots, cache_len // bs), TRASH_BLOCK, np.int32)
    rng = np.random.default_rng(2)
    for slot, (length, pages) in {0: (13, [4, 2]), 2: (5, [7])}.items():
        prompt = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                               (1, 16)))
        small = T.init_caches(cfg, 1, cache_len, "cpu")
        T.forward(params, cfg, prompt, caches=small,
                  lengths=torch.tensor([length]), last_only=True)
        scatter_slot_cache(contig, small, slot)
        tables[slot] = SENTINEL_BLOCK
        tables[slot, :len(pages)] = pages
        scatter_prefill(pool, small, torch.from_numpy(tables[slot]).long(),
                        slot, cfg, cache_len=cache_len, block_size=bs)
    got = gather_caches(pool, torch.from_numpy(tables).long(), cfg,
                        num_slots=slots, cache_len=cache_len, block_size=bs)
    for path, a in _leaves(got):
        b = dict(_leaves(contig))[path]
        for slot in (0, 2):
            assert torch.equal(a[:, slot], b[:, slot]), (path, slot)


@pytest.mark.parametrize("changes", [{}, WINDOWED], ids=["full", "window"])
def test_scatter_decode_equals_the_reference_one_entry_a_slot(changes):
    jcfg, cfg = _configs(**changes)
    rng = np.random.default_rng(3)
    cache_len, bs, nb, slots = 32, 8, 20, 4
    pool = _random_pool(cfg, rng, num_slots=slots, cache_len=cache_len,
                        block_size=bs, num_blocks=nb)
    tables = _tables(rng, slots, cache_len // bs, nb, inactive=(2,))
    positions = np.array([0, 17, 30, 31], np.int32)
    # the decode step's view: fresh values in the paged entries (kept
    # apart from the pool's by their range), the pool's own ring in a
    # window's entry, which the step wrote in place
    new = _to_numpy(T.init_caches(cfg, slots, cache_len, "cpu"))
    got = _to_torch(pool)
    new_t = _to_torch(new)
    lens = T.cache_seq_lens(cfg, cache_len)
    for (path, leaf), (_, ring), (_, ring_t), (_, new_leaf_t) in zip(
            _leaves(new), _leaves(pool), _leaves(got), _leaves(new_t)):
        if leaf.shape == ring.shape:
            leaf[...] = ring
            continue
        leaf[...] = (rng.integers(1000, 2000, leaf.shape)
                     if leaf.dtype == np.int32
                     else rng.standard_normal(leaf.shape))
        new_leaf_t.copy_(torch.from_numpy(leaf))
    for c_new, c_pool in zip([*new_t["eager"].values(), *new_t["segments"]],
                             [*got["eager"].values(), *got["segments"]]):
        for name, t in c_pool["self"].items():
            if t.shape == c_new["self"][name].shape:
                c_new["self"][name] = t          # the same ring tensor
    want = jax_paged.scatter_decode(
        jax.tree.map(jnp.asarray, pool), jax.tree.map(jnp.asarray, new),
        jnp.asarray(positions), jnp.asarray(tables), jcfg,
        cache_len=cache_len, block_size=bs)
    scatter_decode(got, new_t, torch.from_numpy(positions),
                   torch.from_numpy(tables).long(), cfg, cache_len=cache_len,
                   block_size=bs)
    want = jax.tree.map(np.asarray, want)
    for (path, a), (_, w), (_, before), (_, n) in zip(
            _leaves(got), _leaves(want), _leaves(pool), _leaves(new)):
        a = a.numpy()
        np.testing.assert_array_equal(a, w, err_msg=path)
        entry = path.rsplit("/", 1)[0]
        eager = entry.startswith("eager")
        seq = (lens["eager"][entry.split("/")[1]] if eager
               else lens["segments"][int(entry.split("/")[1])])
        if seq != cache_len:
            # a window's ring: the scatter leaves it as the step wrote it
            np.testing.assert_array_equal(a, before, err_msg=path)
            continue
        # exactly one entry a slot changed, at tables[s, pos // bs] and
        # pos % bs; the inactive slot's at the trash page
        a, before, n = ((x[None] if eager else x) for x in (a, before, n))
        changed = np.argwhere((a != before).reshape(a.shape[:3] + (-1,))
                              .any(-1))
        expect = {(layer, int(tables[s, p // bs]), int(p % bs))
                  for layer in range(a.shape[0])
                  for s, p in enumerate(positions)}
        assert {tuple(map(int, c)) for c in changed} == expect, path
        assert (0, TRASH_BLOCK, int(positions[2] % bs)) in expect
        for s, p in enumerate(positions):
            np.testing.assert_array_equal(
                a[:, tables[s, p // bs], p % bs], n[:, s, p], err_msg=path)


# ---- the engines ---------------------------------------------------------
@pytest.mark.parametrize("changes", [{}, WINDOWED], ids=["full", "window"])
def test_paged_and_threaded_engines_equal_the_reference_engine(changes):
    jcfg, jparams, cfg, params = _both(**changes)
    want = np.asarray(jax_serving_portable._run_engine(
        jparams, jcfg, cache_layout="paged"))
    unbatched = serving_portable.unbatched(params, cfg).numpy()
    np.testing.assert_array_equal(unbatched, want)
    for backend in (serving_portable.engine_paged,
                    serving_portable.engine_threaded,
                    serving_portable.engine_contiguous):
        np.testing.assert_array_equal(backend(params, cfg).numpy(), want,
                                      err_msg=backend.__name__)


@pytest.mark.parametrize("backend", ["unbatched", "engine_contiguous",
                                     "engine_paged", "engine_threaded"])
def test_engine_backends_pass_the_bitwise_conformance(backend):
    assert conformance.oracle_tolerance("serving.engine", backend) == \
        "bitwise"
    assert conformance.check_backend("serving.engine", backend) == 0.0


def test_engine_backends_equal_the_reference_registry():
    from repro.core.portable import get_kernel as jax_get_kernel
    ours = get_kernel("serving.engine")
    theirs = jax_get_kernel("serving.engine")
    assert sorted(ours.backends) == sorted(theirs.backends)
    assert ours.oracle == theirs.oracle == "unbatched"
    assert serving_portable.BLOCK_SIZE == jax_serving_portable.BLOCK_SIZE


def _engine(cfg, params, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("cache_len", 32)
    return ServingEngine(params, cfg, **kw)


def _reqs(cfg, lens, max_new=6, arrivals=None, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=max_new,
                    arrival_time=0.0 if arrivals is None else arrivals[i])
            for i, n in enumerate(lens)]


def _generate(params, cfg, req, cache_len):
    return SS.generate(params, cfg, torch.from_numpy(
        req.prompt[None].astype(np.int64)), max_new_tokens=req.max_new_tokens,
        cache_len=cache_len)[0].tolist()


def test_paged_engine_defaults_and_stats_equal_the_reference():
    jcfg, jparams, cfg, params = _both()
    kw = dict(num_slots=3, cache_len=32, prefill_len=16,
              cache_layout="paged")
    ours = ServingEngine(params, cfg, **kw)
    theirs = JaxServingEngine(jparams, jcfg, **kw)
    assert (ours.num_blocks, ours.block_size, ours.pages_per_slot) == (
        theirs.num_blocks, theirs.block_size, theirs.pages_per_slot)
    assert ours.num_blocks == 3 * 32 // 16 + RESERVED_BLOCKS
    np.testing.assert_array_equal(ours.block_tables, theirs.block_tables)
    # the reference's counters, and the port's four of its own
    assert set(ours.stats) - set(theirs.stats) == {
        "graph_replays", "prefill_replays", "page_waits", "pages_peak"}
    assert set(theirs.stats) <= set(ours.stats)
    # on CPU weights the prefill and the decode step run eagerly: nothing
    # is captured
    ours.run(_reqs(cfg, [3, 9], max_new=3))
    assert ours.stats["decode_traces"] == ours.stats["prefill_traces"] == 0
    assert ours.stats["graph_replays"] == ours.stats["prefill_replays"] == 0
    assert ours.stats["decode_steps"] > 0
    with pytest.raises(ValueError, match="cache_layout"):
        ServingEngine(params, cfg, cache_layout="ring")
    with pytest.raises(ValueError, match="multiple of block_size"):
        ServingEngine(params, cfg, cache_len=30, prefill_len=16,
                      cache_layout="paged", block_size=8)


def test_page_admission_is_head_of_line_and_frees_on_finish():
    _, _, cfg, params = _both()
    # 3 pages of 8 behind 4 slots: pages, not slots, gate admission
    eng = _engine(cfg, params, num_slots=4, cache_len=16, prefill_len=8,
                  cache_layout="paged", block_size=8,
                  num_blocks=RESERVED_BLOCKS + 3)
    # pages: 2, 2 (waits: 1 free), then 1, which would fit but may not
    # jump the queue
    reqs = _reqs(cfg, [8, 7, 2], max_new=4)
    order = []
    admit = eng._admit

    def record(req, now, finished):
        order.append((req.uid, eng.balloc.available()))
        admit(req, now, finished)

    eng._admit = record
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.submit(reqs[2])
    eng.step()
    assert order == [(0, 3)]                  # 1 and 2 wait behind 1
    assert eng.stats["page_waits"] == 1       # 1 waited, once
    row = eng.block_tables[0]
    assert list(row[:2]) == eng._slot_blocks[0] == [RESERVED_BLOCKS,
                                                    RESERVED_BLOCKS + 1]
    assert eng.balloc.in_use() == 2
    while eng.queue or eng.active_count():
        eng.step()
    assert [uid for uid, _ in order] == [0, 1, 2]
    assert eng.stats["page_waits"] == 1
    assert eng.stats["pages_peak"] == 3       # 1 and 2 together
    # _finish gave back every page and parked every row on the trash page
    assert eng.balloc.available() == eng.balloc.capacity()
    assert np.all(eng.block_tables == TRASH_BLOCK)
    assert all(not b for b in eng._slot_blocks)
    for r in reqs:
        assert r.generated == _generate(params, cfg, r, 16)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_hooks_repeat_the_last_step(layout):
    """``decode_tokens`` outside a loop repeats the last step (each slot
    writes the same cache entry again), and ``decode_logits`` on the
    static inputs gives the same logits, eager or not, on the CPU."""
    _, _, cfg, params = _both()
    eng = _engine(cfg, params, num_slots=2, cache_len=32, prefill_len=16,
                  cache_layout=layout, block_size=8)
    for r in _reqs(cfg, [5, 11], max_new=8):
        eng.submit(r)
    eng.step()
    assert eng.active_count() == 2
    first = eng.decode_tokens()
    np.testing.assert_array_equal(eng.decode_tokens(), first)
    logits, toks = eng.decode_logits()
    eager, _ = eng.decode_logits(eager=True)
    assert torch.equal(logits, eager)
    np.testing.assert_array_equal(toks.numpy(), first)
    assert eng.stats["graph_replays"] == 0


def test_request_larger_than_the_pool_is_rejected():
    _, _, cfg, params = _both()
    eng = _engine(cfg, params, cache_len=16, prefill_len=8,
                  cache_layout="paged", block_size=2,
                  num_blocks=RESERVED_BLOCKS + 3)      # 6 positions
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(Request(uid=0, prompt=np.arange(2, 8, dtype=np.int32),
                           max_new_tokens=4))          # needs 5 pages
    with pytest.raises(ValueError, match="KV pages"):
        eng.run_threaded([Request(uid=1, prompt=np.arange(2, 8,
                                                          dtype=np.int32),
                                  max_new_tokens=4)])
    assert not eng.queue and eng.balloc.available() == 3


@pytest.mark.parametrize("switch_s", [None, 1e-6],
                         ids=["default-switch", "fast-switch"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_run_threaded_equals_run(layout, switch_s):
    """The fast-switch case hands the interpreter between the three
    threads every microsecond: a lost update to the engine's slots, pages
    or queues would show as a wrong token or a page not given back."""
    _, _, cfg, params = _both()

    def serve(threaded):
        eng = _engine(cfg, params, cache_len=48, prefill_buckets=(8, 16),
                      cache_layout=layout, block_size=8)
        reqs = _reqs(cfg, [3, 9, 12, 5, 7], max_new=6,
                     arrivals=[0.0, 0.0, 0.01, 0.02, 0.03])
        done = eng.run_threaded(reqs) if threaded else eng.run(reqs)
        assert eng.stats["requests_finished"] == 5
        assert eng.active_count() == 0 and not eng.queue
        if layout == "paged":
            assert eng.balloc.available() == eng.balloc.capacity()
        return {r.uid: list(r.generated) for r in done}

    threads = set(threading.enumerate())
    want = serve(threaded=False)
    interval = sys.getswitchinterval()
    try:
        if switch_s is not None:
            sys.setswitchinterval(switch_s)
        got = serve(threaded=True)
    finally:
        sys.setswitchinterval(interval)
    assert got == want
    assert set(threading.enumerate()) == threads    # both threads joined


def test_run_threaded_raises_a_thread_error_on_the_caller():
    _, _, cfg, params = _both()
    eng = _engine(cfg, params, prefill_len=16, cache_layout="paged",
                  block_size=8)

    def broken(*args, **kwargs):
        raise RuntimeError("prefill failed on the admission thread")

    eng._prefill = broken
    threads = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="admission thread"):
        eng.run_threaded(_reqs(cfg, [3, 5], max_new=3))
    assert set(threading.enumerate()) == threads
