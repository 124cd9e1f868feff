"""The traffic generator: one stream a seed, the same work in every block."""

import numpy as np
import pytest

from portbench import spec, traffic

MIXES = ["decode_backlog", "long_prompt"]


def _take(mix, seed, n=80, rate=5.0):
    s = traffic.Stream(mix, 1000, seed, rate=rate)
    return [s.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = spec.traffic(name)
    a, b = _take(mix, 2**31 + 11), _take(mix, 2**31 + 11)
    for (u1, p1, o1, g1), (u2, p2, o2, g2) in zip(a, b):
        assert (u1, o1, g1) == (u2, o2, g2)
        assert np.array_equal(p1, p2)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ(name):
    mix = spec.traffic(name)
    a, b = _take(mix, 2**31 + 11), _take(mix, 2**31 + 12)
    assert [len(p) for _, p, _, _ in a] != [len(p) for _, p, _, _ in b]
    assert not np.array_equal(a[0][1][:16], b[0][1][:16])


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_the_same_work(name):
    mix = spec.traffic(name)
    block = mix["block"]
    prompts, outputs, _ = traffic.block_lengths(mix)
    for seed in (1, 2**31 + 5, 2**33 + 7):
        reqs = _take(mix, seed, n=3 * block)
        for k in range(3):
            part = reqs[k * block:(k + 1) * block]
            assert sorted(len(p) for _, p, _, _ in part) == sorted(prompts)
            assert sorted(o for _, _, o, _ in part) == sorted(outputs)
            if mix["loop"] == "open":
                # the gaps of a block average 1 / rate exactly
                assert np.isclose(sum(g for *_, g in part), block / 5.0)


def test_lengths_within_the_mix():
    for name in MIXES:
        mix = spec.traffic(name)
        prompts, outputs, _ = traffic.block_lengths(mix)
        assert prompts.min() >= mix["prompt"]["min"]
        assert prompts.max() <= mix["prompt"]["max"]
        assert outputs.min() >= mix["output"]["min"]
        assert outputs.max() <= mix["output"]["max"]
    lp = spec.traffic("long_prompt")
    assert np.median(traffic.block_lengths(lp)[0]) == pytest.approx(
        lp["prompt"]["median"], rel=0.1)


def test_tokens_in_vocab_and_ids_unique():
    reqs = _take(spec.traffic("decode_backlog"), 3, n=200)
    assert all(p.min() >= traffic.FIRST_ID and p.max() < 1000
               for _, p, _, _ in reqs)
    assert [u for u, *_ in reqs] == list(range(200))


def test_closed_backlog_has_no_gaps_and_open_needs_a_rate():
    assert all(g == 0.0 for *_, g in _take(spec.traffic("decode_backlog"),
                                           4, rate=None))
    with pytest.raises(ValueError):
        traffic.Stream(spec.traffic("long_prompt"), 1000, 1)


def test_buckets_used():
    b = (512, 1024, 2048, 4096)
    assert traffic.buckets_used(spec.traffic("decode_backlog"), b) == \
        [512, 1024]
    assert traffic.buckets_used(spec.traffic("long_prompt"), b) == \
        [1024, 2048, 4096]


def test_classes_and_gamma_arrivals():
    mix = {"loop": "open", "block": 20,
           "arrivals": {"process": "gamma", "cv": 3.0},
           "classes": [{"share": 0.75,
                        "prompt": {"dist": "fixed", "min": 10, "max": 10},
                        "output": {"dist": "fixed", "min": 1, "max": 1}},
                       {"share": 0.25,
                        "prompt": {"dist": "fixed", "min": 90, "max": 90},
                        "output": {"dist": "fixed", "min": 7, "max": 7}}]}
    reqs = _take(mix, 9, n=40, rate=2.0)
    pairs = {(len(p), o) for _, p, o, _ in reqs}
    assert pairs == {(10, 1), (90, 7)}        # a class keeps its pairs
    gaps = np.array([g for *_, g in reqs])
    assert np.isclose(gaps[:20].mean(), 0.5)
    assert gaps.std() / gaps.mean() > 1.5      # bursty


def test_scaled_divides_lengths_and_waits():
    mix = traffic.scaled(spec.traffic("long_prompt"), 32)
    assert mix["prompt"]["max"] == 120 and mix["output"]["min"] == 1
    mix = traffic.scaled(spec.traffic("long_prompt"), 32, 8)
    assert mix["output"]["max"] == 32 and mix["prompt"]["min"] == 16
    assert mix["warmup_s"] == pytest.approx(0.25)
