"""``repro_torch.core.roofline`` against ``repro.core.roofline``: the chips'
data sheets, ``detect_chip``'s mapping, ``model_flops`` and the roofline
terms' verdicts, exactly (no tolerance: the same constants and the same
arithmetic)."""

import dataclasses

import pytest

import repro.core.roofline as ref
from repro_torch.core import op_analysis, op_cost
from repro_torch.core import roofline as port

CHIPS = ["TPU_V5E", "NVIDIA_H100", "AMD_MI300A", "CPU_HOST"]


@pytest.mark.parametrize("name", CHIPS)
def test_chip_specs_equal_the_references(name):
    ours, theirs = getattr(port, name), getattr(ref, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.ridge == theirs.ridge


def test_chip_table_is_the_references():
    assert sorted(port.CHIP_SPECS) == sorted(ref.CHIP_SPECS)
    for k in ref.CHIP_SPECS:
        assert dataclasses.asdict(port.CHIP_SPECS[k]) == \
            dataclasses.asdict(ref.CHIP_SPECS[k])


@pytest.mark.parametrize("platform,kind", [
    ("tpu", "TPU v5 lite"), ("TPU", ""), ("gpu", "NVIDIA H100 80GB HBM3"),
    ("cuda", "NVIDIA H100 PCIe"), ("gpu", "AMD Instinct MI300A"),
    ("rocm", "whatever"), ("gpu", "amd radeon"), ("cpu", "cpu"),
    ("", ""), ("METAL", "apple"), ("gpu", None), (None, None)])
def test_detect_chip_maps_strings_as_the_reference_does(platform, kind):
    if platform is None:
        # no arguments: the port asks torch.cuda, and this host has no card
        assert port.detect_chip() is port.CPU_HOST
        return
    assert port.detect_chip(platform, kind).name == \
        ref.detect_chip(platform, kind).name


@pytest.mark.parametrize("n,tokens,kind", [
    (1.6e9, 8 * 4096, "train"), (8e9, 128, "serve"), (2.8e9, 1, "decode"),
    (0.0, 10, "train")])
def test_model_flops_equals_the_references(n, tokens, kind):
    assert port.model_flops(n, tokens, kind) == ref.model_flops(n, tokens,
                                                                kind)


TERMS = [
    dict(compute_s=3.0, memory_s=1.0, collective_s=2.0),
    dict(compute_s=0.1, memory_s=1.5, collective_s=0.2),
    dict(compute_s=0.1, memory_s=0.2, collective_s=7.0),
    dict(compute_s=1.0, memory_s=1.0, collective_s=1.0),
]


@pytest.mark.parametrize("t", TERMS)
def test_roofline_terms_verdicts_and_json_keys(t):
    common = dict(flops=1e12, hbm_bytes=2e9, collective_bytes=3e6,
                  collectives={"all-reduce": {"count": 1, "bytes": 3}},
                  argument_bytes=5, peak_bytes=7, xla_flops=1.0,
                  unknown_trip_loops=0, **t)
    ours, theirs = port.RooflineTerms(**common), ref.RooflineTerms(**common)
    assert ours.dominant == theirs.dominant
    assert ours.bound_s == theirs.bound_s
    assert ours.to_json() == theirs.to_json()
    assert set(ours.to_json()) == set(theirs.to_json())


def test_roofline_from_cost_divides_by_the_chips_rates():
    cost = op_cost.OpCost(flops=989e12, hbm_bytes=3.35e12 * 2,
                          collective_bytes=450e9 * 0.5, peak_bytes=10)
    cost.collective_bytes_by_kind["all-gather"] = 450e9 * 0.5
    cost.collective_count_by_kind["all-gather"] = 3
    base = op_cost.OpCost(flops=1.0, hbm_bytes=2.0)
    t = port.roofline_from_cost(cost, port.NVIDIA_H100, base=base,
                                argument_bytes=100, output_bytes=4)
    assert t.compute_s == pytest.approx(1.0, rel=1e-12)
    assert t.memory_s == pytest.approx(2.0, rel=1e-12)
    assert t.collective_s == pytest.approx(0.5, rel=1e-12)
    assert t.dominant == "memory" and t.bound_s == t.memory_s
    assert (t.xla_flops, t.xla_bytes) == (1.0, 2.0)
    assert (t.argument_bytes, t.temp_bytes, t.peak_bytes) == (100, 10, 110)
    assert t.collectives == {"all-gather": {"count": 3,
                                            "bytes": int(450e9 * 0.5)}}
    stats = op_analysis.collective_stats(cost)
    assert (stats.total_bytes, stats.total_count) == (int(450e9 * 0.5), 3)


def test_collective_stats_summary_matches_the_references_shape():
    from repro.core.hlo_analysis import CollectiveStats as Ref
    b, c = {"all-gather": 10, "all-reduce": 4}, {"all-gather": 2,
                                                 "all-reduce": 1}
    assert op_analysis.CollectiveStats(b, c).summary() == Ref(b, c).summary()
    ours = op_analysis.CollectiveStats(b, c)
    assert (ours.total_bytes, ours.total_count) == (14, 3)


@pytest.mark.parametrize("dtype,n", [
    ("float32", 4), ("bfloat16", 2), ("float16", 2), ("int32", 4),
    ("int64", 8), ("int8", 1), ("bool", 1), ("float64", 8)])
def test_dtype_bytes(dtype, n):
    import torch
    assert op_analysis.dtype_bytes(getattr(torch, dtype)) == n
    with pytest.raises(ValueError):
        op_analysis.dtype_bytes("f32")
