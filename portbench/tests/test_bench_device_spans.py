"""The readers of the program's device spans on synthetic spans, and a
traced smoke run of each cell reporting the ones its cell lists."""

import pytest

from portbench import spec
from portbench.tests.test_bench_harness import CELLS, result
from portbench.tests.test_bench_metrics import ctx, read

DEVICE_METRICS = {
    "granite-3-8b.decode_backlog": {"decode_device_ms", "decode_gap_ms",
                                    "prefill_enqueue_share.decode_backlog"},
    "deepseek-moe-16b.decode_backlog": {
        "decode_device_ms", "decode_gap_ms",
        "prefill_enqueue_share.decode_backlog"},
    "granite-3-8b.long_prompt": {"prefill_enqueue_share.long_prompt"},
}


def test_decode_device_ms_over_the_window():
    spans = [("device.decode_step", 99.99, 0.5),          # begun before
             ("device.decode_step", 101.0, 0.012),
             ("device.decode_step", 101.02, 0.014),
             ("device.decode_step", 110.0, 0.5),          # at the close
             ("serving.decode_step", 101.0, 0.1)]
    assert read("decode_device_ms", ctx([], spans=spans)) == \
        pytest.approx(13.0)
    assert read("decode_device_ms", ctx([])) is None


def test_decode_gap_skips_a_prefill_and_the_spans_outside():
    spans = [("device.decode_step", 99.98, 0.01),         # before the open
             ("device.decode_step", 100.00, 0.010),
             ("device.decode_step", 100.012, 0.010),      # gap 2 ms
             ("device.prefill", 100.025, 0.08),
             ("device.decode_step", 100.110, 0.010),      # after a prefill
             ("device.decode_step", 100.124, 0.010),      # gap 4 ms
             ("device.decode_step", 110.0, 0.010)]        # after the close
    assert read("decode_gap_ms", ctx([], spans=spans)) == pytest.approx(3.0)
    only_prefill_between = [("device.decode_step", 101.0, 0.01),
                            ("device.prefill", 101.02, 0.05),
                            ("device.decode_step", 101.1, 0.01)]
    assert read("decode_gap_ms", ctx([], spans=only_prefill_between)) is None


@pytest.mark.parametrize("name", ["prefill_enqueue_share.decode_backlog",
                                  "prefill_enqueue_share.long_prompt"])
def test_prefill_enqueue_share(name):
    spans = [("serving.prefill", 101.0, 0.10),
             ("engine.prefill.enqueue", 101.001, 0.09),
             ("serving.prefill", 102.0, 0.30),
             ("engine.prefill.enqueue", 102.001, 0.12),
             ("serving.prefill", 99.0, 5.0),              # begun before
             ("engine.prefill.enqueue", 99.001, 0.1)]
    assert read(name, ctx([], spans=spans)) == pytest.approx(52.5)
    without = [s for s in spans if s[0] == "serving.prefill"]
    assert read(name, ctx([], spans=without)) is None


def test_each_entry_lists_the_cells_that_report_what_it_moves():
    bench = spec.benchmark()
    for cell, names in DEVICE_METRICS.items():
        listed = {m["name"] for m in spec.metrics(bench, cell, trace=True)}
        assert names <= listed
        assert not (set().union(*DEVICE_METRICS.values()) - names) & listed


@pytest.mark.parametrize("name", CELLS)
def test_traced_smoke_run_reports_the_device_metrics(capsys, name):
    res = result(capsys, name, trace=1)
    assert res["correct"]
    got = set(res["metrics"])
    assert DEVICE_METRICS[name] <= got
    assert not (set().union(*DEVICE_METRICS.values())
                - DEVICE_METRICS[name]) & got
    for m in DEVICE_METRICS[name]:
        assert res["metrics"][m]["value"] > 0
