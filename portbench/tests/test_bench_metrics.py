"""The metric readers on synthetic timestamps, spans and profiles."""

import math

import numpy as np
import pytest

from portbench import counts, profile, readers, spec
from portbench.run import Context

ARCH = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "d_ff": 128, "vocab_size": 256, "head_dim": 16, "mlp": "swiglu"}
GEOM = {"num_slots": 4, "cache_len": 128,
        "prefill_buckets": [16, 32, 64, 128]}


class Req:
    """The fields of ``repro_torch.serving.request.Request`` a reader
    reads."""

    def __init__(self, arrival, admitted=math.nan, tokens=(), done=math.nan,
                 prompt_len=10):
        self.arrival_time = arrival
        self.t_admitted = admitted
        self.t_tokens = list(tokens)
        self.t_first_token = tokens[0] if tokens else math.nan
        self.t_done = done
        self.generated = [1] * len(tokens)
        self.prompt_len = prompt_len


def ctx(requests, **kw):
    base = dict(seconds=10.0, t_open=100.0, t_close=110.0, t_waited=112.0,
                requests=requests, arch=ARCH, geom=GEOM, setup_s=7.5)
    base.update(kw)
    return Context(**base)


def read(name, c):
    return spec.reader(name)(c)


def test_ttft_counts_late_requests_with_their_wait_so_far():
    reqs = [Req(99.0, 99.0, [99.5]),                  # arrived before
            Req(101.0, 101.0, [101.2]),               # 200 ms
            Req(105.0, 105.1, [105.6]),               # 600 ms
            Req(109.0)]                               # waited 3 s so far
    want = np.percentile([200.0, 600.0, 3000.0], 95)
    assert read("ttft_p95_ms", ctx(reqs)) == pytest.approx(want)
    assert read("ttft_p95_ms", ctx([Req(99.0)])) is None


def test_queue_wait_counts_requests_not_admitted():
    reqs = [Req(101.0, 101.5, [101.7]), Req(108.0)]
    want = np.percentile([500.0, 4000.0], 95)
    assert read("queue_wait_p95_ms", ctx(reqs)) == pytest.approx(want)


def test_tpot_over_requests_finished_in_the_window_only():
    reqs = [Req(90.0, 90.0, [101.0, 101.1, 101.2, 101.3, 101.4],
                done=101.4),                               # 100 ms/token
            Req(90.0, 90.0, [102.0, 102.3], done=102.3),   # 300 ms
            Req(90.0, 90.0, [103.0, 103.2, 103.4]),        # unfinished
            Req(90.0, 90.0, [109.0, 111.0], done=111.0),   # after the close
            Req(90.0, 90.0, [104.0], done=104.0)]          # one token
    want = np.percentile([100.0, 300.0], 95)
    assert read("tpot_p95_ms", ctx(reqs)) == pytest.approx(want)


def test_output_tokens_are_those_in_the_window():
    reqs = [Req(90.0, 90.0, [99.9, 100.0, 105.0, 109.99, 110.0])]
    assert read("output_tok_s", ctx(reqs)) == pytest.approx(0.3)
    assert read("output_tok_s", ctx([])) is None


def test_setup_and_spans():
    spans = [("serving.prefill", 101.0, 0.5), ("serving.prefill", 99.0, 9),
             ("serving.prefill", 109.5, 1.5),
             ("serving.decode_step", 102.0, 0.02),
             ("serving.decode_step", 102.1, 0.04)]
    c = ctx([], spans=spans)
    assert read("setup_s", c) == 7.5
    assert read("prefill_time_share", c) == pytest.approx(20.0)
    assert read("prefill_ms", c) == pytest.approx(1000.0)
    assert read("decode_step_ms", c) == pytest.approx(30.0)
    assert read("decode_step_ms", ctx([])) is None


def test_mfu_counts_prompts_without_pads_and_tokens_in_the_window():
    reqs = [Req(100.0, 100.0, [101.0, 101.1, 111.0], prompt_len=10)]
    want = (counts.prefill_flops(ARCH, 10)
            + counts.decode_token_flops(ARCH, 10))
    got = read("mfu.decode_backlog", ctx(reqs))
    assert got == pytest.approx(100 * want / (10 * counts.PEAK_BF16_FLOPS))
    assert read("mfu.long_prompt", ctx(reqs)) == got


def _stretch(kernels, window=1.0):
    busy = profile._union([(s, t) for _, s, t in kernels])
    return profile.Stretch(window_s=window, kernels=kernels,
                           busy_s=sum(t - s for s, t in busy),
                           idle_by_host={}, t0=0.0, t1=window)


def test_busy_is_the_union_of_device_activity():
    st = _stretch([("a", 0.0, 0.2), ("b", 0.1, 0.3), ("c", 0.5, 0.6)])
    assert st.busy_s == pytest.approx(0.4)


def test_decode_roofline_needs_one_launch_a_layer_a_step():
    rows = [40, 44]
    bound = sum(counts.bound_s(counts.attention_flops(ARCH, r),
                               counts.decode_bytes(ARCH, 4, r, 128))
                for r in rows) * ARCH["n_layers"]
    kernels = [("decode_kernel<bf16>", i * 1.0, i * 1.0 + bound)
               for i in range(4)]
    c = ctx([], stretch=_stretch(kernels, 10.0), stretch_rows=rows)
    # every launch at four times the bound: 25%
    assert read("decode_attn_roofline", c) == pytest.approx(25.0)
    c.stretch_rows = rows[:1]
    assert read("decode_attn_roofline", c) is None


def test_flash_roofline_counts_each_prefill():
    pre = [(100, 128), (30, 32)]
    bound = sum(counts.bound_s(counts.flash_flops(ARCH, n),
                               counts.flash_bytes(ARCH, n, b, 128))
                for n, b in pre) * ARCH["n_layers"]
    kernels = [("flash_wgmma_kernel<128>", i, i + bound / 2)
               for i in range(4)]
    c = ctx([], stretch=_stretch(kernels, 10.0), stretch_prefills=pre)
    assert read("flash_roofline", c) == pytest.approx(50.0)
    assert read("flash_roofline", ctx([], stretch=_stretch([], 1.0),
                                      stretch_prefills=pre)) is None


class Ev:
    """A raw Kineto event: name, start and end (ns), on the device or not."""

    def __init__(self, name, s, t, cuda, kind="kernel"):
        self._v = (name, s, t, cuda, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[4] != "kernel"


def test_quiet_stretch_runs_from_the_filler_to_the_last_record():
    spin = profile.FILLER_KERNEL
    evs = [Ev(spin, 0, 10, True), Ev(spin, 20, 100, True),
           Ev("cudaLaunchKernel", 150, 160, False),
           Ev("k1", 200, 300, True), Ev("k2", 250, 400, True),
           Ev("Memcpy DtoH", 600, 1100, True)]
    st = profile.digest_quiet(evs, 0.0, 1.0)
    assert st.window_s == pytest.approx(1000e-9)
    assert st.busy_s == pytest.approx(700e-9)
    assert [k[0] for k in st.kernels] == ["k1", "k2", "Memcpy DtoH"]
    assert st.kernels[0][1:] == pytest.approx((100e-9, 200e-9))
    with pytest.raises(RuntimeError):
        profile.digest_quiet(evs[2:], 0.0, 1.0)


def test_idle_gaps_named_by_the_host():
    evs = [Ev(profile.MARK, 0, 1000, False),
           Ev(profile.MARK, 0, 990, True, "gpu_user_annotation"),
           Ev("a range", 0, 990, True, "gpu_user_annotation"),
           Ev("k1", 0, 100, True),
           Ev("aten::mm", 90, 400, False), Ev("k2", 300, 600, True),
           Ev("cudaMemcpyAsync", 550, 840, False), Ev("k3", 800, 850, True)]
    st = profile.digest(evs, 0.0, 1.0)
    assert st.busy_s == pytest.approx(450e-9)
    assert st.idle_by_host == pytest.approx(
        {"aten::mm": 200e-9, "cudaMemcpyAsync": 200e-9, "python": 150e-9})
