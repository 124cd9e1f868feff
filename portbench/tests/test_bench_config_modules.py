"""A configuration's own weight layout, reference and model arithmetic.

A configuration file may name the modules that draw its weights, compute
its plain reference and count its flops (``spec.module``).  Without the
keys it gets ``weights.py``, ``reference.py`` and ``counts.py`` themselves,
and the seams a new layout or reference reuses (``draw(..., leaves=)``,
``served_logits(..., attention=)``) change nothing of today's numbers.
With them, the fixture under ``fixtures/`` (an attention output bias that
today's layout lacks) runs through ``run.py``'s build, judge, control and
``mfu`` path in a benchmark root that adds it by files and entries alone.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import counts, readers, reference, run, spec, weights

CELLS = ["granite-3-8b.decode_backlog", "deepseek-moe-16b.decode_backlog",
         "granite-3-8b.long_prompt"]
CONFIGS = ["granite-3-8b.decode_backlog", "deepseek-moe-16b.decode_backlog"]
SEED = 2**31 + 33
FIXTURE = "toy-bias"
FIXTURE_CELL = f"{FIXTURE}.decode_backlog"
KINDS = ("weights", "reference", "counts")


# --- without the keys: today's modules, and the seams change nothing ---------
@pytest.mark.parametrize("name", CELLS)
def test_a_config_without_the_keys_gets_todays_modules(name):
    cell = run.Cell.load(name)
    assert not set(KINDS) & set(cell.config)
    assert cell.weights is weights
    assert cell.reference is reference
    assert cell.counts is counts
    for kind in KINDS:
        assert spec.module({}, kind) is getattr(cell, kind)


def test_an_unknown_kind_is_refused():
    with pytest.raises(KeyError):
        spec.module({}, "judge")


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", CONFIGS)
def test_drawing_given_leaves_changes_no_weight(name):
    cell = run.Cell.load(name, smoke=True)
    today = dict(flat(weights.draw(cell.arch, SEED, "cpu")))
    given = dict(flat(weights.draw(cell.arch, SEED, "cpu",
                                   leaves=weights.leaves(cell.arch))))
    resolved = dict(flat(cell.weights.draw(cell.arch, SEED, "cpu")))
    assert today.keys() == given.keys() == resolved.keys()
    for path, t in today.items():
        assert t.dtype == given[path].dtype == resolved[path].dtype
        assert torch.equal(t, given[path]), path
        assert torch.equal(t, resolved[path]), path


def items(cell):
    """(prompt, served tokens, bucket): pads in the bucket, none, and a
    second bucket."""
    rng = np.random.default_rng(11)
    vocab = cell.arch["vocab_size"]
    return [(rng.integers(2, vocab, n).tolist(),
             rng.integers(2, vocab, 5).tolist(), b)
            for n, b in ((20, 32), (32, 32), (50, 64))]


@pytest.mark.parametrize("mode", ["f32", "fp8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_giving_the_attention_changes_no_logit(name, mode):
    cell = run.Cell.load(name, smoke=True)
    params = weights.draw(cell.arch, SEED, "cpu")
    args = (params, cell.arch, items(cell), cell.geom["cache_len"])
    today = reference.served_logits(*args, mode=mode)
    given = reference.served_logits(*args, mode=mode,
                                    attention=reference.attention)
    resolved = cell.reference.served_logits(*args, mode=mode)
    assert len(today) == len(given) == len(resolved) == 3
    for a, b, c in zip(today, given, resolved):
        assert torch.equal(a, b) and torch.equal(a, c)


class Req:
    def __init__(self, prompt_len, tokens):
        self.prompt_len = prompt_len
        self.t_tokens = list(tokens)
        self.t_first_token = tokens[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_counts_module_changes_no_flop(name):
    cell = run.Cell.load(name)
    reqs = [Req(300, [99.0, 100.5, 101.0, 109.9, 110.2]),
            Req(1000, [104.0, 104.1]), Req(7, [111.0])]
    ctx = run.Context(seconds=10.0, t_open=100.0, t_close=110.0,
                      t_waited=110.0, requests=reqs, arch=cell.arch,
                      geom=cell.geom, setup_s=1.0, counts=cell.counts)
    want = 0.0                      # the sum as the reader made it before
    for r in reqs:
        if 100.0 <= r.t_first_token < 110.0:
            want += counts.prefill_flops(cell.arch, r.prompt_len)
        for i, t in enumerate(r.t_tokens[1:], start=1):
            if 100.0 <= t < 110.0:
                want += counts.decode_token_flops(cell.arch,
                                                  r.prompt_len + i - 1)
    assert want > 0
    assert readers.useful_flops(ctx) == want
    assert readers.useful_flops(run.Context(
        **{**ctx.__dict__, "counts": counts})) == want


# --- with the keys: the fixture, added by files and entries ------------------
def watch(mod, fn, calls):
    inner = getattr(mod, fn)

    def watched(*args, **kw):
        calls.append([fn, kw.get("mode", "f32")])
        return inner(*args, **kw)
    setattr(mod, fn, watched)


def main_result(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv, device="cpu", smoke=True)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def drive():
    """In a benchmark root that lists the fixture's cell: its modules, a
    build, a traced run, the control and a run with its reference at
    fault, with every call into its modules recorded."""
    from portbench import control
    cell = run.Cell.load(FIXTURE_CELL, smoke=True)
    out = {"modules": {k: getattr(cell, k).__file__ for k in KINDS},
           "todays": [getattr(cell, k) is spec.module({}, k) for k in KINDS]}
    calls = []
    for kind, fns in spec.MODULE_FUNCTIONS.items():
        for fn in fns:
            watch(getattr(cell, kind), fn, calls)
    params, _ = run.build(cell, SEED, "cpu")
    bias = params["segments"][0][1]["attn"]["bo"]
    out["bias"] = [list(bias.shape), float(bias.abs().max())]
    out["build"], calls[:] = list(calls), []
    argv = ["--workload", FIXTURE_CELL, "--seed", str(SEED), "--seconds",
            "3", "--trace"]
    out["rc"], out["sound"] = main_result(argv + ["1"])
    out["sound_calls"], calls[:] = list(calls), []
    rec = control.one_seed(cell, SEED + 1, 3.0, "cpu")
    out["control"] = {k: rec[k] for k in ("program", "control")}
    out["control_calls"], calls[:] = list(calls), []
    sound = cell.reference.attention

    def flipped(*args):
        """The sublayer's output with its sign flipped."""
        return -sound(*args)
    cell.reference.attention = flipped
    out["fault_rc"], out["fault"] = main_result(argv + ["0"])
    return out


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    from portbench.tests.test_bench_harness import copy_benchmark
    copy_benchmark(root)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "cells" / f"{FIXTURE_CELL}.json").write_text(
        json.dumps({"limits": {"gap_max": 0.3, "gap_mean": 0.015}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": FIXTURE, "source": "a test",
        "file": f"portbench/tests/fixtures/{FIXTURE}.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({"name": FIXTURE_CELL, "config": FIXTURE,
                               "traffic": "decode_backlog", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("output_tok_s", "mfu.decode_backlog"):
            m["workloads"].append(FIXTURE_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from portbench.tests import "
            "test_bench_config_modules as t; print(json.dumps(t.drive()))")
    env = {**os.environ, "PYTHONPATH": f"{root}:{run.ROOT / 'src'}"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["edited"] = [str(p) for p, data in before.items()
                     if p.read_bytes() != data]
    res["pb"] = str(pb)
    return res


def test_the_fixture_cell_loads_its_own_modules(fixture_run):
    pb = fixture_run["pb"]
    for kind in KINDS:
        assert fixture_run["modules"][kind] == os.path.join(
            pb, "tests", "fixtures", f"toy_bias_{kind}.py")
    assert fixture_run["todays"] == [False, False, False]


def test_build_draws_the_fixtures_layout(fixture_run):
    assert fixture_run["build"] == [["draw", "f32"]]
    assert fixture_run["bias"] == [[64], 0.0]


def test_the_judge_and_mfu_read_the_fixtures_reference_and_counts(
        fixture_run):
    calls = fixture_run["sound_calls"]
    assert calls.count(["draw", "f32"]) == 1
    assert calls.count(["served_logits", "f32"]) == 1
    assert ["served_logits", "fp8"] not in calls
    assert ["prefill_flops", "f32"] in calls
    assert ["decode_token_flops", "f32"] in calls
    assert fixture_run["rc"] == 0
    res = fixture_run["sound"]
    assert res["correct"], res["checks"]
    assert res["metrics"]["mfu.decode_backlog"]["value"] > 0


def test_the_control_goes_through_the_fixtures_reference(fixture_run):
    calls = fixture_run["control_calls"]
    assert calls.count(["served_logits", "f32"]) == 1
    assert calls.count(["served_logits", "fp8"]) == 1
    rec = fixture_run["control"]
    assert rec["program"]["gap_mean"] * 3 < rec["control"]["gap_mean"]


def test_a_fault_in_the_fixtures_reference_is_not_correct(fixture_run):
    assert fixture_run["fault_rc"] == 0
    assert not fixture_run["fault"]["correct"]
    assert fixture_run["sound"]["correct"]


def test_the_fixture_needs_no_existing_file_edited(fixture_run):
    assert fixture_run["edited"] == []


def test_the_fixtures_counts_differ_from_todays():
    cfg = spec.load_json(spec.HERE / "tests" / "fixtures" / f"{FIXTURE}.json")
    mine = spec.module(cfg, "counts")
    assert mine is not counts and spec.module(cfg, "counts") is mine
    arch = cfg["arch"]
    extra = arch["n_layers"] * arch["d_model"]
    assert mine.prefill_flops(arch, 30) == pytest.approx(
        counts.prefill_flops(arch, 30) + 30 * extra)
    assert mine.decode_token_flops(arch, 30) == pytest.approx(
        counts.decode_token_flops(arch, 30) + extra)
    assert not math.isclose(mine.prefill_flops(arch, 30),
                            counts.prefill_flops(arch, 30))
