"""The plain reference against the program's own path, both in float32.

At the smoke sizes on the CPU, the program's left-padded prefill into a
fresh cache, then its decode steps one token at a time (batch 1, so a
decode step drops nothing at capacity, as the reference's decoded tokens
do), give the logits the reference gives teacher-forced on the same
tokens.  The prompts leave pads in the bucket, and in the MoE config more
pads than an expert's capacity, so the pads' routing and their keyless
attention are held too.  Then the judge: a program's own tokens give
gaps of rounding, the control's fp8 first choices do not.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import judge, reference, run, weights

CONFIGS = ["granite-3-8b.decode_backlog", "deepseek-moe-16b.decode_backlog"]


def program_logits(cell, params, prompt, served, bucket):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import forward, init_caches
    from repro_torch.training.serve_step import decode_step
    arch = {**cell.arch, "compute_dtype": "float32"}
    cfg = ModelConfig(**arch)
    p32 = {"embed": params["embed"].float(),
           "unembed": params["unembed"].float(),
           "final_norm": params["final_norm"],
           "eager": {k: _f32(v) for k, v in params["eager"].items()},
           "segments": [[_f32(lp) for lp in seg]
                        for seg in params["segments"]]}
    caches = init_caches(cfg, 1, cell.geom["cache_len"], "cpu")
    toks = torch.zeros(1, bucket, dtype=torch.long)
    toks[0, bucket - len(prompt):] = torch.tensor(prompt)
    logits, caches, _ = forward(p32, cfg, toks, caches=caches,
                                lengths=torch.tensor([len(prompt)]),
                                last_only=True)
    rows = [logits[0, -1]]
    for i, t in enumerate(served[:-1]):
        pos = torch.tensor([[len(prompt) + i]], dtype=torch.int32)
        lg, caches = decode_step(p32, cfg, torch.tensor([[t]]), pos, caches)
        rows.append(lg[0])
    return torch.stack(rows)[:, :cell.arch["vocab_size"]]


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_program_in_float32(name):
    cell = run.Cell.load(name, smoke=True)
    params = weights.draw(cell.arch, 2**31 + 3, "cpu")
    rng = np.random.default_rng(5)
    for length, bucket in ((20, 32), (32, 32), (50, 64)):
        prompt = rng.integers(2, cell.arch["vocab_size"], length).tolist()
        served = rng.integers(2, cell.arch["vocab_size"], 6).tolist()
        want = program_logits(cell, params, prompt, served, bucket)
        got = reference.served_logits(params, cell.arch,
                                      [(prompt, served, bucket)],
                                      cell.geom["cache_len"])[0]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_pads_take_capacity_in_the_moe_reference():
    """More identical pads than an expert holds: some of their choices
    drop, and so does every later token's choice of those experts."""
    idx = torch.tensor([[0, 1]] * 12 + [[0, 2], [3, 1]])
    logits = torch.full((14, 8), -5.0)
    logits[torch.arange(14)[:, None], idx] = torch.tensor([2.0, 1.0])
    ids, gates = reference.route(logits, 2, [(0, 14)], 1.25)
    cap = reference.capacity(14, 8, 2, 1.25)             # 5 slots
    assert cap == 5
    assert (gates[:5, 0] > 0).all() and (gates[5:12, 0] == 0).all()
    assert (gates[12, 0] == 0) and (gates[12, 1] > 0)    # expert 0 full
    assert (gates[13, 0] > 0) and (gates[13, 1] == 0)    # 1 full at slot 2


@pytest.mark.parametrize("name", CONFIGS)
def test_judge_separates_program_and_control(name):
    """The served tokens of the engine on the CPU (bf16) read gaps far
    below the fp8 control's, on the same sample."""
    from portbench import control
    cell = run.Cell.load(name, smoke=True)
    rec = control.one_seed(cell, 2**31 + 9, 2.0, "cpu")
    assert rec["program"]["gap_mean"] * 3 < rec["control"]["gap_mean"]


def test_sample_holds_the_longest_and_enough_tokens():
    @dataclasses.dataclass
    class R:
        uid: int
        generated: list
        prompt_len: int = 10

    reqs = [R(i, [0] * n) for i, n in enumerate([5, 1200, 50, 60, 70, 80])]
    got = judge.sample(reqs, 3)
    assert got[0].uid == 1 and len(got) == judge.MIN_REQUESTS
    assert judge.sample(reqs, 3) == got
    few = [R(i, [0] * 10) for i in range(40)]
    assert len(judge.sample(few, 1)) == judge.MAX_REQUESTS
    assert judge.sample([], 1) == []


def test_gaps_and_verdict():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.5, 2.0]])
    g = judge.gaps(logits, [1, 1])
    assert g.tolist() == [0.0, 1.5]
    nums = judge.numbers([g])
    assert nums == {"gap_max": 1.5, "gap_mean": 0.75, "mismatch": 0.5}
    assert judge.verdict(nums, {"gap_max": 2.0})[0]
    assert not judge.verdict(nums, {"gap_max": 1.0})[0]
    assert not judge.verdict(nums, {"gap_max": 2.0, "other": 1.0})[0]
    assert not judge.verdict({}, {"gap_max": 2.0})[0]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference, portbench.judge, portbench.counts,"
            " portbench.traffic, portbench.weights;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, check=True)
    assert out.stdout.strip() == "[]"
