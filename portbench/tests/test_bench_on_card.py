"""On the card, at each cell's own size: the control is not correct.

    PYTHONPATH=src python -m pytest -m gpu portbench/tests/test_bench_on_card.py

(minutes a cell).  For three seeds, ``control.py`` serves a short window
of the cell and reads, over the sample ``judge.py`` draws, the program's
numbers and the control's (the reference in fp8 in the program's place).
The program's stay within the cell's limits; the control's break at least
one.  Skips without a card.
"""

import pytest

from portbench import run, spec

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def cells():
    return [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct_at_the_cells_size(name, tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    from portbench import control, judge
    run.checkout_env(str(tmp_path))
    cell = run.Cell.load(name)
    limits = cell.own["limits"]
    for seed in SEEDS:
        rec = control.one_seed(cell, seed, 20.0, "cuda")
        assert judge.verdict(rec["program"], limits)[0], rec
        assert not judge.verdict(rec["control"], limits)[0], rec
