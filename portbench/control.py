"""The readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--out chiprun_out/control.jsonl]

For each seed, in one process: the cell's weights, engine and traffic as
``run.py`` builds them, its warm-ups, a window of ``--seconds`` at the
cell's own load, then, with the engine freed, the sample ``judge.py``
draws from the requests the window finished.  Over that sample it prints
the program's numbers (its served tokens against the float32 reference)
and the control's: the reference computed in fp8 (the configuration's
reference, ``reference.py`` by default, ``mode="fp8"``), put in the
program's place at the same positions, its first choice at each judged by
the same float32 reference.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from portbench import judge, run  # noqa: E402


def control_numbers(params, cell, chosen, f32_logits):
    """The control's numbers: its first choice at every judged position,
    scored by the float32 reference."""
    items = [(list(r.prompt), list(r.generated),
              min(b for b in cell.geom["prefill_buckets"]
                  if r.prompt_len <= b)) for r in chosen]
    fp8 = cell.reference.served_logits(params, cell.arch, items,
                                       cell.geom["cache_len"], mode="fp8")
    gaps = [judge.gaps(ref, lg.argmax(-1).tolist())
            for ref, lg in zip(f32_logits, fp8)]
    return judge.numbers(gaps)


def one_seed(cell, seed: int, seconds: float, device: str,
             fault=None) -> dict:
    import torch
    t0 = time.perf_counter()
    params, engine = run.build(cell, seed, device)
    if fault is not None:
        fault(engine)
    run.warm_buckets(engine, cell, seed)
    loop = run.new_loop(engine, cell, seed)
    run.warm_traffic(loop, cell)
    t_open = loop.clock()
    t_close = t_open + seconds
    loop.run_until(t_close)
    finished = [r for r in loop.requests if t_open <= r.t_done < t_close]
    loop.engine = engine = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    chosen = judge.sample(finished, seed)
    items = [(list(r.prompt), list(r.generated),
              min(b for b in cell.geom["prefill_buckets"]
                  if r.prompt_len <= b)) for r in chosen]
    t1 = time.perf_counter()
    f32 = cell.reference.served_logits(params, cell.arch, items,
                                       cell.geom["cache_len"])
    program = judge.numbers([judge.gaps(lg, r.generated)
                             for lg, r in zip(f32, chosen)])
    t2 = time.perf_counter()
    control = control_numbers(params, cell, chosen, f32)
    return {"cell": cell.name, "seed": seed, "finished": len(finished),
            "compared": [len(r.generated) for r in chosen],
            "program": program, "control": control,
            "serve_s": t1 - t0, "reference_s": t2 - t1,
            "control_s": time.perf_counter() - t2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run.checkout_env(tmp)
        cell = run.Cell.load(args.workload)
        for seed in [int(s) for s in args.seeds.split(",")]:
            line = json.dumps(one_seed(cell, seed, args.seconds, "cuda"))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
