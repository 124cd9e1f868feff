"""The knee of an open-loop cell: its load swept on the card, once.

    python3 portbench/sweep.py --workload <cell> --seed <n> \
        --rates 4,5,6,7,8 --seconds 30

One engine, built and warmed as ``run.py`` builds it; then for each rate
in turn a fresh stream of the cell's mix at that rate, its warm-up, a
window of ``--seconds``, and a drain with no new arrivals.  For each rate
it prints the requests that arrived in the window, those admitted in it,
those still queued when it closed, the TTFT p50 and p95 and the prefill's
share of the window.  The knee is the highest rate whose queue does not
grow over the window; the cell runs at 0.8 of it (``cells/<cell>.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from portbench import readers, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run.checkout_env(tmp)
        cell = run.Cell.load(args.workload)
        params, engine = run.build(cell, args.seed, "cuda")
        run.warm_buckets(engine, cell, args.seed)
        for rate in [float(r) for r in args.rates.split(",")]:
            loop = run.new_loop(engine, cell, args.seed, rate=rate)
            run.warm_traffic(loop, cell)
            t_open = loop.clock()
            t_close = t_open + args.seconds
            loop.run_until(t_close)
            win = [r for r in loop.requests
                   if t_open <= r.arrival_time < t_close]
            queued = sum(1 for r in loop.requests
                         if r.arrival_time < t_close
                         and not r.t_admitted < t_close)
            ttft = [(r.t_first_token if not math.isnan(r.t_first_token)
                     else t_close) - r.arrival_time for r in win]
            prefill = sum(r.t_first_token - r.t_admitted
                          for r in loop.requests
                          if t_open <= r.t_admitted < t_close
                          and not math.isnan(r.t_first_token))
            print(json.dumps({
                "rate": rate, "arrived": len(win),
                "admitted": sum(1 for r in loop.requests
                                if t_open <= r.t_admitted < t_close),
                "queued_at_close": queued,
                "ttft_p50_ms": 1e3 * readers.percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * readers.percentile(ttft, 95),
                "prefill_share": prefill / args.seconds}), flush=True)
            while engine.queue or engine.active_count():   # drain
                engine.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
