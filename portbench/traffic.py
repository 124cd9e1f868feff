"""The one traffic generator: a mix's data file and a seed -> requests.

A frozen copy of ``repro_torch/serving/trace.py::synthetic_trace``
(exponential gaps, uniform token ids from 2 up), extended:

  * lengths from a distribution (``loguniform`` between ``min`` and
    ``max``; ``lognormal`` by ``median`` and ``sigma``, clipped to
    ``min``-``max``), for prompts and outputs apart;
  * stratified in blocks: each block of ``block`` requests takes the same
    ``block`` quantiles of each distribution, and the seed only orders
    them (prompts, outputs and gaps shuffled apart).  So every seed offers
    the same work in every block, and the seed moves the order and the
    token ids, not the amount of work;
  * an open loop (``"loop": "open"``): arrivals at the cell's rate,
    ``poisson`` (exponential gaps) or ``gamma`` with a coefficient of
    variation ``cv`` (bursts), the gaps of a block scaled to a mean of
    exactly 1 / rate; or a closed backlog (``"loop": "closed"``) that the
    driver keeps topped up, so arrivals are the moment of submission;
  * optional ``classes``: a list of {share, prompt, output} mixed in one
    queue, each class taking its share of every block.

The stream is endless and the same for the same seed.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

#: the first token id a prompt may use (the reference's traces skip 0, 1)
FIRST_ID = 2


def _quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """The ``n`` mid-point quantiles of a length distribution, as ints."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    kind = dist["dist"]
    if kind == "loguniform":
        vals = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    elif kind == "fixed":
        vals = np.full(n, lo)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def _gap_quantiles(arrivals: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` inter-arrival gaps with mean 1 (scaled by 1 / rate later)."""
    u = (np.arange(n) + 0.5) / n
    process = arrivals.get("process", "poisson")
    if process == "poisson":
        gaps = -np.log1p(-u)
    elif process == "gamma":
        from scipy.special import gammaincinv   # the chip host has scipy
        shape = 1.0 / float(arrivals["cv"]) ** 2
        gaps = gammaincinv(shape, u) / shape
    else:
        raise ValueError(f"unknown arrival process {process!r}")
    return gaps / gaps.mean()


def _seed_words(seed: int) -> List[int]:
    s = int(seed) % (1 << 128)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF,
            s >> 96]


def _classes(mix: Dict[str, Any]) -> List[Dict[str, Any]]:
    if "classes" in mix:
        return mix["classes"]
    return [{"share": 1.0, "prompt": mix["prompt"], "output": mix["output"]}]


def block_lengths(mix: Dict[str, Any]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (prompt, output, class index) of every request of a block, in
    class order (before the seed orders them)."""
    block = int(mix["block"])
    prompts, outputs, kinds = [], [], []
    classes = _classes(mix)
    counts = [int(round(c["share"] * block)) for c in classes]
    counts[-1] = block - sum(counts[:-1])
    for i, (c, n) in enumerate(zip(classes, counts)):
        if n <= 0:
            continue
        prompts.append(_quantiles(c["prompt"], n))
        outputs.append(_quantiles(c["output"], n))
        kinds.append(np.full(n, i))
    return (np.concatenate(prompts), np.concatenate(outputs),
            np.concatenate(kinds))


def mean_output(mix: Dict[str, Any]) -> float:
    return float(block_lengths(mix)[1].mean())


class Stream:
    """The endless request stream of one mix and one seed.

    ``next()`` -> (uid, prompt (L,) int32, output tokens, gap in seconds
    after the previous arrival; 0 for a closed backlog)."""

    def __init__(self, mix: Dict[str, Any], vocab_size: int, seed: int,
                 rate: Optional[float] = None):
        self.mix = mix
        self.vocab_size = int(vocab_size)
        self.open = mix["loop"] == "open"
        if self.open and not rate:
            raise ValueError("an open loop needs the cell's rate")
        self.rate = rate
        ss = np.random.SeedSequence(_seed_words(seed))
        self._order, self._tokens = (np.random.default_rng(s)
                                     for s in ss.spawn(2))
        self._prompts, self._outputs, self._kinds = block_lengths(mix)
        self._gaps = (_gap_quantiles(mix.get("arrivals", {}),
                                     len(self._prompts)) / rate
                      if self.open else np.zeros(len(self._prompts)))
        self._uid = 0
        self._it = self._blocks()

    def _blocks(self) -> Iterator[Tuple[int, int, float]]:
        while True:
            # outputs paired with prompts at random within a class, then
            # the pairs ordered at random, and the gaps apart
            o = self._outputs.copy()
            for k in np.unique(self._kinds):
                idx = np.flatnonzero(self._kinds == k)
                o[idx] = self._order.permutation(o[idx])
            order = self._order.permutation(len(o))
            g = self._order.permutation(self._gaps)
            yield from zip(self._prompts[order].tolist(), o[order].tolist(),
                           g.tolist())

    def next(self) -> Tuple[int, np.ndarray, int, float]:
        length, out, gap = next(self._it)
        prompt = self._tokens.integers(FIRST_ID, self.vocab_size,
                                       length).astype(np.int32)
        uid = self._uid
        self._uid += 1
        return uid, prompt, int(out), float(gap)


def buckets_used(mix: Dict[str, Any], buckets) -> List[int]:
    """The prefill buckets this mix's prompts fall into."""
    lengths = np.unique(block_lengths(mix)[0])
    used = set()
    for n in lengths.tolist():
        used.add(min(b for b in buckets if n <= b))
    return sorted(used)


def scaled(mix: Dict[str, Any], scale: float,
           output_scale: Optional[float] = None) -> Dict[str, Any]:
    """The mix with every prompt length and wait divided by ``scale`` and
    every output length by ``output_scale`` (default ``scale``; at least 1
    token): the CPU tests' small sizes."""
    def lengths(dist: Dict[str, Any], by: float) -> Dict[str, Any]:
        return {k: (max(1, round(v / by))
                    if k in ("min", "max", "median") else v)
                for k, v in dist.items()}

    by_out = scale if output_scale is None else output_scale
    out = dict(mix)
    if "classes" in out:
        out["classes"] = [dict(c) for c in out["classes"]]
    for c in [out, *out.get("classes", [])]:
        if "prompt" in c:
            c["prompt"] = lengths(c["prompt"], scale)
            c["output"] = lengths(c["output"], by_out)
    for key in ("warmup_s", "drain_s"):
        if key in out:
            out[key] = out[key] / scale
    return out
