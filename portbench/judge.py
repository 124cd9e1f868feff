"""How ``correct`` is decided: served tokens against the plain reference.

Once the window has closed, a sample of the requests the window finished,
drawn from the seed and always holding the one with the most served
tokens, goes through the float32 reference (``reference.py``),
teacher-forced on each prompt and its served tokens.  For every served
token the gap is the reference's best logit minus the reference's logit
of that token (0 when the program served the reference's choice); a
greedy program that computes what the reference computes serves tokens
whose gaps are rounding.  The numbers compared are

  * ``gap_max``: the widest gap of the sample;
  * ``gap_mean``: the mean gap over the sample's served tokens;
  * ``mismatch``: the share of served tokens that are not the
    reference's first choice;

each against the limit of the cell's ``cells/<cell>.json``; a number the
file gives no limit is printed and not compared.  The control
(``control.py``) reads the same numbers for the token that an fp8
reference puts first at each of the same positions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

#: the sample: at least this many served tokens and requests, at most
#: ``MAX_REQUESTS`` requests
MIN_TOKENS = 1000
MIN_REQUESTS = 3
MAX_REQUESTS = 16


def sample(finished: Sequence[Any], seed: int) -> List[Any]:
    """The requests to compare: the one with the most served tokens, then
    others in an order drawn from the seed."""
    if not finished:
        return []
    pool = sorted(finished, key=lambda r: r.uid)
    longest = max(pool, key=lambda r: (len(r.generated), r.prompt_len))
    rest = [r for r in pool if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    order = rng.permutation(len(rest))
    out, n = [longest], len(longest.generated)
    for i in order.tolist():
        if len(out) >= MAX_REQUESTS or (n >= MIN_TOKENS
                                        and len(out) >= MIN_REQUESTS):
            break
        out.append(rest[i])
        n += len(rest[i].generated)
    return out


def gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> np.ndarray:
    """Reference best minus the reference's logit of each token."""
    idx = torch.as_tensor(list(tokens), device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    picked = ref_logits.gather(1, idx[:, None])[:, 0]
    return (best - picked).double().cpu().numpy()


def numbers(all_gaps: List[np.ndarray]) -> Dict[str, float]:
    g = np.concatenate(all_gaps) if all_gaps else np.zeros(0)
    if not len(g):
        return {}
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "mismatch": float((g > 0).mean())}


def verdict(nums: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every limited number within its limit, {name: {value, limit}}).
    No number or no limit to hold it to is not correct."""
    checks = {k: {"value": nums[k], "limit": float(v)}
              for k, v in limits.items() if k in nums}
    ok = bool(checks) and len(checks) == len(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
