"""Check cases of the attention kernels, in one place.

``chip_smoke.py`` and ``tests/test_torch_on_card.py`` hold the kernels
against their plain versions over the cases below, every row (those that
admit no key included); the CPU tests build their position masks with the
same functions.

The inputs are drawn so that a wrong kernel shows at the bfloat16
tolerance (2e-2, 2e-2): q and k at std ``QK_STD`` give logits of std
``QK_STD**2``, a peaked softmax, and v at std ``V_STD`` gives outputs of
order 0.1-1.  At std 0.5 the softmax over a few thousand keys is nearly
uniform and the outputs are about as small as the tolerance, so a kernel
that skipped a whole k tile would pass.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

QK_STD = 1.5
V_STD = 1.0

#: prefill sweep: (positions mode, B, H, Kv, S, T, causal, window) — ragged
#: S/T, GQA 4:1, 5:1 (25 heads) and 1:1, a window, left pads into a longer
#: fresh cache, self-attention of a left-padded batch, a wrapped ring,
#: cross-attention to an encoder memory of 1500 frames (one query, as a
#: decode step's, and a prompt's), and a long left-padded prompt whose live
#: k tiles (6 to 22 of 128 to 32 keys) go several times round the bf16
#: kernel's two-stage K/V ring
FLASH_SWEEP = (
    ("index", 2, 8, 2, 100, 100, True, 0),
    ("index", 1, 25, 5, 100, 100, True, 0),
    ("cross", 2, 6, 6, 1, 1500, False, 0),
    ("cross", 1, 6, 6, 40, 1500, False, 0),
    ("index", 1, 4, 4, 70, 150, False, 0),
    ("index", 1, 8, 2, 130, 130, True, 33),
    ("leftpad", 2, 8, 2, 96, 200, True, 0),
    ("self", 2, 4, 2, 90, 90, True, 0),
    ("ring", 1, 4, 1, 90, 40, True, 0),
    ("leftpad", 1, 8, 2, 700, 1100, True, 0),
)

#: decode sweep: (B, H, Kv, T, wrap, per-row fill or None, window) — empty
#: slots, a row of one key, a wrapped ring, a window over it, T not a
#: multiple of any split, a row that admits no key beside rows that leave
#: most splits empty, and 12 and 16 query heads per kv head
DECODE_SWEEP = (
    (3, 8, 2, 300, 0, (300, 150, 1), 0),
    (4, 32, 8, 1000, 7, (1000, 600, 300, 50), 100),
    (2, 4, 4, 129, 0, None, 0),
    (1, 8, 1, 64, 5, None, 0),
    (3, 16, 4, 1100, 0, (0, 70, 1100), 0),
    (2, 24, 2, 700, 0, (700, 333), 0),
    (2, 32, 2, 500, 9, None, 64),
)


def draw(rng: np.random.Generator, q_shape: Sequence[int],
         kv_shape: Sequence[int], dtype: torch.dtype,
         device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q of ``q_shape`` and k, v of ``kv_shape``, from ``rng`` in that
    order, at ``QK_STD``/``V_STD``; the same numbers on any device."""
    q = rng.standard_normal(q_shape, dtype=np.float32) * QK_STD
    k = rng.standard_normal(kv_shape, dtype=np.float32) * QK_STD
    v = rng.standard_normal(kv_shape, dtype=np.float32) * V_STD
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (q, k, v))


def flash_positions(mode: str, b: int, s: int,
                    t: int) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(q_pos (B, S), k_pos (B, T), k_index_aligned) of a prefill case.

    ``index``: token i at position i; ``leftpad``: left-padded prompts into
    a fresh longer cache (slot p holds position p); ``self``: the
    self-attention of a left-padded batch; ``ring``: positions 5 .. s + 4
    gone through a ring of t < s slots, so slots do not follow positions;
    ``cross``: decoder queries at positions 3 .. s + 2 against an encoder
    memory at 0 .. t - 1 (non-causal: no order between the two).
    """
    js, jt = np.arange(s), np.arange(t)
    aligned = True
    if mode == "index":
        qp, kp = np.tile(js, (b, 1)), np.tile(jt, (b, 1))
    elif mode == "leftpad":
        lens = np.maximum(1, np.arange(1, b + 1) * s // b - 3)
        qp = js[None] - (s - lens)[:, None]
        qp = np.where(qp >= 0, qp, -1)
        kp = np.where(jt[None] < lens[:, None], jt, -1)
    elif mode == "self":
        lens = np.maximum(1, np.arange(1, b + 1) * s // b - 5)
        qp = js[None] - (s - lens)[:, None]
        qp = kp = np.where(qp >= 0, qp, -1)
    elif mode == "ring":
        last = s + 4
        qp = np.tile(np.arange(5, last + 1), (b, 1))
        kp = np.tile(jt + (last - jt) // t * t, (b, 1))
        aligned = False
    elif mode == "cross":
        qp, kp = np.tile(js + 3, (b, 1)), np.tile(jt, (b, 1))
        aligned = False
    else:
        raise ValueError(f"unknown positions mode {mode!r}")
    return qp.astype(np.int32), kp.astype(np.int32), aligned


def decode_positions(b: int, t: int, wrap: int = 0,
                     fill: Optional[Sequence[int]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(q_pos (B, 1), k_pos (B, T)) of a ring-buffer cache: slot j holds
    position j, the first ``wrap`` slots a lap later, slots from a row's
    ``fill`` on empty (-1); the query one past the row's last key."""
    kp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    if wrap:
        kp[:, :wrap] += t
    if fill is not None:
        kp[np.arange(t)[None] >= np.asarray(fill)[:, None]] = -1
    qp = kp.max(axis=1, keepdims=True) + 1
    return qp.astype(np.int32), kp


def serving_cases(seed: int, *, n_heads: int, n_kv_heads: int,
                  head_dim: int, num_slots: int, cache_len: int, bucket: int,
                  min_prompt: int, max_prompt: int, max_new: int, device,
                  dtype: torch.dtype = torch.bfloat16) -> Dict[str, dict]:
    """The engine's largest prefill and its decode step, from ``seed``.

    ``attention.flash``: one prompt of a length drawn in [min_prompt,
    max_prompt], left-padded to ``bucket``, against a fresh ``cache_len``
    cache (slot p holds position p), q/k/v as the model's transposed views.
    ``attention.decode``: ``num_slots`` rows filled to lengths drawn in
    [min_prompt, max_prompt + max_new], the query one past each row's
    last key.  Each entry holds ``args`` (q, k, v, q_pos, k_pos) and
    ``lengths``."""
    r = np.random.default_rng(seed)
    h, kv, dh, t = n_heads, n_kv_heads, head_dim, cache_len
    length = int(r.integers(min_prompt, max_prompt + 1))
    fills = r.integers(min_prompt, max_prompt + max_new + 1, num_slots)
    slots = np.arange(t)
    qp = np.arange(bucket) - (bucket - length)
    qp = np.where(qp >= 0, qp, -1)[None]
    kp = np.where(slots < length, slots, -1)[None]
    q, k, v = draw(r, (1, bucket, h, dh), (1, t, kv, dh), dtype, device)
    flash = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             torch.tensor(qp, dtype=torch.int32, device=device),
             torch.tensor(kp, dtype=torch.int32, device=device))
    kp = np.where(slots[None] < fills[:, None], slots, -1)
    q, k, v = draw(r, (num_slots, 1, h, dh), (num_slots, t, kv, dh), dtype,
                   device)
    decode = (q, k, v,
              torch.tensor(fills[:, None] - 1, dtype=torch.int32,
                           device=device),
              torch.tensor(kp, dtype=torch.int32, device=device))
    return {"attention.flash": {"args": flash, "lengths": [length]},
            "attention.decode": {"args": decode,
                                 "lengths": fills.tolist()}}
