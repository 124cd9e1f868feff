"""The WKV kernel's checks on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_on_card.py``: inputs drawn in the model's layout and at
its scale, and the sweep over the kernel's tunable.

The model hands the kernel ``movedim`` views of (B, S, H, Dh) float32
tensors; r, k and v are layer-normed activations through d x d projections
of std 1/sqrt(d), so about unit std; the log-decays are
``-exp(clip(n, -8, 1))``, as the reference's conformance case draws them
(down to -e a step: the strong decay that would overflow a factored
intra-chunk exponent); u is small, as ``rwkv_layer_init`` draws it.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from repro_torch.core.portable import max_abs_err
from repro_torch.kernels.rwkv6 import kernel as K

#: sequence lengths of the sweep: one token (the decode step), a ragged
#: chunk, several chunks with a ragged tail, a prompt one short of 2048
SWEEP_S = (1, 63, 200, 2047)
SWEEP_DH = (32, 64)
U_STD = 0.02


def draw(gen: torch.Generator, b: int, h: int, s: int, dh: int, device
         ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """((r, k, v, log-decays) (B, H, S, Dh) views, u (H, Dh)) and a state
    (B, H, Dh, Dh) of unit std."""
    def bshd():
        return torch.randn(b, s, h, dh, generator=gen, device=device)

    r, k, v = (bshd().movedim(2, 1) for _ in range(3))
    lw = -torch.exp(bshd().clamp(-8, 1)).movedim(2, 1)
    u = torch.randn(h, dh, generator=gen, device=device) * U_STD
    state = torch.randn(b, h, dh, dh, generator=gen, device=device)
    return (r, k, v, lw, u), state


def points() -> Iterator[dict]:
    """Every chunk the kernel takes."""
    for chunk in K.CHUNK_GRID:
        yield {"chunk": chunk}


def hold(got: Tuple[torch.Tensor, torch.Tensor],
         want: Tuple[torch.Tensor, torch.Tensor], rtol: float, atol: float,
         what: str) -> float:
    """y and the final state against the plain version's; the worse max
    abs error, or ``AssertionError``."""
    return max(max_abs_err(got[0], want[0], rtol, atol, f"{what}: y"),
               max_abs_err(got[1], want[1], rtol, atol, f"{what}: state"))
