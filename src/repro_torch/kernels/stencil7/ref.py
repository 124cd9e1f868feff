"""Plain PyTorch seven-point stencil (paper Listing 2 semantics) — the oracle.

f[i,j,k] = u[i,j,k]*invhxyz2 + (u[i,j,k-1]+u[i,j,k+1])*invhx2
                             + (u[i,j-1,k]+u[i,j+1,k])*invhy2
                             + (u[i-1,j,k]+u[i+1,j,k])*invhz2
on interior cells; boundary cells are zero.  Axis order is (z, y, x), x
contiguous.  The ``torch`` backend of ``stencil7`` and the plain version
the CUDA wrapper in ``kernel.py`` runs for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def default_coefficients(hx: float = 1.0, hy: float = 1.0, hz: float = 1.0):
    invhx2, invhy2, invhz2 = 1.0 / hx ** 2, 1.0 / hy ** 2, 1.0 / hz ** 2
    invhxyz2 = -2.0 * (invhx2 + invhy2 + invhz2)
    return invhx2, invhy2, invhz2, invhxyz2


def laplacian(u: torch.Tensor, invhx2: float, invhy2: float, invhz2: float,
              invhxyz2: float) -> torch.Tensor:
    core = (u[1:-1, 1:-1, 1:-1] * invhxyz2
            + (u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:]) * invhx2
            + (u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]) * invhy2
            + (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]) * invhz2)
    return F.pad(core, (1, 1, 1, 1, 1, 1))
