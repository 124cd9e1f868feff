"""Registry entry for the Hartree-Fock Fock build (wall-clock figure of merit).

Backends: ``torch`` (the oracle, ``ref.fock_build``) and ``cuda`` (the CUDA
C++ kernel behind ``kernel.twoel``, the default for CUDA tensors).  Both
take ``(positions, density, ngauss=3)``: (N, 3) atom positions, the (N, N)
density, and the STO-nG basis size (3 or 6).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.metrics import hartree_fock_quartets
from repro_torch.core.portable import cuda_probe, register_kernel
from repro_torch.kernels.hartree_fock import kernel as K
from repro_torch.kernels.hartree_fock import ref


@functools.lru_cache(maxsize=None)
def _basis(ngauss: int, dtype: torch.dtype, device: torch.device) -> ref.Basis:
    # made once per (ngauss, dtype, device): a copy from the host would wait
    # for the work already queued on the card
    return ref.sto_basis(ngauss, dtype, device)


def fock_torch(positions, density, ngauss=3):
    return ref.fock_build(positions, density,
                          _basis(ngauss, positions.dtype, positions.device))


def fock_cuda(positions, density, ngauss=3, *, team=K.TEAM, block=K.BLOCK):
    return K.twoel(K.pad4(positions), density,
                   _basis(ngauss, positions.dtype, positions.device),
                   team=team, block=block)


def _flops_model(positions, density, ngauss=3, **kw):
    # ~60 flops per primitive quartet (J + K tiles), x2 tiles
    return 120.0 * hartree_fock_quartets(positions.shape[0], ngauss)


def unique_integrals(natoms: int, nl: Optional[int] = None) -> int:
    """Distinct (ij|kl) under the integrals' 8-fold symmetry that the build
    over the ``l``s of a slab of ``nl`` (every ``l`` by default) needs:
    those with an index in the slab, as the symmetry moves any index into
    ``l``'s place."""
    def distinct(m: int) -> int:
        pairs = m * (m + 1) // 2
        return pairs * (pairs + 1) // 2
    return distinct(natoms) - distinct(natoms - (natoms if nl is None else nl))


def least_flops(natoms: int, ngauss: int, nl: Optional[int] = None) -> float:
    """The fewest flops the build (or its slab) needs: every distinct
    integral once, 60 flops for each of its G^4 primitive integrals (the
    reference's 120 a primitive quartet counts two integrals, J's and K's)
    and 12 for its six Fock updates (two in J, four in K, a multiply-add
    each).  The gather form computes 2 N^4 G^4 primitive integrals, about
    16 times as many for a whole build."""
    return float(unique_integrals(natoms, nl)) * (60.0 * ngauss ** 4 + 12.0)


_k = register_kernel("hartree_fock.twoel", native="cuda",
                     flops_model=_flops_model,
                     doc="HF two-electron Fock build (wall-clock FoM; "
                         "gather reformulation of the paper's atomics)")
_k.add_backend("torch", fock_torch)
_k.add_backend("cuda", fock_cuda, probe=cuda_probe)
# every team divides every block, so every point is valid for every N
_k.declare_tunables("cuda", team=K.TEAM_GRID, block=K.BLOCK_GRID)
# O(N^4 G^4) integrals over O(N^2) operands: compute-bound
_k.declare_roofline_contract(("torch", "cuda"), bound="compute")
