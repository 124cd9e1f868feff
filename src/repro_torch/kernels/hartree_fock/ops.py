"""Registry entry for the Hartree-Fock Fock build (wall-clock figure of merit).

Backends: ``torch`` (the oracle, ``ref.fock_build``) and ``cuda`` (the CUDA
C++ kernels behind ``kernel.twoel``, the default for CUDA tensors).  Both
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


def fock_cuda(positions, density, ngauss=3, *, team=K.TEAM):
    return K.twoel(K.pad4(positions), density,
                   _basis(ngauss, positions.dtype, positions.device),
                   team=team)


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


#: flops of one primitive term of the pair-hoisted form, summed into its
#: integral (``ref.contract``): |P - Q|^2 8, rho x 1, the sqrt, the erf and
#: the division 3, pref K_ij K_kl F0 3, the sum 1 — each special function
#: one operation
TERM_FLOPS = 16
#: the reference's flops for a primitive integral computed from scratch
#: (p, q, P, Q, K_ab and K_cd again for every term)
REFERENCE_TERM_FLOPS = 60
#: six Fock updates for each distinct integral, a multiply-add each
FOCK_FLOPS = 12


def table_flops(natoms: int, ngauss: int) -> int:
    """Flops of the pair tables, made once a build: ``ref.hoisted_pairs``
    over the N (N + 1) / 2 canonical pairs (8 a pair for |Ri - Rj|^2, 15 a
    pair and primitive pair for P and K, 5 a primitive pair for p and the
    exponent's factor) and ``ref.primitive_pairs`` (7 a (g12, g34), 1 a
    g12 for p)."""
    m, g2 = natoms * (natoms + 1) // 2, ngauss ** 2
    return m * (8 + 15 * g2) + 6 * g2 + 7 * g2 * g2


def least_flops(natoms: int, ngauss: int, nl: Optional[int] = None,
                term_flops: int = TERM_FLOPS) -> float:
    """The fewest flops the build (or its slab) needs: every distinct
    integral once, ``term_flops`` for each of its G^4 primitive terms and
    ``FOCK_FLOPS`` for its six Fock updates, plus the pair tables once.
    With the pair-dependent factors hoisted into the tables, a term is
    ``TERM_FLOPS``; ``term_flops=REFERENCE_TERM_FLOPS`` gives the count at
    the reference's cost of a primitive integral from scratch.  A gather
    form computes 2 N^4 G^4 primitive integrals, about 16 times as many as
    there are distinct ones for a whole build."""
    return (float(unique_integrals(natoms, nl))
            * (term_flops * ngauss ** 4 + FOCK_FLOPS)
            + table_flops(natoms, ngauss))


def computed_integrals(natoms: int, l0: int = 0,
                       nl: Optional[int] = None) -> int:
    """Contracted integrals the kernel's tiling evaluates for the build (or
    its slab): TILE^2 quartet slots in each computing tile, those past the
    ragged edges and below the diagonal included, as their threads run the
    loop all the same; at least ``unique_integrals(natoms, nl)``."""
    t = K.tiling(natoms, l0, nl)
    tiles = sum(t.ubs - vb for vb in range(t.vbs))
    return tiles * K.TILE * K.TILE


_k = register_kernel("hartree_fock.twoel", native="cuda",
                     flops_model=_flops_model,
                     doc="HF two-electron Fock build (wall-clock FoM; "
                         "each distinct integral once, then a fixed-order "
                         "gather in place of the paper's atomics)")
_k.add_backend("torch", fock_torch)
_k.add_backend("cuda", fock_cuda, probe=cuda_probe)
# every point is valid for every N
_k.declare_tunables("cuda", team=K.TEAM_GRID)
# O(N^4 G^4) integrals over O(N^2) operands: compute-bound
_k.declare_roofline_contract("torch", bound="compute")
# the kernel's integral scratch E (4 N^3 nl bytes, written once and read
# twice: csrc/hartree_fock.cu) grows as N^2 times the N^2 floor of
# positions, density and F: 120x the floor at the conformance case (N = 8)
_k.declare_roofline_contract("cuda", bound="compute",
                             traffic_inflation_limit=256.0)
