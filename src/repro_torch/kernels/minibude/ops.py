"""Registry entry and deck generator for miniBUDE (paper Eq. 3 figure of merit).

Backends: ``torch`` (the oracle, ``ref.py``) and ``cuda`` (the CUDA C++
kernel behind ``kernel.fasten``, the default for CUDA tensors).  Both take
``(protein_pos, protein_par, ligand_pos, ligand_par, poses)`` and return
the (P,) energies.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core.metrics import minibude_ops
from repro_torch.core.portable import cuda_probe, register_kernel
from repro_torch.kernels.minibude import kernel as K
from repro_torch.kernels.minibude import ref

#: PPWI of the Eq.-3 operation count: the reference's pose tile (128 poses
#: per grid step), so GFLOP/s compare across the two packages whatever
#: ``ppwi`` the CUDA kernel runs with
FLOPS_PPWI = 128
#: flops of one (ligand atom, protein atom, pose) interaction with the pair
#: constants hoisted: 3 differences, a squared norm (3 products, 2 sums), a
#: sqrt, distbb, then steric 1 product, charge and desolvation 3 each
#: (distbb times a constant, 1 minus it, times the pair's factor) and 3 sums
#: into the pose's energy; the clamps are selects
INTERACTION_FLOPS = 20
#: a ligand atom moved under a pose: 3 rows of 3 products and 3 sums
LIGAND_FLOPS = 18
#: a pose's transform (3 sines, 3 cosines, 16 products, 4 sums) and the 0.5
POSE_FLOPS = 27
#: a pair's constants: radij, its reciprocal and -2 HARDNESS times it, the
#: charge and CNSTNT times it, the desolvation sum, 1 / distdslv
PAIR_FLOPS = 7


def least_flops(natpro: int, natlig: int, nposes: int) -> float:
    """The fewest flops a call needs with the pair constants hoisted, the
    count of the bound (an FMA two): every interaction, every ligand atom
    under every pose, every pose's transform, and the pair table once.
    About 2/3 of Eq. 3's count, which has 30 flops an interaction and
    ``FLOPS_PPWI`` poses a work-group (``_flops_model``)."""
    return float(INTERACTION_FLOPS * natpro * natlig * nposes
                 + LIGAND_FLOPS * natlig * nposes + POSE_FLOPS * nposes
                 + PAIR_FLOPS * natpro * natlig)


def make_deck(natpro: int = 938, natlig: int = 26, nposes: int = 65536,
              ntypes: int = 4, seed: int = 0,
              device: Union[str, torch.device] = "cuda"
              ) -> Tuple[torch.Tensor, ...]:
    """Synthetic bm1-shaped deck as float32 tensors on ``device``.

    The same numbers as the reference's ``make_deck`` for the same
    arguments (``ref.deck_arrays`` makes the draws).  Forcefield rows are
    (hbtype, radius, hphb, elsc); hbtype is drawn from {F, E, 0} and hphb
    from {-0.8, 0, 0.9}, the branch structure a real deck exercises.
    """
    return tuple(torch.from_numpy(a).to(device)
                 for a in ref.deck_arrays(natpro, natlig, nposes, ntypes,
                                          seed))


def _flops_model(protein_pos, protein_par, ligand_pos, ligand_par, poses,
                 **kw):
    # paper Eq. 3 with PPWI = the reference's poses per grid step, whatever
    # launch tunables ride along in ``kw``
    return minibude_ops(FLOPS_PPWI, ligand_pos.shape[0],
                        protein_pos.shape[0], poses.shape[1])


_k = register_kernel("minibude.fasten", native="cuda",
                     flops_model=_flops_model,
                     doc="miniBUDE fasten energy kernel (paper Eq. 3 FoM)")
_k.add_backend("torch", ref.fasten)
_k.add_backend("cuda", K.fasten, probe=cuda_probe)
# the pose tail and empty protein slices are masked, so every point is
# valid for every P, natpro and natlig
_k.declare_tunables("cuda", ppwi=K.PPWI_GRID, split=K.SPLIT_GRID)
# O(natlig * natpro) flops per pose over O(1) bytes per pose
_k.declare_roofline_contract(("torch", "cuda"), bound="compute")
