"""Plain PyTorch miniBUDE ``fasten`` — the oracle.

The BUDE energy model (steric + formal/dipole charge + desolvation terms)
of the open-source miniBUDE kernel the paper benchmarks, as
``repro/kernels/minibude/ref.py`` computes it.  Atoms are flat float rows
(x, y, z, type-as-float); per-atom forcefield parameters are pre-gathered
rows (hbtype, radius, hphb, elsc).

    fasten(protein_pos, protein_par, ligand_pos, ligand_par, poses) -> (P,)

``poses`` is (6, P): three rotation angles and three translations.  The
``torch`` backend of ``minibude.fasten`` and the plain version the CUDA
wrapper in ``kernel.py`` runs for CPU tensors.  The reference's
``lax.scan`` over ligand atoms is a Python loop here.

``pair_table`` and ``fasten_sliced`` mirror the CUDA kernel's design on the
CPU (``csrc/minibude.cu``): the pose-independent pair constants with their
folds, and the energy summed per protein slice and then over the slices in
order.  The tests hold them against the reference; nothing on the main path
calls them.

The constants and ``deck_arrays`` (the numpy draws behind ``make_deck``)
are the port's own copies: the reference module imports jax.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ZERO, QUARTER, HALF, ONE, TWO, FOUR = 0.0, 0.25, 0.5, 1.0, 2.0, 4.0
CNSTNT = 45.0
HARDNESS = 38.0
NPNPDIST = 5.5
NPPDIST = 1.0
HBTYPE_F = 70.0
HBTYPE_E = 69.0
FLOAT_MAX = 1e30


def deck_arrays(natpro: int = 938, natlig: int = 26, nposes: int = 65536,
                ntypes: int = 4, seed: int = 0
                ) -> Tuple[np.ndarray, ...]:
    """The float32 numpy arrays of a synthetic bm1-shaped deck.

    The same draws, in the same order, as the reference's ``make_deck``
    (``repro/kernels/minibude/ops.py``): the poses first, then protein
    positions, protein params, ligand positions, ligand params.  Returns
    ``(protein_pos, protein_par, ligand_pos, ligand_par, poses)``.
    """
    rng = np.random.default_rng(seed)
    hb_choices = np.array([HBTYPE_F, HBTYPE_E, 0.0], np.float32)

    def params(n):
        return np.stack([
            rng.choice(hb_choices, n),
            rng.uniform(1.0, 2.5, n),
            rng.choice(np.array([-0.8, 0.0, 0.9], np.float32), n),
            rng.uniform(-1.0, 1.0, n),
        ], axis=1)

    def positions(n, box):
        xyz = rng.uniform(-box, box, (n, 3))
        types = rng.integers(0, ntypes, (n, 1)).astype(np.float64)
        return np.concatenate([xyz, types], axis=1)

    poses = np.concatenate([
        rng.uniform(0, 2 * np.pi, (3, nposes)),
        rng.uniform(-2.0, 2.0, (3, nposes)),
    ], axis=0)
    protein_pos = positions(natpro, 24.0)
    protein_par = params(natpro)
    ligand_pos = positions(natlig, 8.0)
    ligand_par = params(natlig)
    return tuple(a.astype(np.float32) for a in (
        protein_pos, protein_par, ligand_pos, ligand_par, poses))


def pose_transforms(poses: torch.Tensor) -> torch.Tensor:
    """(6, P) pose parameters -> (P, 3, 4) rigid transforms (BUDE order)."""
    sx, cx = torch.sin(poses[0]), torch.cos(poses[0])
    sy, cy = torch.sin(poses[1]), torch.cos(poses[1])
    sz, cz = torch.sin(poses[2]), torch.cos(poses[2])
    tx, ty, tz = poses[3], poses[4], poses[5]
    return torch.stack([
        torch.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz,
                     tx], -1),
        torch.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz,
                     ty], -1),
        torch.stack([-sy, sx * cy, cx * cy, tz], -1),
    ], dim=-2)


def fasten(protein_pos: torch.Tensor, protein_par: torch.Tensor,
           ligand_pos: torch.Tensor, ligand_par: torch.Tensor,
           poses: torch.Tensor) -> torch.Tensor:
    m = pose_transforms(poses)                       # (P, 3, 4)
    # branch constants in the input dtype, made once: on the card each
    # torch.tensor is a copy from the host
    consts = torch.tensor(
        [FOUR, TWO, QUARTER, HALF, ONE, -ONE, ZERO, TWO * HARDNESS, NPNPDIST,
         NPPDIST, -FLOAT_MAX], dtype=poses.dtype, device=poses.device)
    (FOUR_, TWO_, QUARTER_, HALF_, ONE_, NONE_, ZERO_, HARD2_, NPNPDIST_,
     NPPDIST_, NFMAX_) = consts

    p_hbtype = protein_par[:, 0:1]                   # (natpro, 1)
    p_radius = protein_par[:, 1:2]
    p_hphb = protein_par[:, 2:3]
    p_elsc = protein_par[:, 3:4]
    p_xyz = protein_pos[:, :3]                       # (natpro, 3)
    phphb_ltz = p_hphb < ZERO
    phphb_gtz = p_hphb > ZERO
    phphb_nz = p_hphb != ZERO

    etot = torch.zeros(poses.shape[1], dtype=poses.dtype, device=poses.device)
    for il in range(ligand_pos.shape[0]):
        lpos0 = ligand_pos[il, :3]
        l_hbtype, l_radius, l_hphb, l_elsc = ligand_par[il]
        # the ligand atom under every pose: (P, 3)
        lpos = (m[:, :, 0] * lpos0[0] + m[:, :, 1] * lpos0[1]
                + m[:, :, 2] * lpos0[2] + m[:, :, 3])

        lhphb_ltz = l_hphb < ZERO
        lhphb_gtz = l_hphb > ZERO

        radij = p_radius + l_radius                  # (natpro, 1)
        r_radij = ONE / radij
        both_f = (p_hbtype == HBTYPE_F) & (l_hbtype == HBTYPE_F)
        elcdst = torch.where(both_f, FOUR_, TWO_)
        elcdst1 = torch.where(both_f, QUARTER_, HALF_)
        type_e = (p_hbtype == HBTYPE_E) | (l_hbtype == HBTYPE_E)

        p_hphb_s = p_hphb * torch.where(phphb_ltz & lhphb_gtz, NONE_,
                                        ONE_)
        l_hphb_s = l_hphb * torch.where(phphb_gtz & lhphb_ltz, NONE_,
                                        ONE_)
        distdslv = torch.where(
            phphb_ltz,
            torch.where(lhphb_ltz, NPNPDIST_, NPPDIST_),
            torch.where(lhphb_ltz, NPPDIST_, NFMAX_))
        r_distdslv = ONE / distdslv
        chrg_init = l_elsc * p_elsc
        dslv_init = p_hphb_s + l_hphb_s

        # distances: (natpro, P)
        d = lpos.T[None, :, :] - p_xyz[:, :, None]   # (natpro, 3, P)
        distij = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                            + d[:, 2] * d[:, 2])
        distbb = distij - radij
        zone1 = distbb < ZERO

        e_steric = (ONE - distij * r_radij) * torch.where(
            zone1, HARD2_, ZERO_)
        chrg_e = chrg_init * (torch.where(zone1, ONE_,
                                          ONE - distbb * elcdst1)
                              * torch.where(distbb < elcdst, ONE_,
                                            ZERO_))
        chrg_e = torch.where(type_e, -torch.abs(chrg_e), chrg_e)
        e_chrg = chrg_e * CNSTNT

        coeff = ONE - distbb * r_distdslv
        dslv_e = dslv_init * torch.where((distbb < distdslv) & phphb_nz,
                                         ONE_, ZERO_)
        dslv_e = dslv_e * torch.where(zone1, ONE_, coeff)

        etot = etot + _sum_rows(e_steric + e_chrg + dslv_e)
    return etot * HALF


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(dim=0)`` as a fixed tree of elementwise adds (rows ``i`` and
    ``i + h`` first), so a column's sum has the same bits whatever the
    other columns: ATen's reductions (and its small matrix products)
    take another path for a narrow tensor, and a pose's energy then
    depends on how many poses share the call.  The pose-parallel
    ``torch_shard`` backend is bitwise equal to this function because of
    it."""
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        top = x[:h] + x[h:2 * h]
        x = torch.cat([top, x[2 * h:]]) if x.shape[0] % 2 else top
    return x[0]


#: the columns of ``pair_table``: (radij, 1 / radij, elcdst, elcdst1,
#: distdslv, 1 / distdslv, CNSTNT * charge, desolvation)
PAIR_COLUMNS = ("radij", "r_radij", "elcdst", "elcdst1", "distdslv",
                "r_distdslv", "chrg", "dslv")


def pair_table(protein_par: torch.Tensor,
               ligand_par: torch.Tensor) -> torch.Tensor:
    """(natlig, natpro, 8): the pose-independent constants of every (ligand
    atom, protein atom) pair, as the kernel's ``pair_constants`` folds
    them (columns ``PAIR_COLUMNS``).

    The charge is ``-|chrg_init|`` for type E, times CNSTNT; the
    desolvation factor is 0 where its condition can never hold (protein
    ``hphb == 0``, or ``distdslv = -FLOAT_MAX``).  Both folds are exact:
    ``csrc/minibude.cu``'s note proves it and the tests check it.
    """
    p_hb, p_rad, p_hphb, p_elsc = protein_par[None, :, :].unbind(-1)
    l_hb, l_rad, l_hphb, l_elsc = ligand_par[:, None, :].unbind(-1)
    shape = (ligand_par.shape[0], protein_par.shape[0])

    def const(v):
        return protein_par.new_full(shape, v)

    radij = p_rad + l_rad
    both_f = (p_hb == HBTYPE_F) & (l_hb == HBTYPE_F)
    type_e = (p_hb == HBTYPE_E) | (l_hb == HBTYPE_E)
    p_ltz, p_gtz = p_hphb < ZERO, p_hphb > ZERO
    l_ltz, l_gtz = l_hphb < ZERO, l_hphb > ZERO
    p_hphb_s = torch.where(p_ltz & l_gtz, -p_hphb, p_hphb)
    l_hphb_s = torch.where(p_gtz & l_ltz, -l_hphb, l_hphb)
    distdslv = torch.where(
        p_ltz, torch.where(l_ltz, const(NPNPDIST), const(NPPDIST)),
        torch.where(l_ltz, const(NPPDIST), const(-FLOAT_MAX)))
    chrg_init = l_elsc * p_elsc
    chrg = torch.where(type_e, -torch.abs(chrg_init), chrg_init) * CNSTNT
    dslv = torch.where((p_hphb != ZERO) & (distdslv != -FLOAT_MAX),
                       p_hphb_s + l_hphb_s, const(ZERO))
    # reciprocal(): the correctly rounded 1 / x, as ``ONE / x`` computes it
    return torch.stack([
        radij, radij.reciprocal(),
        torch.where(both_f, const(FOUR), const(TWO)),
        torch.where(both_f, const(QUARTER), const(HALF)),
        distdslv, distdslv.reciprocal(), chrg, dslv], dim=-1)


def fasten_sliced(protein_pos: torch.Tensor, protein_par: torch.Tensor,
                  ligand_pos: torch.Tensor, ligand_par: torch.Tensor,
                  poses: torch.Tensor, *, ppwi: int,
                  split: int) -> torch.Tensor:
    """``fasten`` in the kernel's order and form: the energies of poses
    padded with zero poses to whole groups of ``32 * ppwi`` (the tail is
    dropped), each pose's sum taken per protein slice
    ``[w * natpro // split, (w + 1) * natpro // split)`` over its atoms,
    then over ligand atoms, then over the slices in order, from
    ``pair_table``'s constants, each term as the kernel's clamp (the
    steric term as ``-2 HARDNESS / radij * min(distbb, 0)``).  The kernel
    stages a long slice in chunks; each chunk goes on from where the last
    left off, so the order, and this mirror, are the same."""
    if ppwi < 1 or split < 1:
        raise ValueError(f"ppwi and split are >= 1, not {ppwi}, {split}")
    natpro, natlig = protein_pos.shape[0], ligand_pos.shape[0]
    nposes = poses.shape[1]
    group = 32 * ppwi
    padded = torch.zeros((6, -(-nposes // group) * group), dtype=poses.dtype,
                         device=poses.device)
    padded[:, :nposes] = poses
    m = pose_transforms(padded)                      # (P', 3, 4)
    table = pair_table(protein_par, ligand_par)     # (natlig, natpro, 8)
    total = None
    for w in range(split):
        lo, hi = w * natpro // split, (w + 1) * natpro // split
        etot = torch.zeros(padded.shape[1], dtype=poses.dtype,
                           device=poses.device)
        for il in range(natlig):
            lpos = (torch.einsum("pij,j->pi", m[:, :, :3], ligand_pos[il, :3])
                    + m[:, :, 3])                    # (P', 3)
            (radij, r_radij, _, elcdst1, _, r_distdslv, chrg,
             dslv) = table[il, lo:hi].T[..., None]   # each (n, 1)
            d = lpos.T[None, :, :] - protein_pos[lo:hi, :3, None]
            distbb = torch.sqrt(torch.sum(d * d, dim=1)) - radij  # (n, P')
            steric = ((-TWO * HARDNESS * r_radij)
                      * torch.clamp(distbb, max=ZERO))
            charge = chrg * torch.clamp(ONE - distbb * elcdst1, ZERO, ONE)
            desolv = dslv * torch.clamp(ONE - distbb * r_distdslv, ZERO, ONE)
            etot = etot + torch.sum(steric + charge + desolv, dim=0)
        total = etot if total is None else total + etot
    return (total * HALF)[:nposes]
