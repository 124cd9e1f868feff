"""Plain PyTorch Hartree-Fock two-electron Fock build — the oracle.

The proxy app (Fletcher et al., basic-hf-proxy) builds the electron-repulsion
contribution to the Fock matrix from s-type Gaussian (ssss) integrals over a
system of helium atoms, all sharing one contracted basis:

    (ij|kl) = sum_{g1..g4} c1 c2 c3 c4 * ssss(z1@Ri, z2@Rj, z3@Rk, z4@Rl)

    ssss = 2 pi^{5/2} / (p q sqrt(p+q))
           * exp(-z1 z2/p |Ri-Rj|^2 - z3 z4/q |Rk-Rl|^2)
           * F0( p q/(p+q) |P-Q|^2 )
    p = z1+z2, q = z3+z4, P = (z1 Ri + z2 Rj)/p, Q = (z3 Rk + z4 Rl)/q
    F0(t) = 0.5 sqrt(pi/t) erf(sqrt t),  F0(0) = 1

and the gather form of the closed-shell Fock build,

    F[i,j] = sum_{k,l} D[k,l] * ( 2 (ij|kl) - (ik|jl) ),

as ``repro/kernels/hartree_fock/ref.py`` computes them (its ``lax.scan``
over primitive pairs is a Python loop here).  The ``torch`` backend of
``hartree_fock.twoel`` and the plain version the CUDA wrappers in
``kernel.py`` run for CPU tensors.  ``pair_order``, ``canonical_quartets``
and ``eri_from_canonical`` are the CUDA kernel's enumeration in plain
PyTorch: each distinct integral once, from the pair tables of
``hoisted_pairs`` and ``primitive_pairs`` by ``hoisted_term``, written to
its images.
``sto_basis``, ``helium_lattice`` and ``initial_density`` are the port's
own copies: the reference module imports jax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

TWO_PI_POW_2_5 = 2.0 * np.pi ** 2.5
HALF_SQRT_PI = 0.5 * math.sqrt(math.pi)

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Basis:
    """One shared contracted s-shell: exponents + (normalized) coefficients."""

    exponents: torch.Tensor  # (G,)
    coefficients: torch.Tensor  # (G,)

    @property
    def ngauss(self) -> int:
        return self.exponents.shape[0]


def sto_basis(ngauss: int = 3, dtype: torch.dtype = torch.float32,
              device: Device = "cuda") -> Basis:
    """STO-nG-like helium s-shell (proxy-app style values, normalized)."""
    if ngauss == 3:
        expo = np.array([6.36242139, 1.15892300, 0.31364979])
        coef = np.array([0.15432897, 0.53532814, 0.44463454])
    elif ngauss == 6:
        expo = np.array([65.98456824, 12.09819836, 3.38438995,
                         1.16259185, 0.45178004, 0.18599939])
        coef = np.array([0.00916360, 0.04936150, 0.16853830,
                         0.37056280, 0.41649150, 0.13033400])
    else:
        raise ValueError("ngauss must be 3 or 6 (paper's cases)")
    # primitive normalization for s gaussians: (2a/pi)^(3/4)
    norm = (2.0 * expo / np.pi) ** 0.75
    return Basis(exponents=torch.from_numpy(expo).to(device, dtype),
                 coefficients=torch.from_numpy(coef * norm).to(device, dtype))


def boys_f0(t: torch.Tensor) -> torch.Tensor:
    """F0 Boys function, series-guarded at t -> 0."""
    t_safe = torch.clamp_min(t, 1e-12)
    big = 0.5 * torch.sqrt(math.pi / t_safe) * torch.erf(torch.sqrt(t_safe))
    small = 1.0 - t / 3.0 + t * t / 10.0
    return torch.where(t < 1e-6, small, big)


def _pair_tables(positions: torch.Tensor, basis: Basis):
    """Stacked (G^2,) pair quantities over all primitive pairs."""
    R = positions
    z, c = basis.exponents, basis.coefficients
    G = basis.ngauss
    g = torch.arange(G, device=R.device)
    g1, g2 = (a.reshape(-1) for a in torch.meshgrid(g, g, indexing="ij"))
    p = z[g1] + z[g2]                                        # (G2,)
    d2 = torch.sum((R[:, None, :] - R[None, :, :]) ** 2, -1)  # (N,N)
    # P centers (G2, N, N, 3); Kab (G2, N, N)
    P = (z[g1][:, None, None, None] * R[None, :, None, :]
         + z[g2][:, None, None, None] * R[None, None, :, :]) \
        / p[:, None, None, None]
    Kab = torch.exp(-(z[g1] * z[g2] / p)[:, None, None] * d2[None]) \
        * (c[g1] * c[g2])[:, None, None]
    return p, P, Kab


def eri_tensor(positions: torch.Tensor, basis: Basis, l0: int = 0,
               nl: Optional[int] = None) -> torch.Tensor:
    """The (ij|kl) integrals with ``l`` in ``[l0, l0 + nl)`` (every ``l``
    by default): (N, N, N, nl) — N^3 nl floats, so moderate N."""
    N = positions.shape[0]
    nl = N - l0 if nl is None else nl
    G2 = basis.ngauss ** 2
    p, P, Kab = _pair_tables(positions, basis)
    Pkl, Kkl = P[:, :, l0:l0 + nl], Kab[:, :, l0:l0 + nl]
    eri = torch.zeros((N, N, N, nl), dtype=positions.dtype,
                      device=positions.device)
    for ab in range(G2 * G2):
        a, b = ab // G2, ab % G2
        pa, qb = p[a], p[b]
        pq_d2 = torch.sum((P[a][:, :, None, None, :]
                           - Pkl[b][None, None, :, :, :]) ** 2, -1)
        t = (pa * qb / (pa + qb)) * pq_d2
        pref = TWO_PI_POW_2_5 / (pa * qb * torch.sqrt(pa + qb))
        eri = eri + (pref * boys_f0(t)
                     * Kab[a][:, :, None, None] * Kkl[b][None, None, :, :])
    return eri


def pair_order(natoms: int, l0: int = 0, nl: Optional[int] = None,
               device: Device = "cpu"):
    """The canonical atom pairs (i >= j) in the order the kernel ranks them:
    the pairs holding an index of the slab ``[l0, l0 + nl)`` first, each
    group in the order of ``i (i + 1) / 2 + j``.  Returns ``(i, j, s)``: two
    (N (N + 1) / 2,) long tensors and ``s``, the count of slab pairs."""
    nl = natoms - l0 if nl is None else nl
    i, j = torch.tril_indices(natoms, natoms, device=device)
    in_slab = ((i >= l0) & (i < l0 + nl)) | ((j >= l0) & (j < l0 + nl))
    order = torch.argsort((~in_slab).to(torch.int32), stable=True)
    rest = natoms - nl
    return i[order], j[order], natoms * (natoms + 1) // 2 \
        - rest * (rest + 1) // 2


def _canonical_ranks(natoms: int, l0: int, nl: Optional[int],
                     device: Device):
    # pair_order's pairs and the rank pairs u >= v, v < s, of the slab's
    # distinct integrals
    pi, pj, s = pair_order(natoms, l0, nl, device)
    u, v = torch.meshgrid(torch.arange(pi.shape[0], device=device),
                          torch.arange(s, device=device), indexing="ij")
    keep = u >= v
    return pi, pj, u[keep], v[keep]


def canonical_quartets(natoms: int, l0: int = 0, nl: Optional[int] = None,
                       device: Device = "cpu"):
    """The distinct (ij|kl) with an index in the slab, once each: the rank
    pairs ``u >= v`` with ``v < s`` of ``pair_order``, as four long tensors
    ``(i, j, k, l)`` (bra pair ``u``, ket pair ``v``)."""
    pi, pj, u, v = _canonical_ranks(natoms, l0, nl, device)
    return pi[u], pj[u], pi[v], pj[v]


def hoisted_pairs(positions: torch.Tensor, basis: Basis, i: torch.Tensor,
                  j: torch.Tensor):
    """The kernel's pair table over the atom pairs ``(i, j)`` (m each) and
    the primitive pairs g12 = (g1, g2): P = (z1 Ri + z2 Rj) / p, (m, G^2,
    3), and K = c1 c2 exp(-z1 z2 / p |Ri - Rj|^2), (m, G^2)."""
    z, c = basis.exponents, basis.coefficients
    g = torch.arange(basis.ngauss, device=positions.device)
    g1, g2 = (a.reshape(-1) for a in torch.meshgrid(g, g, indexing="ij"))
    z1, z2 = z[g1], z[g2]
    p = z1 + z2
    ri, rj = positions[i], positions[j]
    d = ri - rj
    d2 = (d * d).sum(-1)
    P = (z1[None, :, None] * ri[:, None, :]
         + z2[None, :, None] * rj[:, None, :]) / p[None, :, None]
    K = torch.exp(-(z1 * z2 / p)[None, :] * d2[:, None]) * (c[g1] * c[g2])
    return P, K


def primitive_pairs(basis: Basis):
    """The kernel's table over (g12, g34): rho = pq / (p + q) and the
    prefactor 2 pi^2.5 / (p q sqrt(p + q)) times sqrt(pi) / 2, the constant
    of F0 = sqrt(pi) / 2 erf(sqrt t) / sqrt t; two (G^2, G^2) tensors."""
    z = basis.exponents
    p = (z[:, None] + z[None, :]).reshape(-1)
    pq = p[:, None] * p[None, :]
    ps = p[:, None] + p[None, :]
    return pq / ps, (TWO_PI_POW_2_5 * HALF_SQRT_PI) / (pq * torch.sqrt(ps))


def hoisted_term(P: torch.Tensor, Q: torch.Tensor, k_ij: torch.Tensor,
                 k_kl: torch.Tensor, rho: torch.Tensor,
                 pref: torch.Tensor) -> torch.Tensor:
    """One primitive term of (ij|kl) from the hoisted tables, pref K_ij
    K_kl F0(rho |P - Q|^2): all that is left of a primitive integral once
    everything of one pair is in a table.  t is clamped to 1e-12, where
    erf(s) / s is already F0(0) = 1 in float32 (the kernel's series below
    1e-6 agrees with it)."""
    d = P - Q
    s = torch.sqrt(torch.clamp_min(rho * (d * d).sum(-1), 1e-12))
    return pref * k_ij * k_kl * torch.erf(s) / s


def contract(bra_P: torch.Tensor, bra_K: torch.Tensor, ket_P: torch.Tensor,
             ket_K: torch.Tensor, rho: torch.Tensor,
             pref: torch.Tensor) -> torch.Tensor:
    """The contracted integrals of quartets whose bra and ket pairs have the
    table rows ``(bra_P, bra_K)`` and ``(ket_P, ket_K)``: their G^4
    primitive terms summed, g12 outer and g34 inner, as the kernel sums
    them."""
    g2 = rho.shape[0]
    vals = bra_K.new_zeros(bra_K.shape[0])
    for a in range(g2):
        for b in range(g2):
            vals = vals + hoisted_term(bra_P[:, a], ket_P[:, b], bra_K[:, a],
                                       ket_K[:, b], rho[a, b], pref[a, b])
    return vals


def eri_from_canonical(positions: torch.Tensor, basis: Basis, l0: int = 0,
                       nl: Optional[int] = None) -> torch.Tensor:
    """``eri_tensor``'s (N, N, N, nl) integrals as the kernel makes them:
    each canonical quartet of ``canonical_quartets`` evaluated once from the
    pair tables, then written to every one of its <= 8 images whose last
    index lies in the slab.  A slot no image reaches stays NaN."""
    N = positions.shape[0]
    nl = N - l0 if nl is None else nl
    pi, pj, u, v = _canonical_ranks(N, l0, nl, positions.device)
    P, K = hoisted_pairs(positions, basis, pi, pj)
    vals = contract(P[u], K[u], P[v], K[v], *primitive_pairs(basis))
    i, j, k, l = pi[u], pj[u], pi[v], pj[v]
    eri = torch.full((N, N, N, nl), float("nan"), dtype=positions.dtype,
                     device=positions.device)
    for w, x, y, z in ((i, j, k, l), (j, i, k, l), (i, j, l, k),
                       (j, i, l, k), (k, l, i, j), (l, k, i, j),
                       (k, l, j, i), (l, k, j, i)):
        mine = (z >= l0) & (z < l0 + nl)
        eri[w[mine], x[mine], y[mine], z[mine] - l0] = vals[mine]
    return eri


def fock_from_eri(eri: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """F[i,j] = sum_kl D[k,l] (2 (ij|kl) - (ik|jl)) from the integrals;
    ``eri`` and ``density`` may both hold only a slab of the ``l``s."""
    j_term = 2.0 * torch.einsum("ijkl,kl->ij", eri, density)
    k_term = torch.einsum("ikjl,kl->ij", eri, density)
    return j_term - k_term


def fock_build(positions: torch.Tensor, density: torch.Tensor,
               basis: Basis) -> torch.Tensor:
    """F[i,j] = sum_kl D[k,l] (2 (ij|kl) - (ik|jl)) — the gather form."""
    return fock_from_eri(eri_tensor(positions, basis), density)


def fock_build_slab(positions: torch.Tensor, density: torch.Tensor,
                    basis: Basis, l0: int, nl: int) -> torch.Tensor:
    """The partial Fock build over the quartets with ``l in [l0, l0+nl)``.

    ``l`` is D's column index in both the J and the K term, so only the
    integrals with ``l`` in the slab and D's slab of columns are needed.
    """
    return fock_from_eri(eri_tensor(positions, basis, l0, nl),
                         density[:, l0:l0 + nl])


def helium_lattice(natoms: int, spacing: float = 1.4,
                   dtype: torch.dtype = torch.float32,
                   device: Device = "cuda") -> torch.Tensor:
    """Deterministic cubic-ish lattice of He atoms (proxy test-deck style)."""
    side = int(np.ceil(natoms ** (1.0 / 3.0)))
    pts = []
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if len(pts) < natoms:
                    pts.append((ix * spacing, iy * spacing, iz * spacing))
    return torch.from_numpy(np.array(pts)).to(device, dtype)


def initial_density(natoms: int, dtype: torch.dtype = torch.float32,
                    device: Device = "cuda") -> torch.Tensor:
    """Symmetric positive test density (identity-dominated, like an SCF
    guess); the generator is seeded with 42 whatever the caller's seed."""
    rng = np.random.default_rng(42)
    a = rng.standard_normal((natoms, natoms)) * 0.05
    d = np.eye(natoms) + (a + a.T) / 2.0
    return torch.from_numpy(d).to(device, dtype)
