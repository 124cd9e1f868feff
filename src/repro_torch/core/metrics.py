"""Figures of merit from the paper (Eqs. 1-4).

These are the *paper's own* analytic models — they intentionally count the
algorithmically-required bytes/ops, not what the compiler happened to move —
so that the bandwidth/GFLOPs numbers are comparable across implementations
(Mojo vs CUDA/HIP there; hand-written kernels vs the torch oracle here).
A line-for-line copy of ``repro.core.metrics``: the port keeps its own so
that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "stencil7_effective_bytes",
    "stencil7_effective_bandwidth",
    "babelstream_bytes",
    "babelstream_bandwidth",
    "minibude_ops",
    "minibude_gflops",
    "hartree_fock_quartets",
    "phi_bar",
    "Efficiency",
]


# --------------------------------------------------------------------------
# Eq. 1 — seven-point stencil effective bandwidth
# --------------------------------------------------------------------------
def stencil7_effective_bytes(L: int, itemsize: int) -> float:
    """fetch + write effective bytes for an L^3 grid (paper Eq. 1)."""
    fetch = (L ** 3 - 8 - 12 * (L - 2)) * itemsize
    write = (L - 2) ** 3 * itemsize
    return float(fetch + write)


def stencil7_effective_bandwidth(L: int, itemsize: int,
                                 kernel_time_s: float) -> float:
    """Effective bandwidth in bytes/s (divide by 1e9 for the paper's GB/s)."""
    return stencil7_effective_bytes(L, itemsize) / kernel_time_s


# --------------------------------------------------------------------------
# Eq. 2 — BabelStream per-op bandwidth
# --------------------------------------------------------------------------
_STREAM_ARRAYS = {"copy": 2, "mul": 2, "add": 3, "triad": 3, "dot": 2}


def babelstream_bytes(op: str, vector_size: int, itemsize: int) -> float:
    """bytes moved for one op invocation (paper Eq. 2)."""
    op = op.lower()
    if op not in _STREAM_ARRAYS:
        raise ValueError(f"unknown BabelStream op {op!r}")
    return float(_STREAM_ARRAYS[op] * itemsize * vector_size)


def babelstream_bandwidth(op: str, vector_size: int, itemsize: int,
                          kernel_time_s: float) -> float:
    return babelstream_bytes(op, vector_size, itemsize) / kernel_time_s


# --------------------------------------------------------------------------
# Eq. 3 — miniBUDE GFLOP/s
# --------------------------------------------------------------------------
def minibude_ops(ppwi: int, nligands: int, nproteins: int,
                 nposes: int) -> float:
    """total FLOPs per fasten invocation (paper Eq. 3)."""
    ops_workgroup = (28 * ppwi
                     + nligands * (2 + 18 * ppwi
                                   + nproteins * (10 + 30 * ppwi)))
    return float(ops_workgroup) * (nposes / ppwi)


def minibude_gflops(ppwi: int, nligands: int, nproteins: int, nposes: int,
                    kernel_time_s: float) -> float:
    return minibude_ops(ppwi, nligands, nproteins, nposes) / kernel_time_s / 1e9


# --------------------------------------------------------------------------
# Hartree-Fock — wall-clock is the FoM; quartet count contextualizes it
# --------------------------------------------------------------------------
def hartree_fock_quartets(natoms: int, ngauss: int) -> float:
    """(ij|kl) quartet evaluations in the gather (symmetry-free) formulation."""
    return float(natoms) ** 4 * float(ngauss) ** 4


# --------------------------------------------------------------------------
# Eq. 4 — performance-portability metric  Φ̄
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Efficiency:
    """One e_i(a) term: portable perf relative to the platform baseline."""

    platform: str
    case: str
    portable_perf: float
    baseline_perf: float

    @property
    def e(self) -> float:
        if self.baseline_perf <= 0:
            raise ValueError("baseline perf must be positive")
        return self.portable_perf / self.baseline_perf


def phi_bar(terms: Sequence[Efficiency]) -> float:
    """Arithmetic-mean application efficiency across platforms (paper Eq. 4).

    The paper notes Φ̄ can be misleading when over-performance on one platform
    cancels under-performance on another (their Hartree-Fock case); callers
    should report the per-term e_i alongside.
    """
    if not terms:
        raise ValueError("phi_bar needs at least one efficiency term")
    return float(np.mean([t.e for t in terms]))
