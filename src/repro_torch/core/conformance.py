"""Conformance cases and oracle tolerances of the ported kernels.

The port of ``repro.core.conformance`` for the kernels ported so far:

  * ``CASES`` gives every ported kernel one small, deterministic input, as
    **numpy** arrays drawn from ``numpy.random.default_rng(seed)`` — the
    same arrays feed the JAX package in the cross-framework tests, and
    ``case_tensors`` moves them onto any device (a kernel without a case
    FAILS conformance — coverage is mandatory);
  * ``ORACLE_TOL`` and ``BACKEND_TOL`` are the port's own copies of the
    reference's rows for the ported kernels (the tests hold the tables
    equal);
  * ``conformance_pairs()`` derives the (kernel, backend) matrix from the
    live registry; ``check_backend`` runs one cell of it, raising
    ``BackendUnavailableError`` when this host cannot run the pair.

Importing this module registers nothing: callers import
``repro_torch.kernels`` (or one family's ``ops``) first.  The miniBUDE and
Hartree-Fock cases import their family's ``ref`` inside the case, as the
reference's cases do: the deck, the lattice and the density are that
family's own functions, and the table stays in one place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.portable import registry

Tolerance = Union[str, Tuple[float, float]]  # "bitwise" | (rtol, atol)
Case = Tuple[Tuple[np.ndarray, ...], dict]


def _stencil_case() -> Case:
    u = np.random.default_rng(0).standard_normal((8, 64, 128))
    return (u.astype(np.float32),), {}


def _stream_case(nargs: int) -> Case:
    r = np.random.default_rng(1)
    n = 1 << 17
    return tuple(r.standard_normal(n).astype(np.float32)
                 for _ in range(nargs)), {}


def _minibude_case() -> Case:
    from repro_torch.kernels.minibude import ref as mb_ref
    return mb_ref.deck_arrays(natpro=16, natlig=4, nposes=512, seed=0), {}


def _hf_case() -> Case:
    from repro_torch.kernels.hartree_fock import ref as hf_ref
    return (hf_ref.helium_lattice(8, device="cpu").numpy(),
            hf_ref.initial_density(8, device="cpu").numpy()), {}


def _flash_case() -> Case:
    r = np.random.default_rng(2)
    b, h, s, dh = 1, 2, 128, 64
    return tuple((r.standard_normal((b, h, s, dh)) * 0.5).astype(np.float32)
                 for _ in range(3)), {}


def _decode_case() -> Case:
    """Single-query decode against a ring-buffer cache that exercises both
    hard edges at once: row 0 has wrapped (slot order != position order),
    row 1 has empty slots (pos -1 holes)."""
    r = np.random.default_rng(4)
    b, h, kv, t, dh = 2, 4, 2, 128, 64
    q = (r.standard_normal((b, 1, h, dh)) * 0.5).astype(np.float32)
    k = (r.standard_normal((b, t, kv, dh)) * 0.5).astype(np.float32)
    v = (r.standard_normal((b, t, kv, dh)) * 0.5).astype(np.float32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    pos[0, :5] += t                 # row 0: ring wrapped at slots 0..4
    pos[1, 41:] = -1                # row 1: cache only 41/128 full
    q_pos = np.asarray([[t + 5], [41]], np.int32)
    return (q, k, v, q_pos, pos), {}


def _serving_case() -> Case:
    """The serving engine's token-stream case (``repro_torch.serving.
    portable``): its args are a model (params, cfg), not arrays, and
    ``as_tensors`` passes them through."""
    from repro_torch.serving import portable as serving_portable
    return serving_portable.case_args(), {}


CASES: Dict[str, Callable[[], Case]] = {
    "stencil7": _stencil_case,
    "babelstream.copy": lambda: _stream_case(1),
    "babelstream.mul": lambda: _stream_case(1),
    "babelstream.add": lambda: _stream_case(2),
    "babelstream.triad": lambda: _stream_case(2),
    "babelstream.dot": lambda: _stream_case(2),
    "minibude.fasten": _minibude_case,
    "hartree_fock.twoel": _hf_case,
    "attention.flash": _flash_case,
    "attention.decode": _decode_case,
    "serving.engine": _serving_case,
}

#: per-kernel tolerance vs the oracle — the reference's rows
ORACLE_TOL: Dict[str, Tolerance] = {
    "stencil7": (1e-5, 1e-5),
    "babelstream.copy": (1e-6, 1e-6),
    "babelstream.mul": (1e-6, 1e-6),
    "babelstream.add": (1e-6, 1e-6),
    "babelstream.triad": (1e-6, 1e-6),
    "babelstream.dot": (1e-4, 1e-3),
    "minibude.fasten": (2e-4, 2e-3),
    "hartree_fock.twoel": (1e-4, 1e-4),
    "attention.flash": (2e-4, 2e-4),
    "attention.decode": (2e-4, 2e-4),
    # continuous batching is a scheduling concern: it may never change a
    # token
    "serving.engine": "bitwise",
}

#: (kernel, backend) rows that differ from ORACLE_TOL — the reference's
#: rows for the ported kernels: the attention oracles' own backends are
#: bitwise (they are the functions the model's plain path calls)
BACKEND_TOL: Dict[Tuple[str, str], Tolerance] = {
    ("attention.flash", "torch"): "bitwise",
    ("attention.decode", "torch"): "bitwise",
}


def as_tensors(arrays: Tuple[np.ndarray, ...],
               device: Union[str, torch.device]) -> Tuple[torch.Tensor, ...]:
    """numpy case arrays -> tensors on ``device`` (dtype kept); anything
    else (the serving case's model) as it is."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in arrays)


def case_tensors(kernel: str, device: Union[str, torch.device] = "cpu"):
    """``(args, kwargs)`` of ``kernel``'s case, with args on ``device``."""
    case = CASES.get(kernel)
    if case is None:
        raise AssertionError(
            f"kernel {kernel!r} has no conformance case — every registered "
            f"kernel must add one to repro_torch.core.conformance.CASES")
    arrays, kwargs = case()
    return as_tensors(arrays, device), kwargs


def oracle_tolerance(kernel: str, backend: str) -> Tolerance:
    return BACKEND_TOL.get((kernel, backend), ORACLE_TOL.get(kernel))


def conformance_pairs() -> List[Tuple[str, str]]:
    """Every (kernel, backend) cell of the live registry, sorted."""
    return [(name, b) for name in registry.names()
            for b in sorted(registry.get(name).backends)]


def check_backend(kernel: str, backend: str,
                  device: Union[str, torch.device] = "cpu") -> float:
    """Run one conformance cell on ``device``; return the max abs error.

    Raises ``KeyError`` for an unregistered kernel/backend,
    ``AssertionError`` for a missing case or tolerance or a mismatch, and
    ``BackendUnavailableError`` when this host cannot run the pair.
    """
    k = registry.get(kernel)
    tol = oracle_tolerance(kernel, backend)
    if tol is None:
        raise AssertionError(
            f"kernel {kernel!r} has no conformance tolerance — add it to "
            f"repro_torch.core.conformance.ORACLE_TOL")
    args, kwargs = case_tensors(kernel, device)
    rtol, atol = (0.0, 0.0) if tol == "bitwise" else tol
    return k.validate(*args, backend=backend, rtol=rtol, atol=atol, **kwargs)
