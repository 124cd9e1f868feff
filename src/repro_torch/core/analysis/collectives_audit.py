"""Collectives pass — the traced census against declared contracts.

The port of ``repro/core/analysis/collectives_audit.py``.  Every backend
either declares what it may ppermute / psum / all_gather
(``PortableKernel.declare_comm_contract``: ``distributed/domain.py``'s
``torch_shard`` backends and ``distributed/shard_kernels.py``'s
composites) or is held to zero collectives.  A contract is normalized to a
list of *variants*, call-kwarg overrides with the census each must give,
so one backend is audited under several decompositions (slab and pencil,
overlap on and off).  An expectation may carry:

  * ``"overlap_shape"``: the local interior shape that must be computed
    with no operand that a collective delivered, issued after the halo
    exchange: the witness that the exchange and the interior overlap
    (``trace.independent_compute_exists``);
  * ``"all_gather": 0`` is implied when absent: an undeclared all_gather
    is always a finding (it re-materializes the whole array).

The census counts what ``distributed.collectives`` issues, each helper as
``counting`` counts it (a halo exchange of a mesh axis is two ppermutes).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.core.analysis import trace as T
from repro_torch.core.analysis.report import Finding

Variant = Tuple[Dict[str, Any], Dict[str, Any]]


def normalize_contract(contract: Any, args: tuple) -> List[Variant]:
    """dict -> one default-call variant; callable -> its variant list.
    The no-contract expectation leaves ``all_gather`` out, so a traced
    all_gather reports as ``undeclared-all-gather`` (its own code) rather
    than as a count mismatch."""
    if contract is None:
        return [({}, {"ppermute": 0, "psum": 0})]
    if callable(contract):
        return [(dict(kw), dict(exp)) for kw, exp in contract(*args)]
    return [({}, dict(contract))]


def check_counts(kernel: str, backend: str, tr: "T.Trace",
                 expected: Dict[str, Any], declared: bool,
                 variant: str = "") -> List[Finding]:
    """Compare the traced census to one variant's expectation."""
    findings: List[Finding] = []
    counts = T.count_collectives(tr)
    tag = f" [{variant}]" if variant else ""
    for kind in T.COLLECTIVE_KINDS:
        want = int(expected.get(kind, 0))
        got = counts[kind]
        if got == want:
            continue
        undeclared_gather = kind == "all_gather" and kind not in expected
        code = ("undeclared-all-gather" if undeclared_gather
                else "undeclared-collective" if not declared
                else "comm-contract-mismatch")
        findings.append(Finding(
            kernel=kernel, backend=backend, pass_name="collectives",
            code=code,
            message=(f"{kind} count{tag}: traced {got}, contract says "
                     f"{want}"
                     + ("" if declared else
                        " (backend declares no communication contract)")),
            detail={"kind": kind, "traced": got, "declared": want,
                    "variant": variant}))

    shape = expected.get("overlap_shape")
    if shape is not None and not T.independent_compute_exists(
            tr, tuple(shape)):
        findings.append(Finding(
            kernel=kernel, backend=backend, pass_name="collectives",
            code="overlap-not-independent",
            message=(f"overlap contract{tag}: no interior compute of shape "
                     f"{tuple(shape)} is independent of the halo traffic — "
                     f"halo exchange and compute cannot overlap"),
            detail={"shape": list(shape), "variant": variant}))
    return findings
