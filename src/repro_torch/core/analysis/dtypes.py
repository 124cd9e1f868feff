"""Dtypes pass — float64 lint and accumulation dtype.

The port of ``repro/core/analysis/dtypes.py``.  Three checks on the trace
of the conformance case:

  * **float64 promotion**: an op that yields float64 or complex128 with no
    float64 or complex128 tensor among its inputs, a factory op (``zeros``,
    ``arange``, ``full``) included.  The reference has to re-trace under
    ``enable_x64`` to see such an op, because JAX clamps it back to float32
    by default; PyTorch has no clamp, so the normal trace shows it, and on
    the card it doubles the op's bytes and runs on the float64 pipes.  A
    Python float never promotes a float32 tensor in PyTorch: the usual
    triggers are a float64 numpy array or an explicit dtype.  Integer
    widening is not flagged;
  * **accumulation downgrade**: every reduction or product (``sum``,
    ``mm``, ``bmm``, ``addmm``, ..., and the collectives' ``psum``) that
    yields a floating dtype must yield at least the kernel's declared
    ``accum_dtype`` (float32 by default): a sum carried in bfloat16 loses
    the oracle's precision;
  * **declared accumulation**: each launch plan's ``accum_dtype`` (what
    the hand-written kernel accumulates in) is held to the same rule.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.core.analysis import trace as T
from repro_torch.core.analysis.report import Finding

#: ATen reductions and products audited against the declared accumulation
#: dtype (names without the in-place underscore)
ACCUM_OPS = frozenset((
    "sum", "mean", "nansum", "cumsum", "prod", "mm", "bmm", "addmm",
    "baddbmm", "addbmm", "matmul", "dot", "vdot", "mv", "addmv",
    "linalg_vector_norm", "norm", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention"))

_WIDE = ("float64", "complex128")


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def _floating(name: str) -> bool:
    dt = getattr(torch, name, None)
    return isinstance(dt, torch.dtype) and dt.is_floating_point


def run_f64_lint(kernel: str, backend: str, tr: "T.Trace") -> List[Finding]:
    """Flag ops yielding float64/complex128 from no wide tensor input."""
    findings, seen = [], set()
    for op in tr.ops:
        if op.kind != "aten":
            continue
        wide = [d for d in op.out_dtypes if d in _WIDE]
        if not wide or any(d in _WIDE for d in op.in_dtypes):
            continue
        key = (op.name, wide[0])
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding(
            kernel=kernel, backend=backend, pass_name="dtypes",
            code="f64-promotion",
            message=(f"{op.name} yields {wide[0]} from "
                     f"{list(op.in_dtypes) or 'no tensor input'} — a "
                     f"float64 array or an explicit dtype widened the "
                     f"working dtype"),
            detail={"op": op.name, "dtype": wide[0],
                    "inputs": list(op.in_dtypes)}))
    return findings


def _downgrade(kernel, backend, what, dtype, accum_dtype) -> Finding:
    return Finding(
        kernel=kernel, backend=backend, pass_name="dtypes",
        code="accum-downgrade",
        message=(f"{what} accumulates in {dtype} but the kernel declares "
                 f"accum_dtype={accum_dtype}"),
        detail={"op": what, "dtype": dtype, "declared": accum_dtype})


def run_accum_check(kernel: str, backend: str, tr: "T.Trace",
                    accum_dtype: str) -> List[Finding]:
    """Flag reductions, products, psums and planned launches that
    accumulate narrower than ``accum_dtype``."""
    declared = _itemsize(accum_dtype)
    findings, seen = [], set()
    for op in tr.ops:
        if op.kind == "launch":
            for launch in op.launches:
                dt = launch.accum_dtype
                if _floating(dt) and _itemsize(dt) < declared and \
                        (launch.symbol, dt) not in seen:
                    seen.add((launch.symbol, dt))
                    findings.append(_downgrade(kernel, backend,
                                               launch.symbol, dt,
                                               accum_dtype))
            continue
        if not (op.kind == "aten" and op.name in ACCUM_OPS
                or op.kind == "collective" and op.name == "psum"):
            continue
        for dt in op.out_dtypes:
            if _floating(dt) and _itemsize(dt) < declared and \
                    (op.name, dt) not in seen:
                seen.add((op.name, dt))
                findings.append(_downgrade(kernel, backend, op.name, dt,
                                           accum_dtype))
    return findings
