"""Plain PyTorch BabelStream ops (paper Listing 3 semantics) — the oracle.

The ``torch`` backend of every ``babelstream.*`` kernel, and the plain
version each Triton wrapper in ``kernel.py`` runs for CPU tensors.
scalar = 0.4 matches the upstream BabelStream startScalar.
"""

from __future__ import annotations

import torch

START_SCALAR = 0.4


def copy(a: torch.Tensor) -> torch.Tensor:
    """c[i] = a[i]"""
    return a + 0  # a materialized copy rather than an alias


def mul(c: torch.Tensor, scalar: float = START_SCALAR) -> torch.Tensor:
    """b[i] = scalar * c[i]"""
    return scalar * c


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c[i] = a[i] + b[i]"""
    return a + b


def triad(b: torch.Tensor, c: torch.Tensor,
          scalar: float = START_SCALAR) -> torch.Tensor:
    """a[i] = b[i] + scalar * c[i]"""
    return b + scalar * c


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f16 inputs, the input dtype otherwise."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a[i]*b[i], accumulated in ``accumulator_dtype``, returned as a
    0-d tensor of the input dtype."""
    acc = accumulator_dtype(a.dtype)
    return (a.to(acc) * b.to(acc)).sum().to(a.dtype)
