"""The seven-point stencil in the port vs the JAX package on the same numpy
inputs.

On the CPU the port's ``torch`` backend, and the CUDA wrapper's plain path,
are held against the reference's ``xla`` oracle and its Pallas kernel in
interpret mode, at the reference's ORACLE_TOL.  The CUDA kernel itself
runs only on the GPU (``tests/test_torch_on_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import stencil7_effective_bytes as jax_eq1_bytes
from repro.core.portable import get_kernel as jax_get_kernel
from repro.kernels.stencil7 import ops as jax_ops
from repro.kernels.stencil7 import ref as jax_ref
import repro_torch.kernels.stencil7.ops  # noqa: F401
from repro_torch.core import conformance
from repro_torch.core.portable import get_kernel
from repro_torch.kernels.stencil7 import kernel as K
from repro_torch.kernels.stencil7 import ref

RTOL, ATOL = conformance.ORACLE_TOL["stencil7"]


def _faces(f):
    return (f[0], f[-1], f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1])


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_case_matches_reference(jax_backend):
    (u,), _ = conformance.CASES["stencil7"]()
    want = jax_get_kernel("stencil7")(jnp.asarray(u), backend=jax_backend)
    got = get_kernel("stencil7")(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape,h,by", [
    ((6, 32, 256), (1.0, 2.0, 3.0), 16), ((12, 24, 128), (0.5, 1.0, 2.0), 8)])
def test_coefficients_and_shapes_match_reference(shape, h, by):
    u = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    coeffs = ref.default_coefficients(*h)
    assert coeffs == jax_ref.default_coefficients(*h)
    want = jax_ops.laplacian_pallas(jnp.asarray(u), *coeffs, by=by,
                                    interpret=True)
    for got in (get_kernel("stencil7")(torch.from_numpy(u), *coeffs),
                K.laplacian(torch.from_numpy(u), *coeffs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_boundary_zero_and_constant_field():
    u = torch.from_numpy(
        np.random.default_rng(6).standard_normal((5, 7, 9)).astype(np.float32))
    before = K.laplacian.launches
    f = K.laplacian(u, *ref.default_coefficients(1.0, 2.0, 3.0))
    assert K.laplacian.launches == before  # CPU: plain version, no launch
    assert f.shape == u.shape
    assert all(bool((face == 0).all()) for face in _faces(f))
    assert bool((f[1:-1, 1:-1, 1:-1] != 0).all())
    flat = K.laplacian(torch.ones(4, 5, 6))
    torch.testing.assert_close(flat, torch.zeros(4, 5, 6), rtol=0, atol=1e-6)


def test_bytes_model_matches_reference():
    k = get_kernel("stencil7")
    for L, dtype, isz in ((64, torch.float32, 4), (16, torch.float64, 8)):
        u = torch.zeros(L, L, L, dtype=dtype)
        assert k.bytes_model(u) == jax_eq1_bytes(L, isz)


def test_registered_backends():
    k = get_kernel("stencil7")
    # the sharded backends of repro_torch.distributed ride along
    assert set(k.backends) == {"torch", "cuda", "torch_shard", "shard_cuda"}
    assert (k.oracle, k.native) == ("torch", "cuda")
    assert k.backend("cuda").fn is K.laplacian

