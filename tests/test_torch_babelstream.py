"""BabelStream in the port vs the JAX package on the same numpy inputs.

On the CPU the port's ``torch`` backend, and the Triton wrappers' plain
path, are held against the reference's ``xla`` oracle and its Pallas
kernel in interpret mode, at the reference's ORACLE_TOL.  The Triton
kernels themselves run only on the GPU (``tests/test_torch_on_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.babelstream.ops  # noqa: F401  (registers the reference)
from repro.core.metrics import babelstream_bytes as jax_babelstream_bytes
from repro.core.portable import get_kernel as jax_get_kernel
from repro.kernels.babelstream import ref as jax_ref
import repro_torch.kernels.babelstream.ops  # noqa: F401
from repro_torch.core import conformance
from repro_torch.core.portable import get_kernel
from repro_torch.kernels.babelstream import kernel as K
from repro_torch.kernels.babelstream import ref

OPS = ("copy", "mul", "add", "triad", "dot")


def _assert_close(got, want, name):
    rtol, atol = conformance.ORACLE_TOL[name]
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("op", OPS)
def test_torch_backend_matches_reference(op, jax_backend):
    name = f"babelstream.{op}"
    arrays, _ = conformance.CASES[name]()
    want = jax_get_kernel(name)(*map(jnp.asarray, arrays),
                                backend=jax_backend)
    got = get_kernel(name)(*conformance.as_tensors(arrays, "cpu"))
    assert tuple(got.shape) == tuple(np.shape(want))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, name)


@pytest.mark.parametrize("op", OPS)
def test_wrapper_runs_the_plain_version_on_cpu(op):
    arrays, _ = conformance.CASES[f"babelstream.{op}"]()
    xs = conformance.as_tensors(arrays, "cpu")
    wrapper = getattr(K, op)
    before = wrapper.launches
    torch.testing.assert_close(wrapper(*xs), getattr(ref, op)(*xs),
                               rtol=0, atol=0)
    assert wrapper.launches == before  # nothing was launched


def test_scalar_matches_reference():
    assert ref.START_SCALAR == jax_ref.START_SCALAR
    c = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    for s in (0.4, -3.0):
        _assert_close(ref.mul(torch.from_numpy(c), s).numpy(),
                      jax_ref.mul(jnp.asarray(c), s), "babelstream.mul")
        _assert_close(ref.triad(torch.from_numpy(c), torch.from_numpy(c), s),
                      jax_ref.triad(jnp.asarray(c), jnp.asarray(c), s),
                      "babelstream.triad")


@pytest.mark.parametrize("dtype,acc", [(torch.bfloat16, torch.float32),
                                       (torch.float16, torch.float32),
                                       (torch.float32, torch.float32),
                                       (torch.float64, torch.float64)])
def test_dot_accumulates_like_the_reference(dtype, acc):
    assert ref.accumulator_dtype(dtype) == acc
    r = np.random.default_rng(4)
    a, b = r.standard_normal(4096), r.standard_normal(4096)
    got = ref.dot(torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype))
    assert got.dtype == dtype and got.dim() == 0
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32, torch.float64: jnp.float32}[dtype]
    want = jax_ref.dot(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


@pytest.mark.parametrize("op", OPS)
def test_bytes_model_matches_reference(op):
    k = get_kernel(f"babelstream.{op}")
    for dtype, isz in ((torch.float32, 4), (torch.float64, 8)):
        x = torch.zeros(1 << 12, dtype=dtype)
        assert k.bytes_model(x, x) == jax_babelstream_bytes(op, 1 << 12, isz)


def test_registered_backends():
    for op in OPS:
        k = get_kernel(f"babelstream.{op}")
        # the sharded backends of repro_torch.distributed ride along
        assert set(k.backends) == {"torch", "triton", "torch_shard",
                                   "shard_triton"}
        assert (k.oracle, k.native) == ("torch", "triton")
        assert k.backend("triton").fn is getattr(K, op)
        assert k.roofline_contract("triton") == {"bound": "memory"}

