"""The port's hand-written kernels on the GPU, against their plain versions.

Every test here needs a CUDA device: it is marked ``gpu`` and skips with a
reason elsewhere (a CUDA kernel has no interpret mode).  This file imports
torch and the port only — no jax — so it runs on a GPU host without the
JAX package's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_on_card.py -q

The CPU tests that hold the port against the JAX package are the other
``tests/test_torch_*.py`` files.
"""

import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401
from repro_torch.core import Efficiency, conformance, get_kernel, phi_bar
from repro_torch.kernels.babelstream import kernel as stream_kernel
from repro_torch.kernels.babelstream import ref as stream_ref
from repro_torch.kernels.stencil7 import kernel as stencil_kernel
from repro_torch.kernels.stencil7 import ref as stencil_ref

OPS = ("copy", "mul", "add", "triad", "dot")
PORTED = ("babelstream.add", "babelstream.copy", "babelstream.dot",
          "babelstream.mul", "babelstream.triad", "stencil7")
STENCIL_RTOL, STENCIL_ATOL = conformance.ORACLE_TOL["stencil7"]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda() -> torch.device:
    # decided here, never at import: every xdist worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the GPU")
    return torch.device("cuda", 0)


def _faces(f):
    return (f[0], f[-1], f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1])


@pytest.mark.parametrize("op", OPS)
def test_triton_kernel_matches_plain(cuda, op):
    rtol, atol = conformance.ORACLE_TOL[f"babelstream.{op}"]
    wrapper = getattr(stream_kernel, op)
    g = torch.Generator(device=cuda).manual_seed(0)
    nargs = 1 if op in ("copy", "mul") else 2
    for n in (1, 1000, 4096, (1 << 17) + 3):  # masked tails included
        xs = [torch.randn(n, generator=g, device=cuda) for _ in range(nargs)]
        want = getattr(stream_ref, op)(*xs)
        for block in stream_kernel.BLOCK_GRID:
            for num_warps in stream_kernel.NUM_WARPS_GRID:
                before = wrapper.launches
                got = wrapper(*xs, block=block, num_warps=num_warps)
                assert wrapper.launches > before
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_triton_dot_is_deterministic_and_accumulates_wide(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    a, b = (torch.randn(1 << 20, generator=g, device=cuda) for _ in range(2))
    first = stream_kernel.dot(a, b)
    assert all(torch.equal(first, stream_kernel.dot(a, b)) for _ in range(5))
    for dtype in (torch.bfloat16, torch.float64):
        x, y = a.to(dtype), b.to(dtype)
        got = stream_kernel.dot(x, y)
        assert got.dtype == dtype and got.dim() == 0
        np.testing.assert_allclose(float(got), float(stream_ref.dot(x, y)),
                                   rtol=1e-2)


def test_stencil_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    coeffs = stencil_ref.default_coefficients(1.0, 2.0, 3.0)
    space = get_kernel("stencil7").tunable_space("cuda")
    for shape in ((3, 3, 3), (8, 64, 128), (17, 33, 65), (70, 40, 300)):
        u = torch.randn(shape, generator=g, device=cuda)
        want = stencil_ref.laplacian(u, *coeffs)
        for p in space.points():
            before = stencil_kernel.laplacian.launches
            got = stencil_kernel.laplacian(u, *coeffs, **p)
            torch.cuda.synchronize()
            assert stencil_kernel.laplacian.launches == before + 1
            assert all(bool((face == 0).all()) for face in _faces(got))
            torch.testing.assert_close(got, want, rtol=STENCIL_RTOL,
                                       atol=STENCIL_ATOL)


def test_stencil_kernel_rejects_what_it_cannot_run(cuda):
    lap = stencil_kernel.laplacian
    with pytest.raises(TypeError, match="float32"):
        lap(torch.zeros(4, 4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lap(torch.zeros(4, 4, 8, device=cuda).transpose(0, 2))
    with pytest.raises(ValueError, match="launch shape"):
        lap(torch.zeros(4, 4, 4, device=cuda), block_x=48)


@pytest.mark.parametrize("name", PORTED)
def test_hand_written_conformance_cell(cuda, name):
    k = get_kernel(name)
    wrapper = k.backend(k.native).fn
    args, _ = conformance.case_tensors(name, cuda)
    assert k.default_backend(*args) == k.native
    before = wrapper.launches
    conformance.check_backend(name, k.native, device=cuda)
    assert wrapper.launches > before


def test_quickstart_path(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.randn(1 << 18, generator=g, device=cuda) for _ in range(2))
    terms = []
    for name in ("babelstream.triad", "babelstream.dot"):
        k = get_kernel(name)
        k.validate(a, b, backend=k.native)
        t_ref = k.time_backend(a, b, backend="torch")
        t_port = k.time_backend(a, b, backend=k.native)
        terms.append(Efficiency(torch.cuda.get_device_name(0), name,
                                1 / t_port, 1 / t_ref))
    assert phi_bar(terms) > 0
