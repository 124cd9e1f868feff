"""The port's main path — the quickstart workflow — end to end, held
against the JAX package.

``examples/quickstart.py`` steps 1-3: run a science kernel through the
registry on its backends, validate it against the oracle (the paper's C1)
and compute Eq.-4 Phi-bar (the paper's C3).  On the CPU the port runs its
``torch`` backends; the same numpy inputs go through the reference's
``xla`` oracle and Pallas kernels in interpret mode.  On the GPU the same
path runs the hand-written backends (``tests/test_torch_on_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jax_metrics
from repro.core.portable import get_kernel as jax_get_kernel
import repro.kernels.babelstream.ops  # noqa: F401  (registers the reference)
import repro.kernels.flash_attention.ops  # noqa: F401
import repro.kernels.hartree_fock.ops  # noqa: F401
import repro.kernels.minibude.ops  # noqa: F401
import repro.kernels.stencil7.ops  # noqa: F401
import repro_torch.kernels  # noqa: F401
import repro_torch.serving.portable  # noqa: F401  (registers serving.engine)
from repro_torch.core import (BackendUnavailableError, Efficiency, get_kernel,
                              phi_bar, registry)
from repro_torch.core import conformance

PORTED = ("attention.decode", "attention.flash", "babelstream.add",
          "babelstream.copy", "babelstream.dot", "babelstream.mul",
          "babelstream.triad", "hartree_fock.twoel", "minibude.fasten",
          "stencil7")
#: the serving engine's host loop: oracle ``unbatched``, no kernel
ENGINE = ("serving.engine", ("engine_contiguous", "unbatched"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are tiny: one torch thread per test worker, so parallel
    workers' thread pools do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart_path_on_cpu():
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal(1 << 16).astype(np.float32)
    b_np = rng.standard_normal(1 << 16).astype(np.float32)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)

    # 1. a science kernel through the registry on its backends
    triad = get_kernel("babelstream.triad")
    assert sorted(triad.backends) == ["torch", "triton"]
    out = triad(a, b)
    out_ref = triad(a, b, backend="torch")
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    jax_triad = jax_get_kernel("babelstream.triad")
    rtol, atol = conformance.ORACLE_TOL["babelstream.triad"]
    for backend in ("xla", "pallas_interpret"):
        want = jax_triad(jnp.asarray(a_np), jnp.asarray(b_np),
                         backend=backend)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)

    # 2. validation against the oracle (C1); the kernel backend cannot run
    #    on a host without a card, and says why instead of falling back
    assert triad.validate(a, b, backend="torch") == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(BackendUnavailableError, match="CUDA"):
            triad.validate(a, b, backend="triton")

    # 3. timing, Eq. 2 figure of merit and Eq. 4 (C3)
    t_ref = triad.time_backend(a, b, backend="torch", iters=3)
    t_port = triad.time_backend(a, b, backend="torch", iters=3)
    fom = triad.figure_of_merit(t_ref, a, b)
    assert fom["gbytes_per_s"] == pytest.approx(
        jax_metrics.babelstream_bytes("triad", a.numel(), 4) / t_ref / 1e9)
    e = Efficiency("cpu-host", "triad", 1 / t_port, 1 / t_ref)
    assert phi_bar([e]) == jax_metrics.phi_bar(
        [jax_metrics.Efficiency("cpu-host", "triad", 1 / t_port, 1 / t_ref)])


def test_registry_holds_the_slice():
    assert tuple(registry.names()) == tuple(sorted(PORTED + ENGINE[:1]))
    assert conformance.conformance_pairs() == sorted(
        [(name, b) for name in PORTED
         for b in ("torch", get_kernel(name).native)]
        + [(ENGINE[0], b) for b in ENGINE[1]])


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_slice_default_path_matches_reference(name, jax_backend):
    """Every kernel of the slice through the port's default backend (the
    oracle, for CPU tensors) against the reference on the same arrays."""
    arrays, _ = conformance.CASES[name]()
    want = jax_get_kernel(name)(*map(jnp.asarray, arrays),
                                backend=jax_backend)
    got = get_kernel(name)(*conformance.as_tensors(arrays, "cpu"))
    rtol, atol = conformance.ORACLE_TOL[name]
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", PORTED)
def test_oracle_conformance_cell(name):
    assert conformance.check_backend(name, "torch") == 0.0

