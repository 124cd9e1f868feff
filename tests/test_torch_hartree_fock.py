"""The Hartree-Fock Fock build in the port vs the JAX package on the same
numpy inputs.

On the CPU the port's ``torch`` backend, and the CUDA wrappers' plain
paths (``twoel``, ``twoel_slab``), are held against the reference's ``xla``
oracle and its Pallas kernels in interpret mode, at the reference's
ORACLE_TOL.  The CUDA kernel itself runs only on the GPU
(``tests/test_torch_on_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.portable import get_kernel as jax_get_kernel
from repro.kernels.hartree_fock import kernel as jax_kernel
from repro.kernels.hartree_fock import ops as jax_ops
from repro.kernels.hartree_fock import ref as jax_ref
from repro_torch.kernels.hartree_fock import ops as hf_ops
from repro_torch.core import conformance
from repro_torch.core.portable import get_kernel
from repro_torch.kernels.hartree_fock import kernel as K
from repro_torch.kernels.hartree_fock import ref

RTOL, ATOL = conformance.ORACLE_TOL["hartree_fock.twoel"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are tiny: one torch thread per test worker, so parallel
    workers' thread pools do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _system(natoms):
    return (ref.helium_lattice(natoms, device="cpu"),
            ref.initial_density(natoms, device="cpu"))


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_case_matches_reference(jax_backend):
    arrays, _ = conformance.CASES["hartree_fock.twoel"]()
    want = jax_get_kernel("hartree_fock.twoel")(*map(jnp.asarray, arrays),
                                                backend=jax_backend)
    _close(get_kernel("hartree_fock.twoel")(
        *conformance.as_tensors(arrays, "cpu")), want)


@pytest.mark.parametrize("natoms,ngauss", [(8, 3), (16, 3), (8, 6)])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_shapes_match_reference(natoms, ngauss, jax_backend):
    pos, dens = _system(natoms)
    want = jax_get_kernel("hartree_fock.twoel")(
        jnp.asarray(pos.numpy()), jnp.asarray(dens.numpy()), ngauss=ngauss,
        backend=jax_backend)
    _close(get_kernel("hartree_fock.twoel")(pos, dens, ngauss=ngauss), want)
    before = K.twoel.launches
    got = K.twoel(K.pad4(pos), dens, ref.sto_basis(ngauss, device="cpu"))
    assert K.twoel.launches == before  # CPU: plain version, no launch
    _close(got, want)


@pytest.mark.parametrize("natoms,ngauss", [(8, 3), (8, 6)])
def test_four_slab_cover_matches_reference(natoms, ngauss):
    """Each slab against ``twoel_slab_tiled`` in interpret mode, and the
    four slabs' sum against the full build."""
    pos, dens = _system(natoms)
    basis = ref.sto_basis(ngauss, device="cpu")
    jax_pos4 = jax_ops._pad4(jnp.asarray(pos.numpy()))
    jax_basis = jax_ref.sto_basis(ngauss)
    nl = natoms // 4
    total = torch.zeros(natoms, natoms)
    for l0 in range(0, natoms, nl):
        want = jax_kernel.twoel_slab_tiled(jax_pos4, jnp.asarray(dens.numpy()),
                                           jax_basis, l0, nl, interpret=True)
        before = K.twoel_slab.launches
        got = K.twoel_slab(K.pad4(pos), dens, basis, l0, nl)
        assert K.twoel_slab.launches == before
        _close(got, want)
        total += got
    _close(total, jax_ops.fock_xla(jnp.asarray(pos.numpy()),
                                   jnp.asarray(dens.numpy()), ngauss=ngauss))


def test_plain_slab_is_the_build_of_the_masked_density():
    # the slab's integrals are, bit for bit, the full tensor's l-slab ...
    pos, dens = _system(8)
    basis = ref.sto_basis(3, device="cpu")
    eri = ref.eri_tensor(pos, basis)
    torch.testing.assert_close(ref.eri_tensor(pos, basis, 2, 3),
                               eri[..., 2:5], rtol=0, atol=0)
    torch.testing.assert_close(ref.fock_build_slab(pos, dens, basis, 2, 3),
                               ref.fock_from_eri(eri[..., 2:5], dens[:, 2:5]),
                               rtol=0, atol=0)
    # ... and, F being linear in D with l D's column index in both terms,
    # the slab build is the full build of D with every other column zeroed
    masked = torch.zeros_like(dens)
    masked[:, 2:5] = dens[:, 2:5]
    torch.testing.assert_close(ref.fock_build_slab(pos, dens, basis, 2, 3),
                               ref.fock_build(pos, masked, basis))


@pytest.mark.parametrize("natoms", [1, 8, 27, 64, 128])
def test_lattice_and_density_are_the_reference_arrays(natoms):
    pos, dens = _system(natoms)
    assert pos.dtype == dens.dtype == torch.float32
    np.testing.assert_array_equal(pos.numpy(),
                                  np.asarray(jax_ref.helium_lattice(natoms)))
    np.testing.assert_array_equal(dens.numpy(),
                                  np.asarray(jax_ref.initial_density(natoms)))
    np.testing.assert_array_equal(
        ref.helium_lattice(natoms, 2.0, device="cpu").numpy(),
        np.asarray(jax_ref.helium_lattice(natoms, 2.0)))


@pytest.mark.parametrize("ngauss", [3, 6])
def test_sto_basis_is_the_reference_basis(ngauss):
    ours, theirs = ref.sto_basis(ngauss, device="cpu"), \
        jax_ref.sto_basis(ngauss)
    assert ours.ngauss == theirs.ngauss == ngauss
    np.testing.assert_array_equal(ours.exponents.numpy(),
                                  np.asarray(theirs.exponents))
    np.testing.assert_array_equal(ours.coefficients.numpy(),
                                  np.asarray(theirs.coefficients))
    assert ref.TWO_PI_POW_2_5 == jax_ref.TWO_PI_POW_2_5
    with pytest.raises(ValueError, match="3 or 6"):
        ref.sto_basis(4, device="cpu")


def test_boys_and_eri_match_reference():
    t = np.array([0.0, 1e-9, 5e-7, 2e-6, 0.3, 4.0, 30.0], np.float32)
    np.testing.assert_allclose(ref.boys_f0(torch.from_numpy(t)).numpy(),
                               np.asarray(jax_ref.boys_f0(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-7)
    pos, _ = _system(6)
    eri = ref.eri_tensor(pos, ref.sto_basis(3, device="cpu"))
    want = jax_ref.eri_tensor(jnp.asarray(pos.numpy()), jax_ref.sto_basis(3))
    np.testing.assert_allclose(eri.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the 8-fold symmetry the paper's scatter kernel exploits
    torch.testing.assert_close(eri, eri.permute(2, 3, 0, 1), rtol=1e-4,
                               atol=1e-6)


def test_fock_is_symmetric():
    pos, dens = _system(16)
    f = get_kernel("hartree_fock.twoel")(pos, dens)
    torch.testing.assert_close(f, f.T, rtol=1e-4, atol=1e-5)


def test_flops_model_matches_reference():
    k, jk = get_kernel("hartree_fock.twoel"), \
        jax_get_kernel("hartree_fock.twoel")
    for natoms, ngauss in ((128, 3), (64, 6), (8, 3)):
        pos, dens = torch.zeros(natoms, 3), torch.zeros(natoms, natoms)
        jpos, jdens = jnp.zeros((natoms, 3)), jnp.zeros((natoms, natoms))
        assert k.flops_model(pos, dens, ngauss=ngauss) == \
            jk.flops_model(jpos, jdens, ngauss=ngauss)
        assert k.flops_model(pos, dens, ngauss, team=64) == \
            jk.flops_model(jpos, jdens, ngauss)
    # the paper's two smallest He systems: 2.17e10 quartets each
    assert k.flops_model(torch.zeros(128, 3), None, 3) == \
        k.flops_model(torch.zeros(64, 3), None, 6) == 120.0 * 128 ** 4 * 81


@pytest.mark.parametrize("natoms,l0,nl", [(5, 0, None), (5, 0, 1), (5, 3, 2),
                                          (6, 1, 3), (4, 0, 4)])
def test_unique_integrals_counts_the_symmetry_classes(natoms, l0, nl):
    def canonical(i, j, k, l):
        # (ij|kl) = (ji|kl) = (ij|lk) = (kl|ij) = ...: the 8 index orders
        bra, ket = (i, j), (k, l)
        return min(x + y for p, q in ((bra, ket), (ket, bra))
                   for x in (p, p[::-1]) for y in (q, q[::-1]))
    slab = range(l0, natoms if nl is None else l0 + nl)
    classes = {canonical(i, j, k, l) for i in range(natoms)
               for j in range(natoms) for k in range(natoms) for l in slab}
    assert hf_ops.unique_integrals(natoms, nl) == len(classes)
    assert hf_ops.least_flops(natoms, 3, nl) == len(classes) * (60 * 81 + 12)


def test_pad4_matches_reference():
    pos, _ = _system(8)
    np.testing.assert_array_equal(
        K.pad4(pos).numpy(), np.asarray(jax_ops._pad4(jnp.asarray(pos.numpy()))))


def test_registered_backends_and_tunables():
    k = get_kernel("hartree_fock.twoel")
    assert set(k.backends) == {"torch", "cuda"}
    assert (k.oracle, k.native) == ("torch", "cuda")
    space = k.tunable_space("cuda")
    assert space.params == {"team": K.TEAM_GRID, "block": K.BLOCK_GRID}
    assert all(p["block"] % p["team"] == 0 for p in space.points())
    assert k.roofline_contract("cuda") == {"bound": "compute"}


def test_wrappers_reject_what_they_cannot_run():
    pos, dens = _system(8)
    pos4, basis = K.pad4(pos), ref.sto_basis(3, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.twoel(pos4.to("meta"), dens.to("meta"),
                ref.sto_basis(3, device="meta"))
    with pytest.raises(ValueError, match=r"\(N, 4\)"):
        K.twoel(pos, dens, basis)
    with pytest.raises(ValueError, match=r"\(N, N\)"):
        K.twoel(pos4, dens[:4], basis)
    with pytest.raises(ValueError, match="one device"):
        K.twoel(pos4, dens, ref.sto_basis(3, device="meta"))
    for l0, nl in ((0, 0), (6, 4), (-1, 2)):
        with pytest.raises(ValueError, match="slab"):
            K.twoel_slab(pos4, dens, basis, l0, nl)
    assert K.twoel.launches == K.twoel_slab.launches == 0
