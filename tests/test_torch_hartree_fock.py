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
from torch.utils._python_dispatch import TorchDispatchMode

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
    tables = hf_ops.table_flops(natoms, 3)
    assert hf_ops.least_flops(natoms, 3, nl) == \
        len(classes) * (16 * 81 + 12) + tables
    assert hf_ops.least_flops(natoms, 3, nl, hf_ops.REFERENCE_TERM_FLOPS) \
        == len(classes) * (60 * 81 + 12) + tables


class _FlopCount(TorchDispatchMode):
    """Counts the floating-point operations of the tensor code run under
    it: one for each output element of an elementwise arithmetic op (each
    special function one), n - 1 for each sum of n; selects, clamps and
    indexing none.  Fails on any other op, so that nothing goes uncounted."""

    aten = torch.ops.aten
    ELEMENTWISE = {aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor,
                   aten.div.Tensor, aten.neg.default, aten.reciprocal.default,
                   aten.sqrt.default, aten.erf.default, aten.exp.default}
    FREE = {aten.select.int, aten.slice.Tensor, aten.index.Tensor,
            aten.unsqueeze.default, aten.view.default,
            aten._unsafe_view.default, aten.expand.default,
            aten.clone.default, aten.arange.default, aten.new_zeros.default,
            aten.clamp_min.default}

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ELEMENTWISE:
            self.flops += out.numel()
        elif func is self.aten.sum.dim_IntList:
            self.flops += args[0].numel() - out.numel()
        else:
            assert func in self.FREE, f"uncounted op {func}"
        return out


@pytest.mark.parametrize("ngauss", [3, 6])
def test_term_flops_count_the_hoisted_term(ngauss):
    """``TERM_FLOPS`` is what ``ref.contract`` runs for each primitive
    term of one integral, counted op by op."""
    pos, _ = _system(6)
    basis = ref.sto_basis(ngauss, device="cpu")
    i, j = torch.tensor([4, 2]), torch.tensor([1, 2])
    P, Kt = ref.hoisted_pairs(pos, basis, i, j)
    rho, pref = ref.primitive_pairs(basis)
    with _FlopCount() as count:
        ref.contract(P[:1], Kt[:1], P[1:], Kt[1:], rho, pref)
    assert count.flops == hf_ops.TERM_FLOPS * ngauss ** 4


@pytest.mark.parametrize("natoms,ngauss", [(1, 3), (7, 3), (5, 6)])
def test_table_flops_count_the_pair_tables(natoms, ngauss):
    pos, _ = _system(natoms)
    basis = ref.sto_basis(ngauss, device="cpu")
    i, j = torch.tril_indices(natoms, natoms)
    with _FlopCount() as count:
        ref.hoisted_pairs(pos, basis, i, j)
        ref.primitive_pairs(basis)
    assert count.flops == hf_ops.table_flops(natoms, ngauss)


def test_least_flops_is_the_hoisted_form():
    """The bound's count at the two systems and a slab: 16 flops a
    primitive term, about 3.7 times fewer than the reference's 60."""
    for n, g, nl in ((128, 3, None), (64, 6, None), (128, 3, 32)):
        distinct = hf_ops.unique_integrals(n, nl)
        least = hf_ops.least_flops(n, g, nl)
        assert least == distinct * (16 * g ** 4 + 12) \
            + hf_ops.table_flops(n, g)
        assert 3.5 < hf_ops.least_flops(n, g, nl, 60) / least < 3.8


def test_pad4_matches_reference():
    pos, _ = _system(8)
    np.testing.assert_array_equal(
        K.pad4(pos).numpy(), np.asarray(jax_ops._pad4(jnp.asarray(pos.numpy()))))


def test_registered_backends_and_tunables():
    k = get_kernel("hartree_fock.twoel")
    # the sharded backends of repro_torch.distributed ride along
    assert set(k.backends) == {"torch", "cuda", "torch_shard", "shard_cuda"}
    assert (k.oracle, k.native) == ("torch", "cuda")
    space = k.tunable_space("cuda")
    assert space.params == {"team": K.TEAM_GRID}
    assert {"team": K.TEAM} in list(space.points())
    # a team is whole warps of a 256-thread block
    assert all(256 % p["team"] == 0 and p["team"] % 32 == 0
               for p in space.points())
    # compute-bound; the integral scratch's traffic (4 N^3 nl bytes) is
    # declared for the static auditor (core/analysis/cost.py)
    assert k.roofline_contract("cuda") == {"bound": "compute",
                                           "traffic_inflation_limit": 256.0}


SLAB_CASES = [(5, 0, None), (5, 0, 1), (5, 3, 2), (6, 1, 3), (4, 0, 4)]


@pytest.mark.parametrize("natoms,l0,nl", SLAB_CASES)
def test_canonical_quartets_write_every_slot_once(natoms, l0, nl):
    """The kernel's enumeration in plain PyTorch: each distinct integral
    with an index in the slab evaluated once, its images filling every
    slot of (N, N, N, nl), equal to the full tensor's slab and to the
    reference's integrals."""
    pos, _ = _system(natoms)
    basis = ref.sto_basis(3, device="cpu")
    i, j, k, l = ref.canonical_quartets(natoms, l0, nl)
    assert i.shape[0] == hf_ops.unique_integrals(natoms, nl)
    assert bool((i >= j).all() and (k >= l).all())
    width = natoms - l0 if nl is None else nl
    in_slab = [(x >= l0) & (x < l0 + width) for x in (i, j, k, l)]
    assert bool((in_slab[0] | in_slab[1] | in_slab[2] | in_slab[3]).all())
    eri = ref.eri_from_canonical(pos, basis, l0, nl)
    assert eri.shape == (natoms, natoms, natoms, width)
    assert not bool(torch.isnan(eri).any())
    torch.testing.assert_close(eri, ref.eri_tensor(pos, basis, l0, nl),
                               rtol=1e-5, atol=1e-6)
    want = np.asarray(jax_ref.eri_tensor(jnp.asarray(pos.numpy()),
                                         jax_ref.sto_basis(3)))
    np.testing.assert_allclose(eri.numpy(), want[..., l0:l0 + width],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("natoms,l0,nl", SLAB_CASES)
def test_pair_order_puts_the_slab_pairs_first(natoms, l0, nl):
    t = K.tiling(natoms, l0, nl)
    i, j, s = t.i, t.j, t.s
    width = natoms - l0 if nl is None else nl
    rest = natoms - width
    assert t.m == natoms * (natoms + 1) // 2
    assert s == t.m - rest * (rest + 1) // 2
    assert (t.ubs, t.vbs) == (-(-t.m // K.TILE), -(-s // K.TILE))
    assert sorted(zip(i.tolist(), j.tolist())) == \
        [(a, b) for a in range(natoms) for b in range(a + 1)]
    held = ((i >= l0) & (i < l0 + width)) | ((j >= l0) & (j < l0 + width))
    assert bool(held[:s].all()) and not bool(held[s:].any())


@pytest.mark.parametrize("natoms,l0,nl", [(9, 0, None), (9, 2, 3),
                                          (12, 11, 1), (40, 7, 5),
                                          (40, 0, None), (33, 32, 1)])
def test_computed_integrals_counts_the_kernels_tiles(natoms, l0, nl):
    """The kernel's grid walked on the host: the blocks with bra tile >=
    ket tile, a thread's 2 x 2 quartets at ty + 16 a, tx + 16 b; those it
    writes are the distinct integrals, each once, and the slots it runs
    are ``computed_integrals``."""
    t, tile = K.tiling(natoms, l0, nl), K.TILE
    m, s = t.m, t.s
    slots, seen = 0, set()
    for ub in range(t.ubs):
        for vb in range(min(ub + 1, t.vbs)):
            u = ub * tile + np.arange(tile)[:, None]
            v = vb * tile + np.arange(tile)[None, :]
            slots += tile * tile
            keep = (u < m) & (v < s) & (u >= v)
            seen.update(zip(np.broadcast_to(u, keep.shape)[keep].tolist(),
                            np.broadcast_to(v, keep.shape)[keep].tolist()))
    assert len(seen) == hf_ops.unique_integrals(natoms, nl)
    assert slots == hf_ops.computed_integrals(natoms, l0, nl)


@pytest.mark.parametrize("natoms,l0,nl", [(128, 0, None), (64, 0, None),
                                          (128, 0, 32), (128, 32, 32),
                                          (128, 64, 32), (128, 96, 32),
                                          (216, 0, 213), (216, 213, 3)])
def test_computed_integrals_stay_near_the_distinct_count(natoms, l0, nl):
    distinct = hf_ops.unique_integrals(natoms, nl)
    assert distinct <= hf_ops.computed_integrals(natoms, l0, nl) \
        <= 1.10 * distinct


@pytest.mark.parametrize("natoms,plan", [
    (8, [(0, 8)]), (128, [(0, 128)]), (215, [(0, 215)]),
    (216, [(0, 213), (213, 3)]),
    (400, [(33 * k, 33) for k in range(12)] + [(396, 4)])])
def test_slab_plan_covers_the_build_within_the_scratch_limit(natoms, plan):
    """A full build past ``MAX_SCRATCH_BYTES`` runs as slabs of the widest
    nl that fits, in order; each slab fits and together they cover
    [0, N) once."""
    got = K.slab_plan(natoms)
    assert got == plan
    assert all(K.scratch_bytes(natoms, nl) <= K.MAX_SCRATCH_BYTES
               for _, nl in got)
    assert [l for l0, nl in got for l in range(l0, l0 + nl)] == \
        list(range(natoms))


def test_slab_plan_refuses_what_no_slab_fits():
    # 4 N^3 bytes for a slab of one l: above the limit past N = 1290
    assert K.slab_plan(1290)[0] == (0, 1)
    with pytest.raises(ValueError, match=f"{4 * 1291 ** 3} bytes"):
        K.slab_plan(1291)


def test_scratch_bytes_and_its_limit():
    assert K.scratch_bytes(128) == 4 * 128 ** 4 == 1_073_741_824
    assert K.scratch_bytes(128, 32) == 4 * 128 ** 3 * 32
    assert K.scratch_bytes(64) == 67_108_864
    # the full build fits up to N = 215
    assert K.scratch_bytes(215) <= K.MAX_SCRATCH_BYTES < K.scratch_bytes(216)


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
