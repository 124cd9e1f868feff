"""miniBUDE ``fasten`` in the port vs the JAX package on the same numpy
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

from repro.core.portable import get_kernel as jax_get_kernel
from repro.kernels.minibude import kernel as jax_kernel
from repro.kernels.minibude import ops as jax_ops
from repro.kernels.minibude import ref as jax_ref
import repro_torch.kernels.minibude.ops  # noqa: F401
from repro_torch.core import conformance
from repro_torch.core.portable import get_kernel
from repro_torch.kernels.minibude import kernel as K
from repro_torch.kernels.minibude import ops
from repro_torch.kernels.minibude import ref

RTOL, ATOL = conformance.ORACLE_TOL["minibude.fasten"]


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


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_case_matches_reference(jax_backend):
    deck, _ = conformance.CASES["minibude.fasten"]()
    want = jax_get_kernel("minibude.fasten")(*map(jnp.asarray, deck),
                                             backend=jax_backend)
    _close(get_kernel("minibude.fasten")(*conformance.as_tensors(deck, "cpu")),
           want)


@pytest.mark.parametrize("natpro,natlig,nposes", [
    (64, 8, 256), (96, 16, 512), (32, 4, 128)])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_shapes_match_reference(natpro, natlig, nposes, jax_backend):
    jax_deck = jax_ops.make_deck(natpro=natpro, natlig=natlig, nposes=nposes,
                                 seed=3)
    want = jax_get_kernel("minibude.fasten")(*jax_deck, backend=jax_backend)
    deck = ops.make_deck(natpro, natlig, nposes, seed=3, device="cpu")
    _close(get_kernel("minibude.fasten")(*deck), want)
    _close(K.fasten(*deck), want)


def test_ragged_pose_count_matches_reference():
    """Any P runs (the CUDA kernel masks its tail); the reference's oracle
    takes any P too."""
    deck = ops.make_deck(40, 6, 100, seed=7, device="cpu")
    want = jax_ops.fasten_xla(*(jnp.asarray(t.numpy()) for t in deck))
    before = K.fasten.launches
    got = K.fasten(*deck)
    assert K.fasten.launches == before  # CPU: plain version, no launch
    assert got.shape == (100,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("kw", [
    dict(natpro=16, natlig=4, nposes=128, seed=5),
    dict(natpro=938, natlig=26, nposes=256, seed=0),
    dict(natpro=7, natlig=3, nposes=9, ntypes=2, seed=11)])
def test_deck_is_the_reference_deck(kw):
    """Same draws in the same order: poses first, then the protein's and
    the ligand's positions and params."""
    for ours, theirs in zip(ops.make_deck(**kw, device="cpu"),
                            jax_ops.make_deck(**kw)):
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    for ours, theirs in zip(ref.deck_arrays(**kw), jax_ops.make_deck(**kw)):
        np.testing.assert_array_equal(ours, np.asarray(theirs))


def test_constants_and_pose_transforms_match_reference():
    for name in ("ZERO", "QUARTER", "HALF", "ONE", "TWO", "FOUR", "CNSTNT",
                 "HARDNESS", "NPNPDIST", "NPPDIST", "HBTYPE_F", "HBTYPE_E",
                 "FLOAT_MAX"):
        assert getattr(ref, name) == getattr(jax_ref, name), name
    poses = ref.deck_arrays(8, 2, 64, seed=2)[4]
    got = ref.pose_transforms(torch.from_numpy(poses))
    want = jax_ref.pose_transforms(jnp.asarray(poses))
    assert got.shape == (64, 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_energy_permutes_with_the_poses():
    """No coupling across poses: permuting poses permutes energies."""
    pp, ppar, lp, lpar, poses = ops.make_deck(32, 4, 256, seed=1,
                                              device="cpu")
    e = K.fasten(pp, ppar, lp, lpar, poses)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(256))
    torch.testing.assert_close(K.fasten(pp, ppar, lp, lpar, poses[:, perm]),
                               e[perm], rtol=1e-5, atol=1e-5)


def test_flops_model_matches_reference():
    model = get_kernel("minibude.fasten").flops_model
    for natpro, natlig, nposes in ((938, 26, 65536), (64, 8, 256)):
        shapes = ((natpro, 4), (natpro, 4), (natlig, 4), (natlig, 4),
                  (6, nposes))
        deck = [torch.zeros(s) for s in shapes]
        want = jax_get_kernel("minibude.fasten").flops_model(
            *(jnp.zeros(s) for s in shapes))
        assert model(*deck) == want
        # tunables riding along never change the count
        assert model(*deck, ppwi=4, block=64) == want
    assert ops.FLOPS_PPWI == jax_kernel.POSE_TILE


def test_registered_backends_and_tunables():
    k = get_kernel("minibude.fasten")
    assert set(k.backends) == {"torch", "cuda"}
    assert (k.oracle, k.native) == ("torch", "cuda")
    assert k.backend("cuda").fn is K.fasten
    space = k.tunable_space("cuda")
    assert space.params == {"ppwi": K.PPWI_GRID, "block": K.BLOCK_GRID}
    assert (K.PPWI, K.BLOCK) in {(p["ppwi"], p["block"])
                                 for p in space.points()}
    assert k.roofline_contract("cuda") == {"bound": "compute"}
    # the default keeps at least 8 warps on each of 132 SMs at bm1
    assert 65536 // K.PPWI // 32 >= 8 * 132


def test_wrapper_rejects_what_it_cannot_run():
    deck = ops.make_deck(8, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.fasten(*(t.to("meta") for t in deck))
    with pytest.raises(ValueError, match=r"\(6, P\)"):
        K.fasten(*deck[:4], deck[4][:5])
    with pytest.raises(ValueError, match=r"\(natpro, 4\)"):
        K.fasten(deck[0][:, :3], *deck[1:])
    with pytest.raises(ValueError, match="one device"):
        K.fasten(*deck[:4], deck[4].to("meta"))
    assert K.fasten.launches == 0
