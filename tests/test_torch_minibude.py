"""miniBUDE ``fasten`` in the port vs the JAX package on the same numpy
inputs.

On the CPU the port's ``torch`` backend, and the CUDA wrapper's plain path,
are held against the reference's ``xla`` oracle and its Pallas kernel in
interpret mode, at the reference's ORACLE_TOL; so is ``ref.fasten_sliced``,
the CPU mirror of the CUDA kernel's design, and ``ref.pair_table``'s folds
against the reference's unfolded formulas, bit for bit.  The CUDA kernel
itself runs only on the GPU (``tests/test_torch_on_card.py``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.portable import get_kernel as jax_get_kernel
from repro.kernels.minibude import kernel as jax_kernel
from repro.kernels.minibude import ops as jax_ops
from repro.kernels.minibude import ref as jax_ref
import repro_torch.kernels.minibude.ops  # noqa: F401
from repro_torch import _sass
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
        assert model(*deck, ppwi=4, split=2) == want
    assert ops.FLOPS_PPWI == jax_kernel.POSE_TILE


def test_registered_backends_and_tunables():
    k = get_kernel("minibude.fasten")
    # the sharded backends of repro_torch.distributed ride along
    assert set(k.backends) == {"torch", "cuda", "torch_shard", "shard_cuda"}
    assert (k.oracle, k.native) == ("torch", "cuda")
    assert k.backend("cuda").fn is K.fasten
    space = k.tunable_space("cuda")
    assert space.params == {"ppwi": K.PPWI_GRID, "split": K.SPLIT_GRID}
    assert (K.PPWI, K.SPLIT) in {(p["ppwi"], p["split"])
                                 for p in space.points()}
    assert k.roofline_contract("cuda") == {"bound": "compute"}
    # the default keeps at least 8 warps on each of 132 SMs at bm1: blocks
    # of 32 * ppwi poses, `split` warps each
    assert K.SPLIT * 65536 / K.PPWI / 32 / 132 >= 8


_N6, _N4 = (2 ** 31 - 1) // 6, (2 ** 31 - 1) // 4
_PAIRS = K.MAX_TABLE_BYTES // 32


@pytest.mark.parametrize("at,past,why", [
    ((938, 26, _N6), (938, 26, _N6 + 1), "32-bit"),
    ((_N4, 0, 1), (_N4 + 1, 0, 1), "32-bit"),
    ((0, _N4, 1), (0, _N4 + 1, 1), "32-bit"),
    ((_PAIRS, 1, 1), (_PAIRS + 1, 1, 1), "bytes"),
])
def test_check_deck_refuses_at_the_boundary(at, past, why):
    """The kernels index with int up to 6 * nposes, 4 * natpro and
    4 * natlig, and the pair table takes 32 bytes a pair: a deck at each
    limit runs, one past it is refused."""
    K.check_deck(*at)
    with pytest.raises(ValueError, match=why):
        K.check_deck(*past)


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


# (natpro, natlig, nposes, seed, split, ppwi): natpro no multiple of split,
# split above natpro, a ragged pose count, and a deck of bm1's width
SLICED = [(97, 16, 256, 3, 8, 1), (97, 16, 256, 3, 8, 8),
          (3, 4, 256, 3, 8, 2), (40, 6, 100, 7, 4, 8),
          (938, 26, 256, 0, 8, 8)]
#: decks whose interactions fall in every class of the energy model
BRANCH_DECKS = [(97, 16, 256, 3), (938, 26, 256, 0)]


def _reference(deck, backend):
    """The reference's energies; its Pallas kernel takes whole 128-pose
    tiles, so a ragged deck runs with zero poses after its own."""
    poses = deck[4].numpy()
    nposes = poses.shape[1]
    if backend == "pallas_interpret":
        poses = np.pad(poses, ((0, 0), (0, -nposes % jax_kernel.POSE_TILE)))
    args = [jnp.asarray(t.numpy()) for t in deck[:4]] + [jnp.asarray(poses)]
    return np.asarray(jax_get_kernel("minibude.fasten")(
        *args, backend=backend))[:nposes]


@pytest.mark.parametrize("natpro,natlig,nposes,seed,split,ppwi", SLICED)
@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
def test_sliced_order_matches_reference(natpro, natlig, nposes, seed, split,
                                        ppwi, jax_backend):
    """The kernel's order and folds (per slice, then over ligand atoms, then
    the slices in order, from the pair table) against the reference."""
    deck = ops.make_deck(natpro, natlig, nposes, seed=seed, device="cpu")
    got = ref.fasten_sliced(*deck, ppwi=ppwi, split=split)
    assert got.shape == (nposes,) and got.dtype == torch.float32
    _close(got, _reference(deck, jax_backend))


def _unfolded(ppar, lpar):
    """The reference's per-pair formulas of ``_fasten_body`` in numpy
    float32, before any fold: (natlig, natpro) arrays."""
    f32 = np.float32
    p = {k: ppar[None, :, i] for i, k in enumerate("hb rad hphb elsc".split())}
    q = {k: lpar[:, None, i] for i, k in enumerate("hb rad hphb elsc".split())}
    radij = p["rad"] + q["rad"]
    both_f = (p["hb"] == f32(ref.HBTYPE_F)) & (q["hb"] == f32(ref.HBTYPE_F))
    p_ltz, p_gtz = p["hphb"] < 0, p["hphb"] > 0
    l_ltz, l_gtz = q["hphb"] < 0, q["hphb"] > 0
    distdslv = np.where(p_ltz, np.where(l_ltz, f32(ref.NPNPDIST),
                                        f32(ref.NPPDIST)),
                        np.where(l_ltz, f32(ref.NPPDIST),
                                 f32(-ref.FLOAT_MAX)))
    dslv_init = (p["hphb"] * np.where(p_ltz & l_gtz, f32(-1), f32(1))
                 + q["hphb"] * np.where(p_gtz & l_ltz, f32(-1), f32(1)))
    return {
        "radij": radij, "r_radij": f32(1) / radij,
        "elcdst": np.where(both_f, f32(4), f32(2)),
        "elcdst1": np.where(both_f, f32(0.25), f32(0.5)),
        "distdslv": distdslv, "r_distdslv": f32(1) / distdslv,
        "chrg_init": q["elsc"] * p["elsc"],
        "type_e": (p["hb"] == f32(ref.HBTYPE_E))
        | (q["hb"] == f32(ref.HBTYPE_E)),
        "dslv_init": dslv_init, "phphb_nz": p["hphb"] != 0}


def _distances():
    """float32 distbb values across every cut-off of the model (0, 1, 2, 4,
    5.5), with the neighbours of each cut-off on both sides."""
    f32 = np.float32
    grid = list(np.linspace(-6, 8, 57, dtype=f32))
    for cut in (0, 1, 2, 4, 5.5):
        up = down = f32(cut)
        for _ in range(3):
            up, down = np.nextafter(up, f32(9)), np.nextafter(down, f32(-9))
            grid += [up, down]
        grid.append(f32(cut))
    return np.array(grid, dtype=f32)


@pytest.mark.parametrize("natpro,natlig,seed", [(97, 16, 3), (938, 26, 0)])
def test_pair_table_folds_are_exact(natpro, natlig, seed):
    """``ref.pair_table`` against the reference's unfolded formulas, bit for
    bit: the plain columns, and each fold and clamp over distances that
    cross every cut-off (zone 1, the charge window and cut, the
    desolvation window)."""
    _, ppar, _, lpar, _ = ref.deck_arrays(natpro, natlig, 1, seed=seed)
    f32 = np.float32
    table = ref.pair_table(torch.from_numpy(ppar),
                           torch.from_numpy(lpar)).numpy()
    assert table.shape == (natlig, natpro, 8) and table.dtype == np.float32
    col = {name: table[..., i] for i, name in enumerate(ref.PAIR_COLUMNS)}
    u = _unfolded(ppar, lpar)
    for name in ("radij", "r_radij", "elcdst", "elcdst1", "distdslv",
                 "r_distdslv"):
        np.testing.assert_array_equal(col[name], u[name], err_msg=name)
    chrg_e = np.where(u["type_e"], -np.abs(u["chrg_init"]), u["chrg_init"])
    np.testing.assert_array_equal(col["chrg"], chrg_e * f32(ref.CNSTNT))
    for distbb in _distances():
        zone1 = distbb < 0
        # the charge: -|chrg_init * f| (reference) = (-|chrg_init|) * f
        f = (np.where(zone1, f32(1), f32(1) - distbb * u["elcdst1"])
             * np.where(distbb < u["elcdst"], f32(1), f32(0)))
        want = u["chrg_init"] * f
        want = np.where(u["type_e"], -np.abs(want), want)
        np.testing.assert_array_equal(chrg_e * f, want)
        # ... and f is the clamp the kernel takes
        np.testing.assert_array_equal(
            np.clip(f32(1) - distbb * u["elcdst1"], 0, 1), f)
        # the desolvation: condition and phphb_nz folded into the factor,
        # the window as the clamp of the fused 1 - distbb * r_distdslv
        coeff = (1 - np.float64(distbb) * u["r_distdslv"]).astype(f32)
        want = (u["dslv_init"]
                * np.where((distbb < u["distdslv"]) & u["phphb_nz"], f32(1),
                           f32(0)) * np.where(zone1, f32(1), coeff))
        np.testing.assert_array_equal(col["dslv"] * np.clip(coeff, 0, 1),
                                      want)
        # the steric term: the same zone, and the value within rounding
        hard = -f32(2 * ref.HARDNESS) * col["r_radij"]
        steric = hard * np.minimum(distbb, f32(0))
        distij = distbb + u["radij"]
        ref_steric = ((f32(1) - distij * u["r_radij"])
                      * np.where(zone1, f32(2 * ref.HARDNESS), f32(0)))
        assert ((steric > 0) == zone1).all()
        np.testing.assert_allclose(steric, ref_steric, rtol=0, atol=1e-4)


def test_desolvation_clamp_bounds():
    """The desolvation clamp's premise: for each radius, its float32
    reciprocal r has radius * r >= 1 and pred(radius) * r < 1 (products in
    float64 are exact), so 1 - distbb * r, fused, is > 0 exactly below the
    radius and <= 0 from it on."""
    f32 = np.float32
    for radius in (f32(ref.NPNPDIST), f32(ref.NPPDIST)):
        r = f32(1) / radius
        below = np.nextafter(radius, f32(0))
        assert np.float64(radius) * np.float64(r) >= 1
        assert np.float64(below) * np.float64(r) < 1


def _classes(natpro, natlig, nposes, seed):
    """How many interactions of the deck fall in each class of the energy
    model (numpy, from the reference's formulas)."""
    ppos, ppar, lpos, lpar, poses = ref.deck_arrays(natpro, natlig, nposes,
                                                    seed=seed)
    m = ref.pose_transforms(torch.from_numpy(poses)).numpy()
    lp = np.einsum("pij,lj->lpi", m[:, :, :3], lpos[:, :3]) + m[None, :, :, 3]
    d = lp[:, None] - ppos[None, :, None, :3]              # (L, N, P, 3)
    u = {k: v[..., None] for k, v in _unfolded(ppar, lpar).items()}
    distbb = np.sqrt((d * d).sum(-1)) - u["radij"]
    ph = ppar[None, :, None, 2]
    lh = lpar[:, None, None, 2]
    window = (distbb >= 0) & (distbb < u["elcdst"])
    return {
        "zone 1": distbb < 0,
        "charge window": window,
        "charge cut": distbb >= u["elcdst"],
        "type E, chrg_init < 0": u["type_e"] & (u["chrg_init"] < 0)
        & (distbb < u["elcdst"]),
        "both F in its wider window": (u["elcdst"] == 4) & window
        & (distbb >= 2),
        "protein hphb 0": (ph == 0) & (lh < 0) & (distbb < 1),
        "hphb - -": (ph < 0) & (lh < 0) & (distbb < 5.5),
        "hphb - +": (ph < 0) & (lh > 0) & (distbb < 1),
        "hphb + -": (ph > 0) & (lh < 0) & (distbb < 1),
        "hphb + +": (ph > 0) & (lh > 0) & (distbb < 1),
        "desolvation window": (distbb >= 0) & (distbb < u["distdslv"])
        & (ph != 0),
    }


@pytest.mark.parametrize("natpro,natlig,nposes,seed", BRANCH_DECKS)
def test_test_decks_reach_every_branch(natpro, natlig, nposes, seed):
    """The decks of the tests above put interactions in every class the
    folds touch, so the folds are exercised and not assumed."""
    assert (natpro, natlig, nposes, seed) in {d[:4] for d in SLICED}
    counts = {k: int(v.sum()) for k, v in
              _classes(natpro, natlig, nposes, seed).items()}
    assert all(counts.values()), counts


_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_113fasten_kernelILi2EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;       /* 0x0 */
                                                                /* 0x0 */
.L_x_1:
        /*0010*/                   MUFU.RSQ R3, R2 ;            /* 0x0 */
        /*0020*/                   FFMA R4, R3, R3, R2 ;        /* 0x0 */
        /*0030*/              @!P0 BRA `(.L_x_2) ;              /* 0x0 */
        /*0040*/                   MUFU.RSQ R5, R2 ;            /* 0x0 */
.L_x_2:
        /*0050*/                   FADD R6, R4, R5 ;            /* 0x0 */
        /*0060*/               @P1 BRA `(.L_x_1) ;              /* 0x0 */
        /*0070*/                   EXIT ;                       /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_113fasten_kernelILi1EEEvPKf
        /*0000*/                   MUFU.RSQ R3, R2 ;            /* 0x0 */
        /*0010*/                   FADD R1, R1, R3 ;            /* 0x0 */
        /*0020*/                   MUFU.RSQ R3, R2 ;            /* 0x0 */
        /*0030*/                   FADD R1, R1, R3 ;            /* 0x0 */
        /*0040*/               @P0 BRA 0x20 ;                   /* 0x0 */
        /*0050*/                   @P1 BRA 0x0 ;                /* 0x0 */
        /*0060*/                   EXIT ;                       /* 0x0 */
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;                       /* 0x0 */
"""


def test_sass_counter_reads_innermost_loops(monkeypatch, tmp_path):
    """The SASS counter behind PERF.md's instructions per interaction, on a
    listing in both of cuobjdump's branch-target spellings: labels, and
    addresses (where the inner loop nests in an outer one)."""
    monkeypatch.setattr(_sass, "disassemble", lambda lib: _SASS)
    report = _sass.per_marker(tmp_path / "lib.so", "fasten_kernel")
    labelled = report["_ZN12_GLOBAL__N_113fasten_kernelILi2EEEvPKf"]
    assert labelled == [{"start": 0x10, "end": 0x60, "instructions": 6,
                         "markers": 2, "per_marker": 3.0}]
    nested = report["_ZN12_GLOBAL__N_113fasten_kernelILi1EEEvPKf"]
    assert nested == [{"start": 0x20, "end": 0x40, "instructions": 3,
                       "markers": 1, "per_marker": 3.0}]
    assert "_Z5otherv" not in report
    json.dumps(report)


class _FlopCount(TorchDispatchMode):
    """Counts the floating-point operations of the tensor code run under
    it: one for each output element of an elementwise arithmetic op (each
    special function one), n - 1 for each sum of n, 2k - 1 for each output
    element of a batched product over k; sign changes, selects, clamps,
    comparisons and data movement none.  Fails on any other op, so that
    nothing goes uncounted."""

    aten = torch.ops.aten
    ELEMENTWISE = {aten.add.Tensor, aten.sub.Tensor, aten.rsub.Scalar,
                   aten.mul.Tensor, aten.reciprocal.default,
                   aten.sqrt.default, aten.sin.default, aten.cos.default}
    FREE = {aten.neg.default, aten.abs.default, aten.where.self,
            aten.clamp.default, aten.eq.Scalar, aten.ne.Scalar,
            aten.lt.Scalar, aten.gt.Scalar, aten.bitwise_and.Tensor,
            aten.bitwise_or.Tensor, aten.new_full.default,
            aten.zeros.default, aten.copy_.default, aten.stack.default,
            aten.unbind.int, aten.select.int, aten.slice.Tensor,
            aten.unsqueeze.default, aten.view.default,
            aten.permute.default, aten.expand.default,
            aten._unsafe_view.default, aten.clone.default}

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ELEMENTWISE:
            self.flops += out.numel()
        elif func is self.aten.sum.dim_IntList:
            self.flops += args[0].numel() - out.numel()
        elif func is self.aten.bmm.default:
            self.flops += out.numel() * (2 * args[0].shape[-1] - 1)
        else:
            assert func in self.FREE, f"uncounted op {func}"
        return out


@pytest.mark.parametrize("natpro,natlig,nposes", [(5, 2, 32), (7, 3, 64),
                                                  (16, 4, 96)])
def test_least_flops_counts_the_hoisted_form(natpro, natlig, nposes):
    """``ops.least_flops`` is what ``ref.fasten_sliced`` runs at one slice
    on whole pose groups, counted op by op: the kernel's form, with the
    pair constants once a pair."""
    deck = ops.make_deck(natpro, natlig, nposes, seed=1, device="cpu")
    with _FlopCount() as count:
        ref.fasten_sliced(*deck, ppwi=1, split=1)
    assert count.flops == ops.least_flops(natpro, natlig, nposes)


def test_least_flops_is_two_thirds_of_eq3():
    """At bm1 the bound's count is 20 flops an interaction plus the terms
    that amortise over protein atoms: about 2/3 of Eq. 3's 30."""
    shapes = ((938, 4), (938, 4), (26, 4), (26, 4), (6, 65536))
    deck = [torch.zeros(s) for s in shapes]
    eq3 = get_kernel("minibude.fasten").flops_model(*deck)
    least = ops.least_flops(938, 26, 65536)
    assert least / (938 * 26 * 65536) == pytest.approx(
        ops.INTERACTION_FLOPS, rel=2e-3)
    assert 0.66 < least / eq3 < 0.67
