"""The port's domain decomposition (``repro_torch.distributed.domain``, the
``torch_shard`` backends) against the reference's
(``repro.distributed.domain``, the ``xla_shard`` backends).

The shard-count policy (``resolve_num_shards``, ``resolve_shard_grid``,
``balanced_pencil_grid``, the constraint twins) is held equal to the
reference's with an injected device count, results and error messages
alike; the registry wiring (tunables, comm contracts) equal to the
reference's rows.  ``torch_shard`` is bitwise equal to the port's ``torch``
for the stencil (slab, pencil, overlap, one plane per shard), the four
elementwise streams and miniBUDE at 2, 4 and 8 shards, ``dot`` and
Hartree-Fock within ``ORACLE_TOL``; and within the reference's
``ORACLE_TOL`` of its ``xla`` oracle on the same numpy inputs.  The mesh
here is 8 shard places on the CPU, as on one card.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registers the reference's xla_shard)
from repro.core import conformance as jax_conformance
from repro.core.portable import get_kernel as jax_get_kernel
from repro.distributed import domain as jax_domain
import repro_torch.kernels  # noqa: F401
from repro_torch.core import conformance, tuning
from repro_torch.core.portable import PortableKernel, get_kernel
from repro_torch.distributed import collectives, domain
from repro_torch.kernels.minibude import ops as mb_ops

SHARDED_KERNELS = ["stencil7", "babelstream.copy", "babelstream.mul",
                   "babelstream.add", "babelstream.triad", "babelstream.dot",
                   "minibude.fasten", "hartree_fock.twoel"]
ELEMENTWISE = ("copy", "mul", "add", "triad")
REPO_ROOT = Path(__file__).resolve().parents[1]
DECOMPS = ([{"num_shards": s} for s in (2, 4, 8)]
           + [{"decomp": "pencil", "shard_grid": g}
              for g in ((2, 2), (4, 2), (2, 4))])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=240, env=env, cwd=REPO_ROOT)


def _outcome(fn, *args, **kwargs):
    """The result, or the ValueError's message."""
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        return f"ValueError: {e}"


# ---- registry wiring ---------------------------------------------------
@pytest.mark.parametrize("name", SHARDED_KERNELS)
def test_torch_shard_registered_with_shard_tunables(name):
    k = get_kernel(name)
    ref = jax_get_kernel(name)
    assert domain.SHARD_BACKEND == "torch_shard"
    space = k.tunable_space("torch_shard")
    assert space.params == ref.tunable_space("xla_shard").params
    if name == "stencil7":
        assert tuple(space.params["decomp"]) == domain.STENCIL_DECOMPS
        assert tuple(space.params["shard_grid"]) == \
            domain.STENCIL_SHARD_GRIDS
        assert tuple(space.params["overlap"]) == domain.OVERLAP_GRID
    else:
        assert tuple(space.params["num_shards"]) == domain.SHARD_GRID
    assert k.roofline_contract("torch_shard").get("bound") in (
        "memory", "compute")


@pytest.mark.parametrize("name", SHARDED_KERNELS)
def test_comm_contracts_equal_the_reference(name):
    mine = get_kernel(name).comm_contract("torch_shard")
    theirs = jax_get_kernel(name).comm_contract("xla_shard")
    if name == "stencil7":
        for shape in ((16, 16, 32), (8, 64, 128), (4, 6, 8), (3, 8, 8)):
            assert mine(torch.zeros(shape)) == theirs(jnp.zeros(shape))
    else:
        assert mine == theirs
    assert (domain.NO_COLLECTIVES, domain.ONE_PSUM) == (
        jax_domain.NO_COLLECTIVES, jax_domain.ONE_PSUM)
    assert tuple(collectives.COLLECTIVES) == tuple(domain.NO_COLLECTIVES)


@pytest.mark.parametrize("name", SHARDED_KERNELS)
def test_torch_shard_runs_on_one_device(name):
    """The mesh has 8 places on one device, so torch_shard is available
    here, where the reference's xla_shard needs two devices; the default
    backend is still the oracle for CPU tensors (and the hand-written one
    for CUDA tensors)."""
    k = get_kernel(name)
    args, _ = conformance.case_tensors(name)
    assert k.backend("torch_shard").is_available()
    assert "torch_shard" in k.available_backends()
    assert k.default_backend(*args) == "torch"
    assert k.native in ("cuda", "triton")


# ---- shard-count policy: the reference's, result for result --------------
def test_resolve_num_shards_equals_the_reference():
    for extent in range(1, 25):
        for num_shards in (None, 0, 1, 2, 3, 4, 5, 8, 9, 16):
            for dc in (1, 2, 3, 4, 6, 8):
                assert _outcome(domain.resolve_num_shards, extent,
                                num_shards, device_count=dc) == \
                    _outcome(jax_domain.resolve_num_shards, extent,
                             num_shards, device_count=dc), \
                    (extent, num_shards, dc)
                assert domain._shard_ok(num_shards or 0, extent, dc) == \
                    jax_domain._shard_ok(num_shards or 0, extent, dc)


def test_resolve_num_shards_validates_and_picks_largest():
    assert domain.resolve_num_shards(16, 4, device_count=8) == 4
    assert domain.resolve_num_shards(16, None, device_count=8) == 8
    assert domain.resolve_num_shards(12, None, device_count=8) == 6
    with pytest.raises(ValueError, match="does not divide"):
        domain.resolve_num_shards(15, 2, device_count=8)
    with pytest.raises(ValueError, match=">= 2"):
        domain.resolve_num_shards(16, 1, device_count=8)
    with pytest.raises(ValueError, match="exceeds device_count"):
        domain.resolve_num_shards(16, 16, device_count=8)
    with pytest.raises(ValueError, match="no valid shard count"):
        domain.resolve_num_shards(7, None, device_count=4)
    # no injection: the live host's mesh, 8 places on one device
    assert domain.resolve_num_shards(64) == domain.mesh_device_count()


def test_resolve_shard_grid_equals_the_reference():
    for nz in (2, 4, 8, 9, 16):
        for ny in (2, 3, 8, 12, 16):
            for dc in (2, 4, 6, 8, 16):
                for kw in ({"decomp": "slab"}, {"decomp": "pencil"},
                           {"decomp": "slab", "num_shards": 4},
                           {"decomp": "pencil", "num_shards": 4},
                           {"decomp": "pencil", "shard_grid": (2, 4)},
                           {"decomp": "pencil", "shard_grid": (4, 1)},
                           {"decomp": "slab", "shard_grid": (2, 2)},
                           {"decomp": "pencil", "shard_grid": (2, 2),
                            "num_shards": 8},
                           {"decomp": "block"}):
                    assert _outcome(domain.resolve_shard_grid, nz, ny,
                                    device_count=dc, **kw) == \
                        _outcome(jax_domain.resolve_shard_grid, nz, ny,
                                 device_count=dc, **kw), (nz, ny, dc, kw)
                    for grid in domain.STENCIL_SHARD_GRIDS:
                        for decomp in domain.STENCIL_DECOMPS:
                            p = {"decomp": decomp, "shard_grid": grid}
                            assert domain._stencil_point_ok(p, nz, ny, dc) \
                                == jax_domain._stencil_point_ok(p, nz, ny,
                                                                dc)


def test_balanced_pencil_grid_equals_the_reference():
    for total in range(2, 97):
        for nz in (None, 2, 4, 6, 9, 16):
            for ny in (None, 2, 3, 9, 16):
                assert domain.balanced_pencil_grid(total, nz, ny) == \
                    jax_domain.balanced_pencil_grid(total, nz, ny)


@pytest.mark.parametrize("name", SHARDED_KERNELS)
@pytest.mark.parametrize("dc", [2, 4, 8])
def test_tunable_spaces_admit_the_reference_points(name, dc):
    args, _ = conformance.case_tensors(name)
    mine = get_kernel(name).tunable_space("torch_shard").valid_points(
        *args, device_count=dc)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    theirs = jax_get_kernel(name).tunable_space("xla_shard").valid_points(
        *jargs, device_count=dc)
    assert mine == theirs and mine


def test_bad_shard_counts_raise_as_the_reference_does():
    """Through the registry: the reference's own ValueError, message for
    message, for a count that does not divide, is below 2 or above the
    mesh's 8 places."""
    u = _f32(12, 8, 8)
    a = _f32(12)
    for bad in (5, 1, 16):
        want = _outcome(jax_domain.resolve_num_shards, 12, bad,
                        device_count=8)
        assert want.startswith("ValueError")
        for call in (
                lambda: get_kernel("stencil7")(u, backend="torch_shard",
                                               num_shards=bad),
                lambda: get_kernel("babelstream.copy")(
                    a, backend="torch_shard", num_shards=bad)):
            assert _outcome(call) == want
    with pytest.raises(ValueError, match="pencil decomposition needs"):
        get_kernel("stencil7")(u, backend="torch_shard", decomp="pencil",
                               shard_grid=(4, 1))


# ---- the mesh --------------------------------------------------------------
def test_the_mesh_places_shards():
    cpu = torch.device("cpu")
    assert domain.mesh_device_count("cpu") == domain.PLACES_ON_ONE_DEVICE
    assert domain.shard_mesh(3, "cpu") == [cpu] * 3
    assert domain.shard_mesh2d(2, 4, "cpu") == [[cpu] * 4] * 2
    with pytest.raises(ValueError, match="exceeds the 8 shard place"):
        domain.shard_mesh(9, "cpu")
    with pytest.raises(ValueError, match="needs 9 devices"):
        domain.shard_mesh2d(3, 3, "cpu")
    # two or more cards: one place a card, shard i on card i % cards
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with domain.placement(cards):
        assert domain.mesh_devices("cuda") == cards
        assert domain.mesh_device_count("cuda") == 2
        assert domain.shard_mesh(2, "cuda") == cards
        assert domain.mesh_device_count("cpu") == 8
        with pytest.raises(ValueError, match="exceeds the 2 shard place"):
            domain.shard_mesh(4, "cuda")
    with domain.placement(cards[:1]):
        assert domain.shard_mesh(4, "cuda") == cards[:1] * 4
        assert domain.mesh_device_count("cuda") == 8


def test_importing_the_package_is_side_effect_free():
    code = ("import sys, repro_torch.distributed; "
            "assert 'repro_torch.distributed.domain' not in sys.modules; "
            "assert 'torch' not in sys.modules; print('ok')")
    out = _run("-c", code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---- torch_shard bitwise equal to torch ----------------------------------
@pytest.mark.parametrize("kw", DECOMPS, ids=lambda kw: str(
    kw.get("shard_grid", kw.get("num_shards"))))
@pytest.mark.parametrize("overlap", [False, True])
def test_stencil_is_bitwise(kw, overlap):
    k = get_kernel("stencil7")
    u = _f32(16, 16, 24, seed=3)
    coeffs = (1.0, 0.25, 1.0 / 9, -2.0 * (1 + 0.25 + 1.0 / 9))
    want = k(u, *coeffs, backend="torch")
    got = k(u, *coeffs, backend="torch_shard", overlap=overlap, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("overlap", [False, True])
def test_stencil_one_plane_per_shard_is_bitwise(overlap):
    """nz == num_shards: a shard's first and last plane coincide, so the
    boundary mask ANDs the two edge conditions."""
    k = get_kernel("stencil7")
    for s in (2, 4, 8):
        u = _f32(s, 8, 16, seed=s)
        assert torch.equal(k(u, backend="torch_shard", num_shards=s,
                             overlap=overlap), k(u, backend="torch"))
        # two planes a shard: the overlap variant's smallest interior
        u = _f32(2 * s, 8, 16, seed=s)
        assert torch.equal(k(u, backend="torch_shard", num_shards=s,
                             overlap=overlap), k(u, backend="torch"))


@pytest.mark.parametrize("op", ELEMENTWISE)
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_elementwise_streams_are_bitwise(op, shards):
    k = get_kernel(f"babelstream.{op}")
    args = (_f32(1 << 12, seed=1),) if op in ("copy", "mul") else \
        (_f32(1 << 12, seed=1), _f32(1 << 12, seed=2))
    assert torch.equal(k(*args, backend="torch_shard", num_shards=shards),
                       k(*args, backend="torch"))
    if op in ("mul", "triad"):
        assert torch.equal(
            k(*args, backend="torch_shard", num_shards=shards, scalar=2.5),
            k(*args, 2.5, backend="torch"))
        assert torch.equal(k(*args, 2.5, backend="torch_shard",
                             num_shards=shards), k(*args, 2.5,
                                                   backend="torch"))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_minibude_is_bitwise(shards):
    k = get_kernel("minibude.fasten")
    for natpro, natlig, nposes in ((16, 4, 128), (97, 7, 64)):
        deck = mb_ops.make_deck(natpro, natlig, nposes, seed=3,
                                device="cpu")
        assert torch.equal(k(*deck, backend="torch_shard",
                             num_shards=shards),
                           k(*deck, backend="torch"))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_dot_and_hartree_fock_within_oracle_tol(shards):
    a, b = _f32(1 << 12, seed=1), _f32(1 << 12, seed=2)
    k = get_kernel("babelstream.dot")
    got = k(a, b, backend="torch_shard", num_shards=shards)
    assert got.shape == () and got.dtype == torch.float32
    rtol, atol = conformance.ORACLE_TOL["babelstream.dot"]
    torch.testing.assert_close(got, k(a, b, backend="torch"), rtol=rtol,
                               atol=atol)
    (pos, dens), _ = conformance.case_tensors("hartree_fock.twoel")
    k = get_kernel("hartree_fock.twoel")
    rtol, atol = conformance.ORACLE_TOL["hartree_fock.twoel"]
    torch.testing.assert_close(
        k(pos, dens, backend="torch_shard", num_shards=shards),
        k(pos, dens, backend="torch"), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", SHARDED_KERNELS)
def test_torch_shard_matches_the_jax_oracle(name):
    """The conformance case's numpy arrays through ``torch_shard`` (default
    shard count: 8 places) and through the reference's ``xla`` oracle, at
    the reference's ORACLE_TOL."""
    arrays, kwargs = conformance.CASES[name]()
    got = get_kernel(name)(*conformance.as_tensors(arrays, "cpu"),
                           backend="torch_shard", **kwargs)
    want = jax_get_kernel(name)(*(jnp.asarray(a) for a in arrays),
                                backend="xla", **kwargs)
    rtol, atol = jax_conformance.ORACLE_TOL[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)
    if name == "stencil7":
        got = get_kernel(name)(*conformance.as_tensors(arrays, "cpu"),
                               backend="torch_shard", decomp="pencil",
                               overlap=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)


# ---- the stencil's phases -----------------------------------------------
def test_each_shard_owns_its_buffers():
    u = _f32(8, 12, 16, seed=6)
    shards = domain.distribute_stencil(u, 2, 2)
    ptrs = {u.untyped_storage().data_ptr()}
    for row in shards.bufs:
        for buf in row:
            assert buf.shape == (6, 8, 16) and buf.is_contiguous()
            ptrs.add(buf.untyped_storage().data_ptr())
    assert len(ptrs) == 5
    # the halo planes and columns start at zero, the block is the shard's
    b = shards.bufs[1][0]
    assert not b[0].any() and not b[-1].any() and not b[:, 0].any() \
        and not b[:, -1].any()
    assert torch.equal(b[1:-1, 1:-1], u[4:8, 0:6])


def test_the_resident_step_fills_the_halos_and_repeats():
    """The step on buffers already sharded: each halo plane holds the
    neighbour's edge plane (zero at the open ends), and a second step on
    the same buffers gives the same kept blocks."""
    k = get_kernel("stencil7")
    u = _f32(12, 8, 16, seed=7)
    shards = domain.distribute_stencil(u, 3, 1)

    def local(block):
        return k(block, backend="torch")
    first = domain.collect_stencil(shards, domain.stencil_step(shards, local))
    bufs = [row[0] for row in shards.bufs]
    assert torch.equal(bufs[1][0], u[3]) and torch.equal(bufs[1][-1], u[8])
    assert not bufs[0][0].any() and not bufs[2][-1].any()
    again = domain.collect_stencil(shards, domain.stencil_step(shards, local))
    assert torch.equal(first, again)
    assert torch.equal(first, k(u, backend="torch"))


@pytest.mark.parametrize("grid", [(4, 1), (2, 2)])
def test_overlap_computes_each_interior_from_the_raw_block(grid):
    """The overlap variant's first per-shard compute is the halo-free
    interior of the contract's ``overlap_shape``, made before the halos
    land (the shard's halo planes still hold their old values)."""
    u = _f32(8, 8, 16, seed=8)
    sz, sy = grid
    variant = next(expect for v, expect in domain.stencil_comm_contract(u)
                   if v.get("overlap") and v["shard_grid"] == grid)
    shards = domain.distribute_stencil(u, sz, sy)
    calls = []

    def local(block):
        calls.append((tuple(block.shape), block))
        return get_kernel("stencil7")(block, backend="torch")
    with collectives.counting() as counts:
        domain.stencil_step(shards, local, overlap=True)
    assert calls[0][0] == variant["overlap_shape"]
    assert counts["ppermute"] == variant["ppermute"]
    # one interior and two (slab) or four (pencil) thin patches a shard
    assert len(calls) == sz * sy * (3 if sy == 1 else 5)


# ---- comm-contract audits -------------------------------------------------
@pytest.mark.parametrize("name", SHARDED_KERNELS)
def test_comm_contract_audit_holds(name):
    k = get_kernel(name)
    args, kwargs = conformance.case_tensors(name)
    audit = k.audit_comm_contract(*args, backend="torch_shard", **kwargs)
    expect = domain.ONE_PSUM if name in ("babelstream.dot",
                                         "hartree_fock.twoel") else None
    if expect is not None:
        assert audit == [({}, expect)]
    # the oracle declares nothing and is held to zero collectives
    assert k.audit_comm_contract(*args, backend="torch", **kwargs) == \
        [({}, domain.NO_COLLECTIVES)]


def test_comm_contract_audit_catches_a_mismatch():
    k = PortableKernel(name="tmp.comm")
    blocks = [torch.ones(2), torch.ones(2)]
    k.add_backend("sums", lambda x: collectives.psum(blocks)[0] + x)
    k.add_backend("quiet", lambda x: x)
    k.declare_comm_contract("sums", domain.NO_COLLECTIVES)
    with pytest.raises(AssertionError, match="comm contract says"):
        k.audit_comm_contract(torch.ones(2), backend="sums")
    k.declare_comm_contract("sums", domain.ONE_PSUM)
    assert k.audit_comm_contract(torch.ones(2), backend="sums") == \
        [({}, domain.ONE_PSUM)]
    # undeclared: held to zero collectives
    k.add_backend("undeclared", lambda x: collectives.shift(blocks)[0])
    with pytest.raises(AssertionError, match="issued"):
        k.audit_comm_contract(torch.ones(2), backend="undeclared")
    assert k.audit_comm_contract(torch.ones(2), backend="quiet")


def test_grid_contract_is_declared_metadata():
    k = PortableKernel(name="tmp.grid")
    assert k.grid_contract("x") == {}
    k.declare_grid_contract(("x", "y"), accumulator_outputs=[0])
    assert k.grid_contract("y") == {"accumulator_outputs": (0,)}


# ---- tuning ----------------------------------------------------------------
def test_tune_sweeps_the_decomposition_and_round_trips_the_cache(tmp_path):
    k = get_kernel("stencil7")
    u = _f32(4, 8, 16, seed=2)
    pts = k.tunable_space("torch_shard").valid_points(u)
    grids = sorted({(p["decomp"], p["shard_grid"]) for p in pts})
    assert grids == [("pencil", (2, 2)), ("pencil", (2, 4)),
                     ("pencil", (4, 2)), ("slab", (2, 1)), ("slab", (4, 1))]
    assert all({True, False} == {q["overlap"] for q in pts
                                 if (q["decomp"], q["shard_grid"]) == g}
               for g in grids)
    cache = tuning.TuningCache(path=tmp_path / "tuning.json")
    r = tuning.tune(k, u, backend="torch_shard", cache=cache, iters=1,
                    warmup=0)
    assert r.skipped is None and not r.cached and len(r.swept) == len(pts)
    r2 = tuning.tune(k, u, backend="torch_shard", cache=cache, iters=1,
                     warmup=0)
    assert r2.cached and r2.params == r.params
    assert isinstance(r2.params["shard_grid"], tuple)
    # the tuned point reaches the backend through the registry
    assert torch.equal(k(u, backend="torch_shard", tuned=True,
                         tuning_cache=cache), k(u, backend="torch"))


def test_selftest_runs_on_the_cpu():
    out = _run("-m", "repro_torch.distributed.selftest", "--device", "cpu",
               "--only", "smoke,halo,constraints")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selftest ok (3 batteries)" in out.stdout
    bad = _run("-m", "repro_torch.distributed.selftest", "--device", "cpu",
               "--only", "no_such_battery")
    assert bad.returncode == 2 and "unknown batteries" in bad.stderr
