"""The composites of the hand-written kernels (``repro_torch.distributed.
shard_kernels``: ``shard_cuda``, ``shard_triton``) against the reference's
``shard_pallas`` registration and the port's plain functions.

A CUDA kernel has no interpret mode, so the composites themselves run only
on the card (``tests/test_torch_on_card.py``).  Here: their registration
(the kernel-tile x shard spaces and comm contracts, the reference's
``shard_pallas`` rows in the port's names), their refusal without CUDA
(with the probe's reason), and their code path driven on CPU tensors, where
each kernel wrapper runs its plain version: bitwise equal to the port's
``torch`` where the reference's composite is bitwise, within
``ORACLE_TOL`` otherwise, and within the reference's ``ORACLE_TOL`` of its
``xla`` oracle on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (registers the reference's shard_pallas)
from repro.core import conformance as jax_conformance
from repro.core.portable import get_kernel as jax_get_kernel
from repro.distributed import shard_pallas as jax_shard_pallas
import repro_torch.kernels  # noqa: F401
from repro_torch.core import conformance, tuning
from repro_torch.core.portable import (Backend, BackendUnavailableError,
                                       PortableKernel, cuda_probe,
                                       get_kernel, triton_probe)
from repro_torch.distributed import collectives, domain, shard_kernels
from repro_torch.kernels.babelstream import kernel as stream_K
from repro_torch.kernels.hartree_fock import kernel as hf_K
from repro_torch.kernels.minibude import kernel as mb_K
from repro_torch.kernels.minibude import ops as mb_ops
from repro_torch.kernels.stencil7 import kernel as s7_K

COMPOSITE = {"stencil7": "shard_cuda", "babelstream.copy": "shard_triton",
             "babelstream.mul": "shard_triton",
             "babelstream.add": "shard_triton",
             "babelstream.triad": "shard_triton",
             "babelstream.dot": "shard_triton",
             "minibude.fasten": "shard_cuda",
             "hartree_fock.twoel": "shard_cuda"}
SPACE = {"stencil7": ("decomp", "shard_grid", "block_x", "block_y",
                      "zchunk"),
         "minibude.fasten": ("num_shards", "ppwi", "split"),
         "hartree_fock.twoel": ("num_shards", "team")}
WRAPPERS = (s7_K.laplacian, mb_K.fasten, hf_K.twoel_slab, stream_K.copy,
            stream_K.mul, stream_K.add, stream_K.triad, stream_K.dot)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.fixture
def no_launches():
    """The composite path on CPU tensors launches nothing: every wrapper
    runs its plain version and counts no launch."""
    before = [w.launches for w in WRAPPERS]
    yield
    assert [w.launches for w in WRAPPERS] == before


# ---- registration --------------------------------------------------------
@pytest.mark.parametrize("name", sorted(COMPOSITE))
def test_registered_with_composite_tile_x_shard_space(name):
    k = get_kernel(name)
    backend = COMPOSITE[name]
    space = k.tunable_space(backend)
    want = SPACE.get(name, ("num_shards", "block", "num_warps"))
    assert tuple(space.params) == want
    if "num_shards" in space.params:
        assert space.params["num_shards"] == domain.SHARD_GRID
    else:
        assert space.params["decomp"] == domain.STENCIL_DECOMPS
        assert space.params["shard_grid"] == domain.STENCIL_SHARD_GRIDS
    # each kernel's own tile axes, as its single-device backend declares
    for tile, values in k.tunable_space(k.native).params.items():
        assert space.params[tile] == values
    assert k.backend(backend).probe is (
        triton_probe if backend == "shard_triton" else cuda_probe)
    # the reference's composite rows: the same collectives
    mine = k.comm_contract(backend)
    theirs = jax_get_kernel(name).comm_contract("shard_pallas")
    if callable(mine):
        assert mine(torch.zeros(8, 8, 8)) == theirs(jnp.zeros((8, 8, 8)))
    else:
        assert mine == theirs
    assert k.native == {"shard_cuda": "cuda",
                        "shard_triton": "triton"}[backend]


def test_bitwise_twins_mirror_the_reference():
    """The reference's shard_pallas -> pallas_interpret rows become
    shard_cuda/shard_triton -> the kernel's own backend, and its bitwise
    xla_shard rows the torch_shard -> torch twins and tolerances; dot and
    Hartree-Fock are in neither (the psum reorders their sums)."""
    theirs = {name for (name, b) in jax_conformance.BITWISE_TWIN
              if b == "shard_pallas"}
    composite = {name: twin for (name, b), twin
                 in conformance.BITWISE_TWIN.items() if b != "torch_shard"}
    assert set(composite) == theirs
    assert all(twin == get_kernel(name).native and
               (name, COMPOSITE[name]) in conformance.BITWISE_TWIN
               for name, twin in composite.items())
    plain = {name for (name, b), twin in conformance.BITWISE_TWIN.items()
             if b == "torch_shard" and twin == "torch"}
    bitwise = {name for (name, b), tol in jax_conformance.BACKEND_TOL.items()
               if b == "xla_shard" and tol == "bitwise"}
    assert plain == theirs == bitwise
    assert {name for (name, b), tol in conformance.BACKEND_TOL.items()
            if b == "torch_shard" and tol == "bitwise"} == bitwise
    assert not {"babelstream.dot", "hartree_fock.twoel"} & theirs


@pytest.mark.parametrize("name", sorted(COMPOSITE))
def test_composite_skips_with_a_reason_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the composites run here "
                    "(tests/test_torch_on_card.py)")
    k = get_kernel(name)
    backend = COMPOSITE[name]
    reason = k.backend(backend).unavailable_reason()
    assert reason and "CUDA" in reason
    assert backend not in k.available_backends()
    args, kwargs = conformance.case_tensors(name)
    assert k.default_backend(*args) == "torch"
    with pytest.raises(BackendUnavailableError, match="not available"):
        k(*args, backend=backend, **kwargs)
    with pytest.raises(BackendUnavailableError):
        conformance.check_backend(name, backend)
    r = tuning.tune(k, *args, backend=backend, **kwargs)
    assert r.skipped == f"backend {backend!r} unavailable: {reason}"


def test_a_composite_on_cpu_tensors_is_never_tuned(monkeypatch):
    """Even where the toolchain is there, CPU tensors would make each
    wrapper run its plain version: tune() skips rather than time the
    oracle under the composite's name."""
    k = get_kernel("stencil7")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from repro_torch import _build
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/bin/true")
    r = tuning.tune(k, _f32(8, 8, 8), backend="shard_cuda")
    assert r.skipped is not None and "CUDA tensors only" in r.skipped


# ---- the composite code path on CPU tensors ------------------------------
@pytest.mark.parametrize("kw", [
    {"num_shards": 2}, {"num_shards": 4}, {"num_shards": 8},
    {"num_shards": 4, "block_x": 64, "block_y": 2, "zchunk": 16},
    {"decomp": "pencil", "shard_grid": (2, 2)},
    {"decomp": "pencil", "shard_grid": (4, 2)},
    {"decomp": "pencil", "shard_grid": (2, 4), "block_x": 128,
     "zchunk": 256}], ids=str)
def test_stencil_composite_path_is_bitwise(kw, no_launches):
    u = _f32(16, 24, 40, seed=1)
    want = get_kernel("stencil7")(u, backend="torch")
    with collectives.counting() as counts:
        got = shard_kernels.laplacian_shard_cuda(u, **kw)
    assert torch.equal(got, want)
    assert counts["ppermute"] == (4 if kw.get("decomp") == "pencil" else 2)


def test_stencil_composite_one_plane_per_shard(no_launches):
    for s in (2, 4, 8):
        u = _f32(s, 16, 8, seed=s)
        assert torch.equal(shard_kernels.laplacian_shard_cuda(u,
                                                             num_shards=s),
                           get_kernel("stencil7")(u, backend="torch"))


def test_pencil_blocks_have_no_dead_columns(monkeypatch):
    """The kernel takes any ny, so a pencil shard's padded block is its
    block plus one halo plane on each side of z and y, and nothing more
    (the reference's Pallas tile forces dead y-columns)."""
    shapes = []
    real = s7_K.laplacian

    def spy(block, *a, **kw):
        shapes.append(tuple(block.shape))
        return real(block, *a, **kw)
    monkeypatch.setattr(s7_K, "laplacian", spy)
    u = _f32(8, 12, 16, seed=2)
    out = shard_kernels.laplacian_shard_cuda(u, decomp="pencil",
                                             shard_grid=(2, 4))
    assert shapes == [(4 + 2, 3 + 2, 16)] * 8
    assert torch.equal(out, get_kernel("stencil7")(u, backend="torch"))


@pytest.mark.parametrize("op", ["copy", "mul", "add", "triad", "dot"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_stream_composite_path(op, shards, no_launches):
    fn = shard_kernels.stream_shard_triton_fns()[op]
    args = (_f32(4096, seed=1),) if op in ("copy", "mul") else \
        (_f32(4096, seed=1), _f32(4096, seed=2))
    want = get_kernel(f"babelstream.{op}")(*args, backend="torch")
    with collectives.counting() as counts:
        got = fn(*args, num_shards=shards, block=1024, num_warps=4)
    if op == "dot":
        rtol, atol = conformance.ORACLE_TOL["babelstream.dot"]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        assert counts["psum"] == 1
    else:
        assert torch.equal(got, want) and counts["psum"] == 0
    if op in ("mul", "triad"):
        assert torch.equal(fn(*args, scalar=-1.5, num_shards=shards),
                           get_kernel(f"babelstream.{op}")(
                               *args, -1.5, backend="torch"))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_minibude_composite_path_is_bitwise(shards, no_launches):
    deck = mb_ops.make_deck(40, 6, 256, seed=7, device="cpu")
    for p in ({}, {"ppwi": 1, "split": 2}, {"ppwi": 16, "split": 8}):
        assert torch.equal(
            shard_kernels.fasten_shard_cuda(*deck, num_shards=shards, **p),
            get_kernel("minibude.fasten")(*deck, backend="torch"))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_hartree_fock_composite_path(shards, no_launches):
    (pos, dens), _ = conformance.case_tensors("hartree_fock.twoel")
    rtol, atol = conformance.ORACLE_TOL["hartree_fock.twoel"]
    with collectives.counting() as counts:
        got = shard_kernels.fock_shard_cuda(pos, dens, num_shards=shards,
                                            team=64)
    assert counts == domain.ONE_PSUM
    torch.testing.assert_close(
        got, get_kernel("hartree_fock.twoel")(pos, dens, backend="torch"),
        rtol=rtol, atol=atol)


_FNS = {"stencil7": shard_kernels.laplacian_shard_cuda,
        "minibude.fasten": shard_kernels.fasten_shard_cuda,
        "hartree_fock.twoel": shard_kernels.fock_shard_cuda,
        **{f"babelstream.{op}": fn for op, fn
           in shard_kernels.stream_shard_triton_fns().items()}}


@pytest.mark.parametrize("name", sorted(COMPOSITE))
def test_composite_path_matches_the_jax_oracle(name, no_launches):
    arrays, kwargs = conformance.CASES[name]()
    got = _FNS[name](*conformance.as_tensors(arrays, "cpu"), **kwargs)
    want = jax_get_kernel(name)(*(jnp.asarray(a) for a in arrays),
                                backend="xla", **kwargs)
    rtol, atol = jax_conformance.ORACLE_TOL[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_no_fallback_off_cpu_and_cuda():
    """A composite never runs the plain version for a tensor that is not
    on the CPU: its kernel's wrapper raises."""
    u = _f32(8, 8, 8).to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        shard_kernels.laplacian_shard_cuda(u, num_shards=2)
    deck = [t.to("meta") for t in mb_ops.make_deck(8, 2, 64, device="cpu")]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        shard_kernels.fasten_shard_cuda(*deck, num_shards=2)


# ---- the composite spaces --------------------------------------------------
@pytest.mark.parametrize("dc", [2, 4, 8])
def test_stencil_space_is_the_shard_grid_times_every_tile(dc):
    k = get_kernel("stencil7")
    for shape in ((16, 16, 32), (8, 4, 16), (4, 8, 16), (6, 6, 8)):
        u = torch.zeros(shape)
        space = k.tunable_space("shard_cuda")
        pts = space.valid_points(u, device_count=dc)
        want = [p for p in space.points()
                if domain._stencil_point_ok(p, shape[0], shape[1], dc)]
        assert pts == want
        grids = {(p["decomp"], p["shard_grid"]) for p in pts}
        tiles = {(p["block_x"], p["block_y"], p["zchunk"]) for p in pts}
        assert len(pts) == len(grids) * len(tiles)
        assert all(sz * sy <= dc and shape[0] % sz == 0
                   and shape[1] % sy == 0 for _, (sz, sy) in grids)
        # the reference's composite admits the same shard grids, each with
        # its by tiles
        theirs = jax_get_kernel("stencil7").tunable_space(
            "shard_pallas").valid_points(jnp.zeros(shape), device_count=dc)
        assert {(p["decomp"], p["shard_grid"]) for p in theirs} <= grids


@pytest.mark.parametrize("name", sorted(set(COMPOSITE) - {"stencil7"}))
@pytest.mark.parametrize("dc", [1, 2, 4, 8])
def test_one_axis_spaces_admit_valid_shard_counts(name, dc):
    args, _ = conformance.case_tensors(name)
    # the decomposed extent: the poses for miniBUDE, else the first axis
    extent = args[-1].shape[1] if name == "minibude.fasten" \
        else args[0].shape[0]
    space = get_kernel(name).tunable_space(COMPOSITE[name])
    pts = space.valid_points(*args, device_count=dc)
    assert pts == [p for p in space.points()
                   if jax_shard_pallas._shard_ok(p["num_shards"], extent,
                                                 dc)]
    assert (pts == []) == (dc < 2)


def test_tune_sweeps_a_composite_space_and_round_trips_the_cache(tmp_path):
    """The composite's own space (shard grid x the kernel's tiles, 324
    points) through ``tune()``'s coordinate descent, on the composite's
    code path with the plain per-shard functions (a kernel made here, as
    the registry's composite runs only on the card): the tuple-valued
    ``shard_grid`` comes back from the cache as a tuple."""
    src = get_kernel("stencil7")
    k = PortableKernel(name="stencil7")
    k.add_backend("composite", shard_kernels.laplacian_shard_cuda)
    space = src.tunable_space("shard_cuda")
    k.declare_tunables("composite", constraint=space.constraint,
                       **space.params)
    u = _f32(8, 16, 32, seed=4)
    cache = tuning.TuningCache(path=tmp_path / "tuning.json")
    r = tuning.tune(k, u, backend="composite", cache=cache, iters=1,
                    warmup=0, budget=6)
    assert r.skipped is None and r.search == "coordinate"
    assert 1 <= len(r.swept) <= 6
    assert set(r.params) == set(space.params)
    r2 = tuning.tune(k, u, backend="composite", cache=cache, iters=1,
                     warmup=0, budget=6)
    assert r2.cached and r2.params == r.params
    assert isinstance(r2.params["shard_grid"], tuple)
    assert torch.equal(k(u, backend="composite", **r2.params),
                       src(u, backend="torch"))


def test_check_backend_holds_a_sharded_backend_to_its_twin(monkeypatch):
    """A sharded backend within ORACLE_TOL but not bitwise: with its
    bitwise tolerance row taken out, the twin check still catches it."""
    k = get_kernel("stencil7")

    def nudged(u, *a, **kw):
        out = domain.laplacian_shard(u, *a, **kw)
        return torch.nextafter(out, torch.full_like(out, np.inf))
    monkeypatch.setitem(k.backends, "torch_shard",
                        Backend("torch_shard", nudged))
    monkeypatch.delitem(conformance.BACKEND_TOL, ("stencil7", "torch_shard"))
    with pytest.raises(AssertionError, match="bitwise twin torch"):
        conformance.check_backend("stencil7", "torch_shard")
    monkeypatch.delitem(conformance.BITWISE_TWIN, ("stencil7", "torch_shard"))
    assert conformance.check_backend("stencil7", "torch_shard") < 1e-5
