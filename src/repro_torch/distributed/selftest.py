"""Self-test of the domain-decomposition subsystem.

    PYTHONPATH=src python -m repro_torch.distributed.selftest
        [--device cpu|cuda] [--only BATTERY,...]

The port of ``repro.distributed.selftest``.  The reference needs forced
host devices; the port's meshes have 8 shard places on one device (or one
place per card where there are two or more), so it runs on the CPU as it
is, and on one card.  ``--device`` defaults to ``cuda``, as the port's
entry points do, and exits 2 when there is no CUDA device; ``--device cpu``
asks for the CPU.  ``--only smoke`` is a seconds-scale single battery.

Checks, each against a single-device backend on the same tensors:
  * stencil7 ``torch_shard`` is **bitwise identical** to ``torch`` at 2/4/8
    slab shards, on the 2-D pencil grids ((2,2)/(4,2)/(2,4)), with the
    halo/compute-overlap variant of both decompositions, and at one plane
    per shard (the boundary mask's edge);
  * the halo exchange round-trips shard-boundary planes (zeros at the open
    ends), wraps periodically with ``wrap=True``, and moves ``halo``-thick
    multi-plane slabs;
  * BabelStream copy/mul/add/triad are bitwise identical; ``dot`` matches
    within float32 reduction tolerance (the psum changes the order);
  * miniBUDE pose-parallel energies are bitwise identical;
  * Hartree-Fock psum-accumulated Fock matrices match within tolerance;
  * bad shard counts and grids raise ``ValueError``, the declared grid
    admits only valid points, and ``tune()`` sweeps decomp/shard_grid/
    overlap (tuple-valued params round-trip the cache);
  * on the card, the ``shard_cuda``/``shard_triton`` composites (the
    hand-written kernels once per shard) are **bitwise identical to the
    single-device kernels** for the stencil (slab, pencil, a tile point,
    one plane per shard), the elementwise streams and miniBUDE, one launch
    (dot: two) per shard; ``dot`` and Hartree-Fock within psum tolerance;
    the composite tile x shard space sweeps through ``tune()``.  On the CPU
    these batteries say why they skip;
  * the conformance matrix (``repro_torch.core.conformance``) of the
    sharded families passes for every backend that can run here, the others
    skipping with their probe's reason.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Callable, Dict, List

import numpy as np
import torch

#: a sharded backend against its single-device twin: float32 dot and
#: Hartree-Fock only agree to the psum's reordering
DOT_RTOL = 1e-5
HF_TOL = (1e-4, 1e-4)


def _tensor(rng_seed: int, shape, device) -> torch.Tensor:
    a = np.random.default_rng(rng_seed).standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _equal(want: torch.Tensor, got: torch.Tensor, what: str) -> None:
    if not torch.equal(want, got):
        bad = int(want.ne(got).sum()) if want.shape == got.shape else -1
        raise AssertionError(f"{what} is not bitwise equal ({bad} cells "
                             f"differ)")


def _check_stencil(get_kernel, device, shard_counts):
    k = get_kernel("stencil7")
    u = _tensor(0, (16, 16, 32), device)
    want = k(u, backend="torch")
    for s in shard_counts:
        _equal(want, k(u, backend="torch_shard", num_shards=s),
               f"stencil7 torch_shard num_shards={s}")
    # default shard-count resolution also matches
    _equal(want, k(u, backend="torch_shard"), "stencil7 auto num_shards")
    print(f"  stencil7: bitwise equal at shards {shard_counts} + auto")


def _check_stencil_pencil(get_kernel, device, n_places):
    k = get_kernel("stencil7")
    u = _tensor(3, (16, 16, 32), device)
    want = k(u, backend="torch")
    grids = [g for g in ((2, 2), (4, 2), (2, 4)) if g[0] * g[1] <= n_places]
    for grid in grids:
        for overlap in (False, True):
            _equal(want, k(u, backend="torch_shard", decomp="pencil",
                           shard_grid=grid, overlap=overlap),
                   f"stencil7 pencil grid={grid} overlap={overlap}")
    for s in (2, 4):
        _equal(want, k(u, backend="torch_shard", decomp="slab",
                       shard_grid=(s, 1), overlap=True),
               f"stencil7 slab+overlap s={s}")
    _equal(want, k(u, backend="torch_shard", decomp="pencil"),
           "stencil7 auto pencil grid")
    print(f"  stencil7: pencil grids {grids} and overlap variants bitwise "
          f"equal")


def _check_stencil_one_plane(get_kernel, device, n_places):
    """nz == num_shards: each shard owns one plane, so its first and last
    local plane coincide and the boundary mask must AND the two edge
    conditions rather than overwrite one with the other."""
    k = get_kernel("stencil7")
    s = min(8, n_places)
    u = _tensor(4, (s, 8, 16), device)
    want = k(u, backend="torch")
    for overlap in (False, True):
        _equal(want, k(u, backend="torch_shard", num_shards=s,
                       overlap=overlap),
               f"stencil7 one-plane-per-shard overlap={overlap}")
    print(f"  stencil7: one plane per shard ({s} shards) bitwise equal")


def _blocks(x: torch.Tensor, n: int, device) -> List[torch.Tensor]:
    """``x`` split along dim 0 into ``n`` shards, each its own buffer on its
    place of the mesh."""
    from repro_torch.distributed.domain import shard_mesh
    step = x.shape[0] // n
    return [x[i * step:(i + 1) * step].to(dev, copy=True)
            for i, dev in enumerate(shard_mesh(n, device))]


def _check_halo(device, n):
    from repro_torch.distributed import collectives
    rows = 2 * n
    x = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
    lo, hi = collectives.halo_exchange(_blocks(x, n, device), axis=0)
    xs = x.reshape(n, 2, 3)
    zero = torch.zeros(1, 3)
    for i in range(n):
        want_lo = xs[i - 1][-1:] if i > 0 else zero
        want_hi = xs[i + 1][:1] if i < n - 1 else zero
        _equal(want_lo, lo[i].cpu(), f"halo from_prev {i}")
        _equal(want_hi, hi[i].cpu(), f"halo from_next {i}")
    print(f"  halo_exchange: round-trips at {n} shards, zero at the open "
          f"ends")


def _check_halo_wrap(device, n):
    """The wrap=True periodic ring and halo>1 multi-plane slabs."""
    from repro_torch.distributed import collectives
    planes = 3
    x = torch.arange(planes * n * 2, dtype=torch.float32).reshape(-1, 2)
    xs = x.reshape(n, planes, 2)
    shifted = collectives.shift(_blocks(x, n, device), 1, wrap=True)
    for i in range(n):
        _equal(xs[(i - 1) % n], shifted[i].cpu(), f"periodic shift {i}")
    lo, hi = collectives.halo_exchange(_blocks(x, n, device), axis=0,
                                       halo=2)
    zero = torch.zeros(2, 2)
    for i in range(n):
        _equal(xs[i - 1][-2:] if i > 0 else zero, lo[i].cpu(),
               f"halo=2 prev {i}")
        _equal(xs[i + 1][:2] if i < n - 1 else zero, hi[i].cpu(),
               f"halo=2 next {i}")
    lo, hi = collectives.halo_exchange(_blocks(x, n, device), axis=0,
                                       halo=2, wrap=True)
    for i in range(n):
        _equal(xs[(i - 1) % n][-2:], lo[i].cpu(), f"wrap halo=2 prev {i}")
        _equal(xs[(i + 1) % n][:2], hi[i].cpu(), f"wrap halo=2 next {i}")
    print(f"  halo_exchange: wrap=True periodic ring and halo=2 multi-plane "
          f"slabs at {n} shards")


def _stream_cases(device, n):
    a, b = _tensor(1, (n,), device), _tensor(11, (n,), device)
    return {"copy": (a,), "mul": (a,), "add": (a, b), "triad": (a, b),
            "dot": (a, b)}


def _check_babelstream(get_kernel, device, shard_counts):
    for op, args in _stream_cases(device, 1 << 12).items():
        k = get_kernel(f"babelstream.{op}")
        want = k(*args, backend="torch")
        for s in shard_counts:
            got = k(*args, backend="torch_shard", num_shards=s)
            if op == "dot":
                np.testing.assert_allclose(float(got), float(want),
                                           rtol=1e-6)
            else:
                _equal(want, got, f"babelstream.{op} num_shards={s}")
    a, b = _stream_cases(device, 1 << 12)["triad"]
    k = get_kernel("babelstream.triad")
    _equal(k(a, b, backend="torch", scalar=2.5),
           k(a, b, backend="torch_shard", num_shards=2, scalar=2.5),
           "triad scalar=2.5")
    print(f"  babelstream: copy/mul/add/triad bitwise equal, dot within "
          f"1e-6, shards {shard_counts}")


def _bude_deck(device, nposes):
    from repro_torch.kernels.minibude import ops as mb_ops
    return mb_ops.make_deck(natpro=16, natlig=4, nposes=nposes, seed=0,
                            device=device)


def _check_minibude(get_kernel, device, shard_counts):
    deck = _bude_deck(device, 128)
    k = get_kernel("minibude.fasten")
    want = k(*deck, backend="torch")
    for s in shard_counts:
        _equal(want, k(*deck, backend="torch_shard", num_shards=s),
               f"minibude.fasten num_shards={s}")
    print(f"  minibude: pose-parallel bitwise equal at shards "
          f"{shard_counts}")


def _hf_case(device):
    from repro_torch.kernels.hartree_fock import ref as hf_ref
    return (hf_ref.helium_lattice(8, device=device),
            hf_ref.initial_density(8, device=device))


def _check_hartree_fock(get_kernel, device, shard_counts):
    pos, dens = _hf_case(device)
    k = get_kernel("hartree_fock.twoel")
    want = k(pos, dens, backend="torch")
    for s in shard_counts:
        got = k(pos, dens, backend="torch_shard", num_shards=s)
        torch.testing.assert_close(got, want, rtol=HF_TOL[0], atol=HF_TOL[1])
    print(f"  hartree_fock: psum Fock within oracle tolerance at shards "
          f"{shard_counts}")


def _check_constraints(get_kernel, device):
    from repro_torch.core import tuning
    from repro_torch.distributed.domain import (resolve_num_shards,
                                                resolve_shard_grid)
    for extent, shards in ((15, 2), (16, 1), (16, 1024)):
        try:
            resolve_num_shards(extent, shards, device_count=8)
        except ValueError:
            pass
        else:
            raise AssertionError(f"resolve_num_shards accepted {extent}, "
                                 f"{shards}")
    for kw in ({"decomp": "pencil", "shard_grid": (2, 1)},
               {"decomp": "slab", "shard_grid": (2, 2)},
               {"decomp": "pencil", "shard_grid": (2, 3)},
               {"decomp": "pencil", "shard_grid": (64, 64)},
               {"decomp": "block"}):
        try:
            resolve_shard_grid(16, 8, device_count=8, **kw)
        except ValueError:
            pass
        else:
            raise AssertionError(f"resolve_shard_grid accepted {kw}")
    k = get_kernel("stencil7")
    u = _tensor(2, (4, 8, 16), device)
    pts = k.tunable_space("torch_shard").valid_points(u)
    grids = sorted({(p["decomp"], p["shard_grid"]) for p in pts})
    assert grids == [("pencil", (2, 2)), ("pencil", (2, 4)),
                     ("pencil", (4, 2)), ("slab", (2, 1)),
                     ("slab", (4, 1))], grids
    with tempfile.TemporaryDirectory() as td:
        cache = tuning.TuningCache(path=td + "/tuning.json")
        r = tuning.tune(k, u, backend="torch_shard", cache=cache, iters=1,
                        warmup=0)
        assert r.skipped is None and not r.cached, r
        r2 = tuning.tune(k, u, backend="torch_shard", cache=cache, iters=1,
                         warmup=0)
        assert r2.cached and r2.params == r.params, (r, r2)
        assert isinstance(r2.params["shard_grid"], tuple), r2
    print("  constraints: invalid shard counts/grids rejected, tunable grid "
          "filtered, tune() sweeps decomp/shard_grid/overlap")


def _unavailable(get_kernel, name: str, backend: str):
    """The probe's reason when a composite cannot run here, else None."""
    return get_kernel(name).backend(backend).unavailable_reason()


def _launches(wrapper: Callable, call: Callable[[], torch.Tensor]):
    before = wrapper.launches
    out = call()
    return out, wrapper.launches - before


def _check_shard_kernels_stencil(get_kernel, device, n_places):
    from repro_torch.kernels.stencil7 import kernel as s7_K
    reason = _unavailable(get_kernel, "stencil7", "shard_cuda")
    if reason:
        print(f"  shard_kernels stencil7: skipped ({reason})")
        return
    k = get_kernel("stencil7")
    u = _tensor(5, (16, 32, 128), device)
    want = k(u, backend="cuda")
    cases = [{"num_shards": s} for s in (2, 4, 8) if s <= n_places]
    cases += [{"num_shards": min(4, n_places), "block_x": 64, "block_y": 4,
               "zchunk": 16}]
    cases += [{"decomp": "pencil", "shard_grid": g}
              for g in ((2, 2), (4, 2), (2, 4)) if g[0] * g[1] <= n_places]
    for kw in cases:
        tile = {t: kw[t] for t in ("block_x", "block_y", "zchunk") if t in kw}
        twin = k(u, backend="cuda", **tile) if tile else want
        got, n = _launches(s7_K.laplacian,
                           lambda: k(u, backend="shard_cuda", **kw))
        _equal(twin, got, f"stencil7 shard_cuda {kw}")
        shards = kw.get("num_shards") or kw["shard_grid"][0] * \
            kw["shard_grid"][1]
        assert n == shards, f"stencil7 shard_cuda {kw}: {n} launches"
    s = min(8, n_places)
    u1 = _tensor(6, (s, 16, 128), device)
    _equal(k(u1, backend="cuda"), k(u1, backend="shard_cuda", num_shards=s),
           "stencil7 shard_cuda one plane per shard")
    print(f"  shard_kernels stencil7: bitwise equal to the single-device "
          f"kernel ({len(cases)} grids incl. pencil + one plane per shard), "
          f"one launch a shard")


def _check_shard_kernels_streams(get_kernel, device, n_places):
    from repro_torch.kernels.babelstream import kernel as stream_K
    reason = _unavailable(get_kernel, "babelstream.copy", "shard_triton")
    if reason:
        print(f"  shard_kernels babelstream: skipped ({reason})")
        return
    shard_counts = [s for s in (2, 8) if s <= n_places]
    for op, args in _stream_cases(device, 1 << 17).items():
        k = get_kernel(f"babelstream.{op}")
        want = k(*args, backend="triton")
        for s in shard_counts:
            got, n = _launches(getattr(stream_K, op), lambda: k(
                *args, backend="shard_triton", num_shards=s))
            assert n == s * (2 if op == "dot" else 1), (op, s, n)
            if op == "dot":
                np.testing.assert_allclose(float(got), float(want),
                                           rtol=DOT_RTOL)
            else:
                _equal(want, got, f"babelstream.{op} shard_triton {s}")
    print(f"  shard_kernels babelstream: elementwise bitwise equal to the "
          f"single-device kernels, dot within {DOT_RTOL}, shards "
          f"{shard_counts}")


def _check_shard_kernels_minibude(get_kernel, device, n_places):
    from repro_torch.kernels.minibude import kernel as mb_K
    reason = _unavailable(get_kernel, "minibude.fasten", "shard_cuda")
    if reason:
        print(f"  shard_kernels minibude: skipped ({reason})")
        return
    deck = _bude_deck(device, 512)
    k = get_kernel("minibude.fasten")
    want = k(*deck, backend="cuda")
    shard_counts = [s for s in (2, 4, 8) if s <= n_places]
    for s in shard_counts:
        got, n = _launches(mb_K.fasten, lambda: k(
            *deck, backend="shard_cuda", num_shards=s))
        _equal(want, got, f"minibude shard_cuda num_shards={s}")
        assert n == s, (s, n)
    print(f"  shard_kernels minibude: bitwise equal to the single-device "
          f"kernel at shards {shard_counts}")


def _check_shard_kernels_hf(get_kernel, device, n_places):
    from repro_torch.kernels.hartree_fock import kernel as hf_K
    reason = _unavailable(get_kernel, "hartree_fock.twoel", "shard_cuda")
    if reason:
        print(f"  shard_kernels hartree_fock: skipped ({reason})")
        return
    pos, dens = _hf_case(device)
    k = get_kernel("hartree_fock.twoel")
    want = k(pos, dens, backend="torch")
    shard_counts = [s for s in (2, 4, 8) if s <= n_places]
    for s in shard_counts:
        got, n = _launches(hf_K.twoel_slab, lambda: k(
            pos, dens, backend="shard_cuda", num_shards=s))
        torch.testing.assert_close(got, want, rtol=HF_TOL[0], atol=HF_TOL[1])
        assert n == s, (s, n)
    print(f"  shard_kernels hartree_fock: l-slab kernels + psum within "
          f"oracle tolerance at shards {shard_counts}")


def _check_shard_kernels_tuning(get_kernel, device):
    from repro_torch.core import tuning
    reason = _unavailable(get_kernel, "stencil7", "shard_cuda")
    if reason:
        print(f"  shard_kernels tuning: skipped ({reason})")
        return
    k = get_kernel("stencil7")
    u = _tensor(8, (8, 16, 128), device)
    pts = k.tunable_space("shard_cuda").valid_points(u)
    assert {p["decomp"] for p in pts} == {"slab", "pencil"}, pts
    with tempfile.TemporaryDirectory() as td:
        cache = tuning.TuningCache(path=td + "/tuning.json")
        r = tuning.tune(k, u, backend="shard_cuda", cache=cache, iters=1,
                        warmup=1, budget=4)
        assert r.skipped is None and not r.cached, r
        assert {"decomp", "shard_grid", "block_x"} <= set(r.params), r
        r2 = tuning.tune(k, u, backend="shard_cuda", cache=cache, iters=1,
                         warmup=1, budget=4)
        assert r2.cached and r2.params == r.params, (r, r2)
        assert isinstance(r2.params["shard_grid"], tuple), r2
    print("  shard_kernels tuning: composite tile x shard space sweeps and "
          "round-trips the cache")


def _check_conformance(get_kernel, device):
    """The conformance matrix of the sharded families on this device: every
    (kernel, backend) cell validates against its oracle (and its bitwise
    twin) or skips with its probe's reason; the sharded backends must run
    wherever their kernels can."""
    from repro_torch.core import conformance
    from repro_torch.core.portable import BackendUnavailableError
    ran, skipped = [], []
    for name, backend in conformance.conformance_pairs():
        if "torch_shard" not in get_kernel(name).backends:
            continue
        try:
            conformance.check_backend(name, backend, device=device)
            ran.append((name, backend))
        except BackendUnavailableError:
            skipped.append((name, backend))
    hand_written = ("cuda", "triton", "shard_cuda", "shard_triton")
    assert all(b in hand_written for _, b in skipped), skipped
    want = ["torch_shard"] + (["shard_cuda", "shard_triton"]
                              if torch.device(device).type == "cuda" else [])
    for b in want:
        assert any(x[1] == b for x in ran), f"{b} never ran: {ran}"
    print(f"  conformance: {len(ran)} registry cells validated "
          f"({len(skipped)} skips: hand-written backends without a card)")


def _check_smoke(get_kernel, device):
    """Seconds-scale single battery: one sharded stencil on the plain
    arithmetic and one composite (the wrappers' plain version on the CPU),
    bitwise, at 2 shards."""
    from repro_torch.distributed import shard_kernels
    k = get_kernel("stencil7")
    u = _tensor(9, (4, 8, 128), device)
    want = k(u, backend="torch")
    _equal(want, k(u, backend="torch_shard", num_shards=2),
           "smoke: torch_shard")
    native = k(u) if torch.device(device).type == "cuda" else want
    _equal(native, shard_kernels.laplacian_shard_cuda(u, num_shards=2),
           "smoke: the shard_cuda composite")
    print("  smoke: torch_shard + the shard_cuda composite stencil bitwise "
          "at 2 shards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--only", default=None, metavar="BATTERY[,BATTERY...]",
                    help="run only the named batteries (default: every "
                         "battery except the 'smoke' shortcut)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("selftest --device cuda: torch sees no CUDA device (pass "
              "--device cpu for the CPU)", file=sys.stderr)
        return 2
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")

    import repro_torch.kernels  # noqa: F401  (registers the sharded backends)
    from repro_torch.core.portable import get_kernel
    from repro_torch.distributed.domain import mesh_device_count

    n = mesh_device_count(device)
    shard_counts = [s for s in (2, 4, 8) if s <= n]
    batteries: Dict[str, Callable[[], None]] = {
        "stencil": lambda: _check_stencil(get_kernel, device, shard_counts),
        "stencil_pencil": lambda: _check_stencil_pencil(get_kernel, device,
                                                        n),
        "stencil_one_plane": lambda: _check_stencil_one_plane(
            get_kernel, device, n),
        "halo": lambda: _check_halo(device, min(4, n)),
        "halo_wrap": lambda: _check_halo_wrap(device, min(4, n)),
        "babelstream": lambda: _check_babelstream(get_kernel, device,
                                                  shard_counts),
        "minibude": lambda: _check_minibude(get_kernel, device,
                                            shard_counts),
        "hartree_fock": lambda: _check_hartree_fock(get_kernel, device,
                                                    shard_counts),
        "constraints": lambda: _check_constraints(get_kernel, device),
        "shard_kernels_stencil": lambda: _check_shard_kernels_stencil(
            get_kernel, device, n),
        "shard_kernels_streams": lambda: _check_shard_kernels_streams(
            get_kernel, device, n),
        "shard_kernels_minibude": lambda: _check_shard_kernels_minibude(
            get_kernel, device, n),
        "shard_kernels_hf": lambda: _check_shard_kernels_hf(get_kernel,
                                                            device, n),
        "shard_kernels_tuning": lambda: _check_shard_kernels_tuning(
            get_kernel, device),
        "conformance": lambda: _check_conformance(get_kernel, device),
        "smoke": lambda: _check_smoke(get_kernel, device),
    }
    if args.only is None:
        selected = [b for b in batteries if b != "smoke"]
    else:
        selected = [b.strip() for b in args.only.split(",") if b.strip()]
        unknown = [b for b in selected if b not in batteries]
        if unknown:
            print(f"unknown batteries {unknown}; known: "
                  f"{sorted(batteries)}", file=sys.stderr)
            return 2
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"selftest on {where}: {n} shard places, shard counts "
          f"{shard_counts}, batteries {selected}")
    for name in selected:
        batteries[name]()
    print(f"selftest ok ({len(selected)} batteries)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
