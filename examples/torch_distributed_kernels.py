"""The science kernels sharded: domain decomposition through the registry.

    PYTHONPATH=src python examples/torch_distributed_kernels.py          # GPU
    PYTHONPATH=src python examples/torch_distributed_kernels.py --device cpu

The port's counterpart of ``examples/distributed_kernels.py``.  Each
science family runs on its single-device oracle and on the sharded backends
``repro_torch.distributed`` registers, every sharded result checked against
a single-device one:

  * ``torch_shard`` — the plain arithmetic once per shard:
      - stencil7     1-D z slabs AND 2-D (sz, sy) pencils + a halo exchange
                     per decomposed axis, each with the halo/compute-overlap
                     variant (each interior computed before its halos land)
      - babelstream  block-partitioned triad (elementwise) + psum dot
      - minibude     pose-parallel energies
      - hartree_fock l-slab partial Fock builds added with one psum
  * ``shard_cuda`` / ``shard_triton`` — the *unchanged hand-written kernels*
    once per shard, the shard grid composing with each kernel's tile
    tunables; the stencil, triad and pose results are bitwise identical to
    the single-device kernel: sharding does not change the kernel's output.
    On the CPU they do not run, and each says why (its availability probe).

The mesh has 8 shard places on one device (one a card where there are two
or more), so every shard of a run on one card shares it: the times show
what the decomposition costs there (each shard owns its own buffers, and a
halo exchange copies), not scaling across cards.  ``chip_smoke.py`` phase
11 runs the composites at the paper's sizes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels  # noqa: F401  (registers the sharded backends)
from repro_torch.core import get_kernel
from repro_torch.distributed.domain import mesh_device_count
from repro_torch.kernels.hartree_fock import ref as hf_ref
from repro_torch.kernels.minibude.ops import make_deck

#: Hartree-Fock and dot: the psum adds the partials in another order
TOL = (1e-4, 1e-4)


def show(name: str, args, *, backend: str, against: str, exact: bool = True,
         label: str = "", **shard_kw) -> None:
    """Time ``against`` and ``backend`` on ``args`` and check that they
    agree (bitwise where ``exact``), or say why ``backend`` cannot run."""
    k = get_kernel(name)
    for b in (backend, against):
        reason = k.backend(b).unavailable_reason()
        if reason is not None:
            print(f"{name:18s} {backend}[{label}]: not run ({reason})")
            return
    t_a = k.time_backend(*args, backend=against, iters=3)
    t_s = k.time_backend(*args, backend=backend, iters=3, **shard_kw)
    want = k(*args, backend=against)
    got = k(*args, backend=backend, **shard_kw)
    if exact:
        if not torch.equal(want, got):
            raise SystemExit(f"{name}: {backend}[{label}] is not bitwise "
                             f"equal to {against}")
        match = f"bitwise vs {against}"
    else:
        torch.testing.assert_close(got, want, rtol=TOL[0], atol=TOL[1])
        match = f"~{TOL[0]:g} vs {against}"
    print(f"{name:18s} {against} {t_a * 1e3:8.3f} ms   {backend}[{label}] "
          f"{t_s * 1e3:8.3f} ms   match: {match}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    device = torch.device(args.device)
    places = mesh_device_count(device)
    shards = min(4, places)
    print(f"{places} shard places on {device}; every family at "
          f"num_shards={shards}\n")
    rng = np.random.default_rng(0)

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    u = tensor(32, 64, 128)
    a, b = tensor(1 << 16), tensor(1 << 16)
    deck = make_deck(natpro=32, natlig=4, nposes=256, seed=0, device=device)
    pos = hf_ref.helium_lattice(8, device=device)
    dens = hf_ref.initial_density(8, device=device)

    for backend, against in (("torch_shard", "torch"),
                             ("shard_cuda", "cuda")):
        stream_backend = backend.replace("cuda", "triton")
        stream_against = against.replace("cuda", "triton")
        show("stencil7", (u,), backend=backend, against=against,
             label=f"slab {shards}x1", num_shards=shards)
        if backend == "torch_shard":
            show("stencil7", (u,), backend=backend, against=against,
                 label=f"slab {shards}x1 +overlap", num_shards=shards,
                 overlap=True)
        if places >= 4:
            show("stencil7", (u,), backend=backend, against=against,
                 label="pencil 2x2", decomp="pencil", shard_grid=(2, 2))
        show("babelstream.triad", (a, b), backend=stream_backend,
             against=stream_against, label=str(shards), num_shards=shards)
        show("babelstream.dot", (a, b), backend=stream_backend,
             against=stream_against, exact=False, label=str(shards),
             num_shards=shards)
        show("minibude.fasten", deck, backend=backend, against=against,
             label=str(shards), num_shards=shards)
        show("hartree_fock.twoel", (pos, dens), backend=backend,
             against="torch", exact=False, label=str(shards),
             num_shards=shards)
        print()
    print("every sharded backend that runs here validated against its "
          "single-device twin")


if __name__ == "__main__":
    main()
