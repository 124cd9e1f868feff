#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

The paper's portable-kernel workflow (``examples/quickstart.py``) at the
paper's sizes: BabelStream over 2^25 float32 elements (128 MiB an array),
the seven-point stencil over a 512^3 float32 volume (512 MiB), miniBUDE on
a bm1-shaped deck (938 protein atoms, 26 ligand atoms, 65536 poses) and
the Hartree-Fock Fock build on the paper's two smallest helium systems
(N = 128 with STO-3G, N = 64 with STO-6G: 2.17e10 primitive quartets each),
plus the build split into four l-slabs, as a distributed caller runs it.

  1. build:     nvcc for every ``csrc/*.cu`` (all started together), then
                each kernel once on its small conformance case on the card,
                which compiles the Triton kernels and checks them;
  2. main path: four paths — slice 1 (BabelStream, stencil), miniBUDE,
                Hartree-Fock, the Hartree-Fock slabs — each with every
                launch count set to 0 just before it and read just after;
                registry kernels go through ``get_kernel(name)`` with their
                default backend on CUDA tensors, which must be the
                hand-written one, and each kernel must have launched;
  3. check:     each kernel against its plain PyTorch version on the same
                inputs at the port's ORACLE_TOL; the stencil's boundary
                faces are zero, the Fock matrices symmetric, the four slabs
                sum to the full build, and nothing is NaN;
  4. timing:    CUDA-event medians of the kernel, its plain version and the
                one PyTorch call computing the same function (where there
                is one), beside the least time the card could take, and
                the host's time to enqueue one call;
  5. Eq. 4:     e_i = plain time / kernel time and their mean, Phi-bar,
                over the registry's kernels; the slab, the Hartree-Fock
                kernel again, gets its e_i apart.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  With no CUDA
device, or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import _build  # noqa: E402
import repro_torch.kernels  # noqa: E402,F401  (registers the kernels)
from repro_torch.core import (  # noqa: E402
    Efficiency, get_kernel, max_abs_err, phi_bar, time_call)
from repro_torch.core import conformance  # noqa: E402
from repro_torch.core.portable import LONG_CALL_S  # noqa: E402
from repro_torch.kernels.babelstream.ref import START_SCALAR  # noqa: E402
from repro_torch.kernels.hartree_fock import kernel as hf_kernel  # noqa: E402
from repro_torch.kernels.hartree_fock import ops as hf_ops  # noqa: E402
from repro_torch.kernels.hartree_fock import ref as hf_ref  # noqa: E402
from repro_torch.kernels.minibude.ops import make_deck  # noqa: E402
from repro_torch.kernels.stencil7.ref import default_coefficients  # noqa: E402

STREAM_N = 1 << 25     # the paper's BabelStream size
STENCIL_L = 512        # the paper's smaller stencil volume
BUDE = {"natpro": 938, "natlig": 26, "nposes": 65536}  # bm1's shape
HF_CASES = ((128, 3), (64, 6))  # (N, ngauss): the paper's Table 4 He systems
SLABS = 4              # l-slabs of the N = 128 build
ITERS = 20             # timed samples per median (time_call takes fewer
                       # for calls of a millisecond or more)
STREAM_OPS = ("copy", "mul", "add", "triad", "dot")
SLICE1 = tuple(f"babelstream.{op}" for op in STREAM_OPS) + ("stencil7",)
KERNELS = SLICE1 + ("minibude.fasten", "hartree_fock.twoel")  # registry
SLAB = "hartree_fock.twoel_slab"  # the slab wrapper, outside the registry
RECORDS = KERNELS + (SLAB,)
HF_TOL = conformance.ORACLE_TOL["hartree_fock.twoel"]

SOURCE = {name: "src/repro_torch/kernels/babelstream/kernel.py"
          for name in SLICE1[:5]}
SOURCE.update({
    "stencil7": "src/repro_torch/csrc/stencil7.cu",
    "minibude.fasten": "src/repro_torch/csrc/minibude.cu",
    "hartree_fock.twoel": "src/repro_torch/csrc/hartree_fock.cu",
    SLAB: "src/repro_torch/csrc/hartree_fock.cu",
})
REPLACES = {
    "babelstream.copy": "src/repro/kernels/babelstream/kernel.py:99",
    "babelstream.mul": "src/repro/kernels/babelstream/kernel.py:105",
    "babelstream.add": "src/repro/kernels/babelstream/kernel.py:113",
    "babelstream.triad": "src/repro/kernels/babelstream/kernel.py:119",
    "babelstream.dot": "src/repro/kernels/babelstream/kernel.py:126",
    "stencil7": "src/repro/kernels/stencil7/kernel.py:93",
    "minibude.fasten": "src/repro/kernels/minibude/kernel.py:146",
    "hartree_fock.twoel": "src/repro/kernels/hartree_fock/kernel.py:153",
    SLAB: "src/repro/kernels/hartree_fock/kernel.py:180",
}

# one PyTorch call computing the same function: the yardstick, never
# called by the port itself; no single call computes the stencil, the BUDE
# energies or a Fock build
LIBRARY = {
    "babelstream.copy": torch.clone,
    "babelstream.mul": lambda c: torch.mul(c, START_SCALAR),
    "babelstream.add": torch.add,
    "babelstream.triad": lambda b, c: torch.add(b, c, alpha=START_SCALAR),
    "babelstream.dot": torch.dot,
    "stencil7": None,
    "minibude.fasten": None,
    "hartree_fock.twoel": None,
    SLAB: None,
}

# data-sheet rates (dense, no sparsity): HBM bytes/s and float32 FLOP/s
# outside the tensor cores; the first name that occurs in the device name
DATASHEET = (
    ("H100 PCIe", "H100 PCIe", 2.0e12, 51e12),
    ("H100", "H100 SXM", 3.35e12, 67e12),
)


@dataclasses.dataclass
class Case:
    """One call of the main path: the record it belongs to, the kernel
    (or wrapper) and its plain version, and the inputs."""

    label: str
    record: str
    kernel: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    shape: Tuple[int, ...]
    flops: float        # the registry's model: GFLOP/s
    least_flops: float  # the fewest the function needs: the bound


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def datasheet(kind: str):
    for key, label, bw, flops in DATASHEET:
        if key in kind:
            return label, bw, flops
    fail(f"no data-sheet rates for {kind!r}")


def flops(name: str, args, kwargs) -> float:
    """Floating-point operations the function does on these inputs: the
    registry's model where the kernel has one (Eq. 3 for miniBUDE,
    120 N^4 G^4 for Hartree-Fock), else counted from the shapes."""
    k = get_kernel(name)
    if k.flops_model is not None:
        return float(k.flops_model(*args, **kwargs))
    if name == "stencil7":
        nz, ny, nx = args[0].shape
        return 10.0 * (nz - 2) * (ny - 2) * (nx - 2)
    per_elem = {"copy": 0, "mul": 1, "add": 1, "triad": 2, "dot": 2}
    return float(per_elem[name.split(".")[1]] * args[0].numel())


def enqueue_ms(fn, args, kwargs, calls: int) -> float:
    """Host milliseconds to enqueue one call, averaged over ``calls``
    calls: the registry's and the wrapper's own cost per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args, **kwargs)
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def registry_case(label: str, name: str, args, kwargs, shape,
                  least_flops=None) -> Case:
    """A registry kernel's call; its timing calls the two backends' own
    functions, as ``PortableKernel.time_backend`` does.  The bound counts
    the registry's flops unless ``least_flops`` says the function needs
    fewer."""
    k = get_kernel(name)
    ops = flops(name, args, kwargs)
    return Case(label, name, k.backend(k.native).fn, k.backend("torch").fn,
                args, kwargs, shape, ops,
                ops if least_flops is None else least_flops)


def drive(phase: str, cases: List[Case], wrappers) -> Dict[str, Any]:
    """One path of the main path: every launch count set to 0 just before,
    the path's own counts read just after."""
    for w in wrappers.values():
        w.launches = 0
    outs = {}
    for c in cases:
        if c.record == SLAB:
            outs[c.label] = hf_kernel.twoel_slab(*c.args, **c.kwargs)
            continue
        k = get_kernel(c.record)
        chosen = k.default_backend(*c.args, **c.kwargs)
        if chosen != k.native:
            fail(f"{c.record}: default backend on CUDA tensors is "
                 f"{chosen!r}, not the hand-written {k.native!r}")
        outs[c.label] = k(*c.args, **c.kwargs)
    torch.cuda.synchronize()
    counts = {c.record: wrappers[c.record].launches for c in cases}
    print(f"main path [{phase}] launches: {counts}")
    for name, count in counts.items():
        if count < 1:
            fail(f"{name}: the main path never launched its kernel")
    return outs, counts


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the generator that makes the inputs")
    args = p.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "GPU and never falls back to the CPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    label, bw, peak = datasheet(kind)
    print(f"bound rates: {label} data sheet, {bw / 1e12} TB/s HBM, "
          f"{peak / 1e12} TFLOP/s float32")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"built {name}: {'; '.join(ptxas)}")
    for name in KERNELS:
        k = get_kernel(name)
        err = conformance.check_backend(name, k.native, device=dev)
        print(f"conformance case {name}[{k.native}] max abs err {err:.3g}")
    (pos8, dens8), _ = conformance.case_tensors("hartree_fock.twoel", dev)
    basis3 = hf_ref.sto_basis(3, device=dev)
    err = max_abs_err(
        hf_kernel.twoel_slab(hf_kernel.pad4(pos8), dens8, basis3, 2, 4),
        hf_ref.fock_build_slab(pos8, dens8, basis3, 2, 4), *HF_TOL,
        "conformance case hartree_fock.twoel_slab")
    print(f"conformance case {SLAB}[cuda] l in [2, 6) max abs err {err:.3g}")
    print(f"build + small cases: {time.perf_counter() - t0:.1f} s")

    # ---- inputs: made on the card from the seed ------------------------
    g = torch.Generator(device=dev).manual_seed(args.seed)
    a, b, c = (torch.randn(STREAM_N, generator=g, device=dev)
               for _ in range(3))
    u = torch.randn(STENCIL_L, STENCIL_L, STENCIL_L, generator=g, device=dev)
    coeffs = default_coefficients()
    stream_args = {"copy": (a,), "mul": (c,), "add": (a, b),
                   "triad": (b, c), "dot": (a, b)}
    slice1 = [registry_case(f"babelstream.{op}", f"babelstream.{op}", xs, {},
                            () if op == "dot" else tuple(xs[0].shape))
              for op, xs in stream_args.items()]
    slice1.append(registry_case("stencil7", "stencil7", (u, *coeffs), {},
                                tuple(u.shape)))
    deck = make_deck(**BUDE, seed=args.seed, device=dev)
    bude = [registry_case("minibude.fasten", "minibude.fasten", deck, {},
                          (BUDE["nposes"],))]
    hf, hf_inputs = [], {}
    for n, ngauss in HF_CASES:
        pos = hf_ref.helium_lattice(n, device=dev)
        dens = hf_ref.initial_density(n, device=dev)
        hf_inputs[n, ngauss] = (pos, dens)
        hf.append(registry_case(f"hartree_fock.twoel N={n} ngauss={ngauss}",
                                "hartree_fock.twoel", (pos, dens),
                                {"ngauss": ngauss}, (n, n),
                                hf_ops.least_flops(n, ngauss)))
    # the slabs of the N = 128 build, as one rank of a distributed build
    # calls the wrapper: (positions4, density, basis, l0, nl)
    n, ngauss = HF_CASES[0]
    pos, dens = hf_inputs[n, ngauss]
    pos4, basis = hf_kernel.pad4(pos), hf_ref.sto_basis(ngauss, device=dev)
    nl = n // SLABS
    slab_flops = 120.0 * float(n) ** 3 * nl * ngauss ** 4
    slabs = [Case(f"{SLAB} l in [{l0}, {l0 + nl})", SLAB,
                  hf_kernel.twoel_slab,
                  lambda p4, d, bs, l0_, nl_: hf_ref.fock_build_slab(
                      p4[:, :3], d, bs, l0_, nl_),
                  (pos4, dens, basis, l0, nl), {}, (n, n), slab_flops,
                  hf_ops.least_flops(n, ngauss, nl))
             for l0 in range(0, n, nl)]
    wrappers = {name: get_kernel(name).backend(get_kernel(name).native).fn
                for name in KERNELS}
    wrappers["hartree_fock.twoel"] = hf_kernel.twoel
    wrappers[SLAB] = hf_kernel.twoel_slab

    # ---- 2. main path, with the launch counts --------------------------
    outs, launches = {}, {}
    for phase, cases in (("slice 1", slice1), ("miniBUDE", bude),
                         ("Hartree-Fock", hf), ("Hartree-Fock slabs", slabs)):
        o, counts = drive(phase, cases, wrappers)
        outs.update(o)
        launches.update(counts)

    # ---- 3. check ------------------------------------------------------
    f = outs["stencil7"]
    faces = (f[0], f[-1], f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1])
    if any(bool(face.ne(0).any()) for face in faces):
        fail("stencil7: a boundary face is not zero")
    cases = slice1 + bude + hf + slabs
    for c in cases:
        out = outs[c.label]
        if not bool(torch.isfinite(out).all()):
            fail(f"{c.label}: non-finite values in the main path's output")
        if tuple(out.shape) != c.shape or out.dtype != torch.float32:
            fail(f"{c.label}: output {out.dtype}{tuple(out.shape)}, "
                 f"expected float32{c.shape}")
    for c in hf:
        err = max_abs_err(outs[c.label], outs[c.label].T, *HF_TOL,
                          f"{c.label}: F against its transpose")
        print(f"{c.label}: symmetric, max |F - F^T| {err:.3g}")
    errs: Dict[str, float] = {}
    for c in slice1 + bude + hf:
        k = get_kernel(c.record)
        e = k.validate(*c.args, backend=k.native, **c.kwargs)
        errs[c.label] = e
        print(f"{c.label}[{k.native}] vs torch at ORACLE_TOL "
              f"{conformance.ORACLE_TOL[c.record]}: max abs err {e:.3g}")
    # the slabs: each against its plain slab, their sum against the full
    # kernel's build
    full = outs[hf[0].label]
    for c in slabs:
        errs[c.label] = max_abs_err(outs[c.label], c.plain(*c.args),
                                    *HF_TOL, c.label)
        print(f"{c.label}[cuda] vs torch at ORACLE_TOL {HF_TOL}: max abs "
              f"err {errs[c.label]:.3g}")
    total = sum(outs[c.label] for c in slabs)
    err = max_abs_err(total, full, *HF_TOL, f"sum of the {SLABS} slabs")
    print(f"sum of the {SLABS} slabs vs the full N={n} build at ORACLE_TOL "
          f"{HF_TOL}: max abs err {err:.3g}")

    # ---- 4. timing -----------------------------------------------------
    measured: Dict[str, Dict[str, Any]] = {}
    # one slab stands for the slab record: they are the same work
    for c in slice1 + bude + hf + slabs[:1]:
        ms = time_call(c.kernel, *c.args, iters=ITERS, **c.kwargs) * 1e3
        plain_ms = time_call(c.plain, *c.args, iters=ITERS, **c.kwargs) * 1e3
        lib = LIBRARY[c.record]
        library_ms = (time_call(lib, *c.args, iters=ITERS) * 1e3
                      if lib is not None else None)
        # through the registry, as a user calls it; a few calls will do
        # where each takes a millisecond or more
        call = c.kernel if c.record == SLAB else get_kernel(c.record)
        host_ms = enqueue_ms(call, c.args, c.kwargs,
                             3 if ms >= LONG_CALL_S * 1e3 else ITERS)
        moved = sum(x.nbytes for x in c.args if isinstance(x, torch.Tensor))
        moved += outs[c.label].nbytes
        if c.record == SLAB:
            moved += basis.exponents.nbytes + basis.coefficients.nbytes
        t_bytes, t_ops = moved / bw * 1e3, c.least_flops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        gflops = c.flops / ms / 1e6
        if c.record in ("minibude.fasten",):
            fom = f"{gflops:.0f} GFLOP/s by Eq. 3"
        elif c.record.startswith("hartree_fock"):
            fom = f"wall clock, {gflops:.0f} GFLOP/s by 120 N^4 G^4"
        else:
            gbs = get_kernel(c.record).figure_of_merit(
                ms / 1e3, *c.args)["gbytes_per_s"]
            fom = (f"{gbs:.0f} GB/s by Eq. "
                   f"{1 if c.record == 'stencil7' else 2}")
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{c.label}: {ms:.4f} ms ({fom}, {bound_ms / ms:.1%} of the "
              f"{bound_ms:.4f} ms bound), plain {plain_ms:.4f} ms, library "
              f"{lib_txt}, host enqueue {host_ms:.4f} ms a call")
        measured[c.label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "gflops_per_s": gflops,
            "max_abs_err": errs[c.label]}

    records, terms, slab_term = [], [], None
    for name in RECORDS:
        mine = [c for c in cases if c.record == name]
        timed = [c for c in mine if c.label in measured]
        first = measured[timed[0].label]
        rec = {"name": name, "route": "cuda" if name == SLAB
               else get_kernel(name).native,
               "source": SOURCE[name], "replaces": REPLACES[name],
               "launches": launches[name],
               "max_abs_err": max(errs[c.label] for c in mine)}
        rec.update({key: first[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        if len(timed) > 1:
            # every timed shape of a record with more than one
            rec["cases"] = [dict(case=c.label, **measured[c.label])
                            for c in timed]
        records.append(rec)
        term = Efficiency(kind, name, 1.0 / rec["ms"], 1.0 / rec["plain_ms"])
        if name == SLAB:
            slab_term = term
        else:
            terms.append(term)

    # ---- 5. Eq. 4 ------------------------------------------------------
    for t in terms:
        print(f"Eq.4 e_i {t.case}: {t.e:.3f} (torch baseline)")
    print(f"Eq.4 Phi-bar over {len(terms)} kernels: {phi_bar(terms):.3f}")
    print(f"e_i {SLAB}: {slab_term.e:.3f} (torch baseline; the "
          f"Hartree-Fock kernel again, so not in Phi-bar)")
    print(f"whole run: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
