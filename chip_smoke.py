#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

The paper's portable-kernel workflow (``examples/quickstart.py``) at the
paper's sizes: BabelStream over 2^25 float32 elements (128 MiB an array)
and the seven-point stencil over a 512^3 float32 volume (512 MiB).

  1. build:     nvcc for every ``csrc/*.cu`` (all started together), then
                each kernel once on its small conformance case on the card,
                which compiles the Triton kernels and checks them;
  2. main path: each kernel through ``get_kernel(name)`` with its default
                backend on CUDA tensors, with every launch count set to 0
                just before and read just after; the default must be the
                hand-written backend and each kernel must have launched;
  3. check:     each kernel against its plain PyTorch version on the same
                inputs at the port's ORACLE_TOL; the stencil's boundary
                faces are zero and nothing is NaN;
  4. timing:    CUDA-event medians of the kernel, its plain version and the
                one PyTorch call computing the same function (where there
                is one), beside the least time the card could take, and
                the host's time to enqueue one call through the registry;
  5. Eq. 4:     e_i = plain time / kernel time and their mean, Phi-bar.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  With no CUDA
device, or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import _build  # noqa: E402
import repro_torch.kernels  # noqa: E402,F401  (registers the kernels)
from repro_torch.core import Efficiency, get_kernel, phi_bar, time_call  # noqa: E402
from repro_torch.core import conformance  # noqa: E402
from repro_torch.kernels.babelstream.ref import START_SCALAR  # noqa: E402
from repro_torch.kernels.stencil7.ref import default_coefficients  # noqa: E402

STREAM_N = 1 << 25     # the paper's BabelStream size
STENCIL_L = 512        # the paper's smaller stencil volume
ITERS = 20             # timed calls per median
STREAM_OPS = ("copy", "mul", "add", "triad", "dot")
KERNELS = tuple(f"babelstream.{op}" for op in STREAM_OPS) + ("stencil7",)

SOURCE = {name: "src/repro_torch/kernels/babelstream/kernel.py"
          for name in KERNELS[:5]}
SOURCE["stencil7"] = "src/repro_torch/csrc/stencil7.cu"
REPLACES = {
    "babelstream.copy": "src/repro/kernels/babelstream/kernel.py:99",
    "babelstream.mul": "src/repro/kernels/babelstream/kernel.py:105",
    "babelstream.add": "src/repro/kernels/babelstream/kernel.py:113",
    "babelstream.triad": "src/repro/kernels/babelstream/kernel.py:119",
    "babelstream.dot": "src/repro/kernels/babelstream/kernel.py:126",
    "stencil7": "src/repro/kernels/stencil7/kernel.py:93",
}

# one PyTorch call computing the same function: the yardstick, never
# called by the port itself
LIBRARY = {
    "babelstream.copy": torch.clone,
    "babelstream.mul": lambda c: torch.mul(c, START_SCALAR),
    "babelstream.add": torch.add,
    "babelstream.triad": lambda b, c: torch.add(b, c, alpha=START_SCALAR),
    "babelstream.dot": torch.dot,
    "stencil7": None,
}

# data-sheet rates (dense, no sparsity): HBM bytes/s and float32 FLOP/s
# outside the tensor cores; the first name that occurs in the device name
DATASHEET = (
    ("H100 PCIe", "H100 PCIe", 2.0e12, 51e12),
    ("H100", "H100 SXM", 3.35e12, 67e12),
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def datasheet(kind: str):
    for key, label, bw, flops in DATASHEET:
        if key in kind:
            return label, bw, flops
    fail(f"no data-sheet rates for {kind!r}")


def flops(name: str, args) -> float:
    """Floating-point operations the function does on these inputs."""
    if name == "stencil7":
        nz, ny, nx = args[0].shape
        return 10.0 * (nz - 2) * (ny - 2) * (nx - 2)
    per_elem = {"copy": 0, "mul": 1, "add": 1, "triad": 2, "dot": 2}
    return float(per_elem[name.split(".")[1]] * args[0].numel())


def enqueue_ms(fn, *args) -> float:
    """Host milliseconds to enqueue one call, averaged over ITERS calls:
    the registry's and the wrapper's own cost per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn(*args)
    host = (time.perf_counter() - t0) / ITERS * 1e3
    torch.cuda.synchronize()
    return host


def main_path(inputs):
    """Every kernel once through the registry's default backend."""
    outs = {}
    for name in KERNELS:
        k = get_kernel(name)
        args = inputs[name]
        chosen = k.default_backend(*args)
        if chosen != k.native:
            fail(f"{name}: default backend on CUDA tensors is {chosen!r}, "
                 f"not the hand-written {k.native!r}")
        outs[name] = k(*args)
    torch.cuda.synchronize()
    return outs


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

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {name}: {'; '.join(ptxas)}")
    for name in KERNELS:
        k = get_kernel(name)
        err = conformance.check_backend(name, k.native, device=dev)
        print(f"conformance case {name}[{k.native}] max abs err {err:.3g}")
    print(f"build + small cases: {time.perf_counter() - t0:.1f} s")

    # ---- inputs: made on the card from the seed ------------------------
    g = torch.Generator(device=dev).manual_seed(args.seed)
    a, b, c = (torch.randn(STREAM_N, generator=g, device=dev)
               for _ in range(3))
    u = torch.randn(STENCIL_L, STENCIL_L, STENCIL_L, generator=g, device=dev)
    coeffs = default_coefficients()
    inputs = {
        "babelstream.copy": (a,),
        "babelstream.mul": (c,),
        "babelstream.add": (a, b),
        "babelstream.triad": (b, c),
        "babelstream.dot": (a, b),
        "stencil7": (u, *coeffs),
    }
    wrappers = {name: get_kernel(name).backend(get_kernel(name).native).fn
                for name in KERNELS}

    # ---- 2. main path, with the launch counts --------------------------
    for w in wrappers.values():
        w.launches = 0
    outs = main_path(inputs)
    launches = {name: wrappers[name].launches for name in KERNELS}
    print(f"main path launches: {launches}")
    for name, count in launches.items():
        if count < 1:
            fail(f"{name}: the main path never launched its kernel")

    # ---- 3. check ------------------------------------------------------
    f = outs["stencil7"]
    faces = (f[0], f[-1], f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1])
    if any(bool(face.ne(0).any()) for face in faces):
        fail("stencil7: a boundary face is not zero")
    for name, out in outs.items():
        if not bool(torch.isfinite(out).all()):
            fail(f"{name}: non-finite values in the main path's output")
    expect_shape = {name: inputs[name][0].shape for name in KERNELS}
    expect_shape["babelstream.dot"] = torch.Size([])
    for name, out in outs.items():
        if out.shape != expect_shape[name] or out.dtype != torch.float32:
            fail(f"{name}: output {out.dtype}{tuple(out.shape)}")
    max_err = {}
    for name in KERNELS:
        k = get_kernel(name)
        max_err[name] = k.validate(*inputs[name], backend=k.native)
        print(f"{name}[{k.native}] vs torch at ORACLE_TOL "
              f"{conformance.ORACLE_TOL[name]}: max abs err "
              f"{max_err[name]:.3g}")

    # ---- 4. timing -----------------------------------------------------
    records, terms = [], []
    for name in KERNELS:
        k = get_kernel(name)
        xs = inputs[name]
        ms = k.time_backend(*xs, backend=k.native, iters=ITERS) * 1e3
        plain_ms = k.time_backend(*xs, backend="torch", iters=ITERS) * 1e3
        lib = LIBRARY[name]
        library_ms = (time_call(lib, *xs, iters=ITERS) * 1e3
                      if lib is not None else None)
        host_ms = enqueue_ms(k, *xs)
        moved = sum(x.nbytes for x in xs if isinstance(x, torch.Tensor)) \
            + outs[name].nbytes
        t_bytes, t_ops = moved / bw * 1e3, flops(name, xs) / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        fom = k.figure_of_merit(ms / 1e3, *xs)["gbytes_per_s"]
        lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{name}: {ms:.4f} ms ({fom:.0f} GB/s by Eq. "
              f"{1 if name == 'stencil7' else 2}, {bound_ms / ms:.1%} of the "
              f"{bound_ms:.4f} ms bound), plain {plain_ms:.4f} ms, library "
              f"{lib_txt}, host enqueue {host_ms:.4f} ms a call")
        records.append({
            "name": name, "route": k.native, "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        })
        terms.append(Efficiency(kind, name, 1.0 / ms, 1.0 / plain_ms))

    # ---- 5. Eq. 4 ------------------------------------------------------
    for t in terms:
        print(f"Eq.4 e_i {t.case}: {t.e:.3f} (torch baseline)")
    print(f"Eq.4 Phi-bar over {len(terms)} kernels: {phi_bar(terms):.3f}")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
