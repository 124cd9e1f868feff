"""The paper's four science workloads end to end, on the PyTorch port.

    PYTHONPATH=src python examples/torch_science_kernels.py           # GPU
    PYTHONPATH=src python examples/torch_science_kernels.py --device cpu

The port's counterpart of ``examples/science_kernels.py``: each proxy app
(the seven-point stencil, BabelStream triad and dot, miniBUDE, the
Hartree-Fock Fock build) runs through the portable registry on its
``torch`` oracle and its hand-written Hopper backend (``cuda`` or
``triton``), with the paper's figure of merit for each, and Phi-bar (Eq. 4)
over them.  The sizes are the reference example's small ones; the paper's
sizes are ``chip_smoke.py``'s.  On the CPU the hand-written backends do not
run: each says why (its availability probe), and Phi-bar is not measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.kernels  # noqa: F401  (registers the kernels)
from repro_torch.core import (Efficiency, babelstream_bytes, get_kernel,
                              minibude_ops, phi_bar,
                              stencil7_effective_bytes)
from repro_torch.kernels.hartree_fock import ref as hf_ref
from repro_torch.kernels.minibude.ops import make_deck


def run(name: str, args, device: torch.device, fom, terms) -> None:
    """Time ``name`` on its oracle and its hand-written backend (where it
    runs here) and print the figure of merit ``fom(seconds)``."""
    k = get_kernel(name)
    t_x = k.time_backend(*args, backend="torch")
    line = f"{name:20s} torch {t_x * 1e3:8.3f} ms ({fom(t_x)})"
    reason = k.backend(k.native).unavailable_reason()
    if reason is None and device.type != "cuda":
        reason = f"the {k.native} kernel runs on CUDA tensors"
    if reason is None:
        k.validate(*args, backend=k.native)
        t_p = k.time_backend(*args, backend=k.native)
        line += f"  {k.native} {t_p * 1e3:8.3f} ms ({fom(t_p)}), validated"
        terms.append(Efficiency(str(device), name, 1 / t_p, 1 / t_x))
    else:
        line += f"  {k.native}: not run ({reason})"
    print(line)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    terms = []

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    # seven-point stencil (Eq. 1)
    run("stencil7", (tensor(64, 64, 128),), device,
        lambda t: f"{stencil7_effective_bytes(64, 4) / t / 1e9:.2f} GB/s eff",
        terms)
    # BabelStream (Eq. 2)
    n = 1 << 20
    a, b = tensor(n), tensor(n)
    for op in ("triad", "dot"):
        run(f"babelstream.{op}", (a, b), device,
            lambda t, op=op: f"{babelstream_bytes(op, n, 4) / t / 1e9:.2f} "
                             f"GB/s", terms)
    # miniBUDE (Eq. 3)
    deck = make_deck(natpro=128, natlig=8, nposes=1024, seed=0, device=device)
    run("minibude.fasten", deck, device,
        lambda t: f"{minibude_ops(128, 8, 128, 1024) / t / 1e9:.2f} GFLOP/s",
        terms)
    # Hartree-Fock (Table 4: wall clock)
    run("hartree_fock.twoel", (hf_ref.helium_lattice(16, device=device),
                               hf_ref.initial_density(16, device=device)),
        device, lambda t: "wall clock", terms)

    if terms:
        print(f"\nPhi-bar across workloads on {device} (Eq. 4): "
              f"{phi_bar(terms):.3f}")
    else:
        print("\nPhi-bar not measured: no hand-written backend runs here")


if __name__ == "__main__":
    main()
