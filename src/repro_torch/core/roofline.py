"""Three-term roofline model of one step, from the op-cost walker.

The port of ``repro/core/roofline.py``:

    compute term    = flops            / peak_FLOP/s
    memory term     = HBM bytes        / HBM_bw
    collective term = collective bytes / link_bw

The walker (``core/op_cost.py``) counts per rank, as the reference's
``cost_analysis`` counts per partition, so the chip count enters only
through the per-chip peak rates.  The chips' data sheets are the
reference's, value for value.  ``roofline_from_cost(cost, chip)`` stands for
``roofline_from_compiled(compiled, chip)``; the port has no compiled
program, and its memory figures come from the placements and the walker.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["ChipSpec", "TPU_V5E", "NVIDIA_H100", "AMD_MI300A", "CPU_HOST",
           "CHIP_SPECS", "detect_chip", "RooflineTerms",
           "roofline_from_cost", "model_flops"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float        # FLOP/s (bf16)
    hbm_bw: float            # bytes/s
    ici_bw: float            # bytes/s per link
    hbm_bytes: float         # capacity

    @property
    def ridge(self) -> float:
        """Arithmetic intensity (FLOP/byte) at the compute/memory knee."""
        return self.peak_flops / self.hbm_bw


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops=197e12,      # 197 TFLOP/s bf16
    hbm_bw=819e9,           # 819 GB/s
    ici_bw=50e9,            # ~50 GB/s/link
    hbm_bytes=16 * 2 ** 30,
)

# The paper's two GPU targets (Table: H100 PCIe/SXM and MI300A APU).
NVIDIA_H100 = ChipSpec(
    name="nvidia-h100",
    peak_flops=989e12,      # 989 TFLOP/s bf16 dense (SXM)
    hbm_bw=3.35e12,         # HBM3
    ici_bw=450e9,           # NVLink per direction
    hbm_bytes=80 * 2 ** 30,
)

AMD_MI300A = ChipSpec(
    name="amd-mi300a",
    peak_flops=981e12,      # 980.6 TFLOP/s bf16
    hbm_bw=5.3e12,          # unified HBM3
    ici_bw=128e9,           # Infinity Fabric link
    hbm_bytes=128 * 2 ** 30,
)

# Calibration floor for hosts without an accelerator (CI, laptops): a
# vectorized server core-complex, its ridge in the same decade as the
# real chips'.
CPU_HOST = ChipSpec(
    name="cpu-host",
    peak_flops=5e11,
    hbm_bw=3e10,
    ici_bw=1e10,
    hbm_bytes=16 * 2 ** 30,
)

CHIP_SPECS: Dict[str, ChipSpec] = {
    c.name: c for c in (TPU_V5E, NVIDIA_H100, AMD_MI300A, CPU_HOST)
}


def detect_chip(platform: Optional[str] = None,
                device_kind: Optional[str] = None) -> ChipSpec:
    """The ChipSpec of explicit platform/device-kind strings, or, with no
    arguments, of this process's first CUDA device (``torch.cuda``).

    TPU platforms get the v5e spec, GPU platforms are split H100 vs
    MI300A on the device-kind string, and everything else (a host without
    a card) falls back to ``CPU_HOST``.
    """
    if platform is None:
        try:
            import torch
            if not torch.cuda.is_available():
                return CPU_HOST
            platform = "rocm" if torch.version.hip else "gpu"
            device_kind = torch.cuda.get_device_name()
        except Exception:
            return CPU_HOST
    platform = (platform or "").lower()
    kind = (device_kind or "").lower()
    if platform == "tpu":
        return TPU_V5E
    if platform in ("gpu", "cuda", "rocm"):
        if "mi300" in kind or "amd" in kind or platform == "rocm":
            return AMD_MI300A
        return NVIDIA_H100
    return CPU_HOST


@dataclasses.dataclass
class RooflineTerms:
    """Per-step roofline terms, in seconds, for one (arch, shape, mesh).

    Three fields keep the reference's names for the walker's own figures:
    ``xla_flops`` and ``xla_bytes`` (XLA's flat ``cost_analysis``, loop
    bodies counted once) hold the walker's one trace with every repeated
    unit at depth 1, without layer multiplicity; ``unknown_trip_loops``
    holds the repeated units the walker could not multiply.
    """

    flops: float                  # per-chip flops
    hbm_bytes: float              # per-chip bytes accessed
    collective_bytes: float       # per-chip collective payload bytes
    compute_s: float
    memory_s: float
    collective_s: float
    collectives: Dict[str, Dict[str, int]]
    # memory figures (per chip)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    # the walker's trace at depth 1 (lower bounds)
    xla_flops: float = 0.0
    xla_bytes: float = 0.0
    unknown_trip_loops: int = 0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self) | {
            "dominant": self.dominant, "bound_s": self.bound_s}


def roofline_from_cost(cost: Any, chip: ChipSpec = NVIDIA_H100, *,
                       base: Any = None, argument_bytes: int = 0,
                       output_bytes: int = 0) -> RooflineTerms:
    """RooflineTerms of a step costed by ``core/op_cost.py``.

    ``cost`` is the step's ``OpCost`` (with layer multiplicity), ``base``
    its trace at depth 1 (``with_multiplicity``'s second result; ``cost``
    itself when the step was traced whole).  Whether registry kernels were
    costed as kernels (``kernel_adjusted``) was chosen when the step was
    traced.  ``argument_bytes`` is what one rank holds of the step's
    arguments; the walker's high-water mark of the storage the step
    allocated comes on top of it as ``peak_bytes``.
    """
    from repro_torch.core.op_analysis import collective_stats
    base = cost if base is None else base
    colls = collective_stats(cost).summary()
    temp = int(cost.peak_bytes)
    return RooflineTerms(
        flops=cost.flops,
        hbm_bytes=cost.hbm_bytes,
        collective_bytes=cost.collective_bytes,
        compute_s=cost.flops / chip.peak_flops,
        memory_s=cost.hbm_bytes / chip.hbm_bw,
        collective_s=cost.collective_bytes / chip.ici_bw,
        collectives=colls,
        argument_bytes=int(argument_bytes),
        output_bytes=int(output_bytes),
        temp_bytes=temp,
        peak_bytes=int(argument_bytes) + temp,
        xla_flops=base.flops,
        xla_bytes=base.hbm_bytes,
        unknown_trip_loops=cost.unknown_trip_loops,
    )


def model_flops(n_params_active: float, tokens: float,
                kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D for training; 2·N·D for a forward/decode pass.

    For MoE, pass the *active* parameter count.
    """
    per_token = 6.0 if kind == "train" else 2.0
    return per_token * n_params_active * tokens
