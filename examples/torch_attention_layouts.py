#!/usr/bin/env python3
"""Time the port's attention kernels at the archs' shapes on the card.

    python3 examples/torch_attention_layouts.py [--seed 0] [--time-only]

Decode: the engine's step as the kernel sees it, 8 rows of a bfloat16
4096-slot cache filled to lengths drawn from the seed, as
``kernels/flash_attention/cases.py::serving_cases`` draws them, at the
(heads, kv heads, head dim) of each of the ten archs (G = H / Kv from 1 to
12) and at G = 16.  Prefill: the engine's largest prefill at granite-3-8b's
heads (one prompt left-padded to 2048 against a fresh 4096-slot cache, so
its pad rows admit no key) and whisper-tiny's non-causal attention (the
encoder's 1500 frames, and a decode step's and a 16-token prompt's
cross-attention to them).  Each case is checked against the plain version
on every row, and timed as a CUDA graph (device time) beside one
``scaled_dot_product_attention`` call on the same inputs, also a graph.
``--time-only`` skips the check, for timing an older tree's kernel: a
copy of this file placed in another tree imports that tree's
``repro_torch`` and leaves out the layouts its ``MAX_GROUP`` refuses.
``chip_smoke.py`` takes its cases at the new shapes from ``cases()``.
One JSON line a case, with the least flops and bytes of its work; it needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.portable import max_abs_err, time_graph  # noqa: E402
from repro_torch.kernels.flash_attention import cases as attn_cases  # noqa: E402,E501
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402

#: decode head layouts: (label, heads, kv heads, head dim)
LAYOUTS = (
    ("deepseek-moe-16b", 16, 16, 128), ("stablelm-1.6b", 32, 32, 64),
    ("whisper-tiny", 6, 6, 64), ("granite-3-8b", 32, 8, 128),
    ("pixtral-12b", 32, 8, 128), ("hymba-1.5b", 25, 5, 64),
    ("llama4-scout-17b-a16e", 40, 8, 128), ("deepseek-67b", 64, 8, 128),
    ("starcoder2-3b", 24, 2, 128), ("G = 16", 32, 2, 128),
)
#: the engine's settings on the card (chip_smoke.py's SERVE and trace)
SERVE = dict(num_slots=8, cache_len=4096, bucket=2048, min_prompt=64,
             max_prompt=2048, max_new=32)
#: whisper-tiny: rows, frames, heads, head dim
WHISPER = (8, 1500, 6, 64)
BF16_TOL = (2e-2, 2e-2)


@dataclasses.dataclass
class Case:
    """One kernel call with its plain version and its library call."""

    label: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Callable[[], torch.Tensor]
    flops: float        # 4 Dh a (query, key) pair the mask admits
    bytes: float        # q, o, positions, K rows admitted, V rows needed


def kv_bytes(k: torch.Tensor, admitted: torch.Tensor, t_axis: int) -> float:
    """K rows each query's mask admits, read once, and the V rows the
    output needs: the same, or every V row of a batch row that holds a
    query admitting no key (its output is the average of them all)."""
    row = k.nbytes / (k.shape[0] * k.shape[t_axis])       # one slot, all kv
    used = admitted.any(1)                                 # (B, T)
    keyless = ~admitted.any(-1).all(-1)                    # (B,)
    v_rows = torch.where(keyless[:, None], torch.ones_like(used), used)
    return float(used.sum() + v_rows.sum()) * row


def decode_case(label: str, h: int, kv: int, dh: int, seed: int,
                device) -> Case:
    drawn = attn_cases.serving_cases(seed, n_heads=h, n_kv_heads=kv,
                                     head_dim=dh, device=device,
                                     **SERVE)["attention.decode"]
    q, k, v, qp, kp = args = drawn["args"]
    mask = attn_ref.admitted(qp, kp, causal=True)          # (B, 1, T)
    return Case(
        f"decode {label}: B {q.shape[0]}, H {h}, Kv {kv} (G {h // kv}), "
        f"T {k.shape[1]}, Dh {dh}, fills {drawn['lengths']}",
        lambda: attn_kernel.decode(*args),
        lambda: attn_ref.decode_ref(*args),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True),
        attn_ops.least_flops(qp, kp, h, dh, causal=True),
        2 * q.nbytes + qp.nbytes + kp.nbytes + kv_bytes(k, mask, 1))


def serving_prefill_case(seed: int, device) -> Case:
    """granite-3-8b's largest prefill in the engine."""
    h, kv, dh = 32, 8, 128
    drawn = attn_cases.serving_cases(seed, n_heads=h, n_kv_heads=kv,
                                     head_dim=dh, device=device,
                                     **SERVE)["attention.flash"]
    q, k, v, qp, kp = args = drawn["args"]
    mask = attn_ref.admitted(qp, kp, causal=True)          # (B, S, T)
    return Case(
        f"flash causal, granite-3-8b's largest prefill: B 1, H {h}, Kv "
        f"{kv}, S {q.shape[2]} left-padded from a prompt of "
        f"{drawn['lengths'][0]}, T {k.shape[2]}, Dh {dh}",
        lambda: attn_kernel.flash(*args, causal=True),
        lambda: attn_ref.flash_ref(*args, causal=True),
        lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None], enable_gqa=True),
        attn_ops.least_flops(qp, kp, h, dh, causal=True),
        2 * q.nbytes + qp.nbytes + kp.nbytes + kv_bytes(k, mask, 2))


def whisper_cases(seed: int, device) -> List[Case]:
    """whisper-tiny's encoder self-attention and its decoder's
    cross-attention (a decode step's one query, a 16-token prompt)."""
    b, frames, h, dh = WHISPER
    g = torch.Generator(device=device).manual_seed(seed + 11)
    out = []
    for label, s in (("encoder self-attention", frames),
                     ("cross-attention, a decode step", 1),
                     ("cross-attention, a 16-token prompt", 16)):
        q = torch.randn(b, s, h, dh, generator=g, device=device) * \
            attn_cases.QK_STD
        k = torch.randn(b, frames, h, dh, generator=g, device=device) * \
            attn_cases.QK_STD
        v = torch.randn(b, frames, h, dh, generator=g, device=device)
        q, k, v = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
        qp = torch.arange(s, device=device, dtype=torch.int32).expand(b, s)
        kp = torch.arange(frames, device=device,
                          dtype=torch.int32).expand(b, frames)
        kw = {"causal": False, "k_index_aligned": label.startswith("enc")}
        mask = attn_ref.admitted(qp, kp, causal=False)
        out.append(Case(
            f"flash non-causal, {label}: B {b}, H {h}, S {s}, T {frames}, "
            f"Dh {dh}",
            lambda q=q, k=k, v=v, qp=qp, kp=kp, kw=kw: attn_kernel.flash(
                q, k, v, qp, kp, **kw),
            lambda q=q, k=k, v=v, qp=qp, kp=kp: attn_ref.flash_ref(
                q, k, v, qp, kp, causal=False),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            attn_ops.least_flops(qp, kp, h, dh, causal=False),
            2 * q.nbytes + qp.nbytes + kp.nbytes + kv_bytes(k, mask, 2)))
    return out


def cases(seed: int, device, layouts: Sequence[str] = (),
          prefill: bool = True) -> List[Case]:
    """The decode cases of the named ``layouts`` (every layout the tree's
    decode kernel takes when none is named), then with ``prefill`` the
    granite serving prefill and whisper-tiny's three shapes."""
    out = [decode_case(label, h, kv, dh, seed, device)
           for label, h, kv, dh in LAYOUTS
           if (label in layouts if layouts else
               h // kv <= attn_kernel.MAX_GROUP)]
    if prefill:
        out.append(serving_prefill_case(seed, device))
        out += whisper_cases(seed, device)
    return out


def measure(case: Case, check: bool = True, iters: int = 20
            ) -> dict[str, Any]:
    """The kernel against the plain version on every row (at BF16_TOL),
    then the kernel and the library call as CUDA graphs: device ms."""
    rec: dict[str, Any] = {"case": case.label}
    if check:
        rec["max_abs_err"] = max_abs_err(case.kernel(), case.plain(),
                                         *BF16_TOL, case.label)
    rec["graph_ms"] = time_graph(case.kernel, iters=iters) * 1e3
    rec["library_ms"] = time_graph(case.library, iters=iters) * 1e3
    rec["flops"], rec["bytes"] = case.flops, case.bytes
    return rec


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--time-only", action="store_true",
                   help="time without checking against the plain version")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device: the attention kernels run on the GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for c in cases(args.seed, dev):
        rec = measure(c, check=not args.time_only)
        rec["card"] = card
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
