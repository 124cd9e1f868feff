"""Registry entry of the RWKV6 chunked WKV (``rwkv6.wkv``).

Both backends take ``(r, k, v, w_logdecay, u)`` — r/k/v/w (B, H, S, Dh)
float32, u (H, Dh) — start from a zero state and return y (B, H, S, Dv),
as the reference's registry cell does:

  * ``torch`` — ``ref.wkv_serial``'s y, the exact recurrence: the oracle,
    as the reference's ``xla`` backend is;
  * ``cuda``  — the CUDA C++ kernel behind ``kernel.wkv``, the default for
    CUDA tensors.

The flops model is the reference's (``repro/kernels/rwkv6/ops.py``), so
GFLOP/s compare across the two packages.  The model calls ``kernel.wkv``
itself, with a state in and out (``models/rwkv.py``).
"""

from __future__ import annotations

from repro_torch.core.portable import cuda_probe, register_kernel
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ref


def wkv_torch(r, k, v, w_logdecay, u):
    y, _ = ref.wkv_serial(r, k, v, w_logdecay, u)
    return y


def wkv_cuda(r, k, v, w_logdecay, u, *, chunk=K.CHUNK):
    y, _ = K.wkv(r, k, v, w_logdecay, u, chunk=chunk)
    return y


def _flops_model(r, k, v, w_logdecay, u, chunk=K.CHUNK, **kw):
    b, h, s, dh = r.shape
    dv = v.shape[-1]
    intra = s * chunk * (dh + dv)          # A build + A@v per token row
    inter = (s // chunk) * 2 * dh * dv * chunk
    return float(b * h * (intra + inter)) * 2.0


def least_flops(b: int, h: int, s: int, dh: int, dv: int) -> float:
    """The fewest flops the WKV needs, whatever the chunk: each token reads
    y from the state (Dh Dv multiply-adds) and adds its rank-one term to it
    (Dh Dv more), plus its bonus r . (u * k) v (3 Dh + 2 Dv).  The serial
    recurrence does this and a decay multiply a state element; the chunked
    form this and its strict triangle, ~S C (Dh + Dv) more.  The model
    above charges the full C x C square and grows with the chunk."""
    return float(b * h * s) * (4.0 * dh * dv + 3.0 * dh + 2.0 * dv)


_k = register_kernel("rwkv6.wkv", native="cuda", flops_model=_flops_model,
                     doc="RWKV6 chunked WKV scan (data-dependent decay), "
                         "CUDA C++ kernel")
_k.add_backend("torch", wkv_torch)
_k.add_backend("cuda", wkv_cuda, probe=cuda_probe)
# a ragged last chunk is masked in the kernel, so every chunk fits every S
_k.declare_tunables("cuda", chunk=K.CHUNK_GRID)
# the serial oracle streams the state every step (AI ~8): memory-bound
_k.declare_roofline_contract("torch", bound="memory")
