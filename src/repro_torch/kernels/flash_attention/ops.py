"""Registry entries of the two attention kernels the serving path runs.

  * ``attention.flash``  — prefill, kernel layout q (B, H, S, Dh) /
    k, v (B, Kv, T, Dh), optional (B, S)/(B, T) positions for the serving
    engine's left-padded prefill;
  * ``attention.decode`` — single-query ring-buffer decode in the model's
    own layout q (B, 1, H, Dh) / k, v (B, T, Kv, Dh) / q_pos (B, 1) /
    k_pos (B, T).

Backends: ``torch`` (the oracle, ``ref.py``) and ``cuda`` (the CUDA C++
kernels behind ``kernel.flash`` / ``kernel.decode``, the default for CUDA
tensors).  The flops models are the reference's
(``repro/kernels/flash_attention/ops.py``), so GFLOP/s compare across the
two packages; the least work a call needs (the pairs its mask admits) is
counted from its positions by ``chip_smoke.py``.
"""

from __future__ import annotations

from repro_torch.core.portable import cuda_probe, register_kernel
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


def _flops_model(q, k, v, *pos, causal=True, **kw):
    b, h, s, dh = q.shape
    t = k.shape[2]
    pairs = s * t * (0.5 if causal and s == t else 1.0)
    return 4.0 * b * h * pairs * dh      # QK^T + PV


def _decode_flops_model(q, k, v, *pos, **kw):
    b, s, h, dh = q.shape                # model layout, s == 1
    return 4.0 * b * h * s * k.shape[1] * dh


_k = register_kernel("attention.flash", native="cuda",
                     flops_model=_flops_model,
                     doc="flash attention (causal/windowed GQA), "
                         "online-softmax CUDA C++ kernel")
_k.add_backend("torch", ref.flash_ref)
_k.add_backend("cuda", K.flash, probe=cuda_probe)
# ragged S and T are masked in the kernel, so every tile pair is valid
_k.declare_tunables("cuda", bq=K.BQ_GRID, bk=K.BK_GRID)

_kd = register_kernel("attention.decode", native="cuda",
                      flops_model=_decode_flops_model,
                      doc="single-query GQA decode against a ring-buffer "
                          "KV cache (position-masked, leftpad -1 aware), "
                          "split over the cache (flash-decoding)")
_kd.add_backend("torch", ref.decode_ref)
_kd.add_backend("cuda", K.decode, probe=cuda_probe)
# a ragged last chunk is masked, so every bkv is valid for every T
_kd.declare_tunables("cuda", bkv=K.BKV_GRID)
# single-query decode reads the valid K/V rows once per token (AI ~1)
_kd.declare_roofline_contract(("torch", "cuda"), bound="memory")
