"""Registry entry for the seven-point stencil (paper Eq. 1 figure of merit).

Backends: ``torch`` (the oracle, ``ref.py``) and ``cuda`` (the CUDA C++
kernel behind ``kernel.laplacian``, the default for CUDA tensors).  Both
take ``(u, invhx2=1.0, invhy2=1.0, invhz2=1.0, invhxyz2=-6.0)``.
"""

from __future__ import annotations

from repro_torch.core.metrics import stencil7_effective_bytes
from repro_torch.core.portable import cuda_probe, register_kernel
from repro_torch.kernels.stencil7 import kernel as K
from repro_torch.kernels.stencil7 import ref


def laplacian_torch(u, invhx2=1.0, invhy2=1.0, invhz2=1.0, invhxyz2=-6.0):
    return ref.laplacian(u, invhx2, invhy2, invhz2, invhxyz2)


def _bytes_model(u, *args, **kw):
    # paper Eq. 1, assuming the cubic L^3 grid of the study
    return stencil7_effective_bytes(u.shape[0], u.element_size())


_k = register_kernel("stencil7", native="cuda", bytes_model=_bytes_model,
                     doc="seven-point Laplacian stencil (paper Eq. 1 FoM)")
_k.add_backend("torch", laplacian_torch)
_k.add_backend("cuda", K.laplacian, probe=cuda_probe)
_k.declare_tunables("cuda", block_x=K.BLOCK_X_GRID, block_y=K.BLOCK_Y_GRID,
                    zchunk=K.ZCHUNK_GRID)
# ~1.25 flop/byte at fp32: memory-bound on the H100
_k.declare_roofline_contract(("torch", "cuda"), bound="memory")
