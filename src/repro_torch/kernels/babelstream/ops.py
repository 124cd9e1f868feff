"""Registry entries for BabelStream (paper Eq. 2 figure of merit).

Two backends per op, both taking flat 1-D tensors: ``torch`` (the oracle,
``ref.py``) and ``triton`` (the hand-written kernel wrappers of
``kernel.py``, the default for CUDA tensors).
"""

from __future__ import annotations

from repro_torch.core.metrics import babelstream_bytes
from repro_torch.core.portable import register_kernel, triton_probe
from repro_torch.kernels.babelstream import kernel as K
from repro_torch.kernels.babelstream import ref

OPS = ("copy", "mul", "add", "triad", "dot")


def _bytes_model_factory(op):
    def model(*arrays, **kw):
        return babelstream_bytes(op, arrays[0].numel(),
                                 arrays[0].element_size())
    return model


for _op in OPS:
    _k = register_kernel(
        f"babelstream.{_op}", native="triton",
        bytes_model=_bytes_model_factory(_op),
        doc=f"BabelStream {_op} (paper Eq. 2 FoM)")
    _k.add_backend("torch", getattr(ref, _op))
    _k.add_backend("triton", getattr(K, _op), probe=triton_probe)
    # the tail is masked, so every point is valid for every length
    _k.declare_tunables("triton", block=K.BLOCK_GRID,
                        num_warps=K.NUM_WARPS_GRID)
    # streaming kernels by construction: O(1) flops per byte
    _k.declare_roofline_contract(("torch", "triton"), bound="memory")
