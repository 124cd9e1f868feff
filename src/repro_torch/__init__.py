"""repro_torch: the portable-kernel workflow on PyTorch and NVIDIA Hopper.

The PyTorch port of ``repro`` (the JAX/Pallas reproduction of "Mojo:
MLIR-Based Performance-Portable HPC Science Kernels on GPUs for the Python
Ecosystem", SC-W'25).  It keeps ``repro``'s subpackage names; every Pallas
TPU kernel becomes a kernel written by hand for Hopper (CUDA C++ under
``csrc/``, or Triton), registered beside a plain PyTorch oracle.

The package imports torch, numpy and the stdlib only — never jax, never
``repro``.  Entry points run on the device of the tensors they are given:
CUDA tensors launch the hand-written kernels, CPU tensors run the plain
PyTorch versions.
"""

__version__ = "0.1.0"
