"""BabelStream as Triton kernels written by hand for Hopper.

Replaces the Pallas TPU kernels of ``repro/kernels/babelstream/kernel.py``:
``copy_2d``, ``mul_2d``, ``add_2d`` and ``triad_2d`` (one Pallas builder,
``_elementwise_call``, with one-line bodies) become ONE elementwise kernel
with the op as a ``tl.constexpr``; ``dot_2d`` becomes a two-pass reduction.

What bounds them on the H100: bytes.  Each op does at most 2 flops per 8-12
bytes it must move (paper Eq. 2), about 1/50 of the card's float32 ridge,
so the floor is Eq.-2 bytes over the HBM rate.  What the design does about
it:

  * one pass per op, every element read once and written once; the scalar
    ``s`` is a ``tl.constexpr`` (the Mojo ``alias`` analogue), so it is an
    immediate in the instruction stream, not a load;
  * a 1-D grid of ``BLOCK``-element programs over contiguous ranges, so
    each warp's accesses coalesce into 16-byte vectors; the tail is masked,
    so any ``n`` works (the TPU's (rows, 128) tiling is gone);
  * ``dot``: the Pallas kernel carries a (1, 1) accumulator across a
    sequential grid, but Hopper runs blocks in no order.  So one reduction
    kernel runs twice: pass 1 writes one partial per program, pass 2 runs
    the same code as a single program over the partials.  No atomics, so
    the sum is the same on every run; the partials add 1/``BLOCK`` of the
    input's bytes.

The wrappers take flat 1-D tensors.  CPU tensors run the plain version in
``ref.py``; CUDA tensors launch the kernel, or raise.  Each wrapper counts
its kernel launches in ``<wrapper>.launches`` (``dot`` launches two per
call).  Triton is imported, and the kernels built, at the first launch,
which also installs the telemetry's Triton compile hook
(``core/telemetry/cudamon.py``).
(No ``from __future__ import annotations`` here: the ``tl.constexpr``
parameter annotations stay objects, as Triton expects.)
"""

import torch

from repro_torch.core.telemetry import cudamon
from repro_torch.kernels.babelstream import ref

#: declared tunables of the ``triton`` backend (ops.py registers them)
BLOCK_GRID = (1024, 2048, 4096)
NUM_WARPS_GRID = (4, 8)
BLOCK = 4096
NUM_WARPS = 8

_OP_CODE = {"copy": 0, "mul": 1, "add": 2, "triad": 3}
_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

# bound at the first launch by _kernels(); the @triton.jit bodies below
# resolve ``tl`` from these module globals
triton = tl = None
_STREAM = _DOT = None


def _kernels():
    global triton, tl, _STREAM, _DOT
    if _STREAM is not None:
        return _STREAM, _DOT
    import triton
    import triton.language as tl
    cudamon.watch_triton()

    @triton.jit
    def stream_kernel(x_ptr, y_ptr, out_ptr, n, OP: tl.constexpr,
                      SCALAR: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask)
        if OP == 0:      # copy:  c = a
            out = x
        elif OP == 1:    # mul:   b = s * c
            out = SCALAR * x
        elif OP == 2:    # add:   c = a + b
            out = x + tl.load(y_ptr + offs, mask=mask)
        else:            # triad: a = b + s * c
            out = x + SCALAR * tl.load(y_ptr + offs, mask=mask)
        tl.store(out_ptr + offs, out, mask=mask)

    @triton.jit
    def dot_kernel(x_ptr, y_ptr, out_ptr, n, chunk, HAS_Y: tl.constexpr,
                   ACC: tl.constexpr, BLOCK: tl.constexpr):
        # program p reduces [p*chunk, min((p+1)*chunk, n)) into out[p],
        # BLOCK lanes at a time, lane sums kept in ACC until one final sum
        lo = tl.program_id(0).to(tl.int64) * chunk
        hi = tl.minimum(lo + chunk, n)
        acc = tl.zeros([BLOCK], dtype=ACC)
        for start in range(lo, hi, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            mask = offs < hi
            x = tl.load(x_ptr + offs, mask=mask, other=0).to(ACC)
            if HAS_Y:
                x = x * tl.load(y_ptr + offs, mask=mask, other=0).to(ACC)
            acc += x
        total = tl.sum(acc, axis=0)
        tl.store(out_ptr + tl.program_id(0),
                 total.to(out_ptr.dtype.element_ty))

    _STREAM, _DOT = stream_kernel, dot_kernel
    return _STREAM, _DOT


def _uses_kernel(name: str, *arrays: torch.Tensor) -> bool:
    """Check the inputs; True for CUDA tensors (launch the kernel), False
    for CPU tensors (run the plain version)."""
    a = arrays[0]
    for x in arrays:
        if x.dim() != 1 or x.shape != a.shape:
            raise ValueError(f"{name} takes flat 1-D tensors of one length, "
                             f"got shapes {[tuple(t.shape) for t in arrays]}")
        if x.device != a.device or x.dtype != a.dtype:
            raise ValueError(f"{name}: inputs differ in device or dtype")
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes {_DTYPES}, not {a.dtype}")
    if a.numel() == 0 or not all(x.is_contiguous() for x in arrays):
        raise ValueError(f"{name} kernel takes non-empty contiguous tensors")
    return True


def _stream(op: str, x: torch.Tensor, y: torch.Tensor, scalar: float,
            block: int, num_warps: int) -> torch.Tensor:
    kernel, _ = _kernels()
    out = torch.empty_like(x)
    n = x.numel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(n, block),)](
            x, y, out, n, OP=_OP_CODE[op], SCALAR=float(scalar), BLOCK=block,
            num_warps=num_warps)
    return out


def copy(a: torch.Tensor, *, block: int = BLOCK,
         num_warps: int = NUM_WARPS) -> torch.Tensor:
    """c = a"""
    if not _uses_kernel("babelstream.copy", a):
        return ref.copy(a)
    out = _stream("copy", a, a, 0.0, block, num_warps)
    copy.launches += 1
    return out


def mul(c: torch.Tensor, scalar: float = ref.START_SCALAR, *,
        block: int = BLOCK, num_warps: int = NUM_WARPS) -> torch.Tensor:
    """b = scalar * c"""
    if not _uses_kernel("babelstream.mul", c):
        return ref.mul(c, scalar)
    out = _stream("mul", c, c, scalar, block, num_warps)
    mul.launches += 1
    return out


def add(a: torch.Tensor, b: torch.Tensor, *, block: int = BLOCK,
        num_warps: int = NUM_WARPS) -> torch.Tensor:
    """c = a + b"""
    if not _uses_kernel("babelstream.add", a, b):
        return ref.add(a, b)
    out = _stream("add", a, b, 0.0, block, num_warps)
    add.launches += 1
    return out


def triad(b: torch.Tensor, c: torch.Tensor, scalar: float = ref.START_SCALAR,
          *, block: int = BLOCK, num_warps: int = NUM_WARPS) -> torch.Tensor:
    """a = b + scalar * c"""
    if not _uses_kernel("babelstream.triad", b, c):
        return ref.triad(b, c, scalar)
    out = _stream("triad", b, c, scalar, block, num_warps)
    triad.launches += 1
    return out


def dot(a: torch.Tensor, b: torch.Tensor, *, block: int = BLOCK,
        num_warps: int = NUM_WARPS) -> torch.Tensor:
    """sum_i a[i]*b[i] as a 0-d tensor of the input dtype, accumulated in
    ``ref.accumulator_dtype`` (two launches: partials, then their sum)."""
    if not _uses_kernel("babelstream.dot", a, b):
        return ref.dot(a, b)
    _, kernel = _kernels()
    acc = ref.accumulator_dtype(a.dtype)
    acc_tl = tl.float64 if acc == torch.float64 else tl.float32
    n = a.numel()
    programs = triton.cdiv(n, block)
    partials = torch.empty(programs, dtype=acc, device=a.device)
    out = torch.empty(1, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        kernel[(programs,)](a, b, partials, n, block, HAS_Y=True,
                            ACC=acc_tl, BLOCK=block, num_warps=num_warps)
        dot.launches += 1
        kernel[(1,)](partials, partials, out, programs, programs,
                     HAS_Y=False, ACC=acc_tl, BLOCK=block,
                     num_warps=num_warps)
        dot.launches += 1
    return out[0]


for _wrapper in (copy, mul, add, triad, dot):
    _wrapper.launches = 0
