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
``stream_plan`` and ``dot_plan`` mirror the launch grids below for the
static auditor, which calls the wrappers on ``meta`` tensors.
(No ``from __future__ import annotations`` here: the ``tl.constexpr``
parameter annotations stay objects, as Triton expects.)
"""

from typing import Tuple

import torch

from repro_torch.core.portable import (Launch, Tile, launch_observed,
                                       no_grad_kernel)
from repro_torch.core.telemetry import cudamon
from repro_torch.kernels.babelstream import ref

#: declared tunables of the ``triton`` backend (ops.py registers them)
BLOCK_GRID = (1024, 2048, 4096)
NUM_WARPS_GRID = (4, 8)
BLOCK = 4096
NUM_WARPS = 8

_OP_CODE = {"copy": 0, "mul": 1, "add": 2, "triad": 3}
#: flops an element of each op
_OP_FLOPS = {"copy": 0, "mul": 1, "add": 1, "triad": 2}
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


def _by_program(p, y, z):
    return (p,)


def stream_plan(op: str, x: torch.Tensor, y: torch.Tensor, *,
                block: int = BLOCK, num_warps: int = NUM_WARPS):
    """The one launch of a stream op: a program a ``block`` of elements,
    reading ``x`` (and ``y`` for add and triad) and writing ``out``."""
    n = x.numel()
    ins = [Tile("x", (n,), (block,), _by_program, x.element_size())]
    if op in ("add", "triad"):
        ins.append(Tile("y", (n,), (block,), _by_program, y.element_size()))
    return [Launch("stream_kernel", (-(-n // block), 1, 1),
                   (32 * num_warps, 1, 1),
                   outputs=(Tile("out", (n,), (block,), _by_program,
                                 x.element_size()),),
                   inputs=tuple(ins), flops=float(_OP_FLOPS[op] * n),
                   flops_dtype=str(x.dtype)[len("torch."):])]


def dot_plan(a: torch.Tensor, b: torch.Tensor, *, block: int = BLOCK,
             num_warps: int = NUM_WARPS):
    """The two launches of ``dot``: a program a ``block`` of elements,
    each writing its own partial, then one program over the partials.
    Nothing is revisited, so neither declares an accumulator."""
    n = a.numel()
    programs = -(-n // block)
    acc = str(ref.accumulator_dtype(a.dtype))[len("torch."):]
    acc_size = ref.accumulator_dtype(a.dtype).itemsize
    threads = (32 * num_warps, 1, 1)
    partials = Tile("partials", (programs,), (1,), _by_program, acc_size)
    return [
        Launch("dot_kernel", (programs, 1, 1), threads, outputs=(partials,),
               inputs=(Tile("a", (n,), (block,), _by_program,
                             a.element_size()),
                       Tile("b", (n,), (block,), _by_program,
                            b.element_size())),
               accum_dtype=acc, flops=2.0 * n, flops_dtype=acc),
        Launch("dot_kernel", (1, 1, 1), threads,
               outputs=(Tile("out", (1,), (1,), _by_program,
                             a.element_size()),),
               inputs=(Tile("partials", (programs,), (programs,),
                            _by_program, acc_size),),
               accum_dtype=acc, flops=float(programs), flops_dtype=acc)]


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
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes {_DTYPES}, not {a.dtype}")
    if a.numel() == 0 or not all(x.is_contiguous() for x in arrays):
        raise ValueError(f"{name} kernel takes non-empty contiguous tensors")
    return True


def _stream(op: str, x: torch.Tensor, y: torch.Tensor, scalar: float,
            block: int, num_warps: int) -> Tuple[torch.Tensor, bool]:
    """``op``'s output, and whether it launched (False when the static
    auditor took its plan)."""
    out = torch.empty_like(x)
    if launch_observed(f"babelstream.{op}", x.device, stream_plan, op, x, y,
                       block=block, num_warps=num_warps):
        return out, False
    kernel, _ = _kernels()
    n = x.numel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(n, block),)](
            x, y, out, n, OP=_OP_CODE[op], SCALAR=float(scalar), BLOCK=block,
            num_warps=num_warps)
    return out, True


def copy(a: torch.Tensor, *, block: int = BLOCK,
         num_warps: int = NUM_WARPS) -> torch.Tensor:
    """c = a"""
    no_grad_kernel("babelstream.copy", a)
    if not _uses_kernel("babelstream.copy", a):
        return ref.copy(a)
    out, launched = _stream("copy", a, a, 0.0, block, num_warps)
    copy.launches += launched
    return out


def mul(c: torch.Tensor, scalar: float = ref.START_SCALAR, *,
        block: int = BLOCK, num_warps: int = NUM_WARPS) -> torch.Tensor:
    """b = scalar * c"""
    no_grad_kernel("babelstream.mul", c)
    if not _uses_kernel("babelstream.mul", c):
        return ref.mul(c, scalar)
    out, launched = _stream("mul", c, c, scalar, block, num_warps)
    mul.launches += launched
    return out


def add(a: torch.Tensor, b: torch.Tensor, *, block: int = BLOCK,
        num_warps: int = NUM_WARPS) -> torch.Tensor:
    """c = a + b"""
    no_grad_kernel("babelstream.add", a, b)
    if not _uses_kernel("babelstream.add", a, b):
        return ref.add(a, b)
    out, launched = _stream("add", a, b, 0.0, block, num_warps)
    add.launches += launched
    return out


def triad(b: torch.Tensor, c: torch.Tensor, scalar: float = ref.START_SCALAR,
          *, block: int = BLOCK, num_warps: int = NUM_WARPS) -> torch.Tensor:
    """a = b + scalar * c"""
    no_grad_kernel("babelstream.triad", b, c)
    if not _uses_kernel("babelstream.triad", b, c):
        return ref.triad(b, c, scalar)
    out, launched = _stream("triad", b, c, scalar, block, num_warps)
    triad.launches += launched
    return out


def dot(a: torch.Tensor, b: torch.Tensor, *, block: int = BLOCK,
        num_warps: int = NUM_WARPS) -> torch.Tensor:
    """sum_i a[i]*b[i] as a 0-d tensor of the input dtype, accumulated in
    ``ref.accumulator_dtype`` (two launches: partials, then their sum)."""
    no_grad_kernel("babelstream.dot", a, b)
    if not _uses_kernel("babelstream.dot", a, b):
        return ref.dot(a, b)
    acc = ref.accumulator_dtype(a.dtype)
    n = a.numel()
    programs = -(-n // block)
    partials = torch.empty(programs, dtype=acc, device=a.device)
    out = torch.empty(1, dtype=a.dtype, device=a.device)
    if launch_observed("babelstream.dot", a.device, dot_plan, a, b,
                       block=block, num_warps=num_warps):
        return out[0]
    _, kernel = _kernels()
    acc_tl = tl.float64 if acc == torch.float64 else tl.float32
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
