"""The port's hand-written kernels on the GPU, against their plain versions.

Every test here needs a CUDA device: it is marked ``gpu`` and skips with a
reason elsewhere (a CUDA kernel has no interpret mode).  This file imports
torch and the port only — no jax — so it runs on a GPU host without the
JAX package's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_on_card.py -q

The CPU tests that hold the port against the JAX package are the other
``tests/test_torch_*.py`` files.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core import (Efficiency, conformance, get_kernel, phi_bar,
                              time_call, tuning)
from repro_torch.distributed import collectives
from repro_torch.core.portable import (CALLS_PER_SAMPLE, LONG_CALL_S,
                                       LONG_CALL_SAMPLES, max_abs_err,
                                       time_graph)
from repro_torch.kernels.babelstream import kernel as stream_kernel
from repro_torch.kernels.flash_attention import cases as attn_cases
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.babelstream import ref as stream_ref
from repro_torch.kernels.hartree_fock import kernel as hf_kernel
from repro_torch.kernels.hartree_fock import ref as hf_ref
from repro_torch.kernels.minibude import kernel as bude_kernel
from repro_torch.kernels.minibude import ops as bude_ops
from repro_torch.kernels.minibude import ref as bude_ref
from repro_torch.kernels.rwkv6 import cases as wkv_cases
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.kernels.stencil7 import kernel as stencil_kernel
from repro_torch.kernels.stencil7 import ref as stencil_ref
from repro_torch.models import attention
from repro_torch.models import rwkv as rwkv_model
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.models.transformer import forward, init_params, tree_map
from repro_torch.optim.adamw import AdamWConfig, leaves
from repro_torch.training import train_step as TS
from repro_torch.serving import ServingEngine
from repro_torch.serving import portable as serving_portable
from repro_torch.training import serve_step as SS

OPS = ("copy", "mul", "add", "triad", "dot")
PORTED = ("attention.decode", "attention.flash", "babelstream.add",
          "babelstream.copy", "babelstream.dot", "babelstream.mul",
          "babelstream.triad", "hartree_fock.twoel", "minibude.fasten",
          "rwkv6.wkv", "stencil7")
STENCIL_RTOL, STENCIL_ATOL = conformance.ORACLE_TOL["stencil7"]
BUDE_RTOL, BUDE_ATOL = conformance.ORACLE_TOL["minibude.fasten"]
HF_RTOL, HF_ATOL = conformance.ORACLE_TOL["hartree_fock.twoel"]
#: attention against its plain version: float32 at the reference's
#: ORACLE_TOL, bfloat16 at the reference's own bf16 tolerance
#: (tests/test_kernels_lm.py::test_flash_bf16)
ATTN_TOL = {torch.float32: conformance.ORACLE_TOL["attention.flash"],
            torch.bfloat16: (2e-2, 2e-2)}
WKV_RTOL, WKV_ATOL = conformance.ORACLE_TOL["rwkv6.wkv"]
#: the kernels of a WKV call of S > 1 (csrc/rwkv6.cu)
WKV_CHUNK_KERNELS = ("wkv_delta_kernel", "wkv_scan_kernel",
                     "wkv_output_kernel")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda() -> torch.device:
    # decided here, never at import: every xdist worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the GPU")
    return torch.device("cuda", 0)


def _faces(f):
    return (f[0], f[-1], f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1])


@pytest.mark.parametrize("op", OPS)
def test_triton_kernel_matches_plain(cuda, op):
    rtol, atol = conformance.ORACLE_TOL[f"babelstream.{op}"]
    wrapper = getattr(stream_kernel, op)
    g = torch.Generator(device=cuda).manual_seed(0)
    nargs = 1 if op in ("copy", "mul") else 2
    for n in (1, 1000, 4096, (1 << 17) + 3):  # masked tails included
        xs = [torch.randn(n, generator=g, device=cuda) for _ in range(nargs)]
        want = getattr(stream_ref, op)(*xs)
        for block in stream_kernel.BLOCK_GRID:
            for num_warps in stream_kernel.NUM_WARPS_GRID:
                before = wrapper.launches
                got = wrapper(*xs, block=block, num_warps=num_warps)
                assert wrapper.launches > before
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_triton_dot_is_deterministic_and_accumulates_wide(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    a, b = (torch.randn(1 << 20, generator=g, device=cuda) for _ in range(2))
    first = stream_kernel.dot(a, b)
    assert all(torch.equal(first, stream_kernel.dot(a, b)) for _ in range(5))
    for dtype in (torch.bfloat16, torch.float64):
        x, y = a.to(dtype), b.to(dtype)
        got = stream_kernel.dot(x, y)
        assert got.dtype == dtype and got.dim() == 0
        np.testing.assert_allclose(float(got), float(stream_ref.dot(x, y)),
                                   rtol=1e-2)


def test_stencil_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    coeffs = stencil_ref.default_coefficients(1.0, 2.0, 3.0)
    space = get_kernel("stencil7").tunable_space("cuda")
    for shape in ((3, 3, 3), (8, 64, 128), (17, 33, 65), (70, 40, 300)):
        u = torch.randn(shape, generator=g, device=cuda)
        want = stencil_ref.laplacian(u, *coeffs)
        for p in space.points():
            before = stencil_kernel.laplacian.launches
            got = stencil_kernel.laplacian(u, *coeffs, **p)
            torch.cuda.synchronize()
            assert stencil_kernel.laplacian.launches == before + 1
            assert all(bool((face == 0).all()) for face in _faces(got))
            torch.testing.assert_close(got, want, rtol=STENCIL_RTOL,
                                       atol=STENCIL_ATOL)


def test_stencil_kernel_rejects_what_it_cannot_run(cuda):
    lap = stencil_kernel.laplacian
    with pytest.raises(TypeError, match="float32"):
        lap(torch.zeros(4, 4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lap(torch.zeros(4, 4, 8, device=cuda).transpose(0, 2))
    with pytest.raises(ValueError, match="launch shape"):
        lap(torch.zeros(4, 4, 4, device=cuda), block_x=48)


def test_minibude_kernel_matches_plain(cuda):
    """Every (ppwi, split) point on ragged pose counts (none a multiple of
    a block's poses), natpro 97 (no multiple of a split), natpro 1 (every
    split but one slice empty) and natpro 1100, whose slices at every
    split are longer than a block stages at a time (1024 / split rows), so
    they run in chunks, the last one ragged."""
    space = get_kernel("minibude.fasten").tunable_space("cuda")
    for natpro, natlig, nposes in ((16, 4, 1), (64, 8, 1000),
                                   (96, 16, 4099), (97, 16, 300),
                                   (1, 4, 200), (1100, 6, 300)):
        deck = bude_ops.make_deck(natpro, natlig, nposes, seed=3,
                                  device=cuda)
        want = bude_ref.fasten(*deck)
        for p in space.points():
            before = bude_kernel.fasten.launches
            got = bude_kernel.fasten(*deck, **p)
            torch.cuda.synchronize()
            assert bude_kernel.fasten.launches == before + 1
            assert got.shape == (nposes,)
            torch.testing.assert_close(got, want, rtol=BUDE_RTOL,
                                       atol=BUDE_ATOL)


@pytest.mark.parametrize("natpro", [97, 1100])
def test_minibude_kernel_is_deterministic(cuda, natpro):
    """No atomics in the combine: two calls give the same bits, at every
    point, with one chunk a slice (natpro 97) and several (1100), and a
    CUDA graph's replay gives the eager call's."""
    deck = bude_ops.make_deck(natpro, 16, 3000, seed=5, device=cuda)
    for p in get_kernel("minibude.fasten").tunable_space("cuda").points():
        first = bude_kernel.fasten(*deck, **p)
        assert torch.equal(first, bude_kernel.fasten(*deck, **p)), p
    first = bude_kernel.fasten(*deck)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = bude_kernel.fasten(*deck)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)


def test_hartree_fock_kernel_matches_plain(cuda):
    """Every tunable point at N 8, 12, 16 and 36 (666 canonical pairs at
    36: no multiple of the tile edge), STO-3G and STO-6G; then slab
    covers whose edges fall inside a pair tile, each slab against its plain
    slab and each cover summing to the full build."""
    space = get_kernel("hartree_fock.twoel").tunable_space("cuda")
    for n in (8, 12, 16, 36):
        for ngauss in (3, 6):
            pos = hf_ref.helium_lattice(n, device=cuda)
            dens = hf_ref.initial_density(n, device=cuda)
            basis = hf_ref.sto_basis(ngauss, device=cuda)
            pos4 = hf_kernel.pad4(pos)
            want = hf_ref.fock_build(pos, dens, basis)
            for p in space.points():
                before = hf_kernel.twoel.launches
                got = hf_kernel.twoel(pos4, dens, basis, **p)
                torch.cuda.synchronize()
                assert hf_kernel.twoel.launches == before + 1
                torch.testing.assert_close(got, want, rtol=HF_RTOL,
                                           atol=HF_ATOL)
            # uneven covers, their slab pairs no multiple of a tile edge
            # (3 n - 3 pairs for a slab of 3 atoms): the ket tiles' last is
            # part full
            for cover in (((0, 1), (1, n // 2 - 1), (n // 2, n - n // 2)),
                          ((0, 3), (3, n - 5), (n - 2, 2))):
                total = torch.zeros_like(want)
                for l0, nl in cover:
                    plain = hf_ref.fock_build_slab(pos, dens, basis, l0, nl)
                    for p in space.points():
                        before = hf_kernel.twoel_slab.launches
                        part = hf_kernel.twoel_slab(pos4, dens, basis, l0, nl,
                                                    **p)
                        assert hf_kernel.twoel_slab.launches == before + 1
                        torch.testing.assert_close(part, plain, rtol=HF_RTOL,
                                                   atol=HF_ATOL)
                    total += part
                torch.testing.assert_close(total, want, rtol=HF_RTOL,
                                           atol=HF_ATOL)


def test_hartree_fock_kernel_is_deterministic(cuda):
    for ngauss in (3, 6):
        pos = hf_ref.helium_lattice(24, device=cuda)
        dens = hf_ref.initial_density(24, device=cuda)
        basis = hf_ref.sto_basis(ngauss, device=cuda)
        space = get_kernel("hartree_fock.twoel").tunable_space("cuda")
        for p in space.points():
            first = hf_kernel.twoel(hf_kernel.pad4(pos), dens, basis, **p)
            slab = hf_kernel.twoel_slab(hf_kernel.pad4(pos), dens, basis, 3,
                                        7, **p)
            for _ in range(5):
                again = hf_kernel.twoel(hf_kernel.pad4(pos), dens, basis, **p)
                assert torch.equal(first, again)
                assert torch.equal(slab, hf_kernel.twoel_slab(
                    hf_kernel.pad4(pos), dens, basis, 3, 7, **p))


def test_hartree_fock_full_build_splits_past_the_scratch_limit(cuda):
    """N = 216: a full build's scratch (4 * 216^4 bytes) is above the
    limit, so ``twoel`` runs the slabs [0, 213) and [213, 216) and sums
    them in order: one build, the same bits as that cover through
    ``twoel_slab``, and a symmetric F."""
    pos4 = hf_kernel.pad4(hf_ref.helium_lattice(216, device=cuda))
    dens = hf_ref.initial_density(216, device=cuda)
    basis = hf_ref.sto_basis(3, device=cuda)
    assert hf_kernel.slab_plan(216) == [(0, 213), (213, 3)]
    before = hf_kernel.twoel.launches, hf_kernel.twoel_slab.launches
    full = hf_kernel.twoel(pos4, dens, basis)
    assert (hf_kernel.twoel.launches,
            hf_kernel.twoel_slab.launches) == (before[0] + 1, before[1])
    cover = (hf_kernel.twoel_slab(pos4, dens, basis, 0, 213)
             + hf_kernel.twoel_slab(pos4, dens, basis, 213, 3))
    assert bool(torch.isfinite(full).all())
    assert torch.equal(full, cover)
    assert torch.equal(full, hf_kernel.twoel(pos4, dens, basis))
    torch.testing.assert_close(full, full.T, rtol=HF_RTOL, atol=HF_ATOL)


def test_new_kernels_reject_what_they_cannot_run(cuda):
    deck = bude_ops.make_deck(16, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bude_kernel.fasten(*(t.double() for t in deck))
    poses_t = deck[4].T.contiguous().T  # (6, P) with transposed strides
    with pytest.raises(ValueError, match="contiguous"):
        bude_kernel.fasten(*deck[:4], poses_t)
    with pytest.raises(ValueError, match="launch shape"):
        bude_kernel.fasten(*deck, ppwi=3)
    with pytest.raises(ValueError, match="launch shape"):
        bude_kernel.fasten(*deck, split=3)
    pos4 = hf_kernel.pad4(hf_ref.helium_lattice(8, device=cuda))
    dens = hf_ref.initial_density(8, device=cuda)
    basis = hf_ref.sto_basis(3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        hf_kernel.twoel(pos4.double(), dens.double(), basis)
    with pytest.raises(ValueError, match="contiguous"):
        hf_kernel.twoel(pos4, dens.T, basis)
    with pytest.raises(ValueError, match="launch shape"):
        hf_kernel.twoel(pos4, dens, basis, team=48)
    with pytest.raises(ValueError, match="slab"):
        hf_kernel.twoel_slab(pos4, dens, basis, 6, 4)
    # a slab of all 216 atoms: 4 * 216^4 bytes of integral scratch, above
    # the limit; the wrapper says so before it allocates anything
    big = hf_kernel.pad4(hf_ref.helium_lattice(216, device=cuda))
    big_dens = hf_ref.initial_density(216, device=cuda)
    with pytest.raises(ValueError, match=f"{4 * 216 ** 4} bytes"):
        hf_kernel.twoel_slab(big, big_dens, basis, 0, 216)


@pytest.mark.parametrize("name", PORTED)
def test_hand_written_conformance_cell(cuda, name):
    k = get_kernel(name)
    # the registry's Hartree-Fock and WKV backends call the counting
    # wrappers
    wrapper = {"hartree_fock.twoel": hf_kernel.twoel,
               "rwkv6.wkv": wkv_kernel.wkv}.get(name, k.backend(k.native).fn)
    args, _ = conformance.case_tensors(name, cuda)
    assert k.default_backend(*args) == k.native
    before = wrapper.launches
    conformance.check_backend(name, k.native, device=cuda)
    assert wrapper.launches > before


@pytest.mark.parametrize("cycles,calls", [(0, 2 + 20 * CALLS_PER_SAMPLE),
                                          (10_000_000, 2 + LONG_CALL_SAMPLES)])
def test_time_call_times_long_calls_one_a_sample(cuda, cycles, calls):
    # ~6 ms of spinning at the H100's clock, against a near-empty call
    x, count = torch.zeros(1, device=cuda), [0]

    def call(t):
        count[0] += 1
        torch.cuda._sleep(cycles)
        return t

    t = time_call(call, x, iters=20, warmup=2)
    assert count[0] == calls
    assert (t >= LONG_CALL_S) == (cycles > 0)


def test_quickstart_path(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.randn(1 << 18, generator=g, device=cuda) for _ in range(2))
    terms = []
    for name in ("babelstream.triad", "babelstream.dot"):
        k = get_kernel(name)
        k.validate(a, b, backend=k.native)
        t_ref = k.time_backend(a, b, backend="torch")
        t_port = k.time_backend(a, b, backend=k.native)
        terms.append(Efficiency(torch.cuda.get_device_name(0), name,
                                1 / t_port, 1 / t_ref))
    assert phi_bar(terms) > 0


# ---- attention ---------------------------------------------------------------
def _flash_case(case, dh, dtype, device, rng):
    """One ``FLASH_SWEEP`` case in the model's layout, seen through
    transposed views: (q, k, v, positions or (None, None), k_index_aligned,
    q_pos, k_pos)."""
    mode, b, h, kv, s, t, _, _ = case
    q, k, v = (x.transpose(1, 2) for x in attn_cases.draw(
        rng, (b, s, h, dh), (b, t, kv, dh), dtype, device))
    qp, kp, aligned = attn_cases.flash_positions(mode, b, s, t)
    qp, kp = torch.tensor(qp, device=device), torch.tensor(kp, device=device)
    pos = (None, None) if mode == "index" else (qp, kp)
    return q, k, v, pos, aligned, qp, kp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_kernel_matches_plain(cuda, dtype, dh):
    space = get_kernel("attention.flash").tunable_space("cuda")
    rng = np.random.default_rng(dh)
    for case in attn_cases.FLASH_SWEEP:
        mode, b, h, kv, s, t, causal, window = case
        q, k, v, pos, aligned, qp, kp = _flash_case(case, dh, dtype, cuda,
                                                    rng)
        want = attn_ref.flash_ref(q, k, v, *pos, causal=causal,
                                  window=window)
        points = space.valid_points(q, k, v, *pos)
        assert len(points) == 4
        for p in points:
            before = attn_kernel.flash.launches
            got = attn_kernel.flash(q, k, v, *pos, causal=causal,
                                    window=window, k_index_aligned=aligned,
                                    **p)
            torch.cuda.synchronize()
            assert attn_kernel.flash.launches == before + 1
            assert got.dtype == dtype and got.stride() == q.stride()
            max_abs_err(got, want, *ATTN_TOL[dtype],
                        f"{mode} S={s} T={t} {p}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_deterministic(cuda, dtype):
    """No atomics: five repeats of every tile point on the long left-padded
    case are bit-identical."""
    case = attn_cases.FLASH_SWEEP[-1]
    q, k, v, pos, aligned, _, _ = _flash_case(case, 128, dtype, cuda,
                                              np.random.default_rng(7))
    space = get_kernel("attention.flash").tunable_space("cuda")
    for p in space.valid_points(q, k, v, *pos):
        first = attn_kernel.flash(q, k, v, *pos, k_index_aligned=aligned, **p)
        for _ in range(5):
            assert torch.equal(first, attn_kernel.flash(
                q, k, v, *pos, k_index_aligned=aligned, **p))


def test_flash_bf16_rejects_misaligned_views(cuda):
    """The bf16 kernel copies rows 16 bytes at a time: a view whose base or
    row stride is not 16-byte aligned raises, as do the float32 tiles."""
    q, k, v, pos, _, _, _ = _flash_case(attn_cases.FLASH_SWEEP[0], 64,
                                        torch.bfloat16, cuda,
                                        np.random.default_rng(0))
    attn_kernel.flash(q, k, v)          # the aligned views run
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        attn_kernel.flash(shifted, k, v)
    b, kv, t, dh = k.shape
    wide = torch.zeros(b, t, kv, dh + 4, dtype=k.dtype, device=cuda)
    odd = wide[..., :dh].transpose(1, 2)   # rows 136 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        attn_kernel.flash(q, odd, v)
    with pytest.raises(ValueError, match="tiles"):
        attn_kernel.flash(q, k, v, bq=32)


def _decode_case(b, h, kv, t, dh, dtype, device, wrap=0, fill=None, seed=0):
    """A cache in the model's layout, from the shared sweep's builders."""
    q, k, v = attn_cases.draw(np.random.default_rng(seed), (b, 1, h, dh),
                              (b, t, kv, dh), dtype, device)
    qp, kp = attn_cases.decode_positions(b, t, wrap, fill)
    return (q, k, v, torch.tensor(qp, device=device),
            torch.tensor(kp, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_decode_kernel_matches_plain(cuda, dtype, dh):
    space = get_kernel("attention.decode").tunable_space("cuda")
    for b, h, kv, t, wrap, fill, window in attn_cases.DECODE_SWEEP:
        q, k, v, qp, kp = _decode_case(b, h, kv, t, dh, dtype, cuda, wrap,
                                       fill, seed=dh)
        # the cache as a layer's view of a (layers, ...) tensor
        k_layers, v_layers = torch.stack([k, k]), torch.stack([v, v])
        want = attn_ref.decode_ref(q, k, v, qp, kp, window=window)
        for p in space.points():
            before = attn_kernel.decode.launches
            got = attn_kernel.decode(q, k_layers[1], v_layers[1], qp, kp,
                                     window=window, **p)
            torch.cuda.synchronize()
            assert attn_kernel.decode.launches == before + 1
            max_abs_err(got, want, *ATTN_TOL[dtype],
                        f"T={t} wrap={wrap} {p}")


@pytest.mark.parametrize("group", [12, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_takes_up_to_16_heads_a_kv_head(cuda, dtype, group):
    """starcoder2-3b's 24 heads over 2 kv heads (G = 12), and G = 16,
    against the plain version: a wrapped ring with a window, and rows that
    leave most splits empty."""
    for dh, wrap, fill, window in ((128, 0, (2048, 700, 1), 0),
                                   (64, 37, None, 300)):
        q, k, v, qp, kp = _decode_case(3, 2 * group, 2, 2048, dh, dtype,
                                       cuda, wrap, fill, seed=group)
        want = attn_ref.decode_ref(q, k, v, qp, kp, window=window)
        got = attn_kernel.decode(q, k, v, qp, kp, window=window)
        max_abs_err(got, want, *ATTN_TOL[dtype], f"G={group} dh={dh}")
    with pytest.raises(ValueError, match="at most 16"):
        q, k, v, qp, kp = _decode_case(1, 34, 2, 64, 64, dtype, cuda)
        attn_kernel.decode(q, k, v, qp, kp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t", [(1, 1500), (16, 1500), (1500, 1500)])
def test_flash_non_causal_at_the_encoder_shapes_matches_plain(cuda, dtype,
                                                              s, t):
    """whisper-tiny's attention (6 heads of 64): a decode step's and a
    prompt's cross-attention to 1500 frames of encoder memory, and the
    encoder's own self-attention, all non-causal."""
    rng = np.random.default_rng(s)
    q, k, v = (x.transpose(1, 2) for x in attn_cases.draw(
        rng, (2, s, 6, 64), (2, t, 6, 64), dtype, cuda))
    qp, kp, aligned = attn_cases.flash_positions("cross", 2, s, t)
    qp, kp = torch.tensor(qp, device=cuda), torch.tensor(kp, device=cuda)
    want = attn_ref.flash_ref(q, k, v, qp, kp, causal=False)
    got = attn_kernel.flash(q, k, v, qp, kp, causal=False,
                            k_index_aligned=aligned)
    max_abs_err(got, want, *ATTN_TOL[dtype], f"non-causal S={s} T={t}")


def _cuda_kernels(fn, expect):
    """{name: records} of the CUDA kernels of three calls of ``fn()`` under
    ``torch.profiler``, after one call outside it.  The profiler can drop
    records, even whole calls: the profile is taken again, up to three
    times, until a kernel named with each string of ``expect`` shows."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        ran = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if all(any(n in kernel for kernel in ran) for n in expect):
            break
    return ran


def test_decode_kernel_is_deterministic(cuda):
    """Five eager calls and five replays of one captured CUDA graph give
    the bits of the first call: the arrival counters are back at 0 after
    every call and every replay."""
    q, k, v, qp, kp = _decode_case(8, 32, 8, 4096, 128, torch.bfloat16,
                                   cuda, fill=(4096, 3000, 2047, 1348, 700,
                                               300, 97, 1), seed=5)
    first = attn_kernel.decode(q, k, v, qp, kp)
    for _ in range(5):
        assert torch.equal(first, attn_kernel.decode(q, k, v, qp, kp))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = attn_kernel.decode(q, k, v, qp, kp)
    for _ in range(5):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, out)
    assert torch.equal(first, attn_kernel.decode(q, k, v, qp, kp))


def test_decode_is_one_launch(cuda):
    q, k, v, qp, kp = _decode_case(8, 32, 8, 4096, 128, torch.bfloat16,
                                   cuda, fill=(1348, 1094, 608, 684, 146,
                                               215, 97, 417), seed=6)
    qp, kp = qp.to(torch.int32), kp.to(torch.int32)
    ran = _cuda_kernels(lambda: attn_kernel.decode(q, k, v, qp, kp),
                        ["decode_kernel"])
    assert len(ran) == 1 and all("decode_kernel" in name and calls <= 3
                                 for name, calls in ran.items()), ran


def test_attention_kernels_reject_what_they_cannot_run(cuda):
    q, k, v, qp, kp = _decode_case(2, 4, 2, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn_kernel.decode(q.double(), k.double(), v.double(), qp, kp)
    with pytest.raises(ValueError, match="head_dim"):
        attn_kernel.decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous(), qp, kp)
    shifted = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        attn_kernel.decode(q, shifted, v, qp, kp)
    with pytest.raises(ValueError, match="bkv"):
        attn_kernel.decode(q, k, v, qp, kp, bkv=100)
    fq = q.transpose(1, 2)
    with pytest.raises(ValueError, match="tiles"):
        attn_kernel.flash(fq, k.transpose(1, 2), v.transpose(1, 2), bq=48)


def test_engine_drains_a_trace_through_the_kernels(cuda):
    params, cfg = _float32_smoke(cuda)
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    got = serving_portable.engine_contiguous(params, cfg)
    eng_flash, eng_decode = (attn_kernel.flash.launches,
                             attn_kernel.decode.launches)
    # each prefill bucket and the decode step are captured once as CUDA
    # graphs (a warm-up call and the capture each); the 6 prefills and the
    # 9 steps are replays, which the wrappers' counters do not see
    assert eng_flash == \
        2 * cfg.n_layers * len(serving_portable.PREFILL_BUCKETS)
    assert eng_decode == cfg.n_layers * 2
    want = serving_portable.unbatched(params, cfg)
    assert torch.equal(got, want)


def _float32_smoke(cuda):
    # float32 compute, so that batch-1 and batch-2 GEMMs (other cuBLAS
    # kernels) leave the greedy tokens alone
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              compute_dtype="float32")
    return init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                       cuda), cfg


def _kernel_count(fn, name, want, tries=5):
    """How many kernels whose name holds ``name`` one call of ``fn()`` runs,
    by ``torch.profiler``, after one call outside it.  The profiler can
    drop records: a profile that shows fewer than ``want`` is taken again,
    up to ``tries`` times; the largest count seen is returned."""
    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA
                             and name in e.key))
        if best >= want:
            break
    return best


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_captures_the_decode_step_once(cuda, layout):
    """A trace with staggered arrivals and finishes through two slots: one
    capture for the engine's life, every decode step a replay, tokens equal
    to eager unbatched generate on the card."""
    params, cfg = _float32_smoke(cuda)
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                        prefill_buckets=(8, 16), cache_layout=layout,
                        block_size=8)
    # the warm-up step and the capture, each n_layers calls of the wrapper
    assert attn_kernel.decode.launches == 2 * cfg.n_layers
    assert eng.stats["decode_traces"] == 1
    trace = serving_portable.conformance_trace(cfg)
    for i, r in enumerate(trace):
        r.arrival_time = 0.004 * i
    done = eng.run(trace)
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["prefill_traces"] == len(eng.prefill_buckets)
    assert eng.stats["decode_steps"] == eng.stats["graph_replays"] > 0
    assert eng.stats["prefill_calls"] == eng.stats["prefill_replays"] > 0
    # a replay does not move the wrappers' counters: the warm-up and the
    # capture of each graph do
    assert attn_kernel.decode.launches == 2 * cfg.n_layers
    assert attn_kernel.flash.launches == \
        2 * cfg.n_layers * len(eng.prefill_buckets)
    want = serving_portable.unbatched(params, cfg)
    got = torch.tensor([r.generated for r in sorted(done,
                                                    key=lambda r: r.uid)],
                       dtype=torch.int32)
    assert torch.equal(got, want)
    if layout == "paged":
        assert eng.balloc.available() == eng.balloc.capacity()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_threaded_engine_on_the_card_equals_generate(cuda, layout):
    params, cfg = _float32_smoke(cuda)
    eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                        prefill_buckets=(8, 16), cache_layout=layout,
                        block_size=8)
    trace = serving_portable.conformance_trace(cfg)
    for i, r in enumerate(trace):
        r.arrival_time = 0.004 * i
    done = eng.run_threaded(trace)
    assert eng.stats["decode_traces"] == 1
    got = torch.tensor([r.generated for r in sorted(done,
                                                    key=lambda r: r.uid)],
                       dtype=torch.int32)
    assert torch.equal(got, serving_portable.unbatched(params, cfg))


def test_one_replay_launches_the_decode_kernel_once_a_layer(cuda):
    params, cfg = _float32_smoke(cuda)
    eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                        prefill_len=16)
    replays = eng.stats["graph_replays"]
    got = _kernel_count(eng.decode_logits, "decode_kernel", cfg.n_layers)
    assert got == cfg.n_layers
    assert eng.stats["graph_replays"] > replays


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_a_profiled_run_launches_the_decode_kernel_once_a_layer_a_replay(
        cuda, layout):
    """Over a whole trace, by torch.profiler: n_layers decode kernels a
    replay and n_layers flash kernels a prefill, the counts chip_smoke.py
    gates on its serving runs."""
    params, cfg = _float32_smoke(cuda)
    eng = ServingEngine(params, cfg, num_slots=2, cache_len=32,
                        prefill_buckets=(8, 16), cache_layout=layout,
                        block_size=8)
    trace = serving_portable.conformance_trace(cfg)
    for i, r in enumerate(trace):
        r.arrival_time = 0.004 * i
    eng.run(trace)
    # the profiler can drop records: a run that shows fewer kernels than
    # its steps need is profiled again, up to five times; more fails
    for _ in range(5):
        trace = serving_portable.conformance_trace(cfg)
        for i, r in enumerate(trace):
            r.arrival_time = 0.004 * i
        before = dict(eng.stats)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            eng.run(trace)
            torch.cuda.synchronize()
        ran = {name: sum(e.count for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and name in e.key)
               for name in ("decode_kernel", "flash_kernel")}
        replays = eng.stats["graph_replays"] - before["graph_replays"]
        prefills = eng.stats["prefill_calls"] - before["prefill_calls"]
        want = {"decode_kernel": cfg.n_layers * replays,
                "flash_kernel": cfg.n_layers * prefills}
        assert all(ran[k] <= want[k] for k in want), (ran, want)
        if ran == want:
            break
    assert replays == eng.stats["decode_steps"] - before["decode_steps"] > 0
    assert ran == want


# ---- the RWKV6 WKV ----------------------------------------------------------
@pytest.mark.parametrize("dh", wkv_cases.SWEEP_DH)
def test_wkv_kernel_matches_plain(cuda, dh):
    """Every chunk at every S of the sweep (one token, a ragged chunk,
    several chunks with a ragged tail, 2047 tokens) and at 130, from a
    given state and from zeros: y and the final state against the exact
    recurrence in float32."""
    gen = torch.Generator(device=cuda).manual_seed(dh)
    for s in wkv_cases.SWEEP_S + (130,):
        args, s0 = wkv_cases.draw(gen, 2, 3, s, dh, cuda)
        for start in (s0, None):
            want = wkv_ref.wkv_serial(*args, start)
            for p in wkv_cases.points():
                state = None if start is None else start.clone()
                before = wkv_kernel.wkv.launches
                got = wkv_kernel.wkv(*args, state, **p)
                torch.cuda.synchronize()
                assert wkv_kernel.wkv.launches == before + 1
                if state is not None:
                    assert got[1] is state       # written in place
                wkv_cases.hold(got, want, WKV_RTOL, WKV_ATOL,
                               f"dh={dh} S={s} S0={start is not None} {p}")


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dh", wkv_cases.SWEEP_DH)
def test_wkv_one_token_kernel_matches_plain(cuda, dh, b):
    """The decode step (S 1) from a random state, written in place into
    the state it reads, against the exact recurrence."""
    gen = torch.Generator(device=cuda).manual_seed(b * dh)
    args, s0 = wkv_cases.draw(gen, b, 40, 1, dh, cuda)
    want = wkv_ref.wkv_serial(*args, s0)
    state = s0.clone()
    got = wkv_kernel.wkv(*args, state)
    torch.cuda.synchronize()
    assert got[1] is state
    wkv_cases.hold(got, want, WKV_RTOL, WKV_ATOL, f"S=1 dh={dh} B={b}")


def test_wkv_runs_the_step_kernel_at_one_token_else_three(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    for s, want in ((1, ["wkv_step_kernel"]), (130, list(WKV_CHUNK_KERNELS))):
        args, s0 = wkv_cases.draw(gen, 2, 4, s, 64, cuda)
        ran = _cuda_kernels(lambda: wkv_kernel.wkv(*args, s0), want)
        assert sorted(n for n in ("wkv_step_kernel",) + WKV_CHUNK_KERNELS
                      if any(n in kernel for kernel in ran)) == \
            sorted(want), (s, ran)
        assert len(ran) == len(want) and max(ran.values()) <= 3, ran


def test_wkv_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    for s in (300, 1):      # the chunk kernels, the one-token kernel
        args, s0 = wkv_cases.draw(gen, 2, 40, s, 64, cuda)
        first = wkv_kernel.wkv(*args, s0.clone())
        for _ in range(5):
            again = wkv_kernel.wkv(*args, s0.clone())
            assert torch.equal(first[0], again[0])
            assert torch.equal(first[1], again[1])


def test_wkv_kernel_rejects_what_it_cannot_run(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    (r, k, v, lw, u), s0 = wkv_cases.draw(gen, 1, 2, 8, 64, cuda)
    with pytest.raises(TypeError, match="float32"):
        wkv_kernel.wkv(r.double(), k.double(), v.double(), lw.double(),
                       u.double())
    with pytest.raises(TypeError, match="float32"):
        wkv_kernel.wkv(r, k, v, lw, u, s0.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        wkv_kernel.wkv(r, k, v, lw, u.cpu())
    with pytest.raises(ValueError, match="one shape"):
        wkv_kernel.wkv(r, k, v[:, :, :4], lw, u)
    with pytest.raises(ValueError, match="head_dim"):
        wkv_kernel.wkv(*(x[..., :16] for x in (r, k, v, lw)),
                       u[:, :16].contiguous())
    with pytest.raises(ValueError, match="chunk"):
        wkv_kernel.wkv(r, k, v, lw, u, chunk=8)
    shifted = torch.empty(r.numel() + 1, device=cuda)[1:].view(r.shape)
    with pytest.raises(ValueError, match="16"):
        wkv_kernel.wkv(shifted, k, v, lw, u)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv(r, k, v, lw, u, s0.transpose(2, 3))
    odd = torch.empty(s0.numel() + 1, device=cuda)[1:].view(s0.shape)
    with pytest.raises(ValueError, match="aligned state"):
        wkv_kernel.wkv(r, k, v, lw, u, odd)


def test_time_mix_launches_the_wkv_kernel(cuda):
    """The model's time mix on CUDA tensors runs the kernel at every S
    (a prompt and a one-token step), writes the state in place, and agrees
    with its plain path; ``wkv_backend="torch"`` launches nothing."""
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    p = params["segments"][0][0]["tm"]
    n_heads = cfg.d_model // 64
    gen = torch.Generator(device=cuda).manual_seed(1)
    for s in (64, 37, 1):
        x = torch.randn(2, s, cfg.d_model, generator=gen, device=cuda)
        last = torch.randn(2, 1, cfg.d_model, generator=gen, device=cuda)
        state = torch.randn(2, n_heads, 64, 64, generator=gen, device=cuda)
        before = wkv_kernel.wkv.launches
        want, (want_s, _) = rwkv_model.time_mix_apply(
            p, x, n_heads, state=state.clone(), last_x=last,
            wkv_backend="torch")
        assert wkv_kernel.wkv.launches == before
        got, (got_s, _) = rwkv_model.time_mix_apply(
            p, x, n_heads, state=state, last_x=last)
        assert wkv_kernel.wkv.launches == before + 1
        assert got_s is state
        torch.testing.assert_close(got, want, rtol=WKV_RTOL, atol=WKV_ATOL)
        torch.testing.assert_close(got_s, want_s, rtol=WKV_RTOL,
                                   atol=WKV_ATOL)


def test_rwkv_generate_runs_the_kernel_at_every_step(cuda):
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 70), device=cuda,
                           generator=gen)
    wkv_kernel.wkv.launches = 0
    got = SS.generate(params, cfg, prompt, max_new_tokens=5, cache_len=80)
    assert wkv_kernel.wkv.launches == cfg.n_layers * 5
    want = SS.generate(params, cfg, prompt, max_new_tokens=5, cache_len=80,
                       wkv_backend="torch")
    assert wkv_kernel.wkv.launches == cfg.n_layers * 5
    assert torch.equal(got, want)


# ---- tuning, tuned dispatch and telemetry on the card ----------------------
@pytest.fixture
def tuning_cache(tmp_path, monkeypatch):
    """A fresh default tuning cache file for one test."""
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "tuning.json"))
    attention.reset_dispatch_log()
    yield tuning.default_cache()
    attention.reset_dispatch_log()


def _recording(monkeypatch, name):
    """Wrap the ``cuda`` backend of ``name`` so that each call records the
    kwargs it was given, then runs the kernel."""
    k = get_kernel(name)
    real = k.backend("cuda").fn
    seen = []

    def fn(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setitem(k.backends, "cuda",
                        dataclasses.replace(k.backend("cuda"), fn=fn))
    return seen


def _attn_inputs(kind, dtype, cuda, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "decode":
        b, s, t, h, kv, dh = 2, 1, 300, 8, 2, 64
    else:
        b, s, t, h, kv, dh = 1, 96, 96, 8, 2, 64
    q = torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(
        np.float32)).to(cuda, dtype)
    k = torch.from_numpy(rng.standard_normal((b, t, kv, dh)).astype(
        np.float32)).to(cuda, dtype)
    v = torch.from_numpy(rng.standard_normal((b, t, kv, dh)).astype(
        np.float32)).to(cuda, dtype)
    kp = torch.arange(t, dtype=torch.int32, device=cuda)[None].repeat(b, 1)
    qp = (torch.full((b, 1), t - 1, dtype=torch.int32, device=cuda)
          if kind == "decode" else kp[:, :s].contiguous())
    return q, k, v, qp, kp


@pytest.mark.parametrize("kind,dtype,planted", [
    ("decode", torch.bfloat16, {"bkv": 64}),
    ("decode", torch.float32, {"bkv": 512}),
    ("prefill", torch.float32, {"bq": 32, "bk": 32}),
    ("prefill", torch.bfloat16, {"bq": 64, "bk": 128}),
])
def test_planted_tuned_params_reach_the_kernel_wrapper(
        cuda, tuning_cache, monkeypatch, kind, dtype, planted):
    name = attention.ATTN_KERNELS[kind]
    seen = _recording(monkeypatch, name)
    q, k, v, qp, kp = _attn_inputs(kind, dtype, cuda)
    args, kwargs = attention.kernel_args(kind, q, k, v, qp, kp, causal=True)
    want = attention.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True)
    assert seen[-1] == kwargs
    assert attention.dispatch_log()[kind]["tuning"] == "miss-default"
    tuning_cache.put(tuning.make_key(get_kernel(name), *args, backend="cuda",
                                     **kwargs), planted, 1e-5,
                     search="exhaustive", timer="graph")
    got = attention.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True)
    assert seen[-1] == {**kwargs, **planted}
    assert attention.dispatch_log()[kind] == {
        "backend": "cuda", "kernel": name, "tuning": "exhaustive",
        "params": planted}
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL[dtype][0],
                               atol=ATTN_TOL[dtype][1])


def test_a_planted_bkv_that_does_not_fit_raises(cuda, tuning_cache):
    q, k, v, qp, kp = _attn_inputs("decode", torch.bfloat16, cuda)
    args, kwargs = attention.kernel_args("decode", q, k, v, qp, kp,
                                         causal=True)
    tuning_cache.put(tuning.make_key(get_kernel("attention.decode"), *args,
                                     backend="cuda", **kwargs),
                     {"bkv": 96}, 1e-5)
    with pytest.raises(ValueError, match="bkv"):
        attention.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True)


def test_tune_ranks_fast_points_by_graph_time(cuda, tmp_path):
    """Decode at a small shape reads under GRAPH_TIMER_BELOW_S by
    time_call: every bkv is ranked as a graph's replay, after its own
    eager warm-up, and the entry says so; a repeat is a cache hit."""
    q, k, v, qp, kp = _attn_inputs("decode", torch.bfloat16, cuda)
    cache = tuning.TuningCache(tmp_path / "t.json")
    r = tuning.tune_registered("attention.decode", q, k, v, qp, kp,
                               backend="cuda", cache=cache, window=0,
                               iters=5)
    assert r.skipped is None and r.timer == "graph"
    assert [p["bkv"] for p, _ in r.swept] == list(attn_kernel.BKV_GRID)
    assert all(0 < s < tuning.GRAPH_TIMER_BELOW_S for _, s in r.swept)
    again = tuning.tune_registered("attention.decode", q, k, v, qp, kp,
                                   backend="cuda", cache=cache, window=0)
    assert again.cached and again.params == r.params
    assert again.timer == "graph"


def test_tuned_call_and_time_graph_on_the_card(cuda, tmp_path):
    a = torch.randn(1 << 16, device=cuda)
    cache = tuning.TuningCache(tmp_path / "t.json")
    r = tuning.tune_registered("babelstream.copy", a, backend="triton",
                               cache=cache)
    assert r.skipped is None and len(r.swept) == 6
    kern = get_kernel("babelstream.copy")
    before = stream_kernel.copy.launches
    out = kern(a, tuned=True, tuning_cache=cache)
    assert torch.equal(out, a) and stream_kernel.copy.launches == before + 1
    assert 0 < time_graph(stream_kernel.copy, a, **r.params) < 1e-2


def test_triton_compiles_and_the_jit_body_are_seen(cuda):
    from repro_torch.core import telemetry as tel
    from repro_torch.core.telemetry import cudamon
    a = torch.randn(4096, device=cuda)
    stream_kernel.copy(a)
    assert cudamon.triton_route() is not None
    body = tuning._unwrap_callable(stream_kernel._STREAM)
    assert body.__module__ == stream_kernel.__name__
    rec = tel.configure("on")
    try:
        # a scalar no other test uses: a new compile, then a cached one
        stream_kernel.mul(a, 0.125, block=1024, num_warps=4)
        stream_kernel.mul(a, 0.125, block=1024, num_warps=4)
        counters = rec.snapshot()["counters"]
    finally:
        tel.configure(os.environ.get(tel.ENV))
    assert cudamon.triton_route() != "none"
    assert counters.get(cudamon.TRITON_COMPILE) == 1, counters


def test_engine_counts_one_graph_capture(cuda):
    from repro_torch.core import telemetry as tel
    from repro_torch.core.telemetry import cudamon
    params, cfg = _float32_smoke(cuda)
    rec = tel.configure("on")
    try:
        eng = ServingEngine(params, cfg, num_slots=2, cache_len=64,
                            prefill_len=16)
        counters = rec.snapshot()["counters"]
    finally:
        tel.configure(os.environ.get(tel.ENV))
    assert eng.stats["decode_traces"] == 1
    # the decode step's and the one prefill bucket's
    assert eng.stats["prefill_traces"] == 1
    assert counters[cudamon.GRAPH_CAPTURE] == 2


# --------------------------------------------------------------------------
# training: the guard, and a train step on the card against the CPU
# --------------------------------------------------------------------------
def test_hand_written_kernels_refuse_grad_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(1, 4, 64, 64, generator=g, device=cuda)
    kv = torch.randn(1, 2, 64, 64, generator=g, device=cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)[None]
    r = torch.randn(1, 2, 64, 64, generator=g, device=cuda)
    calls = {
        "attention.flash": lambda x: attn_kernel.flash(x, kv, kv),
        "attention.decode": lambda x: attn_kernel.decode(
            x[:, :, :1].transpose(1, 2).contiguous(), kv.transpose(1, 2),
            kv.transpose(1, 2), pos[:, -1:], pos),
        "rwkv6.wkv": lambda x: wkv_kernel.wkv(
            x[:, :2], r, r, -r.abs(), torch.zeros(2, 64, device=cuda)),
        "babelstream.triad": lambda x: stream_kernel.triad(x.flatten(),
                                                           q.flatten()),
        "stencil7": lambda x: stencil_kernel.laplacian(x[0]),
    }
    for name, call in calls.items():
        before = {w: getattr(w, "launches") for w in (
            attn_kernel.flash, attn_kernel.decode, wkv_kernel.wkv,
            stream_kernel.triad, stencil_kernel.laplacian)}
        with pytest.raises(RuntimeError, match=f"the {name} kernel has no "
                                               f"backward"):
            call(q.clone().requires_grad_())
        assert all(w.launches == n for w, n in before.items())
        with torch.no_grad():
            call(q.clone().requires_grad_())     # no grad mode: it runs


def test_forward_on_the_kernels_refuses_grad_requiring_params(cuda):
    cfg = get_config("granite-3-8b", smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    leafy = tree_map(lambda t: t.detach().requires_grad_(), params)
    with pytest.raises(RuntimeError, match="has no backward"):
        forward(leafy, cfg, tokens)
    forward(leafy, cfg, tokens, attn_backend="torch")[0].float().sum() \
        .backward()
    assert leafy["segments"][0][0]["attn"]["wq"].grad is not None


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One smoke train step (granite-3-8b, float32 masters, bf16 compute,
    two microbatches, remat) from the same masters and batch on the card
    and on the CPU: loss and metrics at (1e-2, 1e-3), the grad norm at
    2e-2 relative, each update within 0.5 of the learning rate (AdamW
    eps 1e-3, as tests/test_torch_train_step.py says why)."""
    cfg = get_config("granite-3-8b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=cfg.pdtype())
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4)).batch_at(0)
    tcfg = TS.TrainConfig(microbatches=2,
                          opt=AdamWConfig(warmup_steps=1, eps=1e-3))
    out = {}
    for dev in ("cpu", cuda):
        on = tree_map(lambda t: t.to(dev), params)
        state, m = TS.train_step(TS.make_train_state(on, tcfg),
                                 to_device(batch, dev), cfg=cfg, tcfg=tcfg)
        out[str(dev)] = (state, {k: float(v) for k, v in m.items()})
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out[str(cuda)]
    for k in m_cpu:
        rtol = 2e-2 if k == "grad_norm" else 1e-2
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=rtol, atol=1e-3,
                                   err_msg=k)
    lr = m_cpu["lr"]
    for a, b, p0 in zip(leaves(s_gpu["params"]), leaves(s_cpu["params"]),
                        leaves(params)):
        assert a.device.type == "cuda"
        assert float(((a.cpu() - p0) - (b - p0)).abs().max()) <= 0.5 * lr



# ---- domain decomposition: the composites of the hand-written kernels ----
SHARDED = ("babelstream.add", "babelstream.copy", "babelstream.dot",
           "babelstream.mul", "babelstream.triad", "hartree_fock.twoel",
           "minibude.fasten", "stencil7")
COMPOSITE = {name: "shard_triton" if name.startswith("babelstream")
             else "shard_cuda" for name in SHARDED}


def _sharded_launches(wrapper, fn):
    before = wrapper.launches
    with collectives.counting() as counts:
        out = fn()
    torch.cuda.synchronize()
    return out, wrapper.launches - before, dict(counts)


@pytest.mark.parametrize("name", SHARDED)
@pytest.mark.parametrize("kind", ["torch_shard", "composite"])
def test_sharded_conformance_cell(cuda, name, kind):
    """Each sharded backend's conformance cell on the card, against the
    oracle and (BITWISE_TWIN) its single-device twin, and its comm
    contract; the default backend stays the single-device kernel."""
    backend = COMPOSITE[name] if kind == "composite" else kind
    k = get_kernel(name)
    args, kwargs = conformance.case_tensors(name, cuda)
    assert k.default_backend(*args) == k.native
    conformance.check_backend(name, backend, device=cuda)
    k.audit_comm_contract(*args, backend=backend, **kwargs)


def test_shard_cuda_stencil_is_bitwise_and_one_launch_a_shard(cuda):
    """Slab 2/4/8, the pencil grids, a tile point and one plane per shard:
    every composite equals the single-device kernel at its tile point bit
    for bit, one launch a shard, 2 (slab) or 4 (pencil) ppermutes."""
    k = get_kernel("stencil7")
    g = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn(16, 40, 96, generator=g, device=cuda)
    cases = ([({"num_shards": s}, s, 2) for s in (2, 4, 8)]
             + [({"decomp": "pencil", "shard_grid": grid},
                 grid[0] * grid[1], 4) for grid in ((2, 2), (4, 2), (2, 4))]
             + [({"num_shards": 4, "block_x": 128, "block_y": 4,
                  "zchunk": 16}, 4, 2)])
    for kw, shards, ppermutes in cases:
        tile = {t: kw[t] for t in ("block_x", "block_y", "zchunk")
                if t in kw}
        want = stencil_kernel.laplacian(u, **tile)
        got, n, counts = _sharded_launches(
            stencil_kernel.laplacian,
            lambda: k(u, backend="shard_cuda", **kw))
        assert torch.equal(got, want), kw
        assert n == shards and counts["ppermute"] == ppermutes, (kw, n)
    u1 = torch.randn(8, 16, 64, generator=g, device=cuda)
    assert torch.equal(k(u1, backend="shard_cuda", num_shards=8),
                       stencil_kernel.laplacian(u1))


def test_shard_triton_streams(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    a, b = (torch.randn((1 << 16) + 8, generator=g, device=cuda)
            for _ in range(2))
    for op in OPS:
        wrapper = getattr(stream_kernel, op)
        xs = (a,) if op in ("copy", "mul") else (a, b)
        want = wrapper(*xs)
        for s in (2, 4, 8):
            got, n, counts = _sharded_launches(wrapper, lambda: get_kernel(
                f"babelstream.{op}")(*xs, backend="shard_triton",
                                     num_shards=s))
            if op == "dot":
                assert n == 2 * s and counts["psum"] == 1
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            else:
                assert n == s and counts["psum"] == 0
                assert torch.equal(got, want), (op, s)


def test_shard_cuda_minibude_is_bitwise(cuda):
    deck = bude_ops.make_deck(97, 16, 4096, seed=2, device=cuda)
    want = bude_kernel.fasten(*deck)
    for s in (2, 4, 8):
        got, n, _ = _sharded_launches(bude_kernel.fasten, lambda: get_kernel(
            "minibude.fasten")(*deck, backend="shard_cuda", num_shards=s))
        assert n == s and torch.equal(got, want), s


def test_shard_cuda_hartree_fock(cuda):
    pos = hf_ref.helium_lattice(16, device=cuda)
    dens = hf_ref.initial_density(16, device=cuda)
    k = get_kernel("hartree_fock.twoel")
    want = k(pos, dens, backend="cuda")
    for s in (2, 4, 8):
        got, n, counts = _sharded_launches(
            hf_kernel.twoel_slab,
            lambda: k(pos, dens, backend="shard_cuda", num_shards=s))
        assert n == s and counts["psum"] == 1
        torch.testing.assert_close(got, want, rtol=HF_RTOL, atol=HF_ATOL)
        assert torch.equal(got, k(pos, dens, backend="shard_cuda",
                                  num_shards=s))


def test_composites_capture_as_cuda_graphs(cuda):
    """One card, one stream, no side streams: each family's composite is
    captured as one CUDA graph, whose replay gives the eager call's bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    u = torch.randn(16, 32, 64, generator=g, device=cuda)
    a = torch.randn(1 << 16, generator=g, device=cuda)
    deck = bude_ops.make_deck(16, 4, 512, seed=0, device=cuda)
    pos = hf_ref.helium_lattice(8, device=cuda)
    dens = hf_ref.initial_density(8, device=cuda)
    calls = [lambda: get_kernel("stencil7")(u, backend="shard_cuda",
                                            decomp="pencil",
                                            shard_grid=(2, 2)),
             lambda: get_kernel("babelstream.triad")(
                 a, a, backend="shard_triton", num_shards=4),
             lambda: get_kernel("minibude.fasten")(
                 *deck, backend="shard_cuda", num_shards=4),
             lambda: get_kernel("hartree_fock.twoel")(
                 pos, dens, backend="shard_cuda", num_shards=4)]
    for call in calls:
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
        assert time_graph(call, iters=2) > 0


def test_selftest_passes_on_the_card(cuda, capsys):
    from repro_torch.distributed import selftest
    assert selftest.main(["--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert "selftest ok (15 batteries)" in out
    assert "skipped" not in out
