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

import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core import (Efficiency, conformance, get_kernel, phi_bar,
                              time_call)
from repro_torch.core.portable import (CALLS_PER_SAMPLE, LONG_CALL_S,
                                       LONG_CALL_SAMPLES)
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
from repro_torch.kernels.stencil7 import kernel as stencil_kernel
from repro_torch.kernels.stencil7 import ref as stencil_ref
from repro_torch.models.transformer import init_params
from repro_torch.serving import portable as serving_portable

OPS = ("copy", "mul", "add", "triad", "dot")
PORTED = ("attention.decode", "attention.flash", "babelstream.add",
          "babelstream.copy", "babelstream.dot", "babelstream.mul",
          "babelstream.triad", "hartree_fock.twoel", "minibude.fasten",
          "stencil7")
STENCIL_RTOL, STENCIL_ATOL = conformance.ORACLE_TOL["stencil7"]
BUDE_RTOL, BUDE_ATOL = conformance.ORACLE_TOL["minibude.fasten"]
HF_RTOL, HF_ATOL = conformance.ORACLE_TOL["hartree_fock.twoel"]
#: attention against its plain version: float32 at the reference's
#: ORACLE_TOL, bfloat16 at the reference's own bf16 tolerance
#: (tests/test_kernels_lm.py::test_flash_bf16)
ATTN_TOL = {torch.float32: conformance.ORACLE_TOL["attention.flash"],
            torch.bfloat16: (2e-2, 2e-2)}

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
    space = get_kernel("minibude.fasten").tunable_space("cuda")
    # ragged pose tails: no count below is a multiple of a block's poses
    for natpro, natlig, nposes in ((16, 4, 1), (64, 8, 1000),
                                   (96, 16, 4099)):
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


def test_hartree_fock_kernel_matches_plain(cuda):
    space = get_kernel("hartree_fock.twoel").tunable_space("cuda")
    for n, ngauss in ((8, 3), (12, 6), (16, 3)):
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
            torch.testing.assert_close(got, want, rtol=HF_RTOL, atol=HF_ATOL)
        # a cover by uneven slabs sums to the full build
        total = torch.zeros_like(want)
        for l0, nl in ((0, 1), (1, n // 2 - 1), (n // 2, n // 2)):
            before = hf_kernel.twoel_slab.launches
            part = hf_kernel.twoel_slab(pos4, dens, basis, l0, nl)
            assert hf_kernel.twoel_slab.launches == before + 1
            torch.testing.assert_close(
                part, hf_ref.fock_build_slab(pos, dens, basis, l0, nl),
                rtol=HF_RTOL, atol=HF_ATOL)
            total += part
        torch.testing.assert_close(total, want, rtol=HF_RTOL, atol=HF_ATOL)


def test_hartree_fock_kernel_is_deterministic(cuda):
    pos = hf_ref.helium_lattice(24, device=cuda)
    dens = hf_ref.initial_density(24, device=cuda)
    basis = hf_ref.sto_basis(3, device=cuda)
    for p in get_kernel("hartree_fock.twoel").tunable_space("cuda").points():
        first = hf_kernel.twoel(hf_kernel.pad4(pos), dens, basis, **p)
        for _ in range(5):
            again = hf_kernel.twoel(hf_kernel.pad4(pos), dens, basis, **p)
            assert torch.equal(first, again)


def test_new_kernels_reject_what_they_cannot_run(cuda):
    deck = bude_ops.make_deck(16, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bude_kernel.fasten(*(t.double() for t in deck))
    poses_t = deck[4].T.contiguous().T  # (6, P) with transposed strides
    with pytest.raises(ValueError, match="contiguous"):
        bude_kernel.fasten(*deck[:4], poses_t)
    with pytest.raises(ValueError, match="launch shape"):
        bude_kernel.fasten(*deck, ppwi=3)
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


@pytest.mark.parametrize("name", PORTED)
def test_hand_written_conformance_cell(cuda, name):
    k = get_kernel(name)
    # the registry's Hartree-Fock backend pads the positions and calls the
    # counting wrapper
    wrapper = {"hartree_fock.twoel": hf_kernel.twoel}.get(
        name, k.backend(k.native).fn)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_flash_kernel_matches_plain(cuda, dtype, dh):
    space = get_kernel("attention.flash").tunable_space("cuda")
    rng = np.random.default_rng(dh)
    for case, b, h, kv, s, t, causal, window in attn_cases.FLASH_SWEEP:
        # the model's layout, seen through transposed views
        q, k, v = (x.transpose(1, 2) for x in attn_cases.draw(
            rng, (b, s, h, dh), (b, t, kv, dh), dtype, cuda))
        qp, kp, aligned = attn_cases.flash_positions(case, b, s, t)
        qp, kp = torch.tensor(qp, device=cuda), torch.tensor(kp, device=cuda)
        pos = (None, None) if case == "index" else (qp, kp)
        want = attn_ref.flash_ref(q, k, v, *pos, causal=causal,
                                  window=window)
        live = attn_ref.admitted(qp, kp, causal=causal, window=window).any(-1)
        live = live[:, None, :].expand(b, h, s)
        for p in space.points():
            before = attn_kernel.flash.launches
            got = attn_kernel.flash(q, k, v, *pos, causal=causal,
                                    window=window, k_index_aligned=aligned,
                                    **p)
            torch.cuda.synchronize()
            assert attn_kernel.flash.launches == before + 1
            assert got.dtype == dtype and got.stride() == q.stride()
            attn_cases.hold_live(got, want, live, *ATTN_TOL[dtype],
                                 f"{case} S={s} T={t} {p}")


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
        live = attn_ref.admitted(qp, kp, causal=True, window=window).any(-1)
        for p in space.points():
            before = attn_kernel.decode.launches
            got = attn_kernel.decode(q, k_layers[1], v_layers[1], qp, kp,
                                     window=window, **p)
            torch.cuda.synchronize()
            assert attn_kernel.decode.launches == before + 1
            attn_cases.hold_live(got, want, live, *ATTN_TOL[dtype],
                                 f"T={t} wrap={wrap} {p}")


def test_decode_kernel_is_deterministic(cuda):
    q, k, v, qp, kp = _decode_case(8, 32, 8, 4096, 128, torch.bfloat16,
                                   cuda, fill=(4096, 3000, 2047, 1348, 700,
                                               300, 97, 1), seed=5)
    first = attn_kernel.decode(q, k, v, qp, kp)
    for _ in range(5):
        assert torch.equal(first, attn_kernel.decode(q, k, v, qp, kp))


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
    # float32 compute, so that batch-1 and batch-2 GEMMs (other cuBLAS
    # kernels) leave the greedy tokens alone
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True),
                              compute_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, cuda)
    attn_kernel.flash.launches = attn_kernel.decode.launches = 0
    got = serving_portable.engine_contiguous(params, cfg)
    eng_flash, eng_decode = (attn_kernel.flash.launches,
                             attn_kernel.decode.launches)
    # 6 prefills; 2 slots x 4 tokens: 3 rounds of 3 decode steps
    assert eng_flash == cfg.n_layers * len(serving_portable.PROMPT_LENS)
    assert eng_decode == cfg.n_layers * 9
    want = serving_portable.unbatched(params, cfg)
    assert torch.equal(got, want)
