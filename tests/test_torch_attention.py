"""The port's attention, held against the JAX package on the CPU.

The plain versions (``flash_ref``, ``decode_ref``: the port of
``attend_xla``) against the reference's ``flash_xla``/``decode_xla`` and its
Pallas kernels in interpret mode (``flash_pallas``/``decode_pallas``), on the
same numpy inputs: float32 at the reference's ORACLE_TOL (2e-4, 2e-4),
bfloat16 at its own bf16 tolerance (2e-2, 2e-2, tests/test_kernels_lm.py).
Index and position masks, left pads, a window, a wrapped ring, ragged S/T.
Then the dispatch rules: no fallback, env > argument > default.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import conformance as jax_conformance
from repro.kernels.flash_attention import ops as jax_fa
from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.models import attention as jax_attn
import repro_torch.kernels  # noqa: F401
from repro_torch.core import conformance, get_kernel
from repro_torch.core.portable import BackendUnavailableError, max_abs_err
from repro_torch.kernels.flash_attention import cases
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.models import attention as A

F32_TOL = (2e-4, 2e-4)     # ORACLE_TOL["attention.flash"/"attention.decode"]
BF16_TOL = (2e-2, 2e-2)    # the reference's bf16 attention tolerance
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _arrays(seed, shapes):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(s) * 0.5).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same numbers as a torch tensor of ``dtype``, a float32 jax array
    for the XLA oracle and a jax array of ``dtype`` for the Pallas kernel.

    The XLA CPU backend has no bf16 x bf16 -> f32 dot for some GQA shapes
    (DotThunk refuses it), so the oracle gets the bf16-rounded numbers in
    float32: its logits are the same (bf16 products are exact in float32);
    only its probabilities skip the rounding to bf16 before P.V.
    """
    _, tdt, jdt, _ = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy()), jnp.asarray(a, jdt)


def _close(got, want, tol, rows=None):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


# (mode, B, H, Kv, S, T, causal, window, pallas-comparable)
FLASH_CASES = [
    ("index", 2, 4, 2, 128, 128, True, 0, True),
    ("index", 1, 4, 4, 64, 128, False, 0, True),
    ("index", 1, 8, 2, 128, 128, True, 40, True),
    ("index", 1, 4, 1, 100, 70, True, 0, False),       # ragged S/T
    ("leftpad", 2, 8, 2, 64, 128, True, 0, True),
    ("self", 2, 4, 2, 64, 64, True, 0, True),
    ("self", 1, 4, 2, 90, 90, False, 0, False),         # ragged, non-causal
    ("ring", 1, 4, 2, 48, 32, True, 0, False),          # wrapped ring
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"{c[0]}-{c[4]}x{c[5]}-c{int(c[6])}w{c[7]}")
def test_flash_ref_matches_reference(case, dtype):
    mode, b, h, kv, s, t, causal, window, pallas = case
    tol = DTYPES[dtype][3]
    qa, ka, va = _arrays(s + t, [(b, h, s, 32), (b, kv, t, 32),
                                 (b, kv, t, 32)])
    (q, jq, pq), (k, jk, pk), (v, jv, pv) = (_pair(a, dtype)
                                             for a in (qa, ka, va))
    if mode == "index":
        pos, jpos = (), ()
        qp = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        kp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    else:
        qp, kp, _ = cases.flash_positions(mode, b, s, t)
        pos = (torch.from_numpy(qp), torch.from_numpy(kp))
        jpos = (jnp.asarray(qp), jnp.asarray(kp))
    got = ref.flash_ref(q, k, v, *pos, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    # the oracles agree on every row, the all-masked ones included
    _close(got, jax_fa.flash_xla(jq, jk, jv, *jpos, causal=causal,
                                 window=window), tol)
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(K.flash(q, k, v, *pos, causal=causal, window=window),
                       got)
    if pallas:
        live = ref.admitted(torch.from_numpy(qp), torch.from_numpy(kp),
                            causal=causal, window=window).any(-1).numpy()
        rows = np.broadcast_to(live[:, None], (b, h, s))
        want = jax_fa.flash_pallas(pq, pk, pv, *jpos, causal=causal,
                                   window=window, bq=32, bk=32,
                                   interpret=True)
        _close(got, want, tol, rows)


def _decode_arrays(seed, b, h, kv, t, dh=32, wrap=0, fill=None):
    qa, ka, va = _arrays(seed, [(b, 1, h, dh), (b, t, kv, dh),
                                (b, t, kv, dh)])
    return (qa, ka, va) + cases.decode_positions(b, t, wrap, fill)


# (B, H, Kv, T, wrap, fill, window)
DECODE_CASES = [
    (2, 4, 2, 128, 0, None, 0),
    (2, 8, 2, 64, 5, None, 0),          # wrapped ring
    (3, 4, 4, 96, 0, (96, 41, 1), 0),   # empty slots
    (2, 8, 1, 128, 7, (128, 60), 16),   # window over a wrapped ring
    (1, 4, 2, 1, 0, None, 0),           # cache_len 1
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"T{c[3]}-wrap{c[4]}-w{c[6]}")
def test_decode_ref_matches_reference(case, dtype):
    b, h, kv, t, wrap, fill, window = case
    tol = DTYPES[dtype][3]
    qa, ka, va, qp, kp = _decode_arrays(t + h, b, h, kv, t, wrap=wrap,
                                        fill=fill)
    (q, jq, pq), (k, jk, pk), (v, jv, pv) = (_pair(a, dtype)
                                             for a in (qa, ka, va))
    tq, tk = torch.from_numpy(qp), torch.from_numpy(kp)
    got = ref.decode_ref(q, k, v, tq, tk, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    jqp, jkp = jnp.asarray(qp), jnp.asarray(kp)
    _close(got, jax_fa.decode_xla(jq, jk, jv, jqp, jkp, window=window), tol)
    _close(got, jax_fa.decode_pallas(pq, pk, pv, jqp, jkp, window=window,
                                     bkv=min(32, t), interpret=True), tol)
    assert torch.equal(K.decode(q, k, v, tq, tk, window=window), got)


# (B, H, Kv, T, wrap, fill, window): a row that admits no key, rows filled
# to T, a wrapped ring, a window over it, fills that leave most chunks empty
SPLIT_CASES = [
    (3, 4, 2, 96, 0, (0, 41, 96), 0),
    (2, 8, 2, 128, 0, None, 0),
    (2, 8, 2, 64, 5, None, 0),
    (2, 8, 1, 128, 7, (128, 60), 16),
    (3, 4, 2, 512, 0, (5, 70, 1), 0),
]


@pytest.mark.parametrize("bkv", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"T{c[3]}-wrap{c[4]}-w{c[6]}-"
                                       f"fill{c[5]}")
def test_decode_split_mirror_matches_reference(case, dtype, bkv):
    """``ref.decode_split``, the decode kernel's decomposition (chunks of
    bkv slots, empty chunks skipped, partials combined in chunk order),
    against the reference's ``decode_ref`` and its Pallas decode kernel in
    interpret mode on every row; a row that admits no key gets the uniform
    average of v over the cache, as both give it and the kernel writes
    it."""
    b, h, kv, t, wrap, fill, window = case
    tol = DTYPES[dtype][3]
    qa, ka, va, qp, kp = _decode_arrays(t + bkv, b, h, kv, t, wrap=wrap,
                                        fill=fill)
    (q, jq, pq), (k, jk, pk), (v, jv, pv) = (_pair(a, dtype)
                                             for a in (qa, ka, va))
    tq, tk = torch.from_numpy(qp), torch.from_numpy(kp)
    got = ref.decode_split(q, k, v, tq, tk, window=window, bkv=bkv)
    assert got.dtype == q.dtype and got.shape == q.shape
    live = ref.admitted(tq, tk, causal=True, window=window).any(-1).numpy()
    assert not live.all() or fill is None or min(fill) > 0
    keyless = ref.keyless(v.transpose(1, 2))             # (B, Kv, Dh)
    want_keyless = keyless.repeat_interleave(h // kv, 1)[:, None]
    assert torch.equal(got[torch.from_numpy(~live)[:, 0]],
                       want_keyless.to(got.dtype)[torch.from_numpy(
                           ~live)[:, 0]])
    jqp, jkp = jnp.asarray(qp), jnp.asarray(kp)
    _close(got, jax_fa_ref.decode_ref(jq, jk, jv, jqp, jkp, window=window),
           tol)
    _close(got, jax_fa.decode_pallas(pq, pk, pv, jqp, jkp, window=window,
                                     bkv=min(32, t), interpret=True), tol)
    _close(got, ref.decode_ref(q, k, v, tq, tk, window=window).float(), tol)


def test_attend_torch_matches_attend_xla_in_model_layout():
    b, s, h, kv, t, dh = 2, 1, 8, 2, 40, 16
    qa, ka, va, qp, kp = _decode_arrays(3, b, h, kv, t, dh=dh, wrap=3)
    got = ref.attend_torch(*(torch.from_numpy(a) for a in (qa, ka, va, qp,
                                                           kp)),
                           n_kv_heads=kv, causal=True)
    want = jax_attn.attend_xla(*(jnp.asarray(a) for a in (qa, ka, va, qp,
                                                          kp)),
                               n_kv_heads=kv, causal=True)
    _close(got, want, F32_TOL)


def test_flops_models_equal_the_reference():
    from repro.core.portable import registry as jax_registry
    for name in ("attention.flash", "attention.decode"):
        args, _ = conformance.case_tensors(name)
        jargs, _ = jax_conformance.CASES[name]()
        ours = get_kernel(name).flops_model(*args)
        theirs = jax_registry.get(name).flops_model(*jargs)
        assert ours == theirs > 0


def test_tunables_declared():
    space = get_kernel("attention.flash").tunable_space("cuda")
    assert space.params == {"bq": (32, 64, 128), "bk": (32, 64, 128)}
    # each dtype sweeps the tiles its kernel is instantiated for
    for dtype, tiles in ((torch.float32, (32, 64)),
                         (torch.bfloat16, (64, 128))):
        q = torch.zeros(1, 1, 1, 16, dtype=dtype)
        assert space.valid_points(q, q, q) == [
            {"bq": bq, "bk": bk} for bq in tiles for bk in tiles]
        assert K.FLASH_DEFAULT[dtype][0] in tiles
        assert K.FLASH_DEFAULT[dtype][1] in tiles
    assert get_kernel("attention.decode").tunable_space("cuda").params == \
        {"bkv": (64, 128, 256, 512)}
    assert get_kernel("attention.decode").roofline_contract("cuda") == \
        {"bound": "memory"}


@pytest.mark.parametrize("case", cases.FLASH_SWEEP,
                         ids=lambda c: f"{c[0]}-{c[4]}x{c[5]}-w{c[7]}")
def test_least_flops_counts_the_admitted_pairs(case):
    mode, b, h, kv, s, t, causal, window = case
    qp, kp, _ = cases.flash_positions(mode, b, s, t)
    pairs = sum(
        1 for row in range(b) for i in range(s) for j in range(t)
        if kp[row, j] >= 0 and (not causal or kp[row, j] <= qp[row, i])
        and (not window or qp[row, i] - kp[row, j] < window))
    got = fa_ops.least_flops(torch.from_numpy(qp), torch.from_numpy(kp), h,
                             64, causal=causal, window=window)
    assert got == 4.0 * 64 * h * pairs


@pytest.mark.parametrize("b,h,s,dh", [(2, 8, 100, 64), (1, 32, 130, 128)])
def test_least_flops_exceeds_the_reference_model_by_the_diagonal(b, h, s,
                                                                 dh):
    # causal index mode, S = T: the reference's model halves the square;
    # the admitted pairs are S (S + 1) / 2 a row, the diagonal included
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    q = torch.zeros(b, h, s, dh)
    k = torch.zeros(b, 2, s, dh)
    ours = fa_ops.least_flops(pos, pos, h, dh, causal=True)
    theirs = get_kernel("attention.flash").flops_model(q, k, k, causal=True)
    assert ours - theirs == 4.0 * b * h * dh * s / 2


# ---- the on-card checks' data can see a dropped tile ---------------------
# chip_smoke.py's serving shapes: granite-3-8b heads, 8 slots of a
# 4096-slot cache, a 2048-token prefill bucket, prompts of 64-2048 tokens
# and 32 new ones, seed 0
SERVING = dict(num_slots=8, cache_len=4096, bucket=2048, min_prompt=64,
               max_prompt=2048, max_new=32)


def _serving(name):
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-8b")
    drawn = cases.serving_cases(0, n_heads=cfg.n_heads,
                                n_kv_heads=cfg.n_kv_heads,
                                head_dim=cfg.head_dim, device="cpu",
                                **SERVING)[name]
    smallest = min(min(p.values()) for p in
                   get_kernel(name).tunable_space("cuda").points())
    return drawn["args"], drawn["lengths"], smallest


def test_flash_serving_check_sees_a_dropped_k_tile():
    """The plain prefill without any one block of 16 keys lies outside the
    bf16 tolerance on the last 64 queries of the serving case: a kernel
    that lost a k tile, or one k step of its P.V product (wgmma takes 16
    keys a step), fails the on-card check."""
    (q, k, v, qp, kp), (length,), _ = _serving("attention.flash")
    bk = 16
    q, qp = q[:, :, -64:], qp[:, -64:]
    want = ref.flash_ref(q, k, v, qp, kp, causal=True)
    max_abs_err(want, want, *BF16_TOL, "unchanged")
    for t0 in range(0, length, bk):
        dropped = kp.clone()
        dropped[:, t0:t0 + bk] = -1
        got = ref.flash_ref(q, k, v, qp, dropped, causal=True)
        with pytest.raises(AssertionError, match="outside"):
            max_abs_err(got, want, *BF16_TOL, f"tile at {t0}")


def test_decode_serving_check_sees_a_dropped_split():
    """The plain decode without any one split of the smallest declared size
    of any row lies outside the bf16 tolerance at the serving shape: a
    kernel that lost a split fails the on-card check."""
    (q, k, v, qp, kp), fills, bkv = _serving("attention.decode")
    want = ref.decode_ref(q, k, v, qp, kp)
    for row, fill in enumerate(fills):
        one = slice(row, row + 1)
        for t0 in range(0, fill, bkv):
            dropped = kp[one].clone()
            dropped[:, t0:t0 + bkv] = -1
            got = ref.decode_ref(q[one], k[one], v[one], qp[one], dropped)
            with pytest.raises(AssertionError, match="outside"):
                max_abs_err(got, want[one], *BF16_TOL,
                            f"row {row} split at {t0}")


# ---- dispatch: no fallback ------------------------------------------------
def _decode_call(device="cpu"):
    qa, ka, va, qp, kp = _decode_arrays(0, 2, 4, 2, 16)
    return [torch.from_numpy(a).to(device) for a in (qa, ka, va, qp, kp)]


def test_resolution_precedence(monkeypatch):
    monkeypatch.delenv(A.ATTN_BACKEND_ENV, raising=False)
    for kind in ("prefill", "decode"):
        assert A.resolve_attention_backend(kind, None, "cpu") == "torch"
        assert A.resolve_attention_backend(kind, "auto", "cpu") == "torch"
        assert A.resolve_attention_backend(kind, "torch", "cpu") == "torch"
        with pytest.raises(KeyError, match="unknown attention backend"):
            A.resolve_attention_backend(kind, "xla", "cpu")
    with pytest.raises(KeyError, match="dispatch kind"):
        A.resolve_attention_backend("encode")
    # the env var wins over the argument
    monkeypatch.setenv(A.ATTN_BACKEND_ENV, "torch")
    assert A.resolve_attention_backend("decode", "cuda", "cpu") == "torch"
    monkeypatch.setenv(A.ATTN_BACKEND_ENV, "pallas")
    with pytest.raises(KeyError, match="pallas"):
        A.resolve_attention_backend("decode", "torch", "cpu")


def test_cuda_attention_on_cpu_tensors_raises(monkeypatch):
    monkeypatch.delenv(A.ATTN_BACKEND_ENV, raising=False)
    q, k, v, qp, kp = _decode_call()
    with pytest.raises(BackendUnavailableError, match="CUDA tensors"):
        A.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True, backend="cuda")
    with pytest.raises(BackendUnavailableError, match="CUDA tensors"):
        A.attend(q.expand(2, 3, 4, 32), k, v, qp.expand(2, 3), kp,
                 n_kv_heads=2, causal=True, backend="cuda")
    monkeypatch.setenv(A.ATTN_BACKEND_ENV, "cuda")
    with pytest.raises(BackendUnavailableError):
        A.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True)


def test_cuda_attention_needs_the_toolchain(monkeypatch):
    # CUDA tensors whose backend cannot run: the probe's reason, raised
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(A.ATTN_BACKEND_ENV, raising=False)
    with pytest.raises(BackendUnavailableError, match="not available"):
        A.resolve_attention_backend("decode", None, "cuda")


def test_env_torch_selects_the_plain_version(monkeypatch):
    q, k, v, qp, kp = _decode_call()
    monkeypatch.setenv(A.ATTN_BACKEND_ENV, "torch")
    calls = []
    monkeypatch.setattr(A, "attend_torch",
                        lambda *a, **kw: calls.append(1) or
                        ref.attend_torch(*a, **kw))
    out = A.attend(q, k, v, qp, kp, n_kv_heads=2, causal=True,
                   backend="cuda")
    assert calls == [1]
    assert torch.equal(out, ref.decode_ref(q, k, v, qp, kp))


def test_kernel_wrappers_reject_bad_shapes():
    q, k, v, qp, kp = _decode_call()
    with pytest.raises(ValueError, match="decode takes"):
        K.decode(q[:, 0], k, v, qp, kp)
    with pytest.raises(ValueError, match="positions"):
        K.decode(q, k, v, qp[:, :0], kp)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        K.decode(q[:, :, :3], k, v, qp, kp)
    fq, fk = q.transpose(1, 2), k.transpose(1, 2)
    with pytest.raises(ValueError, match="both q_pos and k_pos"):
        K.flash(fq, fk, fk, qp)
    with pytest.raises(ValueError, match="one device"):
        K.flash(fq, fk.to("meta"), fk)


def _cache_case(b, s, cache_len, lens):
    r = np.random.default_rng(9)
    k = r.standard_normal((b, s, 2, 8)).astype(np.float32)
    pos = np.arange(s)[None] - (s - np.asarray(lens))[:, None]
    return k, np.where(pos >= 0, pos, -1).astype(np.int32)


@pytest.mark.parametrize("s,cache_len,lens", [(6, 8, (6, 2)), (1, 4, (1, 0)),
                                              (12, 5, (12, 9))])
def test_cache_write_drops_pads_and_keeps_the_latest(s, cache_len, lens):
    k, pos = _cache_case(2, s, cache_len, lens)
    cache = A.init_cache(2, cache_len, 2, 8, torch.float32, "cpu")
    A._write_cache(cache, torch.from_numpy(k), torch.from_numpy(-k),
                   torch.from_numpy(pos))
    for row in range(2):
        real = [(p, i) for i, p in enumerate(pos[row]) if p >= 0]
        latest = {p % cache_len: (p, i) for p, i in real}  # later wins
        for slot in range(cache_len):
            if slot in latest:
                p, i = latest[slot]
                assert int(cache["pos"][row, slot]) == p
                np.testing.assert_array_equal(cache["k"][row, slot], k[row, i])
                np.testing.assert_array_equal(cache["v"][row, slot],
                                              -k[row, i])
            else:
                assert int(cache["pos"][row, slot]) == -1
                assert not cache["k"][row, slot].any()
    if s <= cache_len:   # no ring wrap: the reference's scatter, exactly
        # the reference's scatter (attention.py:354-363), on positions
        jc = jax_attn.init_cache(2, cache_len, 2, 8, jnp.float32)
        slots = np.where(pos >= 0, pos % cache_len, cache_len)
        want = np.asarray(jc["pos"].at[np.arange(2)[:, None], slots].set(
            jnp.asarray(pos), mode="drop"))
        np.testing.assert_array_equal(cache["pos"].numpy(), want)
