"""The port's registry, metrics, conformance tables and build, held against
the JAX package; plus the port's import isolation.

``repro_torch`` never imports jax or ``repro``: a subprocess proves it at
run time and an AST scan of its sources proves it statically.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import conformance as jax_conformance
from repro.core import metrics as jax_metrics
import repro_torch.kernels  # noqa: F401
from repro_torch import _build
from repro_torch.core import conformance, metrics, portable
from repro_torch.core.portable import (BackendUnavailableError,
                                       KernelRegistry, PortableKernel,
                                       TunableSpace, get_kernel,
                                       register_kernel, registry)
from repro_torch.kernels.babelstream import kernel as stream_kernel
from repro_torch.kernels.stencil7 import kernel as stencil_kernel

REPO = Path(__file__).resolve().parents[1]
PORTED = ("babelstream.copy", "babelstream.mul", "babelstream.add",
          "babelstream.triad", "babelstream.dot", "stencil7",
          "minibude.fasten", "hartree_fock.twoel", "attention.flash",
          "attention.decode", "rwkv6.wkv")
#: case arrays each framework computes with its own exp: numpy's and XLA's
#: float32 exp agree to two ulps, not bit for bit (the WKV's log-decays)
EXP_ARRAYS = {("rwkv6.wkv", 3)}
#: the serving engine's host loop, with a case and a tolerance but no kernel
LOOPS = ("serving.engine",)


# ---- metrics and tables equal the reference's ----------------------------
@pytest.mark.parametrize("L,itemsize", [(3, 4), (64, 4), (512, 4), (1024, 8)])
def test_eq1_matches_reference(L, itemsize):
    assert metrics.stencil7_effective_bytes(L, itemsize) == \
        jax_metrics.stencil7_effective_bytes(L, itemsize)
    assert metrics.stencil7_effective_bandwidth(L, itemsize, 1e-3) == \
        jax_metrics.stencil7_effective_bandwidth(L, itemsize, 1e-3)


@pytest.mark.parametrize("op", ["copy", "mul", "add", "triad", "dot", "DOT"])
def test_eq2_matches_reference(op):
    for n, isz in ((1024, 4), (1 << 25, 8)):
        assert metrics.babelstream_bytes(op, n, isz) == \
            jax_metrics.babelstream_bytes(op, n, isz)
        assert metrics.babelstream_bandwidth(op, n, isz, 2e-3) == \
            jax_metrics.babelstream_bandwidth(op, n, isz, 2e-3)
    with pytest.raises(ValueError):
        metrics.babelstream_bytes("nope", 8, 4)


def test_eq3_and_quartets_match_reference():
    for args in ((1, 26, 938, 65536), (4, 26, 938, 1 << 20)):
        assert metrics.minibude_ops(*args) == jax_metrics.minibude_ops(*args)
        assert metrics.minibude_gflops(*args, 0.5) == \
            jax_metrics.minibude_gflops(*args, 0.5)
    assert metrics.hartree_fock_quartets(8, 3) == \
        jax_metrics.hartree_fock_quartets(8, 3)


def test_eq4_matches_reference():
    perf = [(2.0, 1.0), (0.5, 1.0), (3.0, 4.0)]
    port = [metrics.Efficiency("h100", f"k{i}", p, b)
            for i, (p, b) in enumerate(perf)]
    ref = [jax_metrics.Efficiency("h100", f"k{i}", p, b)
           for i, (p, b) in enumerate(perf)]
    assert [t.e for t in port] == [t.e for t in ref]
    assert metrics.phi_bar(port) == jax_metrics.phi_bar(ref)
    with pytest.raises(ValueError):
        metrics.phi_bar([])
    with pytest.raises(ValueError):
        metrics.Efficiency("h100", "k", 1.0, 0.0).e


def test_oracle_tol_rows_equal_reference():
    assert set(conformance.ORACLE_TOL) == set(PORTED + LOOPS)
    assert set(conformance.CASES) == set(PORTED + LOOPS)
    for name in PORTED + LOOPS:
        assert conformance.ORACLE_TOL[name] == \
            jax_conformance.ORACLE_TOL[name]
        assert conformance.oracle_tolerance(name, "torch") == \
            jax_conformance.oracle_tolerance(name, "xla")


@pytest.mark.parametrize("name", PORTED)
def test_cases_are_the_reference_arrays(name):
    args, kwargs = conformance.CASES[name]()
    jax_args, jax_kwargs = jax_conformance.CASES[name]()
    assert kwargs == jax_kwargs == {}
    assert len(args) == len(jax_args)
    for i, (ours, theirs) in enumerate(zip(args, jax_args)):
        # float32 data; the decode case's positions are int32
        assert isinstance(ours, np.ndarray)
        assert ours.dtype == np.asarray(theirs).dtype
        assert ours.dtype in (np.float32, np.int32)
        if (name, i) in EXP_ARRAYS:
            np.testing.assert_array_max_ulp(ours, np.asarray(theirs),
                                            maxulp=2)
        else:
            np.testing.assert_array_equal(ours, np.asarray(theirs))
    tensors, _ = conformance.case_tensors(name, "cpu")
    for t, a in zip(tensors, args):
        np.testing.assert_array_equal(t.numpy(), a)


# ---- registry --------------------------------------------------------------
@pytest.mark.parametrize("name", PORTED)
def test_default_backend_for_cpu_tensors_is_torch(name):
    k = get_kernel(name)
    args, _ = conformance.case_tensors(name, "cpu")
    assert k.default_backend(*args) == "torch"
    assert k.native in ("triton", "cuda") and k.native in k.backends


@pytest.mark.parametrize("name", PORTED)
def test_hand_written_backend_unavailable_with_reason(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the hand-written backends "
                    "are available here")
    k = get_kernel(name)
    reason = k.backend(k.native).unavailable_reason()
    assert reason and "CUDA" in reason
    # torch and, for a science kernel, its sharded torch_shard
    assert k.available_backends() == sorted(
        {"torch", "torch_shard"} & set(k.backends))
    args, _ = conformance.case_tensors(name, "cpu")
    with pytest.raises(BackendUnavailableError, match=re.escape(reason)):
        k(*args, backend=k.native)
    with pytest.raises(BackendUnavailableError, match="not available"):
        conformance.check_backend(name, k.native)


def test_probes_check_only_the_toolchain(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    assert "nvcc" in portable.cuda_probe()
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    assert portable.cuda_probe() is None
    import importlib.util
    found = importlib.util.find_spec("triton") is not None
    assert (portable.triton_probe() is None) == found


def test_cuda_tensors_never_fall_back_to_the_oracle(monkeypatch):
    """On the card the default is the hand-written backend even when it
    cannot run: the call raises instead of quietly running the oracle."""
    k = PortableKernel(name="tmp.native", native="triton")
    k.add_backend("torch", lambda x: x)
    k.add_backend("triton", lambda x: x, probe=lambda: "no triton here")
    monkeypatch.setattr(portable, "_cuda_device",
                        lambda args, kwargs: torch.device("cuda", 0))
    x = torch.zeros(4)
    assert k.default_backend(x) == "triton"
    with pytest.raises(BackendUnavailableError, match="no triton here"):
        k(x)
    bare = PortableKernel(name="tmp.bare")
    bare.add_backend("torch", lambda x: x)
    with pytest.raises(BackendUnavailableError, match="no hand-written"):
        bare.default_backend(x)


def test_registry_create_get_and_errors():
    reg = KernelRegistry()
    k = reg.register(PortableKernel(name="tmp.k"))
    assert reg.get("tmp.k") is k and "tmp.k" in reg
    with pytest.raises(ValueError, match="duplicate"):
        reg.register(PortableKernel(name="tmp.k"))
    with pytest.raises(KeyError, match="registered kernels"):
        reg.get("tmp.none")
    assert register_kernel("stencil7") is registry.get("stencil7")
    with pytest.raises(KeyError, match="no backend"):
        k.backend("torch")
    with pytest.raises(ValueError, match="unknown roofline bound"):
        k.declare_roofline_contract("torch", bound="fast")


def test_tunable_spaces_declared():
    space = TunableSpace(params={"a": (1, 2), "b": ("x", "y")},
                         constraint=lambda p: p["a"] == 2)
    assert list(space.points()) == [
        {"a": 1, "b": "x"}, {"a": 1, "b": "y"},
        {"a": 2, "b": "x"}, {"a": 2, "b": "y"}]
    assert space.valid_points() == [{"a": 2, "b": "x"}, {"a": 2, "b": "y"}]
    dot = get_kernel("babelstream.dot").tunable_space("triton")
    assert dot.params == {"block": (1024, 2048, 4096), "num_warps": (4, 8)}
    st = get_kernel("stencil7").tunable_space("cuda")
    assert len(list(st.points())) == 27
    assert get_kernel("stencil7").roofline_contract("cuda") == \
        {"bound": "memory"}


def test_validate_tolerances_and_mismatches():
    k = PortableKernel(name="stencil7")
    k.add_backend("torch", lambda x: x * 1.0)
    k.add_backend("near", lambda x: x + 5e-6)
    k.add_backend("far", lambda x: x + 1e-3)
    k.add_backend("nan", lambda x: torch.where(x > 0, torch.nan, x))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(64))
    assert k.validate(x, backend="near") == pytest.approx(5e-6)
    with pytest.raises(AssertionError, match="outside rtol=1e-05"):
        k.validate(x, backend="far")
    with pytest.raises(AssertionError, match="elements outside"):
        k.validate(x, backend="nan")
    assert k.validate(x, backend="far", rtol=0.0, atol=2e-3) > 0


def test_time_backend_and_figure_of_merit_on_cpu():
    k = get_kernel("babelstream.triad")
    b, c = conformance.case_tensors("babelstream.triad")[0]
    t = k.time_backend(b, c, backend="torch", iters=3, warmup=1)
    assert t > 0
    fom = k.figure_of_merit(t, b, c)
    assert fom["gbytes_per_s"] == pytest.approx(3 * 4 * b.numel() / t / 1e9)


def test_registered_kernel_without_a_case_fails(monkeypatch):
    reg = KernelRegistry()
    k = reg.register(PortableKernel(name="tmp.nocase"))
    k.add_backend("torch", lambda x: x)
    monkeypatch.setattr(conformance, "registry", reg)
    with pytest.raises(AssertionError, match="no conformance tolerance"):
        conformance.check_backend("tmp.nocase", "torch")
    monkeypatch.setitem(conformance.ORACLE_TOL, "tmp.nocase", (0.0, 0.0))
    with pytest.raises(AssertionError, match="no conformance case"):
        conformance.check_backend("tmp.nocase", "torch")
    assert conformance.conformance_pairs() == [("tmp.nocase", "torch")]


# ---- wrappers and build: no fallback --------------------------------------
@pytest.mark.parametrize("fn,nargs", [
    (stream_kernel.copy, 1), (stream_kernel.mul, 1), (stream_kernel.add, 2),
    (stream_kernel.triad, 2), (stream_kernel.dot, 2)])
def test_stream_wrappers_reject_what_they_cannot_run(fn, nargs):
    meta = [torch.zeros(256, device="meta") for _ in range(nargs)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(*meta)
    with pytest.raises(ValueError, match="1-D"):
        fn(*[torch.zeros(2, 128) for _ in range(nargs)])
    if nargs == 2:
        with pytest.raises(ValueError, match="1-D tensors of one length"):
            fn(torch.zeros(128), torch.zeros(256))
    assert fn.launches == 0


def test_stencil_wrapper_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stencil_kernel.laplacian(torch.zeros(4, 4, 4, device="meta"))
    with pytest.raises(ValueError, match=">= 3"):
        stencil_kernel.laplacian(torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="volume"):
        stencil_kernel.laplacian(torch.zeros(8, 8))
    assert stencil_kernel.laplacian.launches == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    assert _build.sources() == ["flash_attention", "hartree_fock", "minibude",
                                "rwkv6", "stencil7"]
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with pytest.raises(_build.BuildError, match="(?s)exited 2.*no such target"):
        _build.build(["stencil7"])
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_build_keys_libraries_by_source_and_flags(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "print('ptxas info    : Used 24 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    libs = _build.build()
    lib = libs["stencil7"]
    assert lib.exists() and lib.parent == tmp_path / "kernels"
    assert "24 registers" in _build.build_log("stencil7")
    # one library per source, each under its own name
    assert sorted(p.name for p in lib.parent.glob("*.so")) == \
        sorted(p.name for p in libs.values())
    assert sorted(libs) == _build.sources()
    # a second build finds the library and runs nothing
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    assert _build.build()["stencil7"] == lib
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("stencil7") != lib


# ---- import isolation ------------------------------------------------------
def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        sorted((REPO / "examples").glob("torch_*.py")) + \
        [REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, bad
    assert len(_port_sources()) > 10


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.core.conformance, repro_torch._build\n"
        "import repro_torch.kernels.minibude.kernel\n"
        "import repro_torch.kernels.hartree_fock.kernel\n"
        "import repro_torch.kernels.flash_attention.kernel\n"
        "import repro_torch.kernels.rwkv6.kernel\n"
        "import repro_torch.configs, repro_torch.models.transformer\n"
        "import repro_torch.models.rwkv\n"
        "import repro_torch.training.serve_step, repro_torch.serving\n"
        "import repro_torch.core.tuning, repro_torch.core.telemetry\n"
        "import repro_torch.core.telemetry.cudamon\n"
        "import repro_torch.core.telemetry.__main__\n"
        "from repro_torch.core import conformance\n"
        "for name in sorted(conformance.CASES):\n"
        "    conformance.case_tensors(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(repro_torch.core.registry.names()) == 12\n"
        "print('isolated')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
