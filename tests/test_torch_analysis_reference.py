"""The port's static auditor held against the JAX package's own numbers.

The reference's auditor (``repro.core.analysis``) does not import under
this host's jax: its ``jaxpr_utils.py`` imports ``ClosedJaxpr`` from
``jax.core``, which jax 0.9 moved to ``jax.extend.core``, and ``dtypes.py``
reads ``jax.experimental.enable_x64``.  A child process, one per file (a
module-scoped fixture), sets those three aliases and ``enable_x64``, forces
8 host devices, runs the reference and returns JSON; the aliases never
enter the pytest process, so whether ``tests/test_static_analysis.py``
imports does not depend on which worker ran this file.  Nothing in
``src/repro`` changes.

Held, on the same case inputs (``core/conformance.py``, the reference's
draws):

  * the ``torch`` cells against the reference's ``xla`` cells: the
    compulsory boundary bytes equal, the roofline verdict (both on the
    CPU host's spec) equal, and the flops within ``FLOPS_RTOL``;
  * the ``torch_shard`` cells against ``xla_shard``: the collective census
    of every contract variant equal, where the reference traces
    (``babelstream.dot``'s reference reading is jax 0.9's spelling of a
    psum as ``psum_invariant``, which its census does not count, and the
    port is held to the declared one psum; miniBUDE's and Hartree-Fock's
    sharded cells do not trace under jax 0.9, and the port is held to the
    declared contract);
  * the recompile scanner against the reference's on the same sources,
    ``jax.jit`` swapped for ``torch.compile``: the same hazards, lines and
    waivers.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro_torch.core import analysis, conformance
from repro_torch.core.analysis import collectives_audit, recompile
from repro_torch.core.analysis import trace as T
from repro_torch.core.portable import registry

SRC = Path(__file__).resolve().parents[1] / "src"

#: the registry kernels with a ``torch`` cell in the port and an ``xla``
#: cell in the reference
KERNELS = ("stencil7", "babelstream.copy", "babelstream.mul",
           "babelstream.add", "babelstream.triad", "babelstream.dot",
           "minibude.fasten", "hartree_fock.twoel", "attention.flash",
           "attention.decode", "rwkv6.wkv")
#: the kernels with a sharded oracle backend in both
SHARDED = ("stencil7", "babelstream.copy", "babelstream.mul",
           "babelstream.add", "babelstream.triad", "babelstream.dot",
           "minibude.fasten", "hartree_fock.twoel")
#: ATen and XLA decompose the same arithmetic into different ops (a
#: ``where`` and a ``clamp`` where XLA has one ``select_n``, a softmax as
#: eager's five ops), and each counts an elementwise op as one flop an
#: element: the counts agree within 5% (the largest gap is Hartree-Fock's,
#: 3.5%)
FLOPS_RTOL = 0.05

_HAZARD = textwrap.dedent("""
    import functools
    import {mod}

    @functools.lru_cache(maxsize=None)
    def _build(n, scalar):
        return {producer}(lambda x: x * scalar + n)

    def entry(x, scalar=0.5):
        return _build(x.shape[0], float(scalar))(x)

    def bare(x, scalar=0.5):
        return _build(2, scalar)(x)
""")


def _sources(mod: str, producer: str):
    hazard = _HAZARD.format(mod=mod, producer=producer)
    return {
        "hazard": hazard,
        "waived": hazard.replace(
            f"    return {producer}",
            "    # audit: compile-time-constant(scalar) — one program per "
            f"value\n    return {producer}"),
        "shape-keyed": hazard.replace("float(scalar))", "2 * n)").replace(
            "_build(2, scalar)", "_build(2, 3)"),
        "literal": hazard.replace("float(scalar))", "0.25)"),
    }


_CHILD = r"""
import json, sys
import jax
import jax.core
import jax.experimental
import jax.extend.core as jec
for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
    setattr(jax.core, name, getattr(jec, name))
jax.experimental.enable_x64 = jax.enable_x64
from repro.core import analysis, conformance
from repro.core.analysis import collectives_audit, recompile
from repro.core.analysis import jaxpr_utils as JU
import repro.kernels, repro.distributed.domain
from repro.core.portable import registry
kernels, sharded, sources = json.loads(sys.stdin.read())
out = {"cells": {}, "census": {}, "recompile": {}}
for kernel in kernels:
    cost = analysis.audit_cell(kernel, "xla", smoke=True).cost
    t = cost["traffic"]
    out["cells"][kernel] = {"floor": t["hbm_min_bytes"], "flops": t["flops"],
                            "bound": cost["verdict"]["bound"]}
for kernel in sharded:
    k = registry.get(kernel)
    args, kwargs = conformance.CASES[kernel]()
    fn = k.backend("xla_shard").fn
    for vkw, _ in collectives_audit.normalize_contract(
            k.comm_contract("xla_shard"), args):
        try:
            got = JU.count_collectives(
                JU.trace(fn, args, {**kwargs, **vkw}).jaxpr)
        except Exception as exc:
            got = {"error": f"{type(exc).__name__}: {str(exc)[:120]}"}
        out["census"].setdefault(kernel, []).append(
            [sorted(vkw.items()), got])
for name, src in sources.items():
    out["recompile"][name] = recompile.scan_source(src, "planted_mod")
print(json.dumps(out, default=repr))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(SRC) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                        "--xla_force_host_platform_device_count=8").strip()
    payload = json.dumps([KERNELS, SHARDED, _sources("jax", "jax.jit")])
    proc = subprocess.run([sys.executable, "-c", _CHILD], input=payload,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def ours():
    return {kernel: analysis.audit_cell(kernel, "torch", smoke=True).cost
            for kernel in KERNELS}


@pytest.mark.parametrize("kernel", KERNELS)
def test_boundary_bytes_equal_the_reference(reference, ours, kernel):
    assert ours[kernel]["traffic"]["hbm_min_bytes"] == \
        reference["cells"][kernel]["floor"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_bound_verdict_equals_the_reference(reference, ours, kernel):
    assert ours[kernel]["verdict"]["chip"] == "cpu-host"
    assert ours[kernel]["verdict"]["bound"] == \
        reference["cells"][kernel]["bound"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_flops_match_the_reference(reference, ours, kernel):
    assert ours[kernel]["traffic"]["flops"] == pytest.approx(
        reference["cells"][kernel]["flops"], rel=FLOPS_RTOL)


def _variants(kernel):
    k = registry.get(kernel)
    args, kwargs = conformance.CASES[kernel]()
    fn = k.backend("torch_shard").fn
    for vkw, expected in collectives_audit.normalize_contract(
            k.comm_contract("torch_shard"), args):
        counts = T.count_collectives(T.trace(fn, args, {**kwargs, **vkw}))
        yield vkw, expected, counts


def _json_variant(vkw):
    return [[name, list(v) if isinstance(v, tuple) else v]
            for name, v in sorted(vkw.items())]


@pytest.mark.parametrize("kernel", SHARDED)
def test_collective_census_equals_the_reference(reference, kernel):
    theirs = reference["census"][kernel]
    ours = list(_variants(kernel))
    assert [_json_variant(v) for v, _, _ in ours] == [v for v, _ in theirs]
    for (vkw, expected, counts), (_, ref) in zip(ours, theirs):
        declared = {c: int(expected.get(c, 0)) for c in T.COLLECTIVE_KINDS}
        if "error" in ref:
            # miniBUDE and Hartree-Fock: the reference's sharded scan does
            # not trace under jax 0.9; the port holds its declared contract
            assert "scan body function carry" in ref["error"], ref
            assert counts == declared, (vkw, counts)
        elif kernel == "babelstream.dot":
            # jax 0.9 spells the shard_map psum ``psum_invariant``, which
            # the reference's PSUM_PRIMITIVES does not count: it reads 0
            assert ref == {"ppermute": 0, "psum": 0, "all_gather": 0}
            assert counts == declared == {"ppermute": 0, "psum": 1,
                                          "all_gather": 0}
        else:
            assert counts == ref == declared, (vkw, counts, ref)


@pytest.mark.parametrize("name", ["hazard", "waived", "shape-keyed",
                                  "literal"])
def test_recompile_scanner_equals_the_reference(reference, name):
    ours = recompile.scan_source(_sources("torch", "torch.compile")[name],
                                 "planted_mod")
    theirs = reference["recompile"][name]
    assert ours == theirs
    if name == "shape-keyed":
        assert ours == []
    else:
        # the waiver's comment moves the call sites a line down
        assert [h["line"] for h in ours] == \
            ([11, 14] if name == "waived" else [10, 13])
        assert (ours[0]["waiver"] is not None) == (name == "waived")
