"""Compile the CUDA C++ kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` into its own shared library, which ``ctypes`` loads — no PyTorch
headers, so a build takes seconds.  Libraries go into the checkout's
git-ignored ``build/kernels/`` directory under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is not.  A missing ``nvcc`` or a failed compile raises ``BuildError``;
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# sm_90a (not sm_90) keeps wgmma/setmaxnreg open to later kernels;
# -Xptxas -v writes each kernel's registers and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


@functools.lru_cache(maxsize=None)
def nvcc_path() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``), else None.  Looked up once per process: the
    ``cuda`` backends' availability probe asks on every call."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def sources() -> List[str]:
    """Names of every ``csrc/*.cu`` kernel source."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named sources (default: all), one ``nvcc`` per source, all
    started together; return name -> library path.  Libraries already built
    from the same source and flags are reused."""
    libs = {n: library_path(n) for n in (sources() if names is None
                                         else names)}
    missing = {n: p for n, p in libs.items() if not p.exists()}
    if not missing:
        return libs
    nvcc = nvcc_path()
    if nvcc is None:
        raise BuildError(
            f"nvcc not found on PATH or under $CUDA_HOME/bin: cannot build "
            f"{sorted(missing)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, lib in missing.items():
        # compile to a private name, then rename: concurrent builds of
        # the same source never load a half-written library
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        log = lib.with_suffix(".log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=out, stderr=subprocess.STDOUT)
        running.append((name, lib, tmp, log, proc))
    failed = []
    for name, lib, tmp, log, proc in running:
        if proc.wait() != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{log.read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise BuildError("\n".join(failed))
    return libs


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/spill report) for the current build."""
    return library_path(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build([name])[name]))
