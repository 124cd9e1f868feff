"""Count the SASS instructions of a built kernel's innermost loop.

    python -m repro_torch._sass LIBRARY [--match NAME] [--marker OPCODE]

Disassembles a shared library built by ``_build`` (``cuobjdump -sass``, from
the toolkit beside ``nvcc``), finds in every kernel whose mangled name holds
``NAME`` the innermost loops (a backward branch and the instructions from its
target to it) that hold ``OPCODE``, and prints one JSON line a kernel: each
such loop's instruction count, its ``OPCODE`` count, and their ratio.  With
the default ``MUFU.RSQ``, which a precise ``sqrtf`` issues once, that ratio
is the instructions a miniBUDE interaction takes, whatever the loop's unroll.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch import _build

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+)\s*:")
_LABEL_TARGET = re.compile(r"`\((\.L_x_\d+)\)")
_HEX_TARGET = re.compile(r"\b0x([0-9a-fA-F]+)\b")


def disassemble(library: Path) -> str:
    """``cuobjdump -sass`` of ``library``."""
    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise _build.BuildError("no CUDA toolkit: cannot find cuobjdump")
    tool = Path(nvcc).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def functions(sass: str) -> Dict[str, List[Tuple[int, str]]]:
    """{mangled name: [(address, instruction text)]}, with each branch's
    label target (``.L_x_N``) rewritten as ``0x<address>``."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    name, body, labels = None, [], {}
    pending: List[str] = []

    def close():
        if name is not None:
            out[name] = [(a, _LABEL_TARGET.sub(
                lambda m: hex(labels.get(m.group(1), -1)), text))
                for a, text in body]

    for line in sass.splitlines():
        f = _FUNCTION.match(line)
        if f:
            close()
            name, body, labels, pending = f.group(1), [], {}, []
            continue
        if name is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _INSTRUCTION.match(line)
        if ins:
            addr = int(ins.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            body.append((addr, ins.group(2).strip()))
    close()
    return out


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def inner_loops(body: List[Tuple[int, str]], marker: str = "MUFU.RSQ"
                ) -> List[Dict[str, int]]:
    """The innermost loops of one kernel that hold ``marker``: for each, its
    first and last address, its instructions and its ``marker``s."""
    loops = []
    for addr, text in body:
        if _opcode(text).split(".")[0] != "BRA":
            continue
        target = _HEX_TARGET.search(text)
        if target is None or int(target.group(1), 16) > addr:
            continue
        start = int(target.group(1), 16)
        ops = [_opcode(t) for a, t in body if start <= a <= addr]
        count = sum(op.startswith(marker) for op in ops)
        if count:
            loops.append({"start": start, "end": addr,
                          "instructions": len(ops), "markers": count})
    # innermost: no other marked loop lies inside it
    return [lp for lp in loops
            if not any(o is not lp and lp["start"] <= o["start"]
                       and o["end"] <= lp["end"] for o in loops)]


def per_marker(library: Path, match: str, marker: str = "MUFU.RSQ"
               ) -> Dict[str, List[Dict[str, float]]]:
    """{kernel: [innermost marked loop, with ``per_marker`` = instructions /
    markers]} for every kernel of ``library`` whose name holds ``match``."""
    report = {}
    for name, body in functions(disassemble(library)).items():
        if match in name:
            report[name] = [dict(lp, per_marker=lp["instructions"]
                                 / lp["markers"])
                            for lp in inner_loops(body, marker)]
    return report


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("library", type=Path)
    p.add_argument("--match", default="", help="part of the kernel's name")
    p.add_argument("--marker", default="MUFU.RSQ",
                   help="opcode that one iteration of the counted work issues")
    args = p.parse_args()
    for name, loops in per_marker(args.library, args.match,
                                  args.marker).items():
        print(json.dumps({"kernel": name, "loops": loops}))


if __name__ == "__main__":
    main()
