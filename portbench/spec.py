"""Finds every piece of a cell by the names ``BENCHMARK.json`` gives.

  * ``BENCHMARK.json`` at the checkout's root: the cells and metrics;
  * ``configs/<config>.json`` (the entry's ``file``): the model's sizes as
    run (``arch``, the port's ``ModelConfig`` fields), the engine's
    geometry, the source, what was assumed, and the CPU tests' ``smoke``
    sizes; and, where the model needs its own, the files of its weight
    layout, reference and arithmetic (``module``);
  * ``traffic/<traffic>.json``: the mix's parameters (``traffic.py``);
  * ``cells/<cell>.json``: what belongs to one cell alone: the open
    loop's rate and the limits of the numbers ``judge.py`` compares;
  * ``metrics/<metric>.py``: one reader a metric (``read(ctx)``);
  * a configuration's ``"weights"``, ``"reference"`` and ``"counts"``:
    paths relative to this directory of the modules that draw its weights
    (``draw``), compute its plain reference (``served_logits``) and count
    its model flops (``prefill_flops``, ``decode_token_flops``); without
    the key, ``weights.py``, ``reference.py`` and ``counts.py``.

A later cell, mix, metric or model is a new file and a new entry; no file
here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: what a configuration's own module of each kind has to give
MODULE_FUNCTIONS = {"weights": ("draw",), "reference": ("served_logits",),
                    "counts": ("prefill_flops", "decode_token_flops")}


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r}; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: Dict[str, Any], name: str,
           root: Path = ROOT) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r}")


def traffic(name: str) -> Dict[str, Any]:
    return load_json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> Dict[str, Any]:
    path = HERE / "cells" / f"{name}.json"
    return load_json(path) if path.exists() else {}


def metrics(bench: Dict[str, Any], cell_name: str,
            trace: bool) -> List[Dict[str, Any]]:
    """The metrics this cell reports in this kind of run: an end-to-end
    metric that lists the cell (or lists none), a per-layer metric that
    lists it, or that lists none and moves an end-to-end metric the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str) -> Callable[[Any], Any]:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def module(config: Dict[str, Any], kind: str) -> ModuleType:
    """The configuration's module of ``kind`` (``weights``, ``reference``
    or ``counts``): the file its key names, loaded once a process, or
    ``portbench.<kind>`` where it names none."""
    if kind not in MODULE_FUNCTIONS:
        raise KeyError(f"no module kind {kind!r}")
    if kind not in config:
        return importlib.import_module(f"portbench.{kind}")
    path = HERE / config[kind]
    name = "portbench._config_" + re.sub(r"\W", "_", config[kind])
    mod = sys.modules.get(name)
    if mod is None or Path(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    missing = [f for f in MODULE_FUNCTIONS[kind] if not hasattr(mod, f)]
    if missing:
        raise AttributeError(f"{path} gives no {missing}")
    return mod
