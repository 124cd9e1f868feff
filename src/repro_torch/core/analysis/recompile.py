"""Recompile pass — an AST scan for scalar-keyed trace-producing builders.

The port of ``repro/core/analysis/recompile.py``.  The bug class: an
``lru_cache``-wrapped builder that compiles, captures or loads a program
for its Python arguments turns every distinct *value* of those arguments
into a separate program.  That is right for shapes, tile sizes and other
static configuration, and a silent compile storm for runtime scalars that
should have been operands.

The detector is purely syntactic (nothing of the scanned module runs
beyond its import):

  * a **builder** is an ``lru_cache``-decorated function whose body calls a
    trace producer of the port: ``torch.compile``, ``torch.cuda.graph`` /
    ``CUDAGraph`` / ``make_graphed_callables``, ``triton.jit``, or the nvcc
    loader of ``_build.py`` (``load``, ``build``) — the reference's
    ``jit`` / ``shard_map`` / ``pallas_call`` / ``pmap``.  So each
    kernel's ``_library()``, ``_build.load`` and every such cache is in
    scope;
  * a **hazard** is a builder call site passing ``float(...)``, a float
    literal, or a bare name bound to an enclosing function parameter with
    a float default — the syntactic signature of a runtime scalar entering
    the cache key;
  * a builder may **waive** its scalar keys with a structured comment
    anywhere in its body or decorators::

        # audit: compile-time-constant(scalar) — one program per value is
        # the declared contract

    Waived hazards stay in the report (as ``waived``), visible.
"""

from __future__ import annotations

import ast
import functools
import re
from typing import Any, Dict, List, Optional

#: callables whose presence makes an lru_cache'd function trace-producing
#: (the last segment of the call's dotted name)
TRACE_PRODUCERS = ("compile", "graph", "CUDAGraph", "make_graphed_callables",
                   "jit", "load", "build")

_WAIVER_RE = re.compile(
    r"audit:\s*compile-time-constant\s*(?:\(([^)]*)\))?[^\n]*")


def _call_name(node: ast.AST) -> Optional[str]:
    """Last dotted segment of a call target: torch.compile -> 'compile'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_lru_cache(dec: ast.AST) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    return _call_name(target) in ("lru_cache", "cache")


def _find_builders(tree: ast.Module) -> List[ast.FunctionDef]:
    builders = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(_is_lru_cache(d) for d in node.decorator_list):
            continue
        calls = {_call_name(c.func) for c in ast.walk(node)
                 if isinstance(c, ast.Call)}
        if calls & set(TRACE_PRODUCERS):
            builders.append(node)
    return builders


def _builder_waiver(node: ast.FunctionDef, lines: List[str]) -> Optional[str]:
    start = min([node.lineno]
                + [d.lineno for d in node.decorator_list]) - 1
    end = getattr(node, "end_lineno", node.lineno)
    m = _WAIVER_RE.search("\n".join(lines[start:end]))
    return m.group(0).strip() if m else None


def _float_defaults(fn: ast.FunctionDef) -> Dict[str, float]:
    """Parameter name -> default, for params with float-literal defaults."""
    out: Dict[str, float] = {}
    a = fn.args
    pos = a.posonlyargs + a.args
    for name, default in zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                             a.defaults):
        if isinstance(default, ast.Constant) and isinstance(default.value,
                                                            float):
            out[name] = default.value
    for p, default in zip(a.kwonlyargs, a.kw_defaults):
        if isinstance(default, ast.Constant) and isinstance(default.value,
                                                            float):
            out[p.arg] = default.value
    return out


def _hazardous_arg(arg: ast.AST,
                   enclosing_float_params: Dict[str, float]) -> Optional[str]:
    if isinstance(arg, ast.Call) and _call_name(arg.func) == "float":
        return f"float({ast.unparse(arg.args[0]) if arg.args else ''})"
    if isinstance(arg, ast.Constant) and isinstance(arg.value, float):
        return f"float literal {arg.value}"
    if isinstance(arg, ast.Name) and arg.id in enclosing_float_params:
        return (f"parameter {arg.id!r} (float default "
                f"{enclosing_float_params[arg.id]})")
    return None


def scan_source(src: str, where: str = "<string>") -> List[Dict[str, Any]]:
    """Scan one module's source.  Returns raw hazard dicts: the caller
    wraps them into Findings with its own kernel/backend attribution."""
    tree = ast.parse(src, filename=where)
    lines = src.splitlines()
    builders = {b.name: b for b in _find_builders(tree)}
    if not builders:
        return []
    hazards: List[Dict[str, Any]] = []
    seen = set()

    class Visitor(ast.NodeVisitor):
        def __init__(self) -> None:
            self.stack: List[ast.FunctionDef] = []

        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            self.stack.append(node)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node: ast.Call) -> None:
            name = _call_name(node.func)
            builder = builders.get(name)
            if builder is not None and (name, node.lineno) not in seen:
                floats = {}
                for fn in self.stack:
                    floats.update(_float_defaults(fn))
                reasons = []
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    why = _hazardous_arg(arg, floats)
                    if why is not None:
                        reasons.append(why)
                if reasons:
                    seen.add((name, node.lineno))
                    waiver = _builder_waiver(builder, lines)
                    hazards.append({
                        "builder": name,
                        "module": where,
                        "line": node.lineno,
                        "scalars": reasons,
                        "waiver": waiver,
                    })
            self.generic_visit(node)

    Visitor().visit(tree)
    return hazards


@functools.lru_cache(maxsize=None)
def scan_module(module_name: str) -> tuple:
    """Scan an importable module by name (cached — pass 4 is per-module,
    many registry cells share a module).  Unreadable sources scan empty."""
    import importlib
    import inspect
    try:
        mod = importlib.import_module(module_name)
        src = inspect.getsource(mod)
    except (ImportError, OSError, TypeError):
        return ()
    return tuple(
        tuple(sorted(h.items(), key=lambda kv: kv[0]))
        for h in scan_source(src, module_name))


def module_of(fn: Any) -> Optional[str]:
    """Defining module of a backend fn, unwrapping functools.partial."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "__module__", None)
