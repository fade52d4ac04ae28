"""Shared AST helpers for the port's RPL rules: dotted-name resolution,
names read by an expression, the names a function binds, and each node's
enclosing function.

The counterpart of `repro.analysis.astutil` without `iter_traced_bodies`
and `tainted_names`: only RPL001 (tracer leaks in `lax.scan` bodies) used
them, and eager PyTorch has no traced bodies."""
from __future__ import annotations

import ast

__all__ = ["dotted_name", "enclosing_functions", "local_bindings", "names_in"]


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` for Name/Attribute chains, None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set[str]:
    """Every Name identifier loaded anywhere inside `node`."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _param_names(fn: ast.FunctionDef | ast.Lambda) -> set[str]:
    a = fn.args
    out = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)
    return out


def local_bindings(fn: ast.FunctionDef | ast.Lambda) -> set[str]:
    """Every name bound inside the function (params, assignment/loop/with
    targets, comprehension targets, nested defs, imports)."""
    bound = _param_names(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Import):
            bound.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            bound.update(a.asname or a.name for a in node.names)
    return bound


def enclosing_functions(tree: ast.AST) -> dict[int, str]:
    """Map id(node) -> name of the nearest enclosing function def, for
    rules that exempt specific audited helpers."""
    out: dict[int, str] = {}

    def visit(node: ast.AST, current: str | None):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            current = node.name
        for child in ast.iter_child_nodes(node):
            if current is not None:
                out[id(child)] = current
            visit(child, current)

    visit(tree, None)
    return out
