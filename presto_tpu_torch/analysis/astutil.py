"""Small shared AST helpers the rule modules lean on."""

from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains (None for anything whose
    base is not a plain name — e.g. ``f().x``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def func_params(fn) -> "set[str]":
    """Positional + keyword parameter names (NOT *args/**kwargs — a
    varargs tuple is static pytree structure, not a traced value)."""
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    return names


def vararg_params(fn) -> "set[str]":
    a = fn.args
    out = set()
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)
    return out


def iter_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def string_constants(node: ast.AST) -> Iterator[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value


def names_loaded(node: ast.AST) -> "set[str]":
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def names_stored(node: ast.AST) -> "set[str]":
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(
                n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            out.add(n.name)
    return out


def in_with_block(mod, node: ast.AST, item_pred) -> bool:
    """True when ``node`` sits lexically inside a ``with`` statement one
    of whose context expressions satisfies ``item_pred(expr)``."""
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if item_pred(item.context_expr):
                    return True
    return False


def simple_assignments(fn) -> "dict[str, ast.expr]":
    """name -> value expr for plain single-target assignments directly
    inside ``fn`` (last one wins; good enough for knob-flow checks)."""
    out: "dict[str, ast.expr]" = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            out[node.target.id] = node.value
    return out
