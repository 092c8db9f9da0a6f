"""Cache-key-completeness rule (PT2xx).

The executable cache's soundness rests on one sentence in
``exec_cache.py``: keys are content fingerprints of everything the
cached step bakes in. A regression in the JAX package was exactly a
violation: step bodies consulted ``use_pallas()`` (the
``PRESTO_TPU_PALLAS`` toggle) while the key did not fold it, so
flipping ``pallas_strings`` between queries served the stale kernel
variant from a warm hit. On the port that switch picks no code: the
string predicates launch the CUDA kernels on the card and their plain
versions on the CPU, and the session refuses a ``pallas_strings``
setting its device cannot take, so no step reads it. Should one ever
read ``pallas_strings`` or ``PRESTO_TPU_PALLAS``, it is a knob like any
other.

For every ``EXEC_CACHE.get_or_build(key, builder)`` site (the port's:
``exec/q1_route.py``'s fold and split step, ``exec/leaf_route.py``'s
fold and fused step, ``exec/joins.py``'s build and probe steps, the
operators' steps) the rule collects the *behavior knobs* the builder
reads: env flags (``os.environ[...PRESTO_TPU_*...]``), the knob helper
functions that wrap them (``narrow_enabled`` / ``prefetch_enabled``)
and session-property reads (``.prop("...")``), transitively through
same-project functions the builder calls, plus free variables the
builder captures whose defining expression reads a knob. Each knob must
then be *keyed*: one of its token aliases must appear among the
``key_of(...)`` arguments. Unlike the JAX package's, the port's
``key_of`` folds no knob of its own.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from presto_tpu_torch.analysis import astutil as A
from presto_tpu_torch.analysis.engine import ModuleInfo, Project, Rule, register

#: knob helper -> token aliases any of which satisfies the key check.
#: Aliases cover both the helper name and the conventional local names
#: its HOISTED result travels under (the repo bakes `pallas_ok` etc.).
KNOB_FUNCS = {
    "narrow_enabled": ("narrow_enabled", "narrow", "narrow_storage",
                       "PRESTO_TPU_NARROW"),
    "prefetch_enabled": ("prefetch_enabled", "prefetch",
                         "PRESTO_TPU_PREFETCH"),
}

#: call depth when chasing knob reads through project functions
MAX_DEPTH = 3


def _env_knob(call: ast.Call) -> Optional[str]:
    """`os.environ.get("PRESTO_TPU_X")` / `os.environ["..."]` reads."""
    name = A.call_name(call)
    if name in ("os.environ.get", "environ.get", "os.getenv", "getenv"):
        for s in A.string_constants(call):
            if s.startswith("PRESTO_TPU_"):
                return s
    return None


def _prop_knob(call: ast.Call) -> Optional[str]:
    """`<x>.prop("name")` / `<x>.properties.get("name")` reads."""
    name = A.call_name(call) or ""
    if name.endswith(".prop") or name.endswith("properties.get"):
        for s in A.string_constants(call):
            return s
    return None


class _FunctionIndex:
    """Project-wide name -> defs map for the transitive knob chase."""

    def __init__(self, project: Project):
        self.by_name: "dict[str, list[tuple[ModuleInfo, ast.AST]]]" = {}
        for mod in project.engine_modules():
            for fn in A.iter_functions(mod.tree):
                self.by_name.setdefault(fn.name, []).append((mod, fn))

    def lookup(self, name: str) -> "list[tuple[ModuleInfo, ast.AST]]":
        return self.by_name.get(name, [])


def collect_knobs(mod: ModuleInfo, node: ast.AST, index: _FunctionIndex,
                  depth: int = 0, seen: Optional[set] = None
                  ) -> "dict[str, tuple]":
    """knob id -> alias tuple for every knob read reachable from
    ``node`` (transitively through project functions, bounded)."""
    seen = set() if seen is None else seen
    knobs: "dict[str, tuple]" = {}
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        env = _env_knob(call)
        if env:
            knobs[f"env:{env}"] = (env, env.replace("PRESTO_TPU_", "")
                                   .lower())
            continue
        prop = _prop_knob(call)
        if prop:
            knobs[f"prop:{prop}"] = (prop,)
            continue
        fname = A.call_name(call)
        if fname is None:
            continue
        tail = fname.rsplit(".", 1)[-1]
        if tail in KNOB_FUNCS:
            knobs[tail] = KNOB_FUNCS[tail]
        elif depth < MAX_DEPTH and tail not in seen:
            targets = index.lookup(tail)
            # chase only unambiguous project-local callees: a name
            # defined in several modules would attribute one module's
            # env reads to every caller
            if len(targets) == 1:
                seen.add(tail)
                tmod, tfn = targets[0]
                knobs.update(collect_knobs(tmod, tfn, index,
                                           depth + 1, seen))
    return knobs


def _key_tokens(parts: "list[ast.expr]") -> "set[str]":
    """Every name / attribute-tail / string literal mentioned in the
    key expression — the vocabulary a knob alias must appear in."""
    toks: "set[str]" = set()
    for p in parts:
        for n in ast.walk(p):
            if isinstance(n, ast.Name):
                toks.add(n.id)
            elif isinstance(n, ast.Attribute):
                toks.add(n.attr)
            elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                toks.add(n.value)
                toks.update(n.value.split("_"))
    return toks


def _resolve_key(mod: ModuleInfo, key_expr: ast.expr, fn) -> Optional[list]:
    """The key_of argument list, None when the key does not go through
    key_of."""
    if isinstance(key_expr, ast.Call) and \
            (A.call_name(key_expr) or "").endswith("key_of"):
        return list(key_expr.args)
    if isinstance(key_expr, ast.Name) and fn is not None:
        val = A.simple_assignments(fn).get(key_expr.id)
        if isinstance(val, ast.Call) and \
                (A.call_name(val) or "").endswith("key_of"):
            return list(val.args)
    return None


def _builder_body(mod: ModuleInfo, builder: ast.expr, fn):
    """The AST to scan for knob reads: lambda body, or the local/module
    def a Name refers to."""
    if isinstance(builder, ast.Lambda):
        return builder
    if isinstance(builder, ast.Name):
        scope = fn
        while scope is not None:
            for f in A.iter_functions(scope):
                if f.name == builder.id:
                    return f
            scope = mod.enclosing_function(scope)
        for f in A.iter_functions(mod.tree):
            if f.name == builder.id:
                return f
    return builder


@register
class CacheKeyCompleteness(Rule):
    id = "PT201"
    name = "cache-key-completeness"
    severity = "error"
    description = (
        "a behavior knob read in a cached builder's closure (env flag, "
        "knob helper, session property) does not appear in the "
        "EXEC_CACHE key — a warm hit would serve the stale variant "
        "after the knob flips")
    motivation = (
        "the JAX package's Pallas regression: PRESTO_TPU_PALLAS was consulted at "
        "trace time but not folded into the key; flipping "
        "pallas_strings was silently inert on warm hits until key_of "
        "learned to fold it")

    def check_project(self, project: Project) -> Iterator:
        index = _FunctionIndex(project)
        for mod in project.engine_modules():
            yield from self._check_module(mod, index)

    def _check_module(self, mod: ModuleInfo, index: _FunctionIndex
                      ) -> Iterator:
        if mod.rel.replace("\\", "/").endswith("cache/exec_cache.py"):
            return  # the cache's own plumbing is not a call site
        for call in ast.walk(mod.tree):
            if not isinstance(call, ast.Call):
                continue
            if not (A.call_name(call) or "").endswith("get_or_build"):
                continue
            if len(call.args) < 2:
                continue
            fn = mod.enclosing_function(call)
            key_parts = _resolve_key(mod, call.args[0], fn)
            tokens = _key_tokens(key_parts) if key_parts else set()
            builder = _builder_body(mod, call.args[1], fn)

            knobs = collect_knobs(mod, builder, index)
            # free variables the builder captures whose defining
            # expression reads a knob must themselves ride in the key
            # (the hoisted-decision pattern: pallas_ok et al.)
            if fn is not None:
                assigns = A.simple_assignments(fn)
                bound_in_builder = A.names_stored(builder) | (
                    A.func_params(builder) | A.vararg_params(builder)
                    if isinstance(builder,
                                  (ast.Lambda, ast.FunctionDef)) else set())
                for free in sorted(A.names_loaded(builder)
                                   - bound_in_builder):
                    val = assigns.get(free)
                    if val is None or id(val) == id(builder):
                        continue
                    for knob, aliases in collect_knobs(
                            mod, val, index).items():
                        knobs.setdefault(
                            knob + f"->{free}", tuple(aliases) + (free,))

            for knob in sorted(knobs):
                aliases = knobs[knob]
                base = knob.split("->")[0]
                if key_parts is None:
                    # unresolvable key: only complain when a knob is
                    # actually at stake (otherwise stay silent — the
                    # builder may be uncacheable by design)
                    yield mod.finding(
                        self.id, self.severity, call,
                        f"cached builder reads knob `{base}` but the "
                        "cache key does not go through "
                        "EXEC_CACHE.key_of — completeness cannot be "
                        "verified",
                        hint="build the key with EXEC_CACHE.key_of and "
                             "fold the knob in", knob=base)
                    continue
                if not any(a in tokens for a in aliases):
                    yield mod.finding(
                        self.id, self.severity, call,
                        f"knob `{base}` is read in the cached builder's "
                        "closure but none of its aliases "
                        f"{sorted(set(aliases))} appear in the "
                        "EXEC_CACHE key — a warm hit serves the stale "
                        "variant after the knob flips",
                        hint="add the knob (or the hoisted local baked "
                             "from it) to EXEC_CACHE.key_of(...)",
                        knob=base)
