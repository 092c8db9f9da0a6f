"""Global-state hygiene rules (PT4xx), carried over as they are.

The port carries the JAX package's process-global state: the
``PRESTO_TPU_*`` env switches (``PRESTO_TPU_NARROW``, read by
``spi.narrow_enabled`` at scan time and written by
``runtime/session.py``'s ``_mirror_switches``), the process-wide
``EXEC_CACHE``, the ``REGISTRY`` metrics singleton and the global
memory pool. Code that mutates any of these without restoring bleeds
into every later query or test in the process. These rules make the
restore discipline mechanical; the runtime twin is the autouse
``_global_state_guard`` fixture in ``tests/conftest.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from presto_tpu_torch.analysis import astutil as A
from presto_tpu_torch.analysis.engine import ModuleInfo, Rule, register

ENV_PREFIX = "PRESTO_TPU_"

#: process-global mutators that cannot be value-restored: a test using
#: one must declare it with this pytest marker (the conftest guard
#: enforces the same contract at runtime)
RESET_MARKER = "resets_global_state"


def _env_key(node: ast.AST) -> Optional[str]:
    """The PRESTO_TPU key a mutation touches, if statically known."""
    for s in A.string_constants(node):
        if s.startswith(ENV_PREFIX):
            return s
    return None


def _is_environ(expr: ast.expr) -> bool:
    name = A.dotted(expr)
    return name in ("os.environ", "environ")


def _env_mutations(tree: ast.AST):
    """(node, key|None) for every direct os.environ mutation."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        _is_environ(tgt.value):
                    yield node, _env_key(tgt)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        _is_environ(tgt.value):
                    yield node, _env_key(tgt)
        elif isinstance(node, ast.Call):
            name = A.call_name(node) or ""
            if name in ("os.environ.pop", "environ.pop",
                        "os.environ.setdefault", "environ.setdefault",
                        "os.environ.update", "environ.update",
                        "os.putenv"):
                yield node, _env_key(node)


def _first_yield_line(fn) -> Optional[int]:
    for node in ast.walk(fn):
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            return node.lineno
    return None


def _has_restoring_finally(fn: ast.AST, restore_pred) -> bool:
    """True when ANY try in the function restores in its finalbody —
    the repo's snapshot-mutate-try-finally-restore shape puts the
    mutation BEFORE the try, so ancestor-only search would miss it."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                if restore_pred(stmt):
                    return True
    return False


def _has_mark(decorators, marker: str) -> bool:
    for dec in decorators:
        name = A.dotted(dec if not isinstance(dec, ast.Call)
                        else dec.func) or ""
        if name.endswith("mark." + marker):
            return True
    return False


def _marked(mod: ModuleInfo, node: ast.AST, marker: str) -> bool:
    """The declaration surfaces pytest itself accepts: an enclosing
    function or class decorator, or a module-level ``pytestmark``
    assignment — the static rule must accept exactly what the runtime
    conftest guard's ``get_closest_marker`` accepts."""
    fn = mod.enclosing_function(node)
    while fn is not None:
        if _has_mark(fn.decorator_list, marker):
            return True
        fn = mod.enclosing_function(fn)
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.ClassDef) and \
                _has_mark(anc.decorator_list, marker):
            return True
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in stmt.targets):
            marks = stmt.value.elts if isinstance(
                stmt.value, (ast.List, ast.Tuple)) else [stmt.value]
            if _has_mark(marks, marker):
                return True
    return False


@register
class EnvMutationWithoutRestore(Rule):
    id = "PT401"
    name = "env-mutation-without-restore"
    severity = "error"
    description = (
        "direct PRESTO_TPU_* os.environ mutation without a restore "
        "path (monkeypatch, try/finally, or post-yield fixture "
        "teardown)")
    motivation = (
        "the test_narrowing env discipline: sessions mirror "
        "narrow_storage into process-global env, and "
        "an unrestored switch silently re-routes every later test")

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        for node, key in _env_mutations(mod.tree):
            if key is None:
                continue  # non-PRESTO keys are out of scope
            fn = mod.enclosing_function(node)
            if fn is not None and self._restored(mod, fn, node, key):
                continue
            if _marked(mod, node, RESET_MARKER):
                continue
            where = "test" if mod.is_test else "engine code"
            yield mod.finding(
                self.id, self.severity, node,
                f"`{key}` mutated in {where} without a restore path",
                hint="use monkeypatch.setenv / monkeypatch.delenv, or "
                     "restore in try/finally or fixture teardown "
                     "(after the yield)")

    @staticmethod
    def _restored(mod: ModuleInfo, fn, node: ast.AST, key: str) -> bool:
        def restores_key(stmt):
            # a restore must touch THIS key (or a dynamic key the
            # analysis cannot see — give those the benefit of the
            # doubt): a finally that puts back PRESTO_TPU_A does not
            # restore PRESTO_TPU_B
            return any(k == key or k is None
                       for _n, k in _env_mutations(stmt))

        if _has_restoring_finally(fn, restores_key):
            return True
        yline = _first_yield_line(fn)
        if yline is not None:
            if node.lineno > yline:
                return True  # this IS the teardown mutation
            return any(n.lineno > yline and (k == key or k is None)
                       for n, k in _env_mutations(fn))
        return False


@register
class GlobalRegistryMutationInTest(Rule):
    id = "PT402"
    name = "global-registry-mutation-in-test"
    severity = "error"
    description = (
        "test mutates a process-global registry (REGISTRY.reset, "
        "EXEC_CACHE.clear/set_max_entries, metrics HISTOGRAM_BOUNDS) "
        "without restore or an explicit resets_global_state marker")
    motivation = (
        "REGISTRY.reset() detaches every live stat handle process-wide "
        "— an undeclared reset makes later differential assertions "
        "read freshly-zeroed counters (phantom passes)")

    #: receiver.method patterns that hit process-global state. reset/
    #: clear are unrestorable (marker required); set_max_entries can be
    #: value-restored (teardown/finally accepted).
    UNRESTORABLE = {"REGISTRY.reset", "EXEC_CACHE.clear"}
    RESTORABLE = {"EXEC_CACHE.set_max_entries"}

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        if not mod.is_test:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = A.call_name(node) or ""
            if name in self.UNRESTORABLE:
                if _marked(mod, node, RESET_MARKER):
                    continue
                yield mod.finding(
                    self.id, self.severity, node,
                    f"`{name}()` wipes process-global state for every "
                    "later test in the process",
                    hint=f"declare it: @pytest.mark.{RESET_MARKER} "
                         "(the conftest guard then allows it), or use "
                         "a local MetricsRegistry() instance")
            elif name in self.RESTORABLE:
                fn = mod.enclosing_function(node)
                if fn is not None and self._restored(mod, fn, node, name):
                    continue
                if _marked(mod, node, RESET_MARKER):
                    continue
                yield mod.finding(
                    self.id, self.severity, node,
                    f"`{name}(...)` changes a process-global bound "
                    "without restoring it",
                    hint="restore the prior value in try/finally or "
                         "fixture teardown")

    @staticmethod
    def _restored(mod: ModuleInfo, fn, node: ast.AST, name: str) -> bool:
        def calls_same(stmt):
            return any(isinstance(n, ast.Call) and
                       (A.call_name(n) or "") == name
                       for n in ast.walk(stmt))

        if _has_restoring_finally(fn, calls_same):
            return True
        yline = _first_yield_line(fn)
        if yline is not None:
            if node.lineno > yline:
                return True
            return any(isinstance(n, ast.Call) and
                       (A.call_name(n) or "") == name and
                       n.lineno > yline for n in ast.walk(fn))
        return False


@register
class RawTraceProbeInTest(Rule):
    id = "PT403"
    name = "raw-trace-probe-in-test"
    severity = "warning"
    description = (
        "differential test reads the process-global `exec.traces` "
        "probe outside a `trace_delta()` window")
    motivation = (
        "a phantom regression in the JAX package: hand-rolled snapshot/subtract "
        "windows over the process-global counter miscount when any "
        "other session's run interleaves; exec_cache.trace_delta owns "
        "the window bookkeeping")

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        if not mod.is_test:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            # resolve the method/function name even off an unresolvable
            # base (`REGISTRY.snapshot().get(...)` has no dotted chain)
            if isinstance(node.func, ast.Attribute):
                tail = node.func.attr
            elif isinstance(node.func, ast.Name):
                tail = node.func.id
            else:
                continue
            if tail not in ("counter", "get"):
                continue
            if not any(s == "exec.traces"
                       for s in A.string_constants(node)):
                continue
            if A.in_with_block(
                    mod, node,
                    lambda e: isinstance(e, ast.Call) and
                    (A.call_name(e) or "").endswith("trace_delta")):
                continue
            yield mod.finding(
                self.id, self.severity, node,
                "raw `exec.traces` read outside a trace_delta() window",
                hint="wrap the differential run in `with trace_delta() "
                     "as td:` and assert on `td.traces`")
