"""Lock-discipline rules (PT3xx), carried over as they are.

The port's shared mutable state — ``runtime/memory.py``'s
``MemoryPool`` reservations, ``server/scheduler.py``'s
``FairScheduler`` tenant tallies, ``runtime/lifecycle.py``'s
``InflightCoalescer`` entries, ``server/batcher.py``'s
``TemplateBatchGate`` members, ``server/frontend.py``'s
query pages, ``cache/exec_cache.py``'s LRU — is guarded by
per-object locks, and the guard is purely conventional: nothing stops
a new method from mutating ``self._entries`` without taking
``self._lock``. RacerD-style inference makes the convention checkable:
per class, the set of attributes EVER mutated under the lock is the
guarded set, and any mutation of a guarded attribute outside the lock
is a finding. Methods named ``*_locked`` declare "caller holds the
lock" (the ``_evict_locked`` convention) and are exempt; ``__init__``
is exempt (construction happens-before publication).

Cross-object deadlock is the second hazard: the serving tier stacks
scheduler -> gate -> coalescer -> pool, and a cycle in the
while-holding-A-acquire-B graph is a latent deadlock that no test
catches until the unlucky interleaving ships. The rule extracts that
graph statically (method-name matching across analyzed classes —
heuristic, hence ``warning``) and reports cycles. Re-acquiring one's
OWN non-reentrant lock through a self-call is reported separately
(PT303) at ``error``: ``threading.Lock`` self-deadlocks
deterministically.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from presto_tpu_torch.analysis import astutil as A
from presto_tpu_torch.analysis.engine import ModuleInfo, Project, Rule, register

LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition",
              "Lock", "RLock", "Condition"}

#: method names that mutate their receiver in place
MUTATORS = {"append", "appendleft", "extend", "add", "insert", "remove",
            "discard", "pop", "popitem", "popleft", "clear", "update",
            "setdefault", "move_to_end", "__setitem__"}


def _ctor_reentrant(call: ast.Call) -> Optional[bool]:
    """Reentrancy of a lock constructor call, or None for non-locks.
    ``Condition()`` with no lock argument is RLock-backed (reentrant);
    ``Condition(Lock())`` is not."""
    name = A.call_name(call)
    if name not in LOCK_CTORS:
        return None
    tail = name.rsplit(".", 1)[-1]
    if tail == "RLock":
        return True
    if tail == "Lock":
        return False
    # Condition: reentrant unless an explicit non-reentrant lock is
    # passed as the first argument
    if call.args:
        inner = call.args[0]
        if isinstance(inner, ast.Call):
            r = _ctor_reentrant(inner)
            if r is not None:
                return r
        return False  # unknown explicit lock: assume the strict case
    return True


class ClassLocks:
    """Per-class lock facts: lock attrs, guarded attrs, mutation sites,
    lock-acquiring methods and the calls made while holding."""

    def __init__(self, mod: ModuleInfo, cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        #: lock attr -> reentrant?
        self.lock_attrs: "dict[str, bool]" = {}
        #: attr -> [(method, node, under_lock)]
        self.mutations: "list[tuple]" = []
        #: method name -> lock attrs it acquires
        self.acquires: "dict[str, set[str]]" = {}
        #: (method-name-called, call node, lock attrs held at the site)
        self.calls_under_lock: "list[tuple[str, ast.Call, set]]" = []
        self._scan()

    def _scan(self):
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and \
                            isinstance(node.value, ast.Call):
                        r = _ctor_reentrant(node.value)
                        if r is not None:
                            self.lock_attrs[tgt.attr] = r
        if not self.lock_attrs:
            return
        for fn in self.cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            self._scan_method(fn)

    def _lock_attr_of(self, expr: ast.expr) -> Optional[str]:
        name = A.dotted(expr)
        if name is not None and name.startswith("self."):
            attr = name.split(".", 1)[1]
            if attr in self.lock_attrs:
                return attr
        return None

    def _held_attrs(self, node: ast.AST) -> "set[str]":
        held = set()
        for anc in self.mod.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    attr = self._lock_attr_of(item.context_expr)
                    if attr is not None:
                        held.add(attr)
        return held

    def _acquire_ranges(self, fn) -> "list[tuple[str, int, int]]":
        """(attr, start, end) line ranges held by explicit
        ``self.X.acquire()`` ... ``self.X.release()`` pairs — a linear
        (branch-blind, hence approximate) sweep. ``acquire(
        blocking=False)`` may fail, so it opens no range."""
        events = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            nm = A.call_name(node) or ""
            if not nm.startswith("self.") or nm.count(".") != 2:
                continue
            attr, op = nm.split(".")[1], nm.split(".")[2]
            if attr not in self.lock_attrs or op not in ("acquire",
                                                         "release"):
                continue
            if op == "acquire" and any(
                    k.arg == "blocking" for k in node.keywords):
                continue
            events.append((node.lineno, attr, op))
        ranges = []
        open_at: "dict[str, int]" = {}
        for line, attr, op in sorted(events):
            if op == "acquire":
                open_at.setdefault(attr, line)
            elif attr in open_at:
                ranges.append((attr, open_at.pop(attr), line))
        end = max((n.lineno for n in ast.walk(fn)
                   if hasattr(n, "lineno")), default=fn.lineno)
        for attr, start in open_at.items():
            ranges.append((attr, start, end))
        return ranges

    def _scan_method(self, fn):
        acquired: "set[str]" = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for i in node.items:
                    attr = self._lock_attr_of(i.context_expr)
                    if attr is not None:
                        acquired.add(attr)
            # .acquire()/.wait() style acquisition also counts
            if isinstance(node, ast.Call):
                nm = A.call_name(node) or ""
                if nm.startswith("self.") and nm.endswith(
                        (".acquire", ".wait")):
                    attr = nm.split(".")[1]
                    if attr in self.lock_attrs:
                        acquired.add(attr)
        if acquired:
            self.acquires[fn.name] = acquired
        ranges = self._acquire_ranges(fn)

        def held_at(node):
            held = self._held_attrs(node)
            line = getattr(node, "lineno", 0)
            held |= {attr for attr, start, end in ranges
                     if start < line <= end}
            return held

        for node in ast.walk(fn):
            for attr, site in self._mutation_targets(node):
                if attr in self.lock_attrs:
                    continue
                self.mutations.append(
                    (attr, fn, site, bool(held_at(site))))
            if isinstance(node, ast.Call):
                name = A.call_name(node)
                if name:
                    held = held_at(node)
                    if held:
                        self.calls_under_lock.append(
                            (name.rsplit(".", 1)[-1], node, held))

    @staticmethod
    def _self_attr(expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return expr.attr
        return None

    def _mutation_targets(self, node: ast.AST):
        """(attr, site) pairs for mutations of self.<attr> at node."""
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            for tgt in targets:
                attr = self._self_attr(tgt)
                if attr:
                    yield attr, node
                elif isinstance(tgt, ast.Subscript):
                    attr = self._self_attr(tgt.value)
                    if attr:
                        yield attr, node
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                attr = self._self_attr(tgt)
                if attr is None and isinstance(tgt, ast.Subscript):
                    attr = self._self_attr(tgt.value)
                if attr:
                    yield attr, node
        elif isinstance(node, ast.Call):
            name = A.call_name(node)
            if name and name.startswith("self.") and \
                    name.count(".") == 2 and \
                    name.rsplit(".", 1)[-1] in MUTATORS:
                yield name.split(".")[1], node

    @property
    def guarded(self) -> "set[str]":
        return {attr for attr, _fn, _site, locked in self.mutations
                if locked}


def _class_locks(project: Project) -> "list[ClassLocks]":
    out = []
    for mod in project.engine_modules():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                cl = ClassLocks(mod, node)
                if cl.lock_attrs:
                    out.append(cl)
    return out


@register
class UnguardedSharedMutation(Rule):
    id = "PT301"
    name = "unguarded-shared-mutation"
    severity = "error"
    description = (
        "an attribute mutated under `with self._lock` elsewhere in the "
        "class is also mutated outside it (lost-update race)")
    motivation = (
        "the exec-cache ledger and the serving tier share entries "
        "across threads; the JAX package's CacheEntry grew its own "
        "lock after review caught racy extreme updates")

    def check_project(self, project: Project) -> Iterator:
        for cl in _class_locks(project):
            guarded = cl.guarded
            for attr, fn, site, locked in cl.mutations:
                if locked or attr not in guarded:
                    continue
                if fn.name in ("__init__", "__new__") or \
                        fn.name.endswith("_locked"):
                    continue
                locks = "/".join(f"self.{a}"
                                 for a in sorted(cl.lock_attrs))
                yield cl.mod.finding(
                    self.id, self.severity, site,
                    f"`{cl.cls.name}.{attr}` is lock-guarded elsewhere "
                    f"but mutated without {locks} in `{fn.name}`",
                    hint="take the lock, or rename the method "
                         "`*_locked` if the caller must hold it",
                    cls=cl.cls.name, attr=attr)


@register
class SelfDeadlock(Rule):
    id = "PT303"
    name = "self-deadlock"
    severity = "error"
    description = (
        "while holding `self._lock`, calls a method of the SAME object "
        "that acquires it again — threading.Lock is not reentrant")
    motivation = (
        "the coalescer/gate stack wraps publish inside finally blocks; "
        "one refactor moving a locked helper call inside the locked "
        "region deadlocks every follower deterministically")

    def check_project(self, project: Project) -> Iterator:
        for cl in _class_locks(project):
            for name, call, held in cl.calls_under_lock:
                full = A.call_name(call) or ""
                if not full.startswith("self.") or full.count(".") != 1:
                    continue
                if name.endswith("_locked"):
                    continue
                reacquired = cl.acquires.get(name, set()) & {
                    a for a in held if not cl.lock_attrs[a]}
                if reacquired:
                    attr = sorted(reacquired)[0]
                    yield cl.mod.finding(
                        self.id, self.severity, call,
                        f"`self.{name}()` is called while holding "
                        f"`{cl.cls.name}.{attr}`, and `{name}` "
                        "re-acquires that non-reentrant lock",
                        hint="split a `_locked` variant that assumes "
                             "the lock is held", cls=cl.cls.name)


@register
class LockOrderCycle(Rule):
    id = "PT302"
    name = "lock-order-cycle"
    severity = "warning"
    description = (
        "cycle in the while-holding-A-call-into-B lock graph across "
        "runtime classes (potential cross-object deadlock)")
    motivation = (
        "the serving tier stacks FairScheduler -> TemplateBatchGate -> "
        "InflightCoalescer -> MemoryPool; an edge back up the stack "
        "added under any of those locks is a latent deadlock")

    #: method names too generic to build cross-class edges from —
    #: `self.counters.clear()` (a dict) must not match
    #: `ExecutableCache.clear` (a lock-acquiring method)
    GENERIC_METHODS = {"clear", "update", "pop", "get", "add", "set",
                       "remove", "append", "extend", "insert", "discard",
                       "acquire", "release", "wait", "notify",
                       "notify_all", "sort", "copy", "index", "reset",
                       "close", "items", "values", "keys"}

    def check_project(self, project: Project) -> Iterator:
        classes = _class_locks(project)
        by_method: "dict[str, set[str]]" = {}
        for cl in classes:
            for m in cl.acquires:
                if m not in self.GENERIC_METHODS:
                    by_method.setdefault(m, set()).add(cl.cls.name)
        edges: "dict[str, dict[str, tuple]]" = {}
        for cl in classes:
            for name, call, _held in cl.calls_under_lock:
                full = A.call_name(call) or ""
                if full.startswith("self.") and full.count(".") == 1:
                    continue  # same-object: PT303's domain
                for target in by_method.get(name, ()):
                    if target == cl.cls.name:
                        continue
                    edges.setdefault(cl.cls.name, {}).setdefault(
                        target, (cl.mod, call, name))
        for cycle in self._cycles(edges):
            cl_mod, call, name = edges[cycle[0]][cycle[1]]
            yield cl_mod.finding(
                self.id, self.severity, call,
                "lock-order cycle: " + " -> ".join(cycle + (cycle[0],))
                + f" (edge taken here via `.{name}()` under "
                f"`{cycle[0]}`'s lock)",
                hint="acquire in one global order, or move the "
                     "cross-object call outside the locked region")

    @staticmethod
    def _cycles(edges: "dict[str, dict[str, tuple]]"):
        """Distinct simple cycles, canonicalized (rotated to the
        lexicographically smallest head) so each reports once."""
        seen = set()
        out = []

        def dfs(node, path):
            for nxt in edges.get(node, {}):
                if nxt in path:
                    cyc = tuple(path[path.index(nxt):])
                    i = cyc.index(min(cyc))
                    canon = cyc[i:] + cyc[:i]
                    if canon not in seen:
                        seen.add(canon)
                        out.append(canon)
                else:
                    dfs(nxt, path + [nxt])

        for start in sorted(edges):
            dfs(start, [start])
        return out
