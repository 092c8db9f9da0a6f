"""Step-hygiene rules (PT1xx), the port's reading of the trace rules.

Under ``jax.jit`` a step's Python body runs once per trace, so a host
sync inside it either fails on a tracer or freezes one binding's value
into the compiled program. The port runs its steps eagerly, so the
same operations are a cost, not that bug: each one (``.item()``,
``int()`` / ``float()`` / ``bool()`` of a tensor, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``, a Python ``if``
on a tensor comparison) makes the host wait for the card's stream to
drain, once per batch. The rules flag them where they run once per
batch on the hot path:

- the cached step bodies: what an ``EXEC_CACHE.get_or_build`` builder
  returns (a function named in ``lambda: fn``, the functions a builder
  called there defines and returns, the methods a ``self._build_*``
  builder returns off a state-less template), and the conventional
  ``step`` / ``*_step`` body nested in a ``make`` / ``build`` / ``*_step``
  builder;
- the kernel wrappers: every function that launches a kernel (calls
  ``check_launch``).

Everything lexically inside such a function counts, nested helpers
included. A sync a step needs (a data-dependent capacity read once per
batch) is suppressed on its line with the reason.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from presto_tpu_torch.analysis import astutil as A
from presto_tpu_torch.analysis.engine import ModuleInfo, Rule, register

#: attribute chains that stay on the host: a tensor's metadata is not a
#: sync
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "nbytes",
                "itemsize", "layout", "capacity", "names", "type", "kind",
                "width", "scale", "precision"}

#: method calls that copy device values to the host (or wait for the
#: stream)
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize",
                "block_until_ready"}

#: callables that copy a tensor argument to the host
SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

#: builtins that force a concrete Python scalar out of their argument
SCALAR_BUILTINS = {"int", "float", "bool", "complex"}

#: the call every kernel wrapper makes after its launch
LAUNCH_CHECK = "check_launch"


def _module_functions(mod: ModuleInfo) -> "dict[str, ast.FunctionDef]":
    return {fn.name: fn for fn in mod.tree.body
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _enclosing_class(mod: ModuleInfo, node: ast.AST) -> Optional[ast.ClassDef]:
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None


def _method(cls: Optional[ast.ClassDef], name: str):
    if cls is None:
        return None
    for fn in cls.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and fn.name == name:
            return fn
    return None


def _function_named(mod: ModuleInfo, name: str, scope) -> Optional[ast.AST]:
    """A def called ``name`` visible from ``scope``: nested first, then
    the module's."""
    while scope is not None:
        for f in A.iter_functions(scope):
            if f.name == name and f is not scope:
                return f
        scope = mod.enclosing_function(scope)
    return _module_functions(mod).get(name)


def _returned(mod: ModuleInfo, fn) -> "list[ast.expr]":
    """The values ``fn`` returns, its own ``return`` statements only."""
    return [node.value for node in ast.walk(fn)
            if isinstance(node, ast.Return) and node.value is not None
            and mod.enclosing_function(node) is fn]


def _steps_of_value(mod: ModuleInfo, value: ast.expr, scope, cls,
                    depth: int = 0) -> "list[ast.AST]":
    """The step bodies a builder's value stands for."""
    if depth > 2:
        return []
    if isinstance(value, ast.Lambda):
        return [value]
    if isinstance(value, ast.Name):
        fn = _function_named(mod, value.id, scope)
        return [fn] if fn is not None else []
    if isinstance(value, ast.Attribute):
        fn = _method(cls, value.attr)
        return [fn] if fn is not None else []
    if isinstance(value, ast.Call):
        builder = None
        if isinstance(value.func, ast.Name):
            builder = _function_named(mod, value.func.id, scope)
        elif isinstance(value.func, ast.Attribute):
            builder = _method(cls, value.func.attr)
        if builder is None:
            return []
        out = []
        for r in _returned(mod, builder):
            out.extend(_steps_of_value(mod, r, builder, cls, depth + 1))
        return out
    return []


def cached_steps(mod: ModuleInfo) -> "list[ast.AST]":
    """The step bodies every ``get_or_build`` site of ``mod`` caches."""
    out = []
    for call in ast.walk(mod.tree):
        if not (isinstance(call, ast.Call) and
                (A.call_name(call) or "").endswith("get_or_build") and
                len(call.args) >= 2):
            continue
        builder = call.args[1]
        scope = mod.enclosing_function(call)
        cls = _enclosing_class(mod, call)
        if isinstance(builder, ast.Lambda):
            out.extend(_steps_of_value(mod, builder.body, scope, cls))
            continue
        if isinstance(builder, ast.Name):
            fn = _function_named(mod, builder.id, scope)
        elif isinstance(builder, ast.Attribute):
            fn = _method(cls, builder.attr)
        else:
            fn = None
        if fn is None:
            continue
        for r in _returned(mod, fn):
            out.extend(_steps_of_value(mod, r, fn, _enclosing_class(mod, fn)))
    return out


def traced_functions(mod: ModuleInfo) -> "list[ast.AST]":
    """Every function whose body runs once per batch on the hot path:
    the cached step bodies, the conventional nested steps, the kernel
    wrappers."""
    out: "dict[int, ast.AST]" = {id(f): f for f in cached_steps(mod)}
    for fn in A.iter_functions(mod.tree):
        if fn.name == "step" or fn.name.endswith("_step"):
            builder = mod.enclosing_function(fn)
            if builder is not None and (
                    "make" in builder.name or "build" in builder.name or
                    builder.name.endswith("_step")):
                out[id(fn)] = fn
        if any(isinstance(n, ast.Call) and
               (A.call_name(n) or "").rsplit(".", 1)[-1] == LAUNCH_CHECK
               for n in ast.walk(fn)) and mod.enclosing_function(fn) is None:
            out[id(fn)] = fn
    return list(out.values())


def _params(fn) -> "set[str]":
    """A step's tensor-carrying parameters (``self`` is the template
    operator, not a value)."""
    return A.func_params(fn) - {"self", "cls"}


def _under_static_attr(mod: ModuleInfo, name_node: ast.AST,
                      stop: ast.AST) -> bool:
    """True when the name is read through a host-side attribute
    (``batch.capacity``, ``x.shape[0]``, ``x.dtype``) below ``stop``."""
    for anc in mod.ancestors(name_node):
        if anc is stop:
            return False
        if isinstance(anc, ast.Attribute) and anc.attr in STATIC_ATTRS:
            return True
        if isinstance(anc, ast.Call) and (A.call_name(anc) or "").rsplit(
                ".", 1)[-1] in ("len", "isinstance", "size", "dim", "numel"):
            return True
    return False


def _references_traced_value(mod: ModuleInfo, expr: ast.expr,
                             params: "set[str]") -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and \
                n.id in params and not _under_static_attr(mod, n, expr):
            return True
    return False


@register
class HostSyncInTracedStep(Rule):
    id = "PT101"
    name = "host-sync-in-traced-step"
    severity = "error"
    description = (
        "host sync (.item()/.tolist()/.cpu()/.numpy()/int()/float()/"
        "bool() of a tensor/np.asarray/torch.cuda.synchronize) inside a "
        "cached step body or a kernel wrapper")
    motivation = (
        "the JAX package's Pallas regression: an in-trace eligibility check silently "
        "disabled the Pallas kernel; on the card each sync in a step "
        "stalls the stream once per batch")

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        for fn in traced_functions(mod):
            params = _params(fn)
            # names assigned from params carry tensors onward
            tainted = set(params)
            for name, val in A.simple_assignments(fn).items():
                if _references_traced_value(mod, val, tainted):
                    tainted.add(name)
            name = getattr(fn, "name", "<lambda>")
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                fname = A.call_name(call)
                if fname is None:
                    if isinstance(call.func, ast.Attribute) and \
                            call.func.attr in SYNC_METHODS:
                        fname = "<expr>." + call.func.attr
                    else:
                        continue
                tail = fname.rsplit(".", 1)[-1]
                if tail in SYNC_METHODS and "." in fname:
                    yield mod.finding(
                        self.id, self.severity, call,
                        f"`.{tail}()` waits for the device inside step "
                        f"`{name}`",
                        hint="keep the value on the device, or read it "
                             "once outside the per-batch step")
                    continue
                if (fname in SYNC_CALLS or tail in SCALAR_BUILTINS and
                        fname == tail):
                    syncs = any(
                        _references_traced_value(mod, a, tainted)
                        for a in list(call.args) +
                        [k.value for k in call.keywords])
                    if syncs:
                        yield mod.finding(
                            self.id, self.severity, call,
                            f"`{fname}(...)` copies a tensor to the host "
                            f"inside step `{name}`",
                            hint="use torch ops on the tensor, or read "
                                 "it once outside the per-batch step")


@register
class BranchOnTracedValue(Rule):
    id = "PT102"
    name = "python-branch-on-traced-value"
    severity = "error"
    description = (
        "Python if/while on a comparison over a step's tensor parameter "
        "inside a cached step body or a kernel wrapper (a host sync per "
        "batch)")
    motivation = (
        "the JAX package's plan templates: a Python branch on a "
        "traced value bakes one binding's outcome into a shared "
        "executable; on the card it waits for the stream per batch")

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        for fn in traced_functions(mod):
            params = _params(fn)
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                for cmp in ast.walk(node.test):
                    if not isinstance(cmp, ast.Compare):
                        continue
                    if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                           for op in cmp.ops):
                        continue  # identity and membership are host plumbing
                    sides = [cmp.left] + list(cmp.comparators)
                    if any(isinstance(s, ast.Constant) and isinstance(s.value, str)
                           for s in sides):
                        continue  # a mode string, not a tensor
                    if any(isinstance(s, ast.Name) and s.id in params and
                           not _under_static_attr(mod, s, cmp)
                           for s in sides):
                        yield mod.finding(
                            self.id, self.severity, node,
                            "Python branch on a tensor parameter inside "
                            f"step `{getattr(fn, 'name', '<lambda>')}` — "
                            "a host sync per batch",
                            hint="use torch.where, or decide outside "
                                 "the per-batch step")
                        break


@register
class ParamScopeDiscipline(Rule):
    id = "PT103"
    name = "param-scope-discipline"
    severity = "warning"
    description = (
        "expression evaluation with bindings in hand but no installed "
        "param_scope, or direct _PARAM_VALUES access outside expr.py")
    motivation = (
        "plan-template parameterization: a Param evaluated outside an "
        "installed scope raises at runtime only on the first "
        "parameterized query that reaches the site")

    EVAL_FUNCS = {"evaluate", "evaluate_predicate", "expr.evaluate",
                  "expr.evaluate_predicate"}

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        if mod.rel.endswith("expr.py") or mod.is_test:
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr == "_PARAM_VALUES":
                yield mod.finding(
                    self.id, "error", node,
                    "direct _PARAM_VALUES access outside expr.py",
                    hint="use expr.param_scope() — the ContextVar is "
                         "an implementation detail")
        for fn in A.iter_functions(mod.tree):
            bound = A.func_params(fn) | set(A.simple_assignments(fn))
            if "params" not in bound:
                continue
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                if A.call_name(call) not in self.EVAL_FUNCS:
                    continue
                if mod.enclosing_function(call) is not fn:
                    continue  # nested def: judged in its own right
                if A.in_with_block(
                        mod, call,
                        lambda e: isinstance(e, ast.Call) and
                        (A.call_name(e) or "").endswith("param_scope")):
                    continue
                yield mod.finding(
                    self.id, self.severity, call,
                    f"`{A.call_name(call)}(...)` in `{fn.name}` with "
                    "`params` in scope but no enclosing "
                    "`with param_scope(...)`",
                    hint="wrap the evaluation in `with param_scope("
                         "params):` so Param slots resolve")
