"""Row expression IR + vectorized evaluator (the TPC-H Q1 subset).

Counterpart of ``presto_tpu/expr.py``. Expressions are a small immutable
IR evaluated eagerly over ``Batch`` columns; every evaluation returns
``Val(data, valid)`` so NULL handling is branch-free tensor math.

The ported slices cover the functions TPC-H Q1, Q3 and Q10 need:
``add``, ``sub``, ``mul`` over DECIMAL and DATE; the comparisons ``eq``,
``lt``, ``le``, ``gt``, ``ge`` over numbers, dates and dictionary
VARCHAR (a string literal is encoded against its peer column's
dictionary; an absent literal matches nothing under ``eq``); and the
Kleene ``and``. BYTES columns pass through untouched. A call to any
other function raises ``NotSupported`` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from presto_tpu_torch.batch import Batch, Dictionary
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.types import (
    BOOLEAN,
    DOUBLE,
    DataType,
    TypeKind,
    common_super_type,
    decimal,
    numpy_dtype_of,
)

# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    dtype: DataType


@dataclass(frozen=True)
class InputRef(Expr):
    """Reference to a named column of the input batch."""

    name: str = ""

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Literal(Expr):
    """A constant. ``value`` is the *logical* Python value."""

    value: Any = None

    def __str__(self) -> str:
        return repr(self.value)


@dataclass(frozen=True)
class Call(Expr):
    """Function call (covers operators, special forms, casts)."""

    fn: str = ""
    args: tuple[Expr, ...] = ()

    def __str__(self) -> str:
        return f"{self.fn}({', '.join(map(str, self.args))})"


def col(name: str, dtype: DataType) -> InputRef:
    return InputRef(dtype, name)


def lit(value: Any, dtype: DataType) -> Literal:
    return Literal(dtype, value)


# ---------------------------------------------------------------------------
# Evaluation values
# ---------------------------------------------------------------------------


@dataclass
class Val:
    """An evaluated vector: device data + validity + metadata."""

    data: Any
    valid: Any
    dtype: DataType
    dictionary: Dictionary | None = None


# ---------------------------------------------------------------------------
# Scalar function registry
# ---------------------------------------------------------------------------
# impl(args: list[Val], out_type) -> (data, valid_override|None)
# type_rule(arg_types) -> DataType

_REGISTRY: dict[str, tuple[Callable, Callable]] = {}


def register(name: str, type_rule: Callable):
    def deco(impl):
        _REGISTRY[name] = (impl, type_rule)
        return impl

    return deco


def _lookup(fn: str):
    if fn not in _REGISTRY:
        raise NotSupported(
            f"function {fn!r} is not ported to presto_tpu_torch yet")
    return _REGISTRY[fn]


def result_type(fn: str, arg_types) -> DataType:
    """The result type of ``fn`` over ``arg_types`` (the analyzer's
    typing hook)."""
    return _lookup(fn)[1](list(arg_types))


# ---- type rules -----------------------------------------------------------


def _t_bool(_):
    return BOOLEAN


def _t_same(args):
    t = args[0]
    for u in args[1:]:
        t = common_super_type(t, u)
    return t


def _t_add(args):
    a, b = args
    # DATE +/- integer days -> DATE
    if a.kind is TypeKind.DATE and b.kind in (TypeKind.INTEGER, TypeKind.BIGINT):
        return a
    if b.kind is TypeKind.DATE and a.kind in (TypeKind.INTEGER, TypeKind.BIGINT):
        return b
    return _t_same(args)


def _t_mul(args):
    a, b = args
    if a.kind is TypeKind.DECIMAL or b.kind is TypeKind.DECIMAL:
        sa = a.scale if a.kind is TypeKind.DECIMAL else 0
        sb = b.scale if b.kind is TypeKind.DECIMAL else 0
        if a.kind is TypeKind.DOUBLE or b.kind is TypeKind.DOUBLE:
            return DOUBLE
        # engine-defined: product scale capped at 4 (as the JAX package)
        return decimal(38, min(sa + sb, 4))
    return _t_same(args)


# ---- numeric helpers ------------------------------------------------------


def _round_half_away(d: torch.Tensor, f: int) -> torch.Tensor:
    """Divide int64 ``d`` by positive ``f`` rounding half away from zero.

    Neither floor division nor ``rounding_mode="trunc"`` does this on its
    own: |d| is rounded (where floor and trunc agree), then the sign is
    reapplied."""
    a = torch.abs(d)
    q = torch.div(a + f // 2, f, rounding_mode="floor")
    return torch.where(d >= 0, q, -q)


def _to_physical(v: Val, target: DataType) -> torch.Tensor:
    """Rescale/convert v.data to target's physical representation."""
    src = v.dtype
    data = v.data
    if src == target:
        return data
    if target.kind is TypeKind.DECIMAL:
        if src.kind is TypeKind.DECIMAL:
            if src.scale == target.scale:
                return data.to(torch.int64)
            if src.scale < target.scale:
                return data.to(torch.int64) * 10 ** (target.scale - src.scale)
            return _round_half_away(data.to(torch.int64),
                                    10 ** (src.scale - target.scale))
        return data.to(torch.int64) * 10**target.scale
    if target.kind in (TypeKind.BIGINT, TypeKind.INTEGER, TypeKind.DATE):
        return data.to(target.torch_dtype)
    raise NotImplementedError(f"conversion {src} -> {target} is not ported yet")


def _binary_numeric(op):
    def impl(args: list[Val], out: DataType):
        a, b = args
        if out.kind is TypeKind.DECIMAL:
            x = _to_physical(a, decimal(38, out.scale))
            y = _to_physical(b, decimal(38, out.scale))
        else:
            x = _to_physical(a, out)
            y = _to_physical(b, out)
        return op(x, y), None

    return impl


def _mul_impl(args: list[Val], out: DataType):
    a, b = args
    if out.kind is TypeKind.DECIMAL:
        sa = a.dtype.scale if a.dtype.kind is TypeKind.DECIMAL else 0
        sb = b.dtype.scale if b.dtype.kind is TypeKind.DECIMAL else 0
        x = (a.data.to(torch.int64) if a.dtype.kind is TypeKind.DECIMAL
             else _to_physical(a, decimal(38, 0)))
        y = (b.data.to(torch.int64) if b.dtype.kind is TypeKind.DECIMAL
             else _to_physical(b, decimal(38, 0)))
        prod = x * y  # scale sa+sb
        excess = sa + sb - out.scale
        if excess > 0:
            prod = _round_half_away(prod, 10**excess)
        return prod, None
    x = _to_physical(a, out)
    y = _to_physical(b, out)
    return x * y, None


register("add", _t_add)(_binary_numeric(lambda x, y: x + y))
register("sub", _t_add)(_binary_numeric(lambda x, y: x - y))
register("mul", _t_mul)(_mul_impl)


def _cmp_physicals(a: Val, b: Val):
    """Bring two comparable Vals to a common physical domain. VARCHAR
    codes compare within ONE ordered dictionary (literals were encoded
    against it by ``_encode_string_literals``)."""
    ta, tb = a.dtype, b.dtype
    if TypeKind.BYTES in (ta.kind, tb.kind):
        raise NotSupported("comparisons over BYTES strings are not ported yet")
    if TypeKind.VARCHAR in (ta.kind, tb.kind):
        if (a.dictionary is not None and b.dictionary is not None
                and a.dictionary is not b.dictionary):
            raise ValueError(
                "comparing VARCHAR columns from different dictionaries; "
                "re-encode to a shared dictionary first")
        if isinstance(a.data, str) or isinstance(b.data, str):
            raise NotSupported("comparing a VARCHAR literal with a "
                               "dictionary-less value is not ported yet")
        return a.data, b.data
    t = common_super_type(ta, tb) if ta != tb else ta
    if t.kind is TypeKind.DECIMAL:
        s = max(ta.scale if ta.kind is TypeKind.DECIMAL else 0,
                tb.scale if tb.kind is TypeKind.DECIMAL else 0)
        t = decimal(38, s)
    return _to_physical(a, t), _to_physical(b, t)


def _cmp(op):
    def impl(args: list[Val], out: DataType):
        x, y = _cmp_physicals(args[0], args[1])
        return op(x, y), None

    return impl


register("eq", _t_bool)(_cmp(lambda x, y: x == y))
register("lt", _t_bool)(_cmp(lambda x, y: x < y))
register("le", _t_bool)(_cmp(lambda x, y: x <= y))
register("gt", _t_bool)(_cmp(lambda x, y: x > y))
register("ge", _t_bool)(_cmp(lambda x, y: x >= y))


@register("and", _t_bool)
def _and(args: list[Val], out: DataType):
    """Kleene AND: FALSE dominates NULL; data is "definitely true"."""
    a, b = args
    true_a, true_b = a.valid & a.data, b.valid & b.data
    false_a, false_b = a.valid & ~a.data, b.valid & ~b.data
    return true_a & true_b, (a.valid & b.valid) | false_a | false_b


def _encode_string_literals(fn: str, args: list[Val]) -> list[Val]:
    """Encode host-side VARCHAR literals against a sibling's dictionary
    (the JAX package's rule). Codes are string order, so a literal
    absent from the dictionary maps to its insertion point for the
    range comparisons and to the impossible code ``len(dictionary)``
    for ``eq``: it matches nothing."""
    dictionary = next((a.dictionary for a in args if a.dictionary is not None), None)
    if dictionary is None:
        return args
    cap, dev = next((a.data.shape[0], a.data.device) for a in args
                    if a.dictionary is not None)
    out = []
    for a in args:
        if a.dtype.kind is TypeKind.VARCHAR and isinstance(a.data, str):
            code = dictionary._index.get(a.data)
            if code is None:
                if fn in ("lt", "ge"):  # x < s  ==  code < lb(s)
                    code = dictionary.lower_bound(a.data)
                elif fn in ("le", "gt"):  # x <= s  ==  code <= lb(s) - 1
                    code = dictionary.lower_bound(a.data) - 1
                else:
                    code = len(dictionary)
            a = Val(torch.full((cap,), code, dtype=torch.int32, device=dev),
                    torch.ones(cap, dtype=torch.bool, device=dev), a.dtype, dictionary)
        out.append(a)
    return out


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


def evaluate(expr: Expr, batch: Batch) -> Val:
    """Evaluate ``expr`` over a batch; returns a full-capacity ``Val``.

    Dead rows (``~batch.live``) produce garbage-but-well-defined values;
    consumers mask with ``batch.live``.
    """
    if isinstance(expr, InputRef):
        c = batch[expr.name]
        return Val(c.data, c.valid, c.dtype, c.dictionary)
    if isinstance(expr, Literal):
        cap, dev = batch.capacity, batch.device
        t = expr.dtype
        if t.kind is TypeKind.BYTES:
            raise NotSupported(f"{t} literals are not ported to presto_tpu_torch yet")
        if t.kind is TypeKind.VARCHAR and expr.value is not None:
            # stays host-side; encoded lazily against the peer dictionary
            return Val(expr.value, None, t, None)
        if expr.value is None:
            return Val(torch.zeros(cap, dtype=t.torch_dtype, device=dev),
                       torch.zeros(cap, dtype=torch.bool, device=dev), t)
        data = torch.full((cap,), t.to_physical(expr.value),
                          dtype=t.torch_dtype, device=dev)
        return Val(data, torch.ones(cap, dtype=torch.bool, device=dev), t)
    if isinstance(expr, Call):
        impl, _rule = _lookup(expr.fn)
        args = _encode_string_literals(expr.fn, [evaluate(a, batch) for a in expr.args])
        data, valid = impl(args, expr.dtype)
        if valid is None:
            for a in args:
                if a.valid is not None:
                    valid = a.valid if valid is None else (valid & a.valid)
            if valid is None:
                valid = torch.ones(batch.capacity, dtype=torch.bool,
                                   device=batch.device)
        dictionary = None
        if expr.dtype.kind is TypeKind.VARCHAR:
            dictionary = next((a.dictionary for a in args
                               if a.dictionary is not None), None)
        return Val(data, valid, _sync_physical(expr.dtype, data), dictionary)
    raise TypeError(f"unknown expr node {type(expr)}")


def _sync_physical(dtype: DataType, data: torch.Tensor) -> DataType:
    """Metadata tells the truth about storage: sync the physical field to
    the actual tensor dtype (pass-through impls may hand narrow data on
    under a canonical claimed type)."""
    if dtype.kind in (TypeKind.BYTES, TypeKind.BOOLEAN, TypeKind.DOUBLE):
        return dtype
    if data.dtype == dtype.torch_dtype:
        return dtype
    return dtype.with_physical(numpy_dtype_of(data.dtype))


def evaluate_predicate(expr: Expr, batch: Batch) -> torch.Tensor:
    """Evaluate a boolean expr to a device mask (NULL -> False)."""
    v = evaluate(expr, batch)
    return v.data & v.valid
