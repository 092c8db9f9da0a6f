"""Row expression IR + vectorized evaluator (the TPC-H Q1 subset).

Counterpart of ``presto_tpu/expr.py``. Expressions are a small immutable
IR evaluated eagerly over ``Batch`` columns; every evaluation returns
``Val(data, valid)`` so NULL handling is branch-free tensor math.

The ported slices cover the functions TPC-H Q1, Q3, Q6, Q9 and Q10 and
the SSB Q1 flight and LIKE queries need: ``add``, ``sub``, ``mul`` over
DECIMAL and DATE; ``div`` in DOUBLE (float32, as in the JAX package;
division by zero is NULL); ``cast_bigint``; the comparisons ``eq``,
``ne``, ``lt``, ``le``, ``gt``, ``ge`` and ``between`` over numbers,
dates, dictionary VARCHAR (a string literal is encoded against its peer
column's dictionary; an absent literal matches nothing under ``eq``) and
fixed-width BYTES (PAD SPACE, against a string literal or another BYTES
value); the Kleene ``and`` and ``not``; ``year``, ``month`` and ``day``
of a DATE; and the string functions ``like`` and ``starts_with`` (BYTES
through the kernels of ``ops/cuda_strings``, dictionary VARCHAR through a
host regex over the dictionary and a gather by code) and the static
``substr_<start>_<length>`` over BYTES. A call to any other function
raises ``NotSupported`` naming it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Dictionary
from presto_tpu_torch.ops import cuda_strings
from presto_tpu_torch.ops import strings as ops_strings
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DOUBLE,
    INTEGER,
    DataType,
    TypeKind,
    common_super_type,
    decimal,
    fixed_bytes,
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
    if target.kind is TypeKind.DOUBLE:
        # DOUBLE is float32 in both packages. The JAX package divides by
        # the constant 10^scale, which XLA compiles to a multiply by the
        # float32 reciprocal: the same multiply gives the same bits
        if src.kind is TypeKind.DECIMAL:
            inv = np.float32(1) / np.float32(10**src.scale)
            return data.to(torch.float32) * torch.tensor(
                float(inv), dtype=torch.float32, device=data.device)
        return data.to(torch.float32)
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


def _t_div(_args):
    return DOUBLE  # every division is DOUBLE, as in the JAX package


def _div_impl(args: list[Val], out: DataType):
    """x / y in DOUBLE; division by zero gives NULL."""
    a, b = args
    x = _to_physical(a, DOUBLE)
    y = _to_physical(b, DOUBLE)
    bad = y == 0
    res = x / torch.where(bad, torch.ones_like(y), y)
    return res, ~bad & valid_or_all(a) & valid_or_all(b)


def valid_or_all(v: Val) -> torch.Tensor:
    """A Val's validity as a tensor (None means every row valid)."""
    if v.valid is not None:
        return v.valid
    return torch.ones(v.data.shape[0], dtype=torch.bool, device=v.data.device)


register("add", _t_add)(_binary_numeric(lambda x, y: x + y))
register("sub", _t_add)(_binary_numeric(lambda x, y: x - y))
register("mul", _t_mul)(_mul_impl)
register("div", _t_div)(_div_impl)


def _t_int(_):
    return INTEGER


def _t_bigint(_):
    return BIGINT


@register("cast_bigint", _t_bigint)
def _cast_bigint(args: list[Val], out: DataType):
    """To BIGINT; a DECIMAL drops its fraction by floor division, as the
    JAX package's ``//`` does."""
    v = args[0]
    if v.dtype.kind is TypeKind.DECIMAL:
        return torch.div(v.data.to(torch.int64), 10**v.dtype.scale,
                         rounding_mode="floor"), None
    return v.data.to(torch.int64), None


# ---- comparisons ----------------------------------------------------------


def _pad_space(d: torch.Tensor) -> torch.Tensor:
    """SQL CHAR PAD SPACE: the zero padding behind fixed-width values
    compares as spaces (data never contains a real NUL)."""
    return torch.where(d == 0, torch.full_like(d, 32), d)


def _literal_row(s: str, data: torch.Tensor) -> torch.Tensor:
    """A string literal as one [W] byte row beside ``data``."""
    lit = ops_strings.pad_literal(s, data.shape[1])
    return torch.from_numpy(lit).to(data.device)


def _bytes_sign(a: Val, b: Val) -> torch.Tensor:
    """3-way lexicographic compare involving a BYTES side: an int32 sign
    per row; the comparisons test it against 0."""
    bytes_compare = ops_strings.bytes_compare
    if a.dtype.kind is TypeKind.BYTES and isinstance(b.data, str):
        lit = _pad_space(_literal_row(b.data, a.data))
        return bytes_compare(_pad_space(a.data), lit.expand_as(a.data))
    if b.dtype.kind is TypeKind.BYTES and isinstance(a.data, str):
        lit = _pad_space(_literal_row(a.data, b.data))
        return -bytes_compare(_pad_space(b.data), lit.expand_as(b.data))
    if a.dtype.kind is TypeKind.BYTES and b.dtype.kind is TypeKind.BYTES:
        w = max(a.data.shape[1], b.data.shape[1])

        def widen(d):
            return torch.nn.functional.pad(d, (0, w - d.shape[1])) if d.shape[1] < w else d

        return bytes_compare(_pad_space(widen(a.data)), _pad_space(widen(b.data)))
    raise NotSupported(f"comparing {a.dtype} with {b.dtype} is not ported yet")


def _cmp_physicals(a: Val, b: Val):
    """Bring two comparable Vals to a common physical domain. VARCHAR
    codes compare within ONE ordered dictionary (literals were encoded
    against it by ``_encode_string_literals``)."""
    ta, tb = a.dtype, b.dtype
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
        if TypeKind.BYTES in (args[0].dtype.kind, args[1].dtype.kind):
            sign = _bytes_sign(args[0], args[1])
            return op(sign, torch.zeros_like(sign)), None
        x, y = _cmp_physicals(args[0], args[1])
        return op(x, y), None

    return impl


register("eq", _t_bool)(_cmp(lambda x, y: x == y))
register("ne", _t_bool)(_cmp(lambda x, y: x != y))
register("lt", _t_bool)(_cmp(lambda x, y: x < y))
register("le", _t_bool)(_cmp(lambda x, y: x <= y))
register("gt", _t_bool)(_cmp(lambda x, y: x > y))
register("ge", _t_bool)(_cmp(lambda x, y: x >= y))


@register("between", _t_bool)
def _between(args: list[Val], out: DataType):
    """lo <= x <= hi, each side compared as ``ge`` and ``le`` are."""
    lo = _cmp(lambda x, y: x >= y)([args[0], args[1]], out)[0]
    hi = _cmp(lambda x, y: x <= y)([args[0], args[2]], out)[0]
    return lo & hi, None


@register("and", _t_bool)
def _and(args: list[Val], out: DataType):
    """Kleene AND: FALSE dominates NULL; data is "definitely true"."""
    a, b = args
    true_a, true_b = a.valid & a.data, b.valid & b.data
    false_a, false_b = a.valid & ~a.data, b.valid & ~b.data
    return true_a & true_b, (a.valid & b.valid) | false_a | false_b


@register("not", _t_bool)
def _not(args: list[Val], out: DataType):
    """Kleene NOT: NULL stays NULL (the argument's validity carries)."""
    return ~args[0].data, None


# ---- dates ----------------------------------------------------------------


def _floordiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), int32: the civil
    calendar algorithm (Hinnant) with floor division, as in the JAX
    package."""
    z = days.to(torch.int32) + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_of(v: Val) -> torch.Tensor:
    if v.dtype.kind is not TypeKind.DATE:
        raise NotSupported(f"date fields of {v.dtype} are not ported yet")
    return v.data


@register("year", _t_int)
def _year(args: list[Val], out: DataType):
    return civil_from_days(_days_of(args[0]))[0], None


@register("month", _t_int)
def _month(args: list[Val], out: DataType):
    return civil_from_days(_days_of(args[0]))[1], None


@register("day", _t_int)
def _day(args: list[Val], out: DataType):
    return civil_from_days(_days_of(args[0]))[2], None


# ---- string predicates on dictionary / bytes columns ----------------------


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _dict_predicate(target: Val, pred, what: str) -> torch.Tensor:
    """A host predicate over the dictionary's values, gathered by code on
    the device (a scan over distinct values, not rows)."""
    d = target.dictionary
    if d is None:
        raise NotSupported(f"{what} on dictionary-less VARCHAR is not ported yet")
    table = np.fromiter((pred(v) for v in d.values), dtype=np.bool_, count=len(d))
    t = torch.from_numpy(table).to(target.data.device)
    # dead rows may hold any code: clamp as a jnp gather would
    return t[target.data.to(torch.int64).clamp(0, max(len(d) - 1, 0))]


@register("like", _t_bool)
def _like(args: list[Val], out: DataType):
    """like(col, pattern literal). BYTES: the LIKE kernel; dictionary
    VARCHAR: a host regex over the dictionary, then a gather by code."""
    target, pat = args
    if target.dtype.kind is TypeKind.BYTES:
        return cuda_strings.like_mask(target.data, pat.data), None
    rx = re.compile(_like_to_regex(pat.data))
    return _dict_predicate(target, lambda v: rx.match(v) is not None, "LIKE"), None


@register("starts_with", _t_bool)
def _starts_with(args: list[Val], out: DataType):
    target, pref = args
    if target.dtype.kind is TypeKind.BYTES:
        return cuda_strings.starts_with_mask(target.data, pref.data), None
    return _dict_predicate(target, lambda v: v.startswith(pref.data), "starts_with"), None


def substr_fn(start: int, length: int) -> str:
    """Register (once) and return the name of a static-bound substr:
    BYTES(w) -> BYTES(length). SQL is 1-based."""
    name = f"substr_{start}_{length}"
    if name not in _REGISTRY:

        def rule(args, _l=length):
            return fixed_bytes(_l)

        @register(name, rule)
        def impl(args, out, _s=start, _l=length):
            if args[0].dtype.kind is not TypeKind.BYTES:
                raise NotSupported(f"substr over {args[0].dtype} is not ported yet")
            return ops_strings.substr(args[0].data, _s, _l), None

    return name


#: functions whose VARCHAR arguments stay raw strings (patterns, needles)
_RAW_STRING_ARGS = ("like", "starts_with")


def _encode_string_literals(fn: str, args: list[Val]) -> list[Val]:
    """Encode host-side VARCHAR literals against a sibling's dictionary
    (the JAX package's rule). Codes are string order, so a literal
    absent from the dictionary maps to its insertion point for the
    range comparisons and to the impossible code ``len(dictionary)``
    for ``eq``: it matches nothing."""
    if fn in _RAW_STRING_ARGS:
        return args
    dictionary = next((a.dictionary for a in args if a.dictionary is not None), None)
    if dictionary is None:
        return args
    cap, dev = next((a.data.shape[0], a.data.device) for a in args
                    if a.dictionary is not None)
    out = []
    for pos, a in enumerate(args):
        if a.dtype.kind is TypeKind.VARCHAR and isinstance(a.data, str):
            code = dictionary._index.get(a.data)
            if code is None:
                if fn in ("lt", "ge") or (fn == "between" and pos == 1):
                    # x < s  ==  code < lb(s)
                    code = dictionary.lower_bound(a.data)
                elif fn in ("le", "gt") or (fn == "between" and pos == 2):
                    # x <= s  ==  code <= lb(s) - 1
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
