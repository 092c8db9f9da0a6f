"""Row expression IR + vectorized evaluator.

Counterpart of ``presto_tpu/expr.py``. Expressions are a small immutable
IR evaluated eagerly over ``Batch`` columns; every evaluation returns
``Val(data, valid)`` so NULL handling is branch-free tensor math. A
function that sets its own validity returns it; otherwise the result is
valid where every argument is.

Ported: ``add``, ``sub``, ``mul`` over DECIMAL and DATE; ``div`` in
DOUBLE (float32, as in the JAX package; division by zero is NULL);
``mod`` (floor modulo, a zero divisor NULL); ``neg`` (on the argument's
own dtype: the narrow extreme wraps); ``cast_bigint``, ``cast_double``,
``rescale_<s>`` (CAST to ``decimal(p,s)``), ``cast_timestamp``,
``cast_varchar_<w>`` (left-aligned text, zero-padded), ``parse_date``
and ``parse_timestamp``; the comparisons ``eq``, ``ne``, ``lt``, ``le``,
``gt``, ``ge``, ``between`` and ``in`` over numbers, dates, dictionary
VARCHAR (a string literal is encoded against its peer column's
dictionary; an absent literal matches nothing under ``eq`` and ``in``)
and fixed-width BYTES (PAD SPACE, against a string literal or another
BYTES value); the Kleene ``and``, ``or`` and ``not``; ``is_null`` and
``is_not_null``; the conditional forms ``case``, ``if`` and ``coalesce``
(a literal beside BYTES branches becomes a space-padded row); the math
family (``abs``, ``sqrt`` with NULL for a negative argument, ``floor``,
``ceil``, ``round`` half away from zero, ``sign``, ``exp``, ``ln``,
``log10``, ``log2``, ``power``, ``truncate``, ``greatest``, ``least``);
the date family over DATE and TIMESTAMP (``year``, ``month``, ``day``,
``quarter``, ``day_of_week``, ``day_of_year``, ``hour``, ``minute``,
``second``, ``date_trunc_<unit>``, ``date_add_<unit>``,
``date_diff_<unit>``, ``last_day_of_month``); the string family (``like``
and ``starts_with`` on BYTES through the kernels of ``ops/cuda_strings``,
on dictionary VARCHAR through a host regex over the dictionary and a
gather by code; ``upper``, ``lower``, ``concat``, ``length``, ``trim``,
``ltrim``, ``rtrim``, ``reverse``, ``strpos``, the static
``substr_<start>_<length>`` over BYTES; ``replace``,
``split_part_<sep>_<n>``, ``substr_dict_<start>_<length>`` and
``regexp_like`` over dictionary VARCHAR, whose transforms derive a new
dictionary); and the join-key normalizers ``dict_bytes`` (dictionary
VARCHAR to fixed-width BYTES), ``bytes_pack`` (BYTES of at most 7 bytes
to an exact int64), ``bytes_hash`` and ``hash63_mix`` (63-bit FNV folds
whose candidates the join verifies by value). None of these reaches a
TPU kernel in the JAX package but ``like`` and ``starts_with``: the rest
is plain PyTorch here as it is plain jnp there. A call to any other
function raises ``NotSupported`` naming it.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Dictionary
from presto_tpu_torch.ops import cuda_strings
from presto_tpu_torch.ops import strings as ops_strings
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    TIMESTAMP,
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


@dataclass(frozen=True)
class Param(Expr):
    """A typed literal slot (plan-template parameterization): the value
    lives outside the expression tree and arrives at evaluation time
    through the ambient parameter scope (:func:`param_scope`). Hashes by
    (slot, dtype), never by value, so queries differing only in literals
    share one Param-bearing plan template."""

    slot: int = 0

    def __str__(self) -> str:
        return f"?{self.slot}"


#: the ambient parameter-slot values: the executor installs the bound
#: device scalars for the whole plan run (``param_scope``)
_PARAM_VALUES: ContextVar[Optional[tuple]] = ContextVar(
    "presto_tpu_torch_param_values", default=None
)


@contextmanager
def param_scope(values):
    """Install parameter-slot values for evaluate() (see _PARAM_VALUES)."""
    token = _PARAM_VALUES.set(tuple(values) if values is not None else None)
    try:
        yield
    finally:
        _PARAM_VALUES.reset(token)


@dataclass(frozen=True)
class Unbound(Expr):
    """A runtime-scalar slot (an uncorrelated scalar subquery's result).
    The executor substitutes a Literal (``bind_scalars``) before an
    operator sees the expression; evaluating an Unbound is an error."""

    name: str = ""

    def __str__(self) -> str:
        return f"?{self.name}"


def bind_scalars(e: Expr, values: dict[str, Any]) -> Expr:
    """Replace Unbound slots with Literals (executor-side)."""
    if isinstance(e, Unbound):
        if e.name not in values:
            raise KeyError(f"unbound scalar {e.name}")
        return Literal(e.dtype, values[e.name])
    if isinstance(e, Call):
        return Call(e.dtype, e.fn, tuple(bind_scalars(a, values) for a in e.args))
    return e


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
    if target.kind is TypeKind.TIMESTAMP:
        if src.kind is TypeKind.DATE:
            return data.to(torch.int64) * _MICROS_PER_DAY
        return data.to(torch.int64)
    if target.kind in (TypeKind.BIGINT, TypeKind.INTEGER, TypeKind.DATE):
        return data.to(target.torch_dtype)
    if target.kind is TypeKind.BOOLEAN:
        return data.to(torch.bool)
    if (target.kind is TypeKind.BYTES and src.kind is TypeKind.BYTES
            and src.width == target.width):
        return data
    if target.kind is TypeKind.VARCHAR and src.kind is TypeKind.VARCHAR:
        # dictionary codes pass through whatever their physical width
        return data
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


def _t_first(args):
    return args[0]


def _t_double(_):
    return DOUBLE


@register("neg", _t_first)
def _neg(args: list[Val], out: DataType):
    """Unary minus on the argument's own physical dtype: the narrow
    extreme wraps (int8 -128 stays -128), as in the JAX package."""
    return -args[0].data, None


@register("cast_double", _t_double)
def _cast_double(args: list[Val], out: DataType):
    return _to_physical(args[0], DOUBLE), None


def rescale_decimal(target_scale: int) -> str:
    """Register (once) and return the name of ``CAST(x AS decimal(p, s))``:
    to DECIMAL at scale ``s``, a lower scale rounding half away from zero."""
    name = f"rescale_{target_scale}"
    if name not in _REGISTRY:

        def rule(args, _s=target_scale):
            return decimal(38, _s)

        @register(name, rule)
        def impl(args, out, _s=target_scale):
            return _to_physical(args[0], decimal(38, _s)), None

    return name


@register("cast_bigint", _t_bigint)
def _cast_bigint(args: list[Val], out: DataType):
    """To BIGINT; a DECIMAL drops its fraction by floor division, as the
    JAX package's ``//`` does."""
    v = args[0]
    if v.dtype.kind is TypeKind.DECIMAL:
        return torch.div(v.data.to(torch.int64), 10**v.dtype.scale,
                         rounding_mode="floor"), None
    return v.data.to(torch.int64), None


# ---- math -----------------------------------------------------------------


@register("mod", _t_same)
def _mod(args: list[Val], out: DataType):
    """Floor modulo (the divisor's sign), as the JAX package's ``%``;
    a zero divisor gives NULL."""
    x = _to_physical(args[0], out)
    y = _to_physical(args[1], out)
    bad = y == 0
    r = torch.remainder(x, torch.where(bad, torch.ones_like(y), y))
    return (torch.where(bad, torch.zeros_like(r), r),
            ~bad & valid_or_all(args[0]) & valid_or_all(args[1]))


@register("abs", _t_same)
def _abs(args: list[Val], out: DataType):
    return torch.abs(_to_physical(args[0], out)), None


@register("sqrt", _t_double)
def _sqrt(args: list[Val], out: DataType):
    """The square root; a negative argument gives NULL, not NaN."""
    x = _to_physical(args[0], out)
    bad = x < 0
    return torch.sqrt(torch.where(bad, torch.zeros_like(x), x)), ~bad & valid_or_all(args[0])


@register("floor", _t_double)
def _floor(args: list[Val], out: DataType):
    return torch.floor(_to_physical(args[0], out)), None


@register("ceil", _t_double)
def _ceil(args: list[Val], out: DataType):
    return torch.ceil(_to_physical(args[0], out)), None


@register("round", _t_double)
def _round(args: list[Val], out: DataType):
    """SQL ROUND: half away from zero (``torch.round`` is half to even)."""
    x = _to_physical(args[0], out)
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5), None


@register("sign", _t_int)
def _sign(args: list[Val], out: DataType):
    """-1, 0 or 1 as INTEGER for every input type, as in the JAX package."""
    return torch.sign(args[0].data).to(torch.int32), None


def _unary_double(name: str, f):
    @register(name, _t_double)
    def impl(args: list[Val], out: DataType, _f=f):
        return _f(_to_physical(args[0], DOUBLE)), None

    return impl


# ln(0) is -Infinity and ln of a negative number NaN (IEEE)
_unary_double("exp", torch.exp)
_unary_double("ln", torch.log)
_unary_double("log10", torch.log10)
_unary_double("log2", torch.log2)
_unary_double("truncate", torch.trunc)


@register("power", _t_double)
def _power(args: list[Val], out: DataType):
    return torch.pow(_to_physical(args[0], DOUBLE), _to_physical(args[1], DOUBLE)), None


def _check_comparable_dicts(args: list[Val], what: str) -> None:
    if any(a.dtype.kind is TypeKind.VARCHAR and isinstance(a.data, str) for a in args):
        raise NotImplementedError(
            f"{what} with a string literal: the winning literal may be "
            "absent from the column dictionary (unrepresentable result)")
    dicts = [a.dictionary for a in args
             if a.dtype.kind is TypeKind.VARCHAR and a.dictionary is not None]
    if dicts and any(d is not dicts[0] for d in dicts[1:]):
        raise NotImplementedError(
            f"{what} across different dictionaries: codes are only "
            "ordered within one dictionary")


def _extreme(name: str, pick):
    @register(name, _t_same)
    def impl(args: list[Val], out: DataType, _name=name, _pick=pick):
        """NULL when ANY argument is NULL."""
        _check_comparable_dicts(args, _name)
        data = _to_physical(args[0], out)
        valid = valid_or_all(args[0])
        for a in args[1:]:
            data = _pick(data, _to_physical(a, out))
            valid = valid & valid_or_all(a)
        return data, valid

    return impl


_extreme("greatest", torch.maximum)
_extreme("least", torch.minimum)


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
    raise TypeError("not a BYTES comparison")


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


_eq = register("eq", _t_bool)(_cmp(lambda x, y: x == y))
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


@register("or", _t_bool)
def _or(args: list[Val], out: DataType):
    """Kleene OR: TRUE dominates NULL; data is "definitely true"."""
    a, b = args
    va, vb = valid_or_all(a), valid_or_all(b)
    true_a, true_b = va & a.data, vb & b.data
    return true_a | true_b, (va & vb) | true_a | true_b


@register("is_null", _t_bool)
def _is_null(args: list[Val], out: DataType):
    v = valid_or_all(args[0])
    return ~v, torch.ones_like(v)


@register("is_not_null", _t_bool)
def _is_not_null(args: list[Val], out: DataType):
    v = valid_or_all(args[0])
    return v, torch.ones_like(v)


# ---- conditional forms ----------------------------------------------------


def _bytes_literal_matrix(s: str, width: int, cap: int, device) -> torch.Tensor:
    """A VARCHAR literal as a broadcast [cap, width] BYTES matrix,
    space-padded or truncated to the fixed width."""
    raw = s.encode()[:width].ljust(width, b" ")
    row = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(device)
    return row.expand(cap, width)


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(cond, a, b) per row, for [rows] and [rows, width] values."""
    return torch.where(cond[:, None] if a.dim() > 1 or b.dim() > 1 else cond, a, b)


@register("coalesce", _t_same)
def _coalesce(args: list[Val], out: DataType):
    """The first non-NULL argument; a VARCHAR literal beside BYTES
    arguments becomes a space-padded row of the result's width."""
    if out.kind is TypeKind.BYTES:
        cap, dev = next((a.data.shape[0], a.data.device) for a in args
                        if not isinstance(a.data, str))
        args = [Val(_bytes_literal_matrix(a.data, out.width, cap, dev),
                    torch.ones(cap, dtype=torch.bool, device=dev), out)
                if isinstance(a.data, str) else a
                for a in args]
    data = _to_physical(args[-1], out)
    valid = valid_or_all(args[-1])
    for v in reversed(args[:-1]):
        vv = valid_or_all(v)
        data = _select(vv, _to_physical(v, out), data)
        valid = vv | valid
    return data, valid


@register("if", lambda args: _t_same(args[1:]))
def _if(args: list[Val], out: DataType):
    c, t, f = args
    cond = c.data & valid_or_all(c)
    data = _select(cond, _to_physical(t, out), _to_physical(f, out))
    return data, torch.where(cond, valid_or_all(t), valid_or_all(f))


def _t_case(args):
    return _t_same([args[i] for i in range(1, len(args), 2)]
                   + ([args[-1]] if len(args) % 2 else []))


@register("case", _t_case)
def _case(args: list[Val], out: DataType):
    """case(when1, then1, when2, then2, ..., [else]): the first WHEN that
    is TRUE (not NULL) picks its THEN; no match and no ELSE is NULL."""
    pairs = list(zip(args[0::2], args[1::2]))
    if len(args) % 2 == 1:
        data = _to_physical(args[-1], out)
        valid = valid_or_all(args[-1])
    else:
        data = torch.zeros_like(_to_physical(pairs[0][1], out))
        valid = torch.zeros_like(valid_or_all(pairs[0][0]))
    for c, t in reversed(pairs):
        cond = c.data & valid_or_all(c)
        data = _select(cond, _to_physical(t, out), data)
        valid = torch.where(cond, valid_or_all(t), valid)
    return data, valid


@register("in", _t_bool)
def _in(args: list[Val], out: DataType):
    """in(needle, v1, v2, ...) over a small literal list. The result's
    validity is the needle's alone (a NULL item does not make a miss
    NULL), the JAX package's rule."""
    needle = args[0]
    hit = None
    for v in args[1:]:
        h = _eq([needle, v], out)[0]
        hit = h if hit is None else (hit | h)
    return hit, valid_or_all(needle)


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


_MICROS_PER_DAY = 86_400_000_000


def _days_of(v: Val) -> torch.Tensor:
    """Days since the epoch of a DATE, or of a TIMESTAMP (microseconds
    floor to days, right for instants before the epoch too)."""
    if v.dtype.kind is TypeKind.TIMESTAMP:
        return _floordiv(v.data.to(torch.int64), _MICROS_PER_DAY).to(torch.int32)
    return v.data


def _time_of_day_us(v: Val) -> torch.Tensor:
    return torch.remainder(v.data.to(torch.int64), _MICROS_PER_DAY)


@register("year", _t_int)
def _year(args: list[Val], out: DataType):
    return civil_from_days(_days_of(args[0]))[0], None


@register("month", _t_int)
def _month(args: list[Val], out: DataType):
    return civil_from_days(_days_of(args[0]))[1], None


@register("day", _t_int)
def _day(args: list[Val], out: DataType):
    return civil_from_days(_days_of(args[0]))[2], None


@register("hour", _t_int)
def _hour(args: list[Val], out: DataType):
    return _floordiv(_time_of_day_us(args[0]), 3_600_000_000).to(torch.int32), None


@register("minute", _t_int)
def _minute(args: list[Val], out: DataType):
    return torch.remainder(_floordiv(_time_of_day_us(args[0]), 60_000_000), 60).to(
        torch.int32), None


@register("second", _t_int)
def _second(args: list[Val], out: DataType):
    return torch.remainder(_floordiv(_time_of_day_us(args[0]), 1_000_000), 60).to(
        torch.int32), None


@register("cast_timestamp", lambda args: TIMESTAMP)
def _cast_timestamp(args: list[Val], out: DataType):
    return _to_physical(args[0], out), None


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> days since 1970-01-01: the inverse of
    ``civil_from_days``, with floor division."""
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


@register("quarter", _t_int)
def _quarter(args: list[Val], out: DataType):
    return _floordiv(civil_from_days(_days_of(args[0]))[1] + 2, 3), None


@register("day_of_week", _t_int)
def _day_of_week(args: list[Val], out: DataType):
    """ISO: Monday=1 .. Sunday=7 (1970-01-01 was a Thursday)."""
    d = _days_of(args[0]).to(torch.int32)
    return torch.remainder(d + 3, 7) + 1, None


@register("day_of_year", _t_int)
def _day_of_year(args: list[Val], out: DataType):
    d = _days_of(args[0])
    y = civil_from_days(d)[0]
    one = torch.ones_like(y)
    return (d.to(torch.int32) - days_from_civil(y, one, one) + 1).to(torch.int32), None


def date_trunc_fn(unit: str) -> str:
    """Register (once) and return the name of ``date_trunc(unit, x)``: a
    DATE stays a DATE, a TIMESTAMP a TIMESTAMP."""
    name = f"date_trunc_{unit}"
    if name not in _REGISTRY:
        if unit not in ("second", "minute", "hour", "day", "week", "month",
                        "quarter", "year"):
            raise NotImplementedError(f"date_trunc unit {unit!r}")

        @register(name, _t_first)
        def impl(args, out, _u=unit):
            is_ts = args[0].dtype.kind is TypeKind.TIMESTAMP
            if _u in ("hour", "minute", "second"):
                if not is_ts:  # a DATE truncated below a day: identity
                    return args[0].data, None
                per = {"hour": 3_600_000_000, "minute": 60_000_000,
                       "second": 1_000_000}[_u]
                return args[0].data - torch.remainder(_time_of_day_us(args[0]), per), None
            d = _days_of(args[0]).to(torch.int32)
            if _u == "day":
                days = d
            elif _u == "week":  # the ISO week starts on Monday
                days = d - torch.remainder(d + 3, 7)
            else:
                y, m, _day_ = civil_from_days(d)
                one = torch.ones_like(y)
                if _u == "month":
                    days = days_from_civil(y, m, one)
                elif _u == "quarter":
                    days = days_from_civil(y, _floordiv(m - 1, 3) * 3 + 1, one)
                else:
                    days = days_from_civil(y, one, one)
            if is_ts:
                return days.to(torch.int64) * _MICROS_PER_DAY, None
            return days, None

    return name


def _add_months(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Calendar month addition, clamped to the end of the month."""
    y, m, day = civil_from_days(d)
    tot = y * 12 + (m - 1) + n
    y2 = _floordiv(tot, 12)
    m2 = torch.remainder(tot, 12) + 1
    one = torch.ones_like(y2)
    first = days_from_civil(y2, m2, one)
    nxt = days_from_civil(y2 + (m2 == 12).to(y2.dtype), torch.remainder(m2, 12) + 1, one)
    return first + torch.minimum(day, nxt - first) - 1


def date_add_fn(unit: str) -> str:
    """Register (once) and return the name of ``date_add(unit, n, d)``."""
    name = f"date_add_{unit}"
    if name not in _REGISTRY:
        if unit not in ("day", "week", "month", "quarter", "year"):
            raise NotImplementedError(f"date_add unit {unit!r}")

        @register(name, lambda args: DATE)
        def impl(args, out, _u=unit):
            n = args[0].data.to(torch.int32)
            d = args[1].data.to(torch.int32)
            if _u == "day":
                return d + n, None
            if _u == "week":
                return d + 7 * n, None
            return _add_months(d, n * {"month": 1, "quarter": 3, "year": 12}[_u]), None

    return name


def _trunc_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """Division toward zero: SQL's date_diff counts COMPLETE units."""
    q = _floordiv(torch.abs(x), d)
    return torch.where(x >= 0, q, -q)


def date_diff_fn(unit: str) -> str:
    """Register (once) and return the name of ``date_diff(unit, a, b)``."""
    name = f"date_diff_{unit}"
    if name not in _REGISTRY:
        if unit not in ("day", "week", "month", "quarter", "year"):
            raise NotImplementedError(f"date_diff unit {unit!r}")

        @register(name, _t_bigint)
        def impl(args, out, _u=unit):
            a = args[0].data.to(torch.int32)
            b = args[1].data.to(torch.int32)
            if _u == "day":
                return (b - a).to(torch.int64), None
            if _u == "week":
                return _trunc_div(b - a, 7).to(torch.int64), None
            ya, ma, da = civil_from_days(a)
            yb, mb, db = civil_from_days(b)
            raw = (yb * 12 + mb) - (ya * 12 + ma)
            months = torch.where(b >= a, raw - (db < da).to(raw.dtype),
                                 raw + (db > da).to(raw.dtype))
            per = {"month": 1, "quarter": 3, "year": 12}[_u]
            return _trunc_div(months, per).to(torch.int64), None

    return name


@register("last_day_of_month", lambda args: DATE)
def _last_day_of_month(args: list[Val], out: DataType):
    y, m, _d = civil_from_days(args[0].data.to(torch.int32))
    nxt = days_from_civil(y + (m == 12).to(y.dtype), torch.remainder(m, 12) + 1,
                          torch.ones_like(y))
    return nxt - 1, None


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
        raise NotImplementedError(f"{what} on dictionary-less VARCHAR")
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


# ---- string functions -----------------------------------------------------
# Dictionary VARCHAR runs through host tables over the dictionary's values
# and one gather by code on the device (a scan over distinct values, as
# ``like`` does); fixed-width BYTES through the [rows, width] functions of
# ops/strings.


@register("upper", _t_first)
def _upper(args: list[Val], out: DataType):
    a = args[0]
    if a.dtype.kind is not TypeKind.BYTES and a.dictionary is not None:
        data, nd = _dict_value_transform(a, "upper", str.upper)
        return data, None, nd
    d = a.data
    return torch.where((d >= 97) & (d <= 122), d - 32, d), None


@register("lower", _t_first)
def _lower(args: list[Val], out: DataType):
    a = args[0]
    if a.dtype.kind is not TypeKind.BYTES and a.dictionary is not None:
        data, nd = _dict_value_transform(a, "lower", str.lower)
        return data, None, nd
    d = a.data
    return torch.where((d >= 65) & (d <= 90), d + 32, d), None


@register("concat", _t_first)
def _concat(args: list[Val], out: DataType):
    """SQL ``||`` over BYTES and string literals: the width is the sum of
    the parts' (the analyzer's); a BYTES part keeps its whole width,
    its zero tail as spaces (CHAR semantics), a literal its own bytes."""
    cap, dev = next((a.data.shape[0], a.data.device) for a in args
                    if not isinstance(a.data, str))
    parts = []
    for a in args:
        if isinstance(a.data, str):
            raw = np.frombuffer(a.data.encode(), np.uint8).copy()
            parts.append(torch.from_numpy(raw).to(dev).expand(cap, len(raw)))
        else:
            parts.append(_pad_space(a.data))
    return torch.cat(parts, dim=1), None


def _dict_int_table(dictionary: Dictionary, key, fn, dtype=np.int32) -> np.ndarray:
    """A host table of ``fn`` over the dictionary's values, cached on the
    dictionary by ``key``."""
    cache = dictionary._bytes_mats
    k = ("int_table", key)
    if k not in cache:
        cache[k] = np.fromiter((fn(v) for v in dictionary.values), dtype=dtype,
                               count=len(dictionary))
    return cache[k]


def _gather_dict(a: Val, table: np.ndarray) -> torch.Tensor:
    """``table[code]`` per row on the device (codes clamped into range,
    as a jnp gather clamps)."""
    t = torch.from_numpy(table).to(a.data.device)
    return t[a.data.to(torch.int64).clamp(0, max(table.shape[0] - 1, 0))]


def _dict_value_transform(a: Val, key, fn):
    """A string-to-string transform of a dictionary column: the derived
    Dictionary is built on the host once (cached on the source
    dictionary) and the codes remap with one gather. Returns (codes,
    derived dictionary)."""
    cache = a.dictionary._bytes_mats
    k = ("remap", key)
    if k not in cache:
        xs = [fn(v) for v in a.dictionary.values]
        nd = Dictionary(xs)
        cache[k] = (nd, nd.encode(xs))
    nd, table = cache[k]
    return _gather_dict(a, table), nd


@register("length", _t_int)
def _length(args: list[Val], out: DataType):
    """BYTES: the content length after trailing spaces (fixed-width
    storage cannot tell stored trailing spaces from padding), in int64
    as the JAX package's row sum gives it; dictionary VARCHAR: int32."""
    a = args[0]
    if a.dtype.kind is TypeKind.BYTES:
        return ops_strings.row_lengths(ops_strings.rtrim_bytes(a.data)).to(torch.int64), None
    if a.dictionary is None:
        raise NotImplementedError("length() on dictionary-less VARCHAR")
    return _gather_dict(a, _dict_int_table(a.dictionary, "length", len)), None


def _string_transform(key: str, host_fn, bytes_fn):
    """A same-type string transform: BYTES rows through ``bytes_fn``, a
    dictionary VARCHAR into a derived dictionary."""

    @register(key, _t_first)
    def impl(args: list[Val], out: DataType, _key=key, _h=host_fn, _b=bytes_fn):
        a = args[0]
        if a.dtype.kind is TypeKind.BYTES:
            return _b(a.data), None
        if a.dictionary is None:
            raise NotImplementedError(f"{_key} on dictionary-less VARCHAR")
        data, nd = _dict_value_transform(a, _key, _h)
        return data, None, nd

    return impl


# the ASCII space only, on both representations
_string_transform("trim", lambda s: s.strip(" "), ops_strings.trim_bytes)
_string_transform("ltrim", lambda s: s.lstrip(" "), ops_strings.ltrim_bytes)
_string_transform("rtrim", lambda s: s.rstrip(" "), ops_strings.rtrim_bytes)
_string_transform("reverse", lambda s: s[::-1], ops_strings.reverse_bytes)


@register("strpos", _t_int)
def _strpos(args: list[Val], out: DataType):
    """strpos(haystack, needle literal): 1-based, 0 when absent."""
    a, b = args
    if not isinstance(b.data, str):
        raise NotImplementedError("strpos needle must be a literal")
    if a.dtype.kind is TypeKind.BYTES:
        return ops_strings.position_in(a.data, b.data), None
    if a.dictionary is None:
        raise NotImplementedError("strpos on dictionary-less VARCHAR")
    t = _dict_int_table(a.dictionary, ("strpos", b.data), lambda v: v.find(b.data) + 1)
    return _gather_dict(a, t), None


@register("replace", _t_first)
def _replace(args: list[Val], out: DataType):
    """replace(col, from literal, to literal): dictionary VARCHAR only (a
    BYTES replace would have data-dependent widths)."""
    a, frm, to = args
    if not (isinstance(frm.data, str) and isinstance(to.data, str)):
        raise NotImplementedError("replace() arguments must be literals")
    if a.dictionary is None:
        raise NotImplementedError("replace() requires a dictionary VARCHAR")
    data, nd = _dict_value_transform(a, ("replace", frm.data, to.data),
                                     lambda v: v.replace(frm.data, to.data))
    return data, None, nd


def split_part_fn(sep: str, n: int) -> str:
    """Register (once) and return the name of ``split_part(col, sep, n)``
    with literal arguments: dictionary VARCHAR only."""
    name = f"split_part_{sep!r}_{n}"
    if name not in _REGISTRY:

        @register(name, _t_first)
        def impl(args, out, _s=sep, _n=n):
            a = args[0]
            if a.dictionary is None:
                raise NotImplementedError("split_part() requires a dictionary VARCHAR")

            def f(v):
                parts = v.split(_s)
                return parts[_n - 1] if 1 <= _n <= len(parts) else ""

            data, nd = _dict_value_transform(a, ("split_part", _s, _n), f)
            return data, None, nd

    return name


def substr_dict_fn(start: int, length: int) -> str:
    """Register (once) and return the name of a 1-based substr over a
    dictionary VARCHAR (a derived dictionary; a negative start counts
    from the end)."""
    name = f"substr_dict_{start}_{length}"
    if name not in _REGISTRY:

        @register(name, _t_first)
        def impl(args, out, _s=start, _l=length):
            a = args[0]
            if a.dictionary is None:
                raise NotImplementedError("substr on dictionary-less VARCHAR")

            def f(v):
                if _s >= 1:
                    return v[_s - 1:_s - 1 + _l]
                if _s < 0:
                    b = len(v) + _s
                    return v[b:b + _l] if b >= 0 else ""  # before the start: empty
                return ""  # start 0 is out of range in SQL

            data, nd = _dict_value_transform(a, ("substr", _s, _l), f)
            return data, None, nd

    return name


@register("regexp_like", _t_bool)
def _regexp_like(args: list[Val], out: DataType):
    a, pat = args
    if not isinstance(pat.data, str):
        raise NotImplementedError("regexp_like pattern must be a literal")
    if a.dictionary is None:
        raise NotImplementedError("regexp_like requires a dictionary VARCHAR")
    rx = re.compile(pat.data)
    table = np.fromiter((rx.search(v) is not None for v in a.dictionary.values),
                        dtype=np.bool_, count=len(a.dictionary))
    return _gather_dict(a, table), None


# ---- parses and casts to VARCHAR -------------------------------------------


def parse_timestamp_fn() -> str:
    """Register (once) and return the name of ``cast(varchar AS
    timestamp)`` over a dictionary column (a host parse of ISO
    'YYYY-MM-DD[ HH:MM:SS[.ffffff]]'; an unparsable value is NULL)."""
    name = "parse_timestamp"
    if name not in _REGISTRY:

        @register(name, lambda args: TIMESTAMP)
        def impl(args, out):
            a = args[0]
            if a.dictionary is None:
                raise NotImplementedError("cast to timestamp on dictionary-less VARCHAR")
            bad_v = -(2**63)

            def f(v):
                try:
                    return int((np.datetime64(v.strip().replace(" ", "T"), "us")
                                - np.datetime64("1970-01-01T00:00:00", "us")).astype(np.int64))
                except ValueError:
                    return bad_v

            d = _gather_dict(a, _dict_int_table(a.dictionary, "parse_timestamp", f,
                                                dtype=np.int64))
            bad = d == bad_v
            return torch.where(bad, torch.zeros_like(d), d), ~bad & valid_or_all(a)

    return name


def parse_date_fn() -> str:
    """Register (once) and return the name of ``cast(varchar AS date)``
    over a dictionary column (a host parse; an unparsable value is
    NULL)."""
    name = "parse_date"
    if name not in _REGISTRY:

        @register(name, lambda args: DATE)
        def impl(args, out):
            import datetime

            a = args[0]
            if a.dictionary is None:
                raise NotImplementedError("cast to date on dictionary-less VARCHAR")
            epoch = datetime.date(1970, 1, 1)

            def f(v):
                try:
                    return (datetime.date.fromisoformat(v.strip()) - epoch).days
                except ValueError:
                    return -(2**31)  # poisoned; the validity clears it below

            d = _gather_dict(a, _dict_int_table(a.dictionary, "parse_date", f))
            bad = d == -(2**31)
            return torch.where(bad, torch.zeros_like(d), d), ~bad & valid_or_all(a)

    return name


_POW10_I64 = np.array([10**k for k in range(19)] + [np.iinfo(np.int64).max], dtype=np.int64)


def _render_int_bytes(v: torch.Tensor, width: int, neg=None) -> torch.Tensor:
    """Left-aligned decimal text of int64 ``v`` in [rows, width] uint8,
    zero-padded; ``neg`` overrides the sign (the decimal renderer needs
    '-0.50')."""
    neg = (v < 0) if neg is None else neg
    a = torch.abs(v)
    nd = torch.ones(v.shape[0], dtype=torch.int32, device=v.device)
    for k in range(1, 19):
        nd = nd + (a >= 10**k).to(torch.int32)
    j = torch.arange(width, dtype=torch.int32, device=v.device)[None, :]
    je = j - neg[:, None].to(torch.int32)  # shift past the '-' sign
    place = nd[:, None] - 1 - je
    pw = torch.from_numpy(_POW10_I64).to(v.device)[place.clamp(0, 19).to(torch.int64)]
    dig = torch.remainder(_floordiv(a[:, None], pw), 10)
    in_digits = (je >= 0) & (je < nd[:, None])
    out = torch.where(in_digits, 48 + dig.to(torch.int32), torch.zeros_like(je))
    out = torch.where((j == 0) & neg[:, None], torch.full_like(out, 45), out)  # '-'
    return out.to(torch.uint8)


def _date_text(y, m, d) -> list:
    """The ten columns of 'yyyy-mm-dd', as int64 byte values."""
    y, m, d = y.to(torch.int64), m.to(torch.int64), d.to(torch.int64)
    dash = torch.full_like(y, 45)
    return [48 + torch.remainder(_floordiv(y, 1000), 10),
            48 + torch.remainder(_floordiv(y, 100), 10),
            48 + torch.remainder(_floordiv(y, 10), 10), 48 + torch.remainder(y, 10), dash,
            48 + _floordiv(m, 10), 48 + torch.remainder(m, 10), dash,
            48 + _floordiv(d, 10), 48 + torch.remainder(d, 10)]


def _fit_width(txt: torch.Tensor, width: int) -> torch.Tensor:
    """Cut or zero-pad [rows, w] text to ``width`` columns."""
    if txt.shape[1] >= width:
        return txt[:, :width]
    return torch.nn.functional.pad(txt, (0, width - txt.shape[1]))


def cast_varchar_fn(width: int) -> str:
    """Register (once) and return the name of ``cast(x AS varchar)``
    rendered into BYTES(width): integers, DATE ('yyyy-mm-dd'), TIMESTAMP
    ('yyyy-mm-dd hh:mm:ss'), DECIMAL, and BYTES / dictionary VARCHAR
    passed through; left-aligned, zero-padded."""
    name = f"cast_varchar_{width}"
    if name not in _REGISTRY:

        def rule(args, _w=width):
            return fixed_bytes(_w)

        @register(name, rule)
        def impl(args, out, _w=width):
            a = args[0]
            k = a.dtype.kind
            if k is TypeKind.BYTES:
                return _fit_width(a.data, _w), None
            if k is TypeKind.VARCHAR:
                if a.dictionary is None:
                    raise NotImplementedError("cast on dictionary-less VARCHAR")
                return _gather_dict(a, a.dictionary.bytes_matrix(_w)), None
            if k is TypeKind.TIMESTAMP:
                us = torch.remainder(a.data.to(torch.int64), _MICROS_PER_DAY)
                y, m, d = civil_from_days(
                    _floordiv(a.data.to(torch.int64), _MICROS_PER_DAY).to(torch.int32))
                hh = _floordiv(us, 3_600_000_000)
                mi = torch.remainder(_floordiv(us, 60_000_000), 60)
                ss = torch.remainder(_floordiv(us, 1_000_000), 60)
                space, colon = torch.full_like(hh, 32), torch.full_like(hh, 58)
                cols = _date_text(y, m, d) + [
                    space, 48 + _floordiv(hh, 10), 48 + torch.remainder(hh, 10), colon,
                    48 + _floordiv(mi, 10), 48 + torch.remainder(mi, 10), colon,
                    48 + _floordiv(ss, 10), 48 + torch.remainder(ss, 10)]
                return _fit_width(torch.stack(cols, dim=1).to(torch.uint8), _w), None
            if k is TypeKind.DATE:
                y, m, d = civil_from_days(a.data)
                return _fit_width(torch.stack(_date_text(y, m, d), dim=1).to(torch.uint8),
                                  _w), None
            if k is TypeKind.DECIMAL and a.dtype.scale > 0:
                sc = a.dtype.scale
                v = a.data.to(torch.int64)
                ip = _floordiv(torch.abs(v), 10**sc)  # the sign apart: '-0.50'
                frac = torch.remainder(torch.abs(v), 10**sc)
                ip_txt = _render_int_bytes(ip, _w, neg=v < 0)
                ip_len = ops_strings.row_lengths(ip_txt)
                j = torch.arange(_w, dtype=torch.int32, device=v.device)[None, :]
                rel = j - ip_len[:, None]  # 0 -> '.', 1..sc -> the fraction digits
                pw = torch.from_numpy(_POW10_I64).to(v.device)[
                    (sc - 1 - (rel - 1)).clamp(0, 19).to(torch.int64)]
                fd = torch.remainder(_floordiv(frac[:, None], pw), 10)
                out_b = torch.where(rel == 0, torch.full_like(rel, 46), torch.zeros_like(rel))
                out_b = torch.where((rel >= 1) & (rel <= sc), 48 + fd.to(torch.int32), out_b)
                return torch.where(rel < 0, ip_txt.to(torch.int32), out_b).to(torch.uint8), None
            return _render_int_bytes(a.data.to(torch.int64), _w), None

    return name


# ---- join-key normalization ------------------------------------------------

_I64_MAX = torch.iinfo(torch.int64).max


def _t_dict_bytes(_args):
    raise NotSupported("dict_bytes width is planner-assigned (construct the Call with "
                       "an explicit fixed_bytes dtype)")


@register("dict_bytes", _t_dict_bytes)
def _dict_bytes(args: list[Val], out: DataType):
    """Dictionary VARCHAR -> fixed-width BYTES through the dictionary's
    decode table: the join planner compares keys of DIFFERENT
    dictionaries by value (codes are comparable within one only)."""
    a = args[0]
    if a.dictionary is None:
        raise NotSupported("dict_bytes on dictionary-less VARCHAR")
    mat = torch.from_numpy(a.dictionary.bytes_matrix(out.width)).to(a.data.device)
    codes = torch.clamp(a.data.to(torch.int64), 0, len(a.dictionary) - 1)
    return mat[codes], None


@register("bytes_pack", lambda args: BIGINT)
def _bytes_pack(args: list[Val], out: DataType):
    """BYTES(w <= 7) -> the exact big-endian int64 (order-preserving,
    non-negative, below 2^56), over space-normalized padding (PAD SPACE)."""
    d = _pad_space(args[0].data).to(torch.int64)
    h = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    for i in range(d.shape[1]):
        h = h * 256 + d[:, i]
    return h, None


def _fnv63_fold(columns) -> torch.Tensor:
    """Order-sensitive FNV fold of int64 columns into [0, 2^63) that
    never yields the int64-max lookup sentinel (a hash there would drop
    its row from the sorted lookup source). The int64 products wrap, on
    the CPU and the card alike, as the JAX package's do."""
    h = columns[0].to(torch.int64)
    for c in columns[1:]:
        h = h * 1099511628211 + c.to(torch.int64)
    h = h & _I64_MAX
    return torch.where(h == _I64_MAX, torch.zeros_like(h), h)


@register("bytes_hash", lambda args: BIGINT)
def _bytes_hash(args: list[Val], out: DataType):
    """BYTES(w > 7) -> a 63-bit FNV fold over space-normalized padding.
    Not injective: the join verifies candidates on the original bytes."""
    d = _pad_space(args[0].data).to(torch.int64)
    cols = [torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)]
    cols += [d[:, i] for i in range(d.shape[1])]
    return _fnv63_fold(cols), None


@register("hash63_mix", lambda args: BIGINT)
def _hash63_mix(args: list[Val], out: DataType):
    """The 63-bit FNV mix of N integer key columns: the multi-key join
    fallback when packed widths exceed 63 bits or a key is negative. Not
    injective: the join verifies candidates on the key pairs."""
    return _fnv63_fold([a.data for a in args]), None


#: functions whose VARCHAR arguments stay raw strings (patterns, needles)
_RAW_STRING_ARGS = ("like", "starts_with", "strpos", "replace", "regexp_like",
                    "greatest", "least")


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
    if isinstance(expr, Param):
        vals = _PARAM_VALUES.get()
        if vals is None or expr.slot >= len(vals):
            raise KeyError(
                f"unbound literal slot ?{expr.slot}: evaluation outside a "
                "param_scope (executor run scope or traced step body)"
            )
        cap, dev = batch.capacity, batch.device
        data = vals[expr.slot].to(device=dev, dtype=expr.dtype.torch_dtype)
        return Val(data.expand(cap).contiguous(),
                   torch.ones(cap, dtype=torch.bool, device=dev), expr.dtype)
    if isinstance(expr, Literal):
        cap, dev = batch.capacity, batch.device
        t = expr.dtype
        if expr.value is None:
            shape = (cap, t.width) if t.kind is TypeKind.BYTES else (cap,)
            return Val(torch.zeros(shape, dtype=t.torch_dtype, device=dev),
                       torch.zeros(cap, dtype=torch.bool, device=dev), t)
        if t.kind is TypeKind.BYTES:
            raise NotSupported(f"{t} literals are not ported to presto_tpu_torch yet")
        if t.kind is TypeKind.VARCHAR:
            # stays host-side; encoded lazily against the peer dictionary
            return Val(expr.value, None, t, None)
        data = torch.full((cap,), t.to_physical(expr.value),
                          dtype=t.torch_dtype, device=dev)
        return Val(data, torch.ones(cap, dtype=torch.bool, device=dev), t)
    if isinstance(expr, Call):
        impl, _rule = _lookup(expr.fn)
        args = _encode_string_literals(expr.fn, [evaluate(a, batch) for a in expr.args])
        # (data, valid), or (data, valid, derived dictionary) from the
        # dictionary transforms (trim, replace, substr, ...)
        data, valid, *derived = impl(args, expr.dtype)
        if valid is None:
            for a in args:
                if a.valid is not None:
                    valid = a.valid if valid is None else (valid & a.valid)
            if valid is None:
                valid = torch.ones(batch.capacity, dtype=torch.bool,
                                   device=batch.device)
        dictionary = derived[0] if derived else None
        if dictionary is None and expr.dtype.kind is TypeKind.VARCHAR:
            dictionary = next((a.dictionary for a in args
                               if a.dictionary is not None), None)
        return Val(data, valid, _sync_physical(expr.dtype, data), dictionary)
    if isinstance(expr, Unbound):
        raise TypeError(f"scalar {expr.name} evaluated before bind_scalars bound it")
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
