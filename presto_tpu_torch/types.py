"""Logical type system.

Counterpart of ``presto_tpu/types.py``. Every logical type maps onto a
fixed-width device representation so batches are struct-of-arrays torch
tensors:

=============  =========================================================
Logical        Physical (device)
=============  =========================================================
BOOLEAN        bool
INTEGER        int32
BIGINT         int64
DOUBLE         float32
DECIMAL(p,s)   int64 scaled by 10**s — exact arithmetic, exact sums
DATE           int32 days since 1970-01-01
TIMESTAMP      int64 microseconds since 1970-01-01 00:00:00 UTC
VARCHAR        int32 codes into an *ordered* host-side dictionary
BYTES(w)       uint8[cap, w] fixed-width padded bytes
=============  =========================================================

``DataType.phys`` narrows the physical storage of a column whose value
domain is bounded (``narrow_physical``); the logical identity is the
canonical form, so arithmetic widens narrow reads before any overflow.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace

import numpy as np
import torch


class TypeKind(enum.Enum):
    BOOLEAN = "boolean"
    INTEGER = "integer"
    BIGINT = "bigint"
    DOUBLE = "double"
    DECIMAL = "decimal"
    DATE = "date"
    TIMESTAMP = "timestamp"
    VARCHAR = "varchar"
    BYTES = "bytes"


#: numpy dtype -> torch dtype, for every physical storage the engine uses
TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.uint8): torch.uint8,
}

_NUMPY_DTYPES = {t: n for n, t in TORCH_DTYPES.items()}


def torch_dtype_of(np_dtype) -> torch.dtype:
    return TORCH_DTYPES[np.dtype(np_dtype)]


def numpy_dtype_of(dtype: torch.dtype) -> np.dtype:
    return _NUMPY_DTYPES[dtype]


@dataclass(frozen=True)
class DataType:
    """A logical SQL type plus the parameters that pin its physical layout.

    ``phys`` is the physical dtype override (a numpy name); the empty
    string means the canonical mapping. ``common_super_type`` and every
    coercion resolve to canonical types.
    """

    kind: TypeKind
    precision: int = 0
    scale: int = 0
    width: int = 0
    phys: str = ""

    # ---- physical layout ------------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        if self.phys:
            return np.dtype(self.phys)
        return np.dtype(_PHYSICAL[self.kind])

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype_of(self.np_dtype)

    @property
    def canonical_np_dtype(self) -> np.dtype:
        return np.dtype(_PHYSICAL[self.kind])

    @property
    def is_narrowed(self) -> bool:
        return bool(self.phys)

    def canonical(self) -> "DataType":
        """The logical identity: this type with canonical storage."""
        return replace(self, phys="") if self.phys else self

    def with_physical(self, np_dtype) -> "DataType":
        """This type stored as ``np_dtype`` (None/canonical clears the
        override)."""
        if np_dtype is None:
            return self.canonical()
        dt = np.dtype(np_dtype)
        if dt == self.canonical_np_dtype:
            return self.canonical()
        return replace(self, phys=dt.name)

    # ---- value conversion ----------------------------------------------
    def to_physical(self, value):
        """Convert one Python-level value to its physical scalar."""
        if value is None:
            return self.null_value()
        if self.kind is TypeKind.DECIMAL:
            return int(round(float(value) * 10**self.scale))
        if self.kind is TypeKind.DATE:
            if isinstance(value, str):
                return int((np.datetime64(value, "D")
                            - np.datetime64("1970-01-01", "D")).astype(np.int32))
            return int(value)
        if self.kind is TypeKind.TIMESTAMP:
            if isinstance(value, str):
                return int((np.datetime64(value.strip(), "us")
                            - np.datetime64("1970-01-01T00:00:00", "us"))
                           .astype(np.int64))
            return int(value)
        if self.kind is TypeKind.BOOLEAN:
            return bool(value)
        if self.kind in (TypeKind.INTEGER, TypeKind.BIGINT):
            return int(value)
        if self.kind is TypeKind.DOUBLE:
            return float(value)
        raise TypeError(f"cannot convert scalar for {self}")

    def from_physical(self, value):
        """Convert one physical scalar back to a Python-level value (a
        DECIMAL as ``int(value) / 10**scale``, which ``to_physical``
        rounds back to the same integer below 2^53)."""
        if self.kind is TypeKind.DECIMAL:
            return int(value) / 10**self.scale
        if self.kind is TypeKind.BOOLEAN:
            return bool(value)
        if self.kind is TypeKind.DOUBLE:
            return float(value)
        if self.kind is TypeKind.DATE:
            return str(np.datetime64("1970-01-01", "D") + np.int64(value))
        if self.kind is TypeKind.TIMESTAMP:
            return str(np.datetime64("1970-01-01T00:00:00", "us")
                       + np.timedelta64(int(value), "us"))
        return int(value)

    def null_value(self):
        """Physical fill value used in NULL slots (masked by validity)."""
        if self.kind is TypeKind.DOUBLE:
            return 0.0
        if self.kind is TypeKind.BOOLEAN:
            return False
        return 0

    def __str__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind is TypeKind.BYTES:
            return f"bytes({self.width})"
        return self.kind.value

    def physical_str(self) -> str:
        """Rendering with the physical storage made visible (EXPLAIN):
        ``bigint`` canonically, ``bigint:int16`` when narrowed."""
        base = str(self)
        return f"{base}:{self.phys}" if self.phys else base


_PHYSICAL = {
    TypeKind.BOOLEAN: np.bool_,
    TypeKind.INTEGER: np.int32,
    TypeKind.BIGINT: np.int64,
    TypeKind.DOUBLE: np.float32,
    TypeKind.DECIMAL: np.int64,
    TypeKind.DATE: np.int32,
    TypeKind.TIMESTAMP: np.int64,
    TypeKind.VARCHAR: np.int32,
    TypeKind.BYTES: np.uint8,
}

BOOLEAN = DataType(TypeKind.BOOLEAN)
INTEGER = DataType(TypeKind.INTEGER)
BIGINT = DataType(TypeKind.BIGINT)
DOUBLE = DataType(TypeKind.DOUBLE)
DATE = DataType(TypeKind.DATE)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)


def decimal(precision: int, scale: int) -> DataType:
    return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)


def varchar() -> DataType:
    return DataType(TypeKind.VARCHAR)


VARCHAR = varchar()


def fixed_bytes(width: int) -> DataType:
    return DataType(TypeKind.BYTES, width=width)


#: kinds whose physical storage may be narrowed from stats bounds
NARROWABLE_KINDS = frozenset({
    TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DECIMAL, TypeKind.DATE,
    TypeKind.TIMESTAMP, TypeKind.VARCHAR,
})

_NARROW_LADDER = (np.int8, np.int16, np.int32, np.int64)


def narrow_physical(dtype: DataType, lo: int, hi: int) -> DataType:
    """The narrowest signed-int storage of ``dtype`` whose range covers
    the PHYSICAL-value interval [lo, hi]. Never wider than canonical, and
    never a dtype whose extreme the domain touches
    (``max(|lo|, |hi|) < 2^(bits-1)``), so unary negation of any
    in-domain value stays exact. Returns ``dtype`` unchanged for
    un-narrowable kinds or unbounded/oversized domains."""
    if dtype.kind not in NARROWABLE_KINDS or dtype.phys:
        return dtype
    lo, hi = int(lo), int(hi)
    if lo > hi:
        return dtype
    canonical_size = dtype.canonical_np_dtype.itemsize
    bound = max(abs(lo), abs(hi))
    for cand in _NARROW_LADDER:
        info = np.iinfo(cand)
        if np.dtype(cand).itemsize >= canonical_size:
            return dtype
        if bound < -int(info.min):  # strict: the extreme slot stays free
            return dtype.with_physical(cand)
    return dtype


def check_narrow_range(name: str, dtype: DataType, arr) -> None:
    """Narrow-storage soundness guard: a value outside a narrowed
    column's physical dtype fails loudly instead of wrapping."""
    if not dtype.is_narrowed or getattr(arr, "size", 0) == 0:
        return
    info = np.iinfo(dtype.np_dtype)
    lo, hi = arr.min(), arr.max()
    if lo < info.min or hi > info.max:
        raise ValueError(
            f"column {name!r}: value range [{lo}, {hi}] exceeds its "
            f"narrowed physical storage {dtype.np_dtype} — wrong/stale "
            "connector stats"
        )


def common_super_type(a: DataType, b: DataType) -> DataType:
    """Implicit-coercion lattice over the LOGICAL identities."""
    if a == b:
        return a
    a = a.canonical()
    b = b.canonical()
    if a == b:
        return a
    order = {
        TypeKind.INTEGER: 0,
        TypeKind.BIGINT: 1,
        TypeKind.DECIMAL: 2,
        TypeKind.DOUBLE: 3,
    }
    if a.kind in order and b.kind in order:
        hi = a if order[a.kind] >= order[b.kind] else b
        lo = b if hi is a else a
        if hi.kind is TypeKind.DECIMAL and lo.kind is TypeKind.DECIMAL:
            scale = max(a.scale, b.scale)
            prec = max(a.precision - a.scale, b.precision - b.scale) + scale
            return decimal(min(prec, 38), scale)
        return hi
    if a.kind is TypeKind.DATE and b.kind is TypeKind.DATE:
        return a
    if {a.kind, b.kind} == {TypeKind.DATE, TypeKind.TIMESTAMP}:
        return a if a.kind is TypeKind.TIMESTAMP else b
    if a.kind is TypeKind.BYTES and b.kind is TypeKind.VARCHAR:
        return a
    if b.kind is TypeKind.BYTES and a.kind is TypeKind.VARCHAR:
        return b
    raise TypeError(f"no common super type for {a} and {b}")
