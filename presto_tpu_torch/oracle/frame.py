"""A small columnar frame over numpy: the pandas operations the oracles use.

The reference oracles are pandas; the card's machine has none. This module
keeps pandas' method names wherever the oracles call them, so each query
reads line for line against its reference, and copies pandas' semantics
wherever they show in an answer:

- a column is a numpy array. A nullable integer column arrives as an
  ``object`` array holding ``None`` (``decode_values``' form); arithmetic,
  comparisons and reductions read it as ``float64`` with NaN;
- ``merge`` keeps the left rows' order (inner and left), matches NULL keys
  to NULL keys, sorts the keys of an outer join and turns a missed integer
  column into ``float64`` NaN;
- ``groupby`` sorts its keys, puts a NULL key last and drops it unless
  ``dropna=False``;
- ``sort_values`` is stable and puts NULLs last unless asked otherwise;
- ``sum`` over nothing is 0, ``mean`` skips NaN, ``std`` has ``ddof=1``,
  ``rank(method="min")`` gives ties the lowest rank.

Rows carry no index: every operation is positional, which is what the
oracles' row-aligned code relies on. A grouped reduction with
``as_index=True`` keeps its keys as a ``Series.index`` frame.

It imports numpy and the standard library only.
"""

from __future__ import annotations

import copy
import itertools
import re
from typing import Callable, Iterable, Mapping

import numpy as np

NaN = np.nan


# ---------------------------------------------------------------- columns


class Lazy:
    """A column decoded on first use: ``decode(rows)`` gives the logical
    values of ``rows`` (every row for None). Taking rows from a lazy
    column stays lazy, so a column no query reads is never decoded."""

    __slots__ = ("n", "decode", "rows")

    def __init__(self, n: int, decode: Callable, rows=None):
        self.n = n
        self.decode = decode
        self.rows = rows

    def __len__(self):
        return self.n if self.rows is None else len(self.rows)

    def take(self, idx: np.ndarray, miss: bool, memo: dict) -> "Lazy | np.ndarray":
        if miss:
            return _take(self.resolve(), idx)
        key = id(self.rows)
        if key not in memo:  # the columns of one table share their row map
            memo[key] = idx if self.rows is None else self.rows[idx]
        return Lazy(self.n, self.decode, memo[key])

    def resolve(self) -> np.ndarray:
        return self.decode(self.rows)


def _is_str_obj(a: np.ndarray) -> bool:
    """An object column of strings (else of numbers and None)."""
    if a.dtype != object:
        return False
    for v in a:
        if v is not None and not (isinstance(v, float) and v != v):
            return isinstance(v, str)
    return False


def _numobj(a: np.ndarray) -> bool:
    return a.dtype == object and not _is_str_obj(a)


def _values(a) -> np.ndarray:
    """A column as arithmetic sees it: numeric object columns as float64."""
    if isinstance(a, Series):
        a = a.values
    if isinstance(a, np.ndarray):
        if a.dtype == object and len(a) and not _is_str_obj(a):
            return a.astype(np.float64)
        if a.dtype.kind == "U":
            return a.astype(object)
        return a
    if isinstance(a, (list, tuple, range)):
        return _array(list(a))
    return a


def _array(vals: list) -> np.ndarray:
    a = np.asarray(vals) if len(vals) else np.zeros(0, np.float64)
    if a.dtype.kind in "US":
        a = np.asarray(vals, dtype=object)
    return a


def isnull(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return np.isnan(a)
    if a.dtype.kind in "mM":
        return np.isnat(a)
    if a.dtype == object:
        return np.asarray(np.equal(a, None) | np.not_equal(a, a), bool)
    return np.zeros(len(a), bool)


def _take(a: np.ndarray | Lazy, idx: np.ndarray, has_miss: bool | None = None,
          memo: dict | None = None) -> np.ndarray | Lazy:
    """Rows ``idx`` of a column; -1 gives NULL, and a column that cannot
    hold NULL widens as pandas' does (integers to float64, bools to object)."""
    if has_miss is None:
        has_miss = bool(len(idx)) and bool((idx < 0).any())
    if isinstance(a, Lazy):
        return a.take(idx, has_miss, {} if memo is None else memo)
    if not has_miss:
        return a[idx]
    miss = idx < 0
    safe = np.where(miss, 0, idx)
    if not len(a):  # every row missed: any stand-in row of the dtype
        a = np.zeros(1, a.dtype)
    k = a.dtype.kind
    if k in "iu":
        out = a[safe].astype(np.float64)
        out[miss] = NaN
    elif k == "f":
        out = a[safe].copy()
        out[miss] = NaN
    elif k in "mM":
        out = a[safe].copy()
        out[miss] = np.datetime64("NaT")
    else:
        out = a[safe].astype(object)
        out[miss] = NaN if k == "b" else None
    return out


def _concat_cols(parts: list[np.ndarray], lens: list[int]) -> np.ndarray:
    """One column of ``concat``: pandas' common dtype of the parts."""
    present = [p for p in parts if p is not None]
    if len(present) == len(parts) and len({p.dtype for p in parts}) == 1:
        return np.concatenate(parts)
    kinds = {p.dtype.kind for p in present}
    if len(present) < len(parts):
        if kinds <= set("iuf"):
            parts = [p.astype(np.float64) if p is not None
                     else np.full(n, NaN) for p, n in zip(parts, lens)]
            return np.concatenate(parts)
        parts = [p if p is not None else np.full(n, None, dtype=object)
                 for p, n in zip(parts, lens)]
        kinds.add("O")
    if kinds <= set("iu"):
        return np.concatenate(parts)
    if kinds <= set("iuf"):
        return np.concatenate([p.astype(np.float64) for p in parts])
    if kinds == {"M"}:
        return np.concatenate([p.astype("datetime64[s]") for p in parts])
    if kinds == {"b"}:
        return np.concatenate(parts)
    return np.concatenate([p.astype(object) for p in parts])


# ------------------------------------------------------------ factorizing


def _sortable(a: np.ndarray) -> np.ndarray:
    """Values that order and compare like the column's logical values."""
    if a.dtype.kind == "M":
        v = a.astype("datetime64[s]").astype(np.int64).astype(np.float64)
        v[np.isnat(a)] = NaN
        return v
    if a.dtype.kind == "b":
        return a.astype(np.int64)
    if a.dtype == object:
        return a if _is_str_obj(a) else a.astype(np.float64)
    return a


def factorize(a: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, sorted uniques, null mask): codes order like the values;
    NULL rows get the code ``len(uniques)``."""
    a = _sortable(a)
    null = isnull(a)
    vals = a[~null] if null.any() else a
    if vals.dtype == object:  # strings: one dict pass, then the uniques sorted
        seen: dict = {}
        first = np.fromiter(map(seen.setdefault, vals, itertools.count()), np.int64,
                            len(vals))  # the row of each value's first appearance
        at = np.fromiter(seen.values(), np.int64, len(seen))
        uniq = vals[at]
        order = np.argsort(uniq.astype(str), kind="stable")
        rank = np.empty(len(vals), np.int64)
        rank[at[order]] = np.arange(len(order))
        uniq, inv = uniq[order], rank[first]
    elif _dense_range(vals):  # integers over a narrow range: their offsets
        lo = vals.min()
        present = np.zeros(int(vals.max() - lo) + 1, bool)
        off = (vals - lo).astype(np.int64)
        present[off] = True
        uniq = np.flatnonzero(present) + lo
        inv = (np.cumsum(present) - 1)[off]
    else:
        uniq, inv = np.unique(vals, return_inverse=True)
    codes = np.full(len(a), len(uniq), np.int64)
    codes[~null] = inv.reshape(-1)
    return codes, uniq, null


def _dense_range(v: np.ndarray) -> bool:
    """Integer values whose range is at most a few times their count."""
    if not len(v) or v.dtype.kind not in "iuf":
        return False
    lo, hi = v.min(), v.max()
    if hi - lo > 4 * len(v) + 1024:
        return False
    return v.dtype.kind != "f" or bool(np.all(v == np.floor(v)))


def _dense(codes: np.ndarray) -> np.ndarray:
    """Non-negative codes renumbered 0..k-1, order kept."""
    if not len(codes):
        return codes.astype(np.int64)
    if codes.max() <= 4 * len(codes) + 1024:
        present = np.zeros(int(codes.max()) + 1, bool)
        present[codes] = True
        return (np.cumsum(present) - 1)[codes].astype(np.int64)
    return np.unique(codes, return_inverse=True)[1].reshape(-1).astype(np.int64)


def _combine(codes: list[np.ndarray], n: int) -> np.ndarray:
    """Dense codes of the rows' key tuples, in lexicographic order."""
    if not codes:
        return np.zeros(n, np.int64)
    out = _dense(codes[0])
    for c in codes[1:]:
        width = int(c.max()) + 1 if len(c) else 1
        out = _dense(out * width + c)
    return out


def _joint_codes(left: list[np.ndarray], right: list[np.ndarray]):
    """Codes of the key tuples of two sides in one code space."""
    nl = len(left[0]) if left else 0
    codes = [factorize(_joint(a, b))[0] for a, b in zip(left, right)]
    both = _combine(codes, nl + (len(right[0]) if right else 0))
    return both[:nl], both[nl:]


def _joint(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = _sortable(a), _sortable(b)
    if a.dtype == object or b.dtype == object:
        return np.concatenate([a.astype(object), b.astype(object)])
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.concatenate([a.astype(np.float64), b.astype(np.float64)])
    return np.concatenate([a, b])


# ------------------------------------------------------------------ Series


class Series:
    """One column: ``values`` plus, for a grouped reduction, its keys."""

    __array_priority__ = 100

    def __init__(self, values, name: str | None = None, index: "Frame | None" = None):
        if isinstance(values, Series):
            values = values.values
        if not isinstance(values, np.ndarray):
            values = _array(list(values))
        self.values = values
        self.name = name
        self._index = index

    # -- basics
    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __array__(self, dtype=None, copy=None):
        v = _values(self)
        return v if dtype is None else v.astype(dtype)

    def to_numpy(self):
        return self.values

    def tolist(self):
        return self.values.tolist()

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def index(self):
        """The keys of a grouped reduction (one key: its values)."""
        if self._index is None:
            return np.arange(len(self))
        cols = self._index.columns
        if len(cols) == 1:
            return self._index[cols[0]].values
        return list(zip(*(self._index[c].values for c in cols)))

    @property
    def iloc(self):
        return self.values

    def _new(self, values, keep_index=True):
        return Series(values, self.name, self._index if keep_index else None)

    def __getitem__(self, key):
        if isinstance(key, str):
            raise KeyError(key)
        key = np.asarray(_values(key)) if isinstance(key, Series) else key
        out = self.values[key]
        idx = None
        if self._index is not None:
            idx = self._index._take(np.arange(len(self))[key])
        return Series(out, self.name, idx)

    def rename(self, name):
        return Series(self.values, name, self._index)

    def reset_index(self, name: str | None = None, drop: bool = False):
        if drop or self._index is None:
            return Frame({name or self.name or 0: self.values})
        f = self._index.copy()
        f[name or self.name or 0] = self.values
        return f

    def copy(self):
        return Series(self.values.copy(), self.name, self._index)

    # -- elementwise
    def _binop(self, other, op):
        a, b = _values(self), _values(other)
        with np.errstate(all="ignore"):
            return self._new(op(a, b))

    def _cmp(self, other, op):
        if isinstance(other, str) and op in (np.equal, np.not_equal):
            # None == "x" is False and None != "x" True, as with NaN
            return self._new(np.asarray(op(self.values.astype(object), other), bool))
        a, b = _values(self), _values(other)
        if isinstance(other, str):  # an all-NULL column compared to a string
            a = self.values.astype(object)
        if a.dtype == object or (isinstance(b, np.ndarray) and b.dtype == object):
            na = isnull(a) | (isnull(b) if isinstance(b, np.ndarray) else
                              np.full(len(a), b is None))
            out = np.zeros(len(a), bool)
            ok = ~na
            bb = b[ok] if isinstance(b, np.ndarray) else b
            out[ok] = np.asarray(op(a[ok], bb), bool)
            if op is np.not_equal:
                out[na] = True
            return self._new(out)
        with np.errstate(all="ignore"):
            return self._new(op(a, b))

    def __add__(self, o): return self._binop(o, np.add)
    def __radd__(self, o): return self._binop(o, lambda a, b: np.add(b, a))
    def __sub__(self, o): return self._binop(o, np.subtract)
    def __rsub__(self, o): return self._binop(o, lambda a, b: np.subtract(b, a))
    def __mul__(self, o): return self._binop(o, np.multiply)
    def __rmul__(self, o): return self._binop(o, lambda a, b: np.multiply(b, a))
    def __truediv__(self, o): return self._binop(o, np.true_divide)
    def __rtruediv__(self, o): return self._binop(o, lambda a, b: np.true_divide(b, a))
    def __eq__(self, o): return self._cmp(o, np.equal)
    def __ne__(self, o): return self._cmp(o, np.not_equal)
    def __lt__(self, o): return self._cmp(o, np.less)
    def __le__(self, o): return self._cmp(o, np.less_equal)
    def __gt__(self, o): return self._cmp(o, np.greater)
    def __ge__(self, o): return self._cmp(o, np.greater_equal)
    def __and__(self, o): return self._binop(o, np.logical_and)
    def __rand__(self, o): return self._binop(o, np.logical_and)
    def __or__(self, o): return self._binop(o, np.logical_or)
    def __ror__(self, o): return self._binop(o, np.logical_or)
    def __invert__(self): return self._new(~self.values.astype(bool))
    __hash__ = None

    def all(self):
        return bool(np.all(_values(self)))

    def between(self, lo, hi):
        return (self >= lo) & (self <= hi)

    def isin(self, values) -> "Series":
        if isinstance(values, (set, frozenset)):
            values = list(values)
        other = _values(values if not isinstance(values, Series) else values.values)
        if not isinstance(other, np.ndarray):
            other = _array(list(other))
        a = self.values
        if len(other) == 0 or len(a) == 0:
            return self._new(np.zeros(len(a), bool))
        if a.dtype == object and other.dtype == object:  # strings: set membership
            keep = {v for v in other.tolist() if isinstance(v, str)}
            return self._new(np.fromiter(map(keep.__contains__, a), bool, len(a)))
        ca, co = _joint_codes([a], [other])
        out = np.isin(ca, co) & ~isnull(a)
        return self._new(out)

    def isna(self): return self._new(isnull(self.values))
    def notna(self): return self._new(~isnull(self.values))

    def fillna(self, value):
        v = _values(self)
        null = isnull(v)
        if not null.any():
            return self._new(v)
        if v.dtype == object:
            out = v.copy()
        else:
            out = v.astype(np.result_type(v.dtype, np.asarray(value).dtype))
        out[null] = value
        return self._new(out)

    def dropna(self):
        return self[~isnull(self.values)]

    def where(self, cond, other=NaN):
        v = _values(self)
        cond = np.asarray(_values(cond), bool)
        if v.dtype.kind in "iub":
            v = v.astype(np.float64)
        return self._new(np.where(cond, v, other))

    def astype(self, dtype):
        return self._new(_values(self).astype(dtype))

    def round(self, decimals: int = 0):
        return self._new(np.round(_values(self), decimals))

    def unique(self) -> np.ndarray:
        codes, _, _ = factorize(self.values)
        _, first = np.unique(codes, return_index=True)
        return self.values[np.sort(first)]

    def nunique(self) -> int:
        codes, uniq, null = factorize(self.values)
        return len(np.unique(codes[~null]))

    def count(self) -> int:
        return int((~isnull(self.values)).sum())

    def sum(self, min_count: int = 0):
        v = _values(self)
        ok = ~isnull(v)
        if ok.sum() < min_count:
            return NaN
        v = v[ok]
        if v.dtype.kind == "b":
            v = v.astype(np.int64)
        return v.sum() if len(v) else (0 if v.dtype.kind in "iu" else 0.0)

    def mean(self):
        v = _values(self).astype(np.float64)
        v = v[~np.isnan(v)]
        return v.sum() / len(v) if len(v) else NaN

    def std(self):
        v = _values(self).astype(np.float64)
        v = v[~np.isnan(v)]
        if len(v) < 2:
            return NaN
        return float(np.sqrt(((v - v.mean()) ** 2).sum() / (len(v) - 1)))

    def max(self):
        v = self.dropna().values
        return _values(v).max() if len(v) else NaN

    def min(self):
        v = self.dropna().values
        return _values(v).min() if len(v) else NaN

    def map(self, keyed: "Series") -> "Series":
        """Each value looked up in the keys of a grouped reduction (NaN
        where missing)."""
        keys = keyed._index[keyed._index.columns[0]].values
        mine, theirs = _joint_codes([self.values], [keys])
        where = np.full(int(max(mine.max(initial=-1), theirs.max(initial=-1))) + 1, -1)
        where[theirs] = np.arange(len(theirs))
        return self._new(_take(_values(keyed.values), where[mine]), keep_index=False)

    def rank(self, method: str = "min", ascending: bool = True):
        return self._new(_rank(_values(self), np.zeros(len(self), np.int64), ascending),
                         keep_index=True)

    def value_counts(self) -> "Series":
        """Rows per distinct non-NULL value, keyed by the value (keys in
        ascending order, where pandas orders by count)."""
        return Frame({"v": self.values}).groupby("v")["v"].size().rename(self.name)

    @property
    def str(self):
        return _Str(self)

    @property
    def dt(self):
        return _Dt(self)


def to_numeric(s: Series) -> Series:
    """An object column of numbers as numbers: int64 when it holds only
    integers, else float64 with NaN for NULL."""
    v = s.values
    if v.dtype != object:
        return s._new(v)
    if all(isinstance(x, (int, np.integer)) for x in v.tolist()):
        return s._new(v.astype(np.int64))
    return s._new(v.astype(np.float64))


class _Str:
    """The ``.str`` methods the oracles call; NULL stays NULL (False in a
    predicate)."""

    def __init__(self, s: Series):
        self.s = s

    def _map(self, fn, pred=False):
        out = [None if v is None or (isinstance(v, float) and v != v) else fn(v)
               for v in self.s.values]
        if pred:
            return self.s._new(np.array([bool(x) for x in out], bool))
        return self.s._new(np.array(out, dtype=object))

    def __getitem__(self, sl):
        return self._map(lambda v: v[sl])

    def startswith(self, p): return self._map(lambda v: v.startswith(p), True)
    def endswith(self, p): return self._map(lambda v: v.endswith(p), True)
    def strip(self): return self._map(str.strip)
    def ljust(self, n): return self._map(lambda v: v.ljust(n))

    def contains(self, pat, regex: bool = True):
        if not regex:
            return self._map(lambda v: pat in v, True)
        rx = re.compile(pat)
        return self._map(lambda v: rx.search(v) is not None, True)

    def match(self, pat):
        rx = re.compile(pat)
        return self._map(lambda v: rx.match(v) is not None, True)


class _Dt:
    def __init__(self, s: Series):
        self.s = s

    @property
    def year(self):
        return self.s._new(self.s.values.astype("datetime64[Y]").astype(np.int64) + 1970)


# ------------------------------------------------------------------- Frame


def _broadcast(v, n: int) -> np.ndarray:
    if v is None:
        return np.full(n, None, dtype=object)
    if isinstance(v, str):
        return np.full(n, v, dtype=object)
    return np.full(n, v)


class Frame:
    """An ordered ``dict`` of equal-length columns (``np.ndarray`` or
    ``Lazy``)."""

    def __init__(self, data: Mapping | list | None = None):
        cols: dict = {}
        n = None
        if isinstance(data, list):  # records
            data = {k: [r[k] for r in data] for k in (data[0] if data else {})}
        data = dict(data or {})
        for k, v in data.items():
            if isinstance(v, Series):
                v = v.values
            if isinstance(v, (np.ndarray, Lazy)):
                n = len(v)
            elif isinstance(v, (list, tuple)):
                n = len(v)
        for k, v in data.items():
            if isinstance(v, Series):
                v = v.values
            if isinstance(v, (list, tuple)):
                v = _array(list(v))
            elif isinstance(v, np.ndarray) and v.dtype.kind == "U":
                v = v.astype(object)
            elif not isinstance(v, (np.ndarray, Lazy)):
                v = _broadcast(v, n or 0)
            cols[k] = v
        self._cols = cols

    # -- columns
    def _col(self, name) -> np.ndarray:
        v = self._cols[name]
        if isinstance(v, Lazy):
            v = self._cols[name] = v.resolve()
        return v

    @property
    def columns(self) -> list:
        return list(self._cols)

    @columns.setter
    def columns(self, names):
        self._cols = dict(zip(names, self._cols.values()))

    def __contains__(self, name):
        return name in self._cols

    def __len__(self):
        for v in self._cols.values():
            return len(v)
        return 0

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        cols = self.__dict__.get("_cols", {})
        if name in cols:
            return Series(self._col(name), name)
        raise AttributeError(name)

    def __getitem__(self, key):
        if not isinstance(key, (list, np.ndarray, Series)):
            return Series(self._col(key), key)
        if isinstance(key, list) and (not key or isinstance(key[0], str)):
            return Frame({c: self._cols[c] for c in key})
        mask = np.asarray(_values(key))
        if mask.dtype != bool:
            mask = mask.astype(bool)
        return self._take(np.flatnonzero(mask))

    def __setitem__(self, name, value):
        if isinstance(value, Series):
            value = value.values
        if not isinstance(value, np.ndarray):
            value = _broadcast(value, len(self)) if not isinstance(value, list) \
                else _array(value)
        elif value.dtype.kind == "U":
            value = value.astype(object)
        self._cols[name] = value

    def _take(self, idx: np.ndarray) -> "Frame":
        miss, memo = bool(len(idx)) and bool((idx < 0).any()), {}
        f = Frame()
        f._cols = {c: _take(v, idx, miss, memo) for c, v in self._cols.items()}
        return f

    # -- whole-frame helpers
    def copy(self):
        f = Frame()
        f._cols = dict(self._cols)
        return f

    def head(self, n: int = 5):
        return self._take(np.arange(min(n, len(self))))

    def reset_index(self, drop: bool = True):
        return self

    def rename(self, columns: Mapping):
        f = Frame()
        f._cols = {columns.get(c, c): v for c, v in self._cols.items()}
        return f

    def add_prefix(self, prefix: str):
        return self.rename({c: prefix + c for c in self._cols})

    def assign(self, **kw):
        f = self.copy()
        for k, v in kw.items():
            f[k] = v(f) if callable(v) else v
        return f

    def drop(self, columns):
        cols = [columns] if isinstance(columns, str) else columns
        f = Frame()
        f._cols = {c: v for c, v in self._cols.items() if c not in cols}
        return f

    def to_numpy(self):
        return np.column_stack([self._col(c) for c in self._cols])

    def itertuples(self, index: bool = False) -> list[tuple]:
        """The rows as tuples."""
        return list(zip(*(self._col(c).tolist() for c in self._cols)))

    def dropna(self, subset=None):
        cols = subset or self.columns
        keep = np.ones(len(self), bool)
        for c in cols:
            keep &= ~isnull(self._col(c))
        return self._take(np.flatnonzero(keep))

    def drop_duplicates(self):
        codes = _combine([factorize(self._col(c))[0] for c in self._cols], len(self))
        _, first = np.unique(codes, return_index=True)
        return self._take(np.sort(first))

    def sort_values(self, by, ascending=True, kind: str = "stable",
                    na_position: str = "last"):
        by = [by] if isinstance(by, str) else list(by)
        asc = [ascending] * len(by) if isinstance(ascending, bool) else list(ascending)
        keys = []
        for c, a in zip(by, asc):
            codes, uniq, null = factorize(self._col(c))
            if not a:
                codes = np.where(null, codes, len(uniq) - 1 - codes)
            if na_position == "first":
                codes = np.where(null, -1, codes)
            keys.append(codes)
        if not keys:
            return self
        return self._take(np.lexsort(keys[::-1]))

    def merge(self, right: "Frame", how: str = "inner", on=None, left_on=None,
              right_on=None, suffixes=("_x", "_y")):
        return _merge(self, right, how, on, left_on, right_on, suffixes)

    def groupby(self, by, as_index: bool = True, dropna: bool = True):
        return GroupBy(self, [by] if isinstance(by, str) else list(by), as_index, dropna)

    def __repr__(self):
        return f"Frame({len(self)} rows, {self.columns})"


DataFrame = Frame


def concat(frames: Iterable[Frame], ignore_index: bool = True) -> Frame:
    """Rows of ``frames`` in order; a column missing from a frame is NULL
    there (pandas' common dtypes)."""
    frames = list(frames)
    if frames and all(isinstance(f, Series) for f in frames):
        return Series(_concat_cols([f.values for f in frames], [len(f) for f in frames]))
    names: list = []
    for f in frames:
        names += [c for c in f.columns if c not in names]
    lens = [len(f) for f in frames]
    return Frame({c: _concat_cols([f._col(c) if c in f else None for f in frames], lens)
                  for c in names})


def _merge(left: Frame, right: Frame, how, on, left_on, right_on, suffixes):
    if how == "cross":
        nl, nr = len(left), len(right)
        li = np.repeat(np.arange(nl), nr)
        ri = np.tile(np.arange(nr), nl)
        return _joined(left, right, li, ri, [], suffixes, False)
    if on is not None:
        lk = rk = [on] if isinstance(on, str) else list(on)
    else:
        lk = [left_on] if isinstance(left_on, str) else list(left_on)
        rk = [right_on] if isinstance(right_on, str) else list(right_on)
    lc, rc = _joint_codes([left._col(c) for c in lk], [right._col(c) for c in rk])
    order = np.argsort(rc, kind="stable")
    k = int(max(lc.max(initial=-1), rc.max(initial=-1))) + 1
    rcount = np.bincount(rc, minlength=k)
    cnt = rcount[lc]
    lo = (np.cumsum(rcount) - rcount)[lc]
    reps = cnt if how == "inner" else np.maximum(cnt, 1)
    li = np.repeat(np.arange(len(left)), reps)
    offs = np.arange(len(li)) - np.repeat(np.cumsum(reps) - reps, reps)
    ri = (order[np.minimum(np.repeat(lo, reps) + offs, len(order) - 1)]
          if len(order) else np.zeros(len(li), np.int64))
    if how != "inner":
        ri = np.where(np.repeat(cnt > 0, reps), ri, -1)
    if how == "outer":
        ronly = np.flatnonzero(~np.isin(rc, lc))
        li = np.concatenate([li, np.full(len(ronly), -1)])
        ri = np.concatenate([ri, ronly])
        kc = np.empty(len(li), np.int64)
        kc[li >= 0], kc[li < 0] = lc[li[li >= 0]], rc[ri[li < 0]]
        srt = np.lexsort((ri, li, kc))
        li, ri = li[srt], ri[srt]
    same = [a for a, b in zip(lk, rk) if a == b]
    return _joined(left, right, li, ri, same, suffixes, how == "outer")


def _joined(left, right, li, ri, same, suffixes, coalesce):
    """The merged frame: left columns then right ones, a key column named
    alike on both sides once, other shared names suffixed."""
    lcols = left.columns
    rcols = [c for c in right.columns if c not in same]
    overlap = set(lcols) & set(rcols)
    out = {}
    lmiss, lmemo = bool(len(li)) and bool((li < 0).any()), {}
    rmiss, rmemo = bool(len(ri)) and bool((ri < 0).any()), {}
    for c in lcols:
        v = _take(left._cols[c], li, lmiss, lmemo)
        if coalesce and c in same:  # an outer join's key: either side's
            miss = li < 0
            both = _concat_cols([left._col(c)[li[~miss]], right._col(c)[ri[miss]]], [])
            v = np.empty_like(both)
            v[~miss], v[miss] = both[:(~miss).sum()], both[(~miss).sum():]
        out[c + suffixes[0] if c in overlap else c] = v
    for c in rcols:
        out[c + suffixes[1] if c in overlap else c] = _take(right._cols[c], ri, rmiss, rmemo)
    f = Frame()
    f._cols = out
    return f


# ----------------------------------------------------------------- groupby


def _rank(v: np.ndarray, codes: np.ndarray, ascending: bool) -> np.ndarray:
    """``rank(method="min")`` within each code; NaN ranks NaN."""
    v = v.astype(np.float64)
    null = np.isnan(v)
    key = v if ascending else -v
    order = np.lexsort((key, codes))
    sv, sc = key[order], codes[order]
    n = len(v)
    new_group = np.r_[True, sc[1:] != sc[:-1]] if n else np.zeros(0, bool)
    new_val = new_group | np.r_[True, sv[1:] != sv[:-1]] if n else new_group
    gstart = np.maximum.accumulate(np.where(new_group, np.arange(n), 0))
    vstart = np.maximum.accumulate(np.where(new_val, np.arange(n), 0))
    out = np.empty(n)
    out[order] = vstart - gstart + 1
    out[null] = NaN
    return out


class GroupBy:
    def __init__(self, frame: Frame, keys: list, as_index: bool, dropna: bool,
                 select=None):
        self.frame, self.keys, self.as_index, self.dropna = frame, keys, as_index, dropna
        self.select = select
        per = [factorize(frame._col(k)) for k in keys]
        null = np.zeros(len(frame), bool)
        for _, _, nl in per:
            null |= nl
        codes = _combine([c for c, _, _ in per], len(frame))
        if dropna and null.any():
            codes = np.where(null, -1, codes)
            codes[~null] = _dense(codes[~null])
        self.codes = codes
        self.ngroups = int(codes.max()) + 1 if len(codes) and codes.max() >= 0 else 0
        live = codes >= 0
        self.order = np.flatnonzero(live)[np.argsort(codes[live], kind="stable")]
        sc = codes[self.order]
        self.starts = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]]) if len(sc) else \
            np.zeros(0, np.int64)
        self.first = self.order[self.starts]

    def key_frame(self) -> Frame:
        out = {}
        for k in self.keys:
            v = self.frame._col(k)[self.first]
            if v.dtype == object and not _is_str_obj(v):
                v = v.astype(np.float64)
                if not np.isnan(v).any() and np.all(v == np.round(v)):
                    v = v.astype(np.int64)
            out[k] = v
        return Frame(out)

    def __getitem__(self, sel):
        g = copy.copy(self)
        g.select = sel
        return g

    def __getattr__(self, name):
        if name.startswith("_") or name not in self.frame:
            raise AttributeError(name)
        return self[name]

    # -- reductions: one value per group, in key order
    def _reduce(self, col: str, how: str, min_count: int = 0) -> np.ndarray:
        raw = self.frame._col(col)
        g = self.ngroups
        if how == "size":
            return np.bincount(self.codes[self.codes >= 0], minlength=g).astype(np.int64)
        if how == "nunique":
            vc, _, vnull = factorize(raw)
            ok = (self.codes >= 0) & ~vnull
            pairs = np.unique(np.stack([self.codes[ok], vc[ok]]), axis=1)
            return np.bincount(pairs[0], minlength=g).astype(np.int64)
        if how in ("min", "max"):
            vc, uniq, vnull = factorize(raw)
            ok = (self.codes >= 0) & ~vnull
            if how == "min":
                ext = np.full(g, len(uniq))
                np.minimum.at(ext, self.codes[ok], vc[ok])
            else:
                ext = np.full(g, -1)
                np.maximum.at(ext, self.codes[ok], vc[ok])
            rep = np.zeros(len(uniq) + 1, np.int64)  # a row holding each value
            rows = np.flatnonzero(ok)
            rep[vc[rows]] = rows
            have = (ext >= 0) & (ext < len(uniq))
            base = raw.astype(np.float64) if _numobj(raw) else raw
            return _take(base, np.where(have, rep[np.clip(ext, 0, len(uniq))], -1))
        v = _values(raw)
        if v.dtype.kind == "b":
            v = v.astype(np.int64)
        null = isnull(v)
        ok = (self.codes >= 0) & ~null
        cnt = np.bincount(self.codes[ok], minlength=g)
        if how == "count":
            return cnt.astype(np.int64)
        order = self.order[~null[self.order]]
        sc = self.codes[order]
        vals = v[order]
        if how in ("sum", "mean", "std"):
            tot = np.zeros(g, vals.dtype if vals.dtype.kind in "iu" else np.float64)
            if len(order):
                st = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
                tot[sc[st]] = np.add.reduceat(vals, st)
            if how == "sum":
                if min_count and (cnt < min_count).any():
                    tot = tot.astype(np.float64)
                    tot[cnt < min_count] = NaN
                return tot
            with np.errstate(all="ignore"):
                mean = tot / cnt
            if how == "mean":
                return mean
            dev = (vals - mean[sc]) ** 2
            ss = np.zeros(g)
            if len(order):
                ss[sc[st]] = np.add.reduceat(dev, st)
            with np.errstate(all="ignore"):
                out = np.sqrt(ss / (cnt - 1))
            out[cnt < 2] = NaN
            return out
        raise ValueError(f"unsupported aggregation {how}")

    def _cols(self):
        sel = self.select
        if sel is None:
            return [c for c in self.frame.columns if c not in self.keys]
        return [sel] if isinstance(sel, str) else list(sel)

    def _result(self, named: dict[str, np.ndarray]):
        if self.as_index and isinstance(self.select, str):
            (name, vals), = named.items()
            return Series(vals, name, self.key_frame())
        out = self.key_frame()
        for k, v in named.items():
            out[k] = v
        return out

    def _each(self, how, **kw):
        return self._result({c: self._reduce(c, how, **kw) for c in self._cols()})

    def sum(self, min_count: int = 0): return self._each("sum", min_count=min_count)
    def mean(self): return self._each("mean")
    def count(self): return self._each("count")
    def nunique(self): return self._each("nunique")
    def min(self): return self._each("min")
    def max(self): return self._each("max")
    def std(self): return self._each("std")

    def size(self):
        vals = self._reduce(self.frame.columns[0], "size") if self.frame.columns else \
            np.zeros(0, np.int64)
        if self.as_index:
            return Series(vals, None, self.key_frame())
        out = self.key_frame()
        out["size"] = vals
        return out

    def agg(self, **named):
        out = self.key_frame()
        for k, (col, how) in named.items():
            out[k] = self._reduce(col, how)
        return out

    def __iter__(self):
        """(key tuple, group frame) in key order."""
        kf = self.key_frame()
        keys = kf.itertuples()
        for i, key in enumerate(keys):
            end = self.starts[i + 1] if i + 1 < len(self.starts) else len(self.order)
            rows = np.sort(self.order[self.starts[i]:end])
            yield key, self.frame._take(rows)

    # -- per-row results, in the frame's row order
    def transform(self, how: str) -> Series:
        red = self._reduce(self.select, how)
        return Series(_take(np.asarray(red, np.float64) if how == "mean" else red,
                            self.codes), self.select)

    def rank(self, method: str = "min", ascending: bool = True) -> Series:
        v = _values(self.frame._col(self.select)).astype(np.float64)
        out = _rank(v, self.codes, ascending)
        out[self.codes < 0] = NaN
        return Series(out, self.select)

    def _segments(self, fn) -> Series:
        v = _values(self.frame._col(self.select)).astype(np.float64)
        out = np.full(len(v), NaN)
        bounds = list(self.starts) + [len(self.order)]
        for i in range(len(self.starts)):
            rows = self.order[bounds[i]:bounds[i + 1]]
            out[rows] = fn(v[rows])
        return Series(out, self.select)

    def shift(self, n: int = 1) -> Series:
        def sh(x):
            y = np.full(len(x), NaN)
            if n > 0:
                y[n:] = x[:-n]
            elif n < 0:
                y[:n] = x[-n:]
            return y
        return self._segments(sh)

    def cumsum(self) -> Series:
        def cs(x):
            y = np.nancumsum(x)
            y[np.isnan(x)] = NaN
            return y
        return self._segments(cs)

    def cummax(self) -> Series:
        def cm(x):
            y = np.fmax.accumulate(x)
            y[np.isnan(x)] = NaN
            return y
        return self._segments(cm)

    def ffill(self) -> Series:
        def ff(x):  # each NaN takes the last value before it (a leading NaN, x[0]'s)
            return x[np.maximum.accumulate(np.where(np.isnan(x), 0, np.arange(len(x))))]
        return self._segments(ff)


# -------------------------------------------------------------- the tables


class LazyTables(dict):
    """The oracle's input frames, each made on first use by ``load(table)``
    (a connector's ``table_logical``), whose columns decode on first use."""

    def __init__(self, load: Callable[[str], Frame]):
        super().__init__()
        self.load = load

    def __missing__(self, table):
        frame = self[table] = self.load(table)
        return frame
