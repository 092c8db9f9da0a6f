"""Columnar device batches — the unit of data flow between operators.

Counterpart of ``presto_tpu/batch.py``. A ``Batch`` is a fixed-capacity
struct-of-arrays of torch tensors: one ``Column`` (data + validity) per
field plus a per-batch ``live`` row mask. Filtering only ANDs the live
mask (a selection vector); strings are order-preserving dictionary codes.

Identity contract: a NULL-free scan column SHARES the batch's ``live``
tensor object as its validity. The Q1 kernel's eligibility check keys on
``col.valid is batch.live`` (``ops/cuda_q1.supported``), so every
constructor and every device move keeps that identity.
"""

from __future__ import annotations

import bisect
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.types import DataType, TypeKind, check_narrow_range


class Dictionary:
    """An ordered, host-resident string dictionary: codes are indices
    into the sorted values, so code order is string order."""

    __slots__ = ("values", "_index", "_bytes_mats")

    def __init__(self, values: Sequence[str]):
        vals = sorted(set(values))
        self.values = np.array(vals, dtype=object)
        self._index = {v: i for i, v in enumerate(vals)}
        #: cached decode tables by width, and ``max_bytes``
        self._bytes_mats: dict = {}

    def __len__(self) -> int:
        return len(self.values)

    def encode(self, strings) -> np.ndarray:
        idx = self._index
        return np.fromiter((idx[s] for s in strings), dtype=np.int32, count=len(strings))

    def code_of(self, s: str) -> int:
        """Exact code of ``s``; raises KeyError if absent."""
        return self._index[s]

    def lower_bound(self, s: str) -> int:
        """First code whose string is >= ``s`` (range predicates on codes)."""
        return bisect.bisect_left(self.values.tolist(), s)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.values[np.asarray(codes)]

    @property
    def max_bytes(self) -> int:
        """The longest value's encoded byte length."""
        m = self._bytes_mats.get("max_bytes")
        if m is None:
            m = max((len(v.encode()) for v in self.values.tolist()), default=0)
            self._bytes_mats["max_bytes"] = m
        return m

    def bytes_matrix(self, width: int) -> np.ndarray:
        """``[len, width]`` uint8 matrix of the values, zero-padded and
        cut at ``width`` bytes: the decode table behind ``dict_bytes``
        (cross-dictionary join keys compare by value). Cached per width."""
        m = self._bytes_mats.get(width)
        if m is None:
            m = np.zeros((len(self.values), width), np.uint8)
            for i, v in enumerate(self.values.tolist()):
                raw = v.encode()[:width]
                m[i, : len(raw)] = np.frombuffer(raw, np.uint8)
            self._bytes_mats[width] = m
        return m

    def __repr__(self) -> str:
        return f"Dictionary({len(self)} values)"


class Column:
    """One column: device data + validity mask + static type metadata.
    ``valid`` may be None (no mask: every row valid)."""

    __slots__ = ("data", "valid", "dtype", "dictionary")

    def __init__(self, data: torch.Tensor, valid: torch.Tensor | None,
                 dtype: DataType, dictionary: Dictionary | None = None):
        self.data = data
        self.valid = valid
        self.dtype = dtype
        self.dictionary = dictionary

    def __repr__(self) -> str:
        return f"Column({self.dtype}, cap={self.data.shape[0]})"


class Batch:
    """A fixed-capacity batch of rows: named columns + a live-row mask."""

    __slots__ = ("columns", "live")

    def __init__(self, columns: Mapping[str, Column], live: torch.Tensor):
        self.columns = dict(columns)
        self.live = live

    @property
    def capacity(self) -> int:
        return self.live.shape[0]

    @property
    def device(self) -> torch.device:
        return self.live.device

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns)

    def count(self) -> torch.Tensor:
        """Number of live rows (a device scalar)."""
        return torch.sum(self.live.to(torch.int64))

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __iter__(self) -> Iterator[str]:
        return iter(self.columns)

    # ---- structural ops -------------------------------------------------
    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.live)

    def with_live(self, live: torch.Tensor) -> "Batch":
        return Batch(self.columns, live)

    def rename(self, mapping: Mapping[str, str]) -> "Batch":
        return Batch({mapping.get(n, n): c for n, c in self.columns.items()}, self.live)

    def to(self, device) -> "Batch":
        """This batch on ``device``. ``live`` moves once, and every column
        whose validity WAS the live tensor gets the moved live tensor, so
        the shared-mask identity survives the move."""
        dev = torch.device(device)
        live = self.live.to(dev)
        cols = {}
        for name, c in self.columns.items():
            if c.valid is self.live:
                valid = live
            elif c.valid is None:
                valid = None
            else:
                valid = c.valid.to(dev)
            cols[name] = Column(c.data.to(dev), valid, c.dtype, c.dictionary)
        return Batch(cols, live)

    # ---- host conversion ------------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        arrays: Mapping[str, np.ndarray],
        types: Mapping[str, DataType],
        count: int | None = None,
        valids: Mapping[str, np.ndarray] | None = None,
        dictionaries: Mapping[str, Dictionary] | None = None,
        capacity: int | None = None,
        device="cuda",
    ) -> "Batch":
        """Build a device Batch from host arrays, padding to ``capacity``.

        Columns with no explicit NULL mask (and ``count == n``) SHARE the
        batch's live tensor as their validity. Narrowed physical types
        range-check their input here: a value outside the narrowed dtype
        fails loudly, never wraps.
        """
        dev = resolve_device(device)
        n = len(next(iter(arrays.values())))
        count = n if count is None else count
        cap = capacity or n
        if cap < n:
            raise ValueError(
                f"capacity {cap} < {n} input rows: batches never silently "
                "truncate; pick a larger capacity bucket"
            )
        live_np = np.zeros(cap, dtype=np.bool_)
        live_np[:count] = True
        live = torch.from_numpy(live_np).to(dev)
        cols = {}
        for name, arr in arrays.items():
            t = types[name]
            arr = np.asarray(arr)
            if t.kind is TypeKind.BYTES:
                padded = np.zeros((cap, t.width), dtype=np.uint8)
                padded[: arr.shape[0], : arr.shape[1]] = arr[:cap]
            else:
                check_narrow_range(name, t, arr)
                padded = np.zeros(cap, dtype=t.np_dtype)
                padded[:n] = arr.astype(t.np_dtype, copy=False)[:cap]
            if valids is not None and valids.get(name) is not None:
                v = np.zeros(cap, dtype=np.bool_)
                v[:n] = valids[name][:cap]
                v = torch.from_numpy(v).to(dev)
            elif count == n:
                v = live  # NULL-free column: share the live tensor object
            else:
                v = np.zeros(cap, dtype=np.bool_)
                v[:n] = True
                v = torch.from_numpy(v).to(dev)
            d = dictionaries.get(name) if dictionaries else None
            cols[name] = Column(torch.from_numpy(padded).to(dev), v, t, d)
        return cls(cols, live)

    @classmethod
    def from_arrays(
        cls,
        columns: Mapping[str, tuple[np.ndarray, np.ndarray | None]],
        live: np.ndarray,
        types: Mapping[str, DataType],
        dictionaries: Mapping[str, Dictionary] | None = None,
        device="cuda",
    ) -> "Batch":
        """Rebuild a batch from host copies of another batch's arrays.

        ``columns`` maps name -> (data, valid). ``valid`` is a bool array,
        None (the column has no mask), or the very ``live`` array object
        passed here — then the column's validity is the SAME tensor
        object as the new batch's ``live``, as it was in the source batch.
        Data keeps its dtype (narrow storage stays narrow)."""
        dev = resolve_device(device)
        live_t = torch.from_numpy(np.array(live, dtype=np.bool_)).to(dev)
        cols = {}
        for name, (data, valid) in columns.items():
            if valid is live:
                v = live_t
            elif valid is None:
                v = None
            else:
                v = torch.from_numpy(np.array(valid, dtype=np.bool_)).to(dev)
            d = dictionaries.get(name) if dictionaries else None
            cols[name] = Column(torch.from_numpy(np.array(data)).to(dev), v,
                                types[name], d)
        return cls(cols, live_t)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype}" for n, c in self.columns.items())
        return f"Batch(cap={self.capacity}, [{cols}])"


def decode_values(data: np.ndarray, valid: np.ndarray | None, dtype: DataType,
                  dictionary: Dictionary | None = None, logical: bool = True) -> np.ndarray:
    """Physical -> client value decode, the rules of the JAX package's
    ``batch.decode_values``: VARCHAR codes decode through the dictionary,
    BYTES strip their zero padding (latin-1), narrowed storage widens to
    the canonical dtype, and with ``logical`` DECIMAL becomes float64 /
    10^scale, DATE ``datetime64[D]`` and TIMESTAMP ``datetime64[us]``.
    NULL slots become None."""
    t = dtype
    if t.kind is TypeKind.VARCHAR and dictionary is not None:
        vals = dictionary.decode(data).astype(object)
    elif t.kind is TypeKind.BYTES:
        vals = np.array([bytes(row).rstrip(b"\x00").decode("latin1") for row in data],
                        dtype=object)
    elif t.kind is TypeKind.DECIMAL and logical:
        vals = data.astype(np.float64) / 10**t.scale
    elif t.kind is TypeKind.DATE and logical:
        vals = np.datetime64("1970-01-01", "D") + data.astype(np.int64)
    elif t.kind is TypeKind.TIMESTAMP and logical:
        vals = np.datetime64("1970-01-01T00:00:00", "us") + data.astype("timedelta64[us]")
    else:
        vals = data.astype(t.canonical_np_dtype) if t.is_narrowed else data
    if valid is not None and not valid.all():
        vals = np.asarray(vals, dtype=object)
        vals[~np.asarray(valid)] = None
    return vals


class QueryResult:
    """A query's rows on the host: column names plus numpy arrays.

    ``column(name)`` holds the exact values (strings decoded, DECIMAL
    still the scaled int64, DATE day numbers, NULLs None);
    ``logical(name)`` the client decode of ``decode_values``. No pandas:
    tests build frames from ``to_dict()`` themselves. ``approximate`` is
    True when the run probed a Bloom sketch (``approx_join``): the rows
    may then include false positives of a semi join."""

    def __init__(self, names, batches, approximate: bool = False):
        self.names = list(names)
        self.approximate = bool(approximate)
        self.types: dict[str, DataType] = {}
        self._cols: dict[str, tuple] = {}
        for name in self.names:
            parts = []
            for b in batches:
                live = b.live.cpu().numpy()
                c = b[name]
                valid = (np.ones(int(live.sum()), np.bool_) if c.valid is None
                         else c.valid.cpu().numpy()[live])
                parts.append((c.data.cpu().numpy()[live], valid, c.dtype, c.dictionary))
            self.types[name] = parts[0][2] if parts else None
            self._cols[name] = parts

    def __len__(self) -> int:
        first = self._cols[self.names[0]] if self.names else []
        return int(sum(len(p[1]) for p in first))

    def parts(self, name: str, logical: bool = True) -> list[np.ndarray]:
        """The column decoded batch by batch, each batch with its own type
        and dictionary (a UNION branch of NULL literals carries none), as
        the JAX package decodes each batch of its result."""
        return [decode_values(data, valid, t, d, logical=logical)
                for data, valid, t, d in self._cols[name]]

    def _decode(self, name: str, logical: bool) -> np.ndarray:
        if self.types[name] is None:
            return np.zeros(0, dtype=object)
        return np.concatenate(self.parts(name, logical))

    def column(self, name: str) -> np.ndarray:
        return self._decode(name, logical=False)

    def logical(self, name: str) -> np.ndarray:
        return self._decode(name, logical=True)

    def to_dict(self, logical: bool = True) -> dict[str, np.ndarray]:
        return {n: self._decode(n, logical) for n in self.names}

    def __repr__(self) -> str:
        return f"QueryResult({len(self)} rows, {self.names})"
