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

from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.types import DataType, TypeKind, check_narrow_range


class Dictionary:
    """An ordered, host-resident string dictionary: codes are indices
    into the sorted values, so code order is string order."""

    __slots__ = ("values", "_index")

    def __init__(self, values: Sequence[str]):
        vals = sorted(set(values))
        self.values = np.array(vals, dtype=object)
        self._index = {v: i for i, v in enumerate(vals)}

    def __len__(self) -> int:
        return len(self.values)

    def encode(self, strings) -> np.ndarray:
        idx = self._index
        return np.fromiter((idx[s] for s in strings), dtype=np.int32, count=len(strings))

    def code_of(self, s: str) -> int:
        """Exact code of ``s``; raises KeyError if absent."""
        return self._index[s]

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

