"""Connector SPI — the engine/connector seam.

Counterpart of ``presto_tpu/spi.py``: a split is a deterministic
key-range descriptor; a connector produces host-columnar chunks that the
engine pads into fixed-capacity device Batches. ``narrowed_schema``
reads the same ``PRESTO_TPU_NARROW`` switch as the JAX package, so both
pick the same physical schema.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Mapping, Protocol, Sequence

import numpy as np

from presto_tpu_torch.batch import Batch, Dictionary
from presto_tpu_torch.types import DataType, TypeKind, narrow_physical


@dataclass(frozen=True)
class Split:
    """A deterministic unit of scan work (a key range of a table)."""

    table: str
    chunk: int
    lo: int
    hi: int
    row_hint: int  # expected output rows (>= actual is fine)


class Connector(Protocol):
    name: str

    def tables(self) -> Sequence[str]: ...

    def schema(self, table: str) -> Mapping[str, DataType]: ...

    def dictionaries(self, table: str) -> Mapping[str, Dictionary]: ...

    def splits(self, table: str, target_splits: int) -> Sequence[Split]: ...

    def scan_numpy(
        self, split: Split, columns: Sequence[str] | None = None
    ) -> Mapping[str, np.ndarray]: ...

    def scan(
        self, split: Split, columns: Sequence[str] | None = None, capacity: int | None = None
    ) -> Batch: ...

    def row_count(self, table: str) -> int: ...



def split_valids(arrays: Mapping[str, np.ndarray]):
    """Separate ``<col>$valid`` NULL-mask companions from data columns.

    Connectors whose sources carry NULLs (the TPC-DS fact FKs) return
    masks under this naming convention; the engine splits them here
    before building device Batches.
    """
    data = {c: v for c, v in arrays.items() if not c.endswith("$valid")}
    valids = {
        c[: -len("$valid")]: v for c, v in arrays.items() if c.endswith("$valid")
    }
    return data, valids

@dataclass(frozen=True)
class ColumnStats:
    """The connector-statistics shape the engine consumes (duck-typed:
    the TPC-H schema declares its own equivalent). min/max are LOGICAL
    values — decimal units, day numbers for DATE."""

    ndv: float
    min_value: float | None = None
    max_value: float | None = None
    null_fraction: float = 0.0


def narrow_enabled() -> bool:
    """Stats-driven narrow physical storage. Default on;
    ``PRESTO_TPU_NARROW=0`` disables it (the JAX package reads the same
    switch)."""
    v = os.environ.get("PRESTO_TPU_NARROW")
    if v is not None:
        return v.strip().lower() not in ("0", "false", "off", "no")
    return True


def stats_physical_interval(stats, dtype: DataType):
    """(lo, hi) over the PHYSICAL representation from connector stats
    (min/max are LOGICAL values), or None when unbounded."""
    if stats is None or stats.min_value is None or stats.max_value is None:
        return None
    if dtype.kind is TypeKind.DECIMAL:
        f = 10**dtype.scale
        return (math.floor(stats.min_value * f), math.ceil(stats.max_value * f))
    if dtype.kind in (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DATE,
                      TypeKind.TIMESTAMP):
        return (math.floor(stats.min_value), math.ceil(stats.max_value))
    return None


def narrowed_schema(
    types: Mapping[str, DataType],
    stats_fn: Callable[[str], object],
    dictionaries: Mapping[str, Dictionary] | None = None,
) -> dict[str, DataType]:
    """Per-column physical types for a scan: each column narrowed to the
    smallest signed-int storage its declared bounds permit. VARCHAR
    narrows from its dictionary's code domain; numeric kinds from
    ``stats_fn(col)``."""
    if not narrow_enabled():
        return dict(types)
    out = {}
    for name, t in types.items():
        d = dictionaries.get(name) if dictionaries else None
        if t.kind is TypeKind.VARCHAR and d is not None:
            out[name] = narrow_physical(t, 0, max(len(d) - 1, 0))
            continue
        iv = stats_physical_interval(stats_fn(name), t)
        out[name] = t if iv is None else narrow_physical(t, iv[0], iv[1])
    return out


def batch_capacity(n: int, minimum: int = 1024) -> int:
    """Round a row count up to a power-of-two capacity bucket."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap
