"""The memory connector: writable in-process tables.

Counterpart of ``presto_tpu/connectors/memory.py``: the CREATE TABLE AS
target, with INSERT INTO appends and DROP TABLE. Storage is host numpy
arrays plus ``<col>$valid`` NULL masks, the shape every scan source
produces, so a created table round-trips through the ordinary scan path;
``scan`` copies a split to ``device``. Writes are all-or-nothing per
statement: an entry is built complete and published with one dict swap.

A stored column carries exact stats (min, max, distinct count and an
honest ``null_fraction`` over INTEGER, BIGINT and DATE columns), so
written tables narrow and reach the fused leaf route and the join probes
as the generator tables do. INSERT encodes the new rows as the table's
existing column types and merges the stats through the kept unique
values, bit-identical to a recompute over all rows; new strings rebuild
the column's dictionary, counted as ``stream.dict_rebuilds``. Every
write bumps the table's epoch and notifies the DDL listeners (the
session wires ``Catalog.invalidate`` there).

Column types follow the JAX package, which infers them from the pandas
frame of the statement's result: that frame is built one result batch
at a time and concatenated, and pandas' inference decides each column's
type (``_frame_column`` reproduces it over the batches' decoded numpy
arrays, with no pandas). So DECIMAL is stored as DOUBLE, INTEGER with
NULLs as BIGINT, BOOLEAN with NULLs as the VARCHAR 'True' / 'False', and
an all-NULL or empty column as VARCHAR with the dictionary ``[""]``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Mapping, Sequence

import numpy as np

from presto_tpu_torch.batch import Batch, Dictionary, QueryResult, decode_values
from presto_tpu_torch.connectors.logical import logical_frame
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.spi import (
    ColumnStats,
    Split,
    batch_capacity,
    narrowed_schema,
    split_valids,
)
from presto_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    DataType,
    TypeKind,
    common_super_type,
    varchar,
)

_EPOCH = np.datetime64("1970-01-01", "D")


# ---------------------------------------------------------------------------
# a result's columns as pandas would type them
# ---------------------------------------------------------------------------


def _is_null(v) -> bool:
    """pandas' ``isna`` on one object value."""
    if v is None:
        return True
    if isinstance(v, (float, np.floating)):
        return bool(np.isnan(v))
    if isinstance(v, np.datetime64):
        return bool(np.isnat(v))
    return False


def _part_kind(a: np.ndarray) -> str:
    """The dtype family pandas gives one batch's column: ``b`` bool, ``i``
    integer, ``f`` float, ``M`` datetime (an object array of datetimes
    and NULLs is inferred as datetime) or ``O`` object (strings too)."""
    k = a.dtype.kind
    if k == "u":
        return "i"
    if k in "bifM":
        return k
    if k == "O":
        nz = [v for v in a if not _is_null(v)]
        if nz and all(isinstance(v, np.datetime64) for v in nz):
            return "M"
    return "O"


def _timestamp_str(v: np.datetime64) -> str:
    """``str`` of the pandas Timestamp a datetime becomes in an object
    column."""
    return str(v.astype("datetime64[s]")).replace("T", " ")


def _frame_column(parts: Sequence[np.ndarray]):
    """(kind, values, null mask) of the column pandas builds from the
    per-batch arrays ``parts``: one frame per batch, concatenated."""
    if not parts:
        return "O", np.zeros(0, dtype=object), np.zeros(0, dtype=np.bool_)
    kinds = [_part_kind(p) for p in parts]
    vals = []
    for p, k in zip(parts, kinds):
        if k == "M" and p.dtype.kind == "O":
            p = np.array([np.datetime64("NaT") if _is_null(v) else v for v in p],
                         dtype="datetime64[us]")
        vals.append(p)
    if len(set(kinds)) == 1:
        kind = kinds[0]
    elif set(kinds) <= {"i", "f"}:
        kind = "f"
    else:
        kind = "O"
    if kind == "O":
        out = np.empty(sum(len(p) for p in vals), dtype=object)
        i = 0
        for p, k in zip(vals, kinds):
            items = [None if np.isnat(v) else _timestamp_str(v) for v in p] if k == "M" \
                else list(p)
            out[i:i + len(items)] = items
            i += len(items)
        null = np.array([_is_null(v) for v in out], dtype=np.bool_)
        return kind, out, null
    if kind == "M":
        out = np.concatenate([p.astype("datetime64[us]") for p in vals])
        return kind, out, np.isnat(out)
    out = np.concatenate(vals) if len(vals) > 1 else vals[0]
    null = np.isnan(out) if kind == "f" else np.zeros(len(out), dtype=np.bool_)
    return kind, out, null


def _strings(values: np.ndarray, valid: np.ndarray) -> list:
    """``fillna("").astype(str)``."""
    return [str(v) if ok else "" for v, ok in zip(values, valid)]


def _days(kind: str, values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """DATE day numbers of a datetime column, 0 in NULL slots."""
    if kind != "M":
        values = np.array([np.datetime64("NaT") if not ok else v
                           for v, ok in zip(values, valid)], dtype="datetime64[us]")
    days = (values.astype("datetime64[D]") - _EPOCH).astype(np.int32)
    return np.where(valid, days, 0).astype(np.int32)


def _infer_column(parts) -> tuple[DataType, np.ndarray, np.ndarray | None, Dictionary | None]:
    """A result column (per-batch arrays) -> (dtype, physical array, valid
    mask or None, dictionary or None), the JAX package's inference."""
    kind, values, null = _frame_column(parts)
    valid = ~null
    has_null = bool(null.any())
    mask = valid if has_null else None
    if kind == "O":
        nz = values[valid]
        if len(nz) and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
                           for v in nz):
            data = np.array([int(v) if ok else 0 for v, ok in zip(values, valid)],
                            dtype=np.int64)
            return BIGINT, data, mask, None
        if len(nz) and all(isinstance(v, (int, float, np.integer, np.floating))
                           and not isinstance(v, bool) for v in nz):
            data = np.array([float(v) if ok else 0.0 for v, ok in zip(values, valid)],
                            dtype=np.float64)
            return DOUBLE, data, mask, None
    if kind == "b":
        return BOOLEAN, values.astype(np.bool_), mask, None
    if kind == "i":
        t = INTEGER if values.dtype.itemsize <= 4 else BIGINT
        return t, values.astype(t.np_dtype), mask, None
    if kind == "f":
        # integral floats WITH NULLs came from a nullable int column;
        # a NULL-free float column stays DOUBLE
        nz = values[valid]
        if has_null and len(nz) and (nz == nz.astype(np.int64)).all():
            return BIGINT, np.where(valid, values, 0).astype(np.int64), valid, None
        return DOUBLE, np.where(valid, values, 0.0).astype(DOUBLE.np_dtype), mask, None
    if kind == "M":
        return DATE, _days(kind, values, valid), mask, None
    # strings: dictionary-encode (ordered codes, the engine's VARCHAR)
    strs = _strings(values, valid)
    d = Dictionary(sorted({s for s, ok in zip(strs, valid) if ok}) or [""])
    codes = d.encode([s if ok else d.values[0] for s, ok in zip(strs, valid)])
    return varchar(), codes.astype(np.int32), mask, d


def _encode_as(told: DataType, parts, d: Dictionary | None):
    """A result column encoded as an existing column type: (data, valid,
    dictionary or None when unchanged)."""
    kind, values, null = _frame_column(parts)
    valid = ~null
    if told.kind in (TypeKind.VARCHAR, TypeKind.BYTES):
        strs = _strings(values, valid)
        new = {s for s, ok in zip(strs, valid) if ok}
        rebuilt = None
        if not new <= set(d.values.tolist()):
            rebuilt = d = Dictionary(list(d.values) + sorted(new))
        data = d.encode([s if ok else d.values[0] for s, ok in zip(strs, valid)])
        return data.astype(np.int32), valid, rebuilt
    if told.kind is TypeKind.DATE:
        return _days(kind, values, valid), valid, None
    fill = {TypeKind.BOOLEAN: False, TypeKind.DOUBLE: 0.0}.get(told.kind, 0)
    if told.kind in (TypeKind.BOOLEAN, TypeKind.DOUBLE, TypeKind.INTEGER, TypeKind.BIGINT):
        if kind == "O":
            values = np.array([v if ok else fill for v, ok in zip(values, valid)])
        elif not valid.all():
            values = np.where(valid, values, fill)
        return values.astype(told.np_dtype), valid, None
    # _infer_column never stores such a kind, and _check_types admits
    # only batches coercible into the stored kinds
    raise UserError(f"append unsupported for a column of type {told.kind.value}")


class _Rows:
    """The columns of a statement's result (``QueryResult``: per-batch
    decoded arrays) or of a mapping name -> one array."""

    def __init__(self, data):
        if isinstance(data, QueryResult):
            self.names = list(data.names)
            self._parts = {n: data.parts(n) for n in self.names}
            self.rows = len(data)
        else:
            self.names = list(data)
            self._parts = {n: [np.asarray(v)] for n, v in data.items()}
            self.rows = len(self._parts[self.names[0]][0]) if self.names else 0

    def parts(self, name: str) -> list:
        return self._parts[name]


def _stats_of(data: np.ndarray, valid: np.ndarray | None, n: int):
    """(ColumnStats, sorted unique values, valid count) of an INTEGER,
    BIGINT or DATE column: exact min/max over non-NULL values and an
    honest null fraction (a stored mask means the column HAS NULLs)."""
    vals = data if valid is None else data[valid]
    u = np.unique(vals)
    nf = 0.0 if valid is None or not n else float(1.0 - len(vals) / n)
    st = (ColumnStats(float(len(u)), int(vals.min()), int(vals.max()), null_fraction=nf)
          if len(vals) else ColumnStats(0.0, null_fraction=nf))
    return st, u, int(len(vals))


_STATS_KINDS = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DATE)


class MemoryConnector:
    name = "memory"

    DEFAULT_UNITS_PER_SPLIT = 1 << 17

    def __init__(self, units_per_split: int | None = None, device="cuda"):
        self.units_per_split = units_per_split or self.DEFAULT_UNITS_PER_SPLIT
        self.device = resolve_device(device)
        self._tables: dict[str, dict] = {}
        #: per-table monotone write epochs, never reset (they survive a
        #: drop and re-create)
        self._epochs: dict[str, int] = {}
        #: serializes writers; readers see one entry or the next
        self._write_lock = threading.Lock()
        #: fired with the table name on every write (CTAS, INSERT, DROP)
        self._ddl_listeners: list = []

    def add_ddl_listener(self, cb) -> None:
        """Bound methods are held weakly (a connector shared across
        sessions must not pin dead sessions' catalogs); anything else
        strongly."""
        if hasattr(cb, "__self__"):
            self._ddl_listeners.append(weakref.WeakMethod(cb))
        else:
            self._ddl_listeners.append(lambda _cb=cb: _cb)

    def _notify_ddl(self, table: str) -> None:
        live = []
        for ref in self._ddl_listeners:
            cb = ref()
            if cb is not None:
                live.append(ref)
                cb(table)
        self._ddl_listeners = live

    # ---- write path -----------------------------------------------------
    def create_table(self, table: str, data) -> int:
        """CTAS target: store a result (``QueryResult``, or a mapping of
        column name -> array) as a table; returns its row count."""
        rows = _Rows(data)
        entry = self._built_entry(rows)
        with self._write_lock:
            self._tables[table] = entry
            self._epochs[table] = self._epochs.get(table, 0) + 1
        self._notify_ddl(table)
        return rows.rows

    def insert(self, table: str, data) -> int:
        """INSERT INTO: append rows (atomic per statement)."""
        return self.append(table, data)

    def append(self, table: str, data) -> int:
        """Append rows encoded as the table's existing column types, with
        the stats merged exactly. A zero-row append is a no-op (no epoch
        bump, no invalidation)."""
        if table not in self._tables:
            raise KeyError(f"table not found: {table}")
        rows = _Rows(data)
        types = self._tables[table]["types"]
        if rows.names != list(types):
            raise UserError(f"insert schema {rows.names} != table {list(types)}")
        if not rows.rows:
            return 0
        self._check_types(table, rows)
        with self._write_lock:
            self._tables[table] = self._appended_entry(self._tables[table], rows)
            self._epochs[table] = self._epochs.get(table, 0) + 1
        self._notify_ddl(table)
        return rows.rows

    def _check_types(self, table: str, rows: _Rows) -> None:
        """Inserted values must be coercible INTO the column's existing
        type (common_super_type(new, old) == old)."""
        existing = self._tables[table]["types"]
        for c in rows.names:
            t_new = _infer_column(rows.parts(c))[0]
            t_old = existing[c]
            if t_new.kind is t_old.kind:
                continue
            if {t_new.kind, t_old.kind} <= {TypeKind.VARCHAR, TypeKind.BYTES}:
                continue
            try:
                widened = common_super_type(t_new, t_old)
            except TypeError:
                widened = None
            if widened is None or widened.kind is not t_old.kind:
                raise UserError(f"insert type mismatch for {c!r}: {t_new.kind.value} "
                                f"into {t_old.kind.value}")

    def drop_table(self, table: str) -> None:
        with self._write_lock:
            del self._tables[table]
            self._epochs[table] = self._epochs.get(table, 0) + 1
        self._notify_ddl(table)

    def _built_entry(self, rows: _Rows) -> dict:
        """Full encode of a result into a table entry (the CTAS path)."""
        arrays: dict[str, np.ndarray] = {}
        types: dict[str, DataType] = {}
        dicts: dict[str, Dictionary] = {}
        stats: dict[str, ColumnStats] = {}
        uniques: dict[str, np.ndarray] = {}
        valid_counts: dict[str, int] = {}
        for c in rows.names:
            t, data, valid, d = _infer_column(rows.parts(c))
            types[c] = t
            arrays[c] = data
            if valid is not None:
                arrays[c + "$valid"] = valid
            if d is not None:
                dicts[c] = d
            if t.kind in _STATS_KINDS:
                stats[c], uniques[c], valid_counts[c] = _stats_of(data, valid, len(data))
        return {"arrays": arrays, "types": types, "dicts": dicts, "rows": rows.rows,
                "stats": stats, "uniques": uniques, "valid_counts": valid_counts}

    def _appended_entry(self, t: dict, rows: _Rows) -> dict:
        """Entry for ``t``'s rows plus ``rows``, each new column encoded as
        the table's existing type and the stats merged through the kept
        unique values and valid counts (bit-identical to a recompute)."""
        n_old = t["rows"]
        total = n_old + rows.rows
        arrays = dict(t["arrays"])
        types = dict(t["types"])
        dicts = dict(t["dicts"])
        stats = dict(t["stats"])
        uniques = dict(t["uniques"])
        valid_counts = dict(t["valid_counts"])
        for c, told in types.items():
            data, bvalid, rebuilt = _encode_as(told, rows.parts(c), dicts.get(c))
            if rebuilt is not None:
                # codes are ordered: remap the old rows through the merge
                remap = rebuilt.encode(list(dicts[c].values)).astype(np.int32)
                arrays[c] = remap[arrays[c]]
                dicts[c] = rebuilt
                REGISTRY.counter("stream.dict_rebuilds").add()
            old_valid = arrays.get(c + "$valid")
            if not bvalid.all() or old_valid is not None:
                ov = old_valid if old_valid is not None else np.ones(n_old, dtype=np.bool_)
                arrays[c + "$valid"] = np.concatenate([ov, bvalid])
            arrays[c] = np.concatenate([arrays[c], data])
            if told.kind in _STATS_KINDS:
                bvals = data[bvalid]
                u = uniques[c]
                if len(bvals):
                    u = uniques[c] = np.union1d(u, np.unique(bvals))
                vc = valid_counts[c] = valid_counts[c] + int(len(bvals))
                nf = 0.0 if (c + "$valid") not in arrays or not total else float(1.0 - vc / total)
                stats[c] = (ColumnStats(float(len(u)), int(u[0]), int(u[-1]), null_fraction=nf)
                            if len(u) else ColumnStats(0.0, null_fraction=nf))
        return {"arrays": arrays, "types": types, "dicts": dicts, "rows": total,
                "stats": stats, "uniques": uniques, "valid_counts": valid_counts}

    # ---- version epochs -------------------------------------------------
    def table_epoch(self, table: str) -> int:
        """Monotone write-version of ``table`` (0 = never written)."""
        return self._epochs.get(table, 0)

    def epochs(self) -> dict[str, int]:
        """Snapshot of every table's version epoch."""
        return dict(self._epochs)

    # ---- metadata -------------------------------------------------------
    def tables(self) -> Sequence[str]:
        return list(self._tables)

    def schema(self, table: str) -> Mapping[str, DataType]:
        return self._tables[table]["types"]

    def dictionaries(self, table: str) -> Mapping[str, Dictionary]:
        return self._tables[table]["dicts"]

    def row_count(self, table: str) -> int:
        return self._tables[table]["rows"]

    def unique_keys(self, table: str):
        return ()

    def func_deps(self, table: str):
        return {}

    def stats(self, table: str, column: str):
        return self._tables[table].get("stats", {}).get(column)

    def physical_schema(self, table: str, columns: Sequence[str] | None = None) -> dict:
        t = self._tables[table]
        cols = list(columns) if columns is not None else list(t["types"])
        return narrowed_schema({c: t["types"][c] for c in cols},
                               lambda c: self.stats(table, c), t["dicts"])

    # ---- read path ------------------------------------------------------
    def splits(self, table: str, target_splits: int = 0) -> Sequence[Split]:
        """Contiguous row ranges; a table always has at least one split."""
        rows = self._tables[table]["rows"]
        per = self.units_per_split
        if target_splits:
            per = max(1, -(-rows // target_splits))
        out = []
        for chunk, lo in enumerate(range(0, max(rows, 1), per)):
            hi = min(lo + per, rows)
            out.append(Split(table, chunk, lo, hi, hi - lo))
        return out or [Split(table, 0, 0, 0, 0)]

    def scan_numpy(self, split: Split, columns: Sequence[str] | None = None
                   ) -> Mapping[str, np.ndarray]:
        t = self._tables[split.table]
        keep = list(t["types"]) if columns is None else list(columns)
        out = {}
        for c in keep:
            out[c] = t["arrays"][c][split.lo:split.hi]
            v = t["arrays"].get(c + "$valid")
            if v is not None:
                out[c + "$valid"] = v[split.lo:split.hi]
        return out

    def scan(self, split: Split, columns: Sequence[str] | None = None,
             capacity: int | None = None) -> Batch:
        t = self._tables[split.table]
        arrays, valids = split_valids(self.scan_numpy(split, columns))
        n = split.hi - split.lo
        cap = capacity or batch_capacity(max(n, 1))
        types = self.physical_schema(split.table, list(arrays))
        dicts = {c: d for c, d in t["dicts"].items() if c in arrays}
        return Batch.from_numpy(arrays, types, capacity=cap, dictionaries=dicts,
                                valids=valids, device=self.device)

    def table_numpy(self, table: str, columns: Sequence[str] | None = None
                    ) -> dict[str, np.ndarray]:
        """Decoded logical values per column (NULLs None), the oracle's
        view of a table."""
        t = self._tables[table]
        cols = list(t["types"]) if columns is None else list(columns)
        return {c: decode_values(t["arrays"][c], t["arrays"].get(c + "$valid"),
                                 t["types"][c], t["dicts"].get(c)) for c in cols}

    def table_logical(self, table: str, columns: Sequence[str] | None = None):
        """The oracle's input frame, the counterpart of the JAX package's
        ``table_pandas``: each column decoded by ``decode_values`` on first
        use."""
        t = self._tables[table]
        arrays, valids = split_valids({
            c: v for c, v in t["arrays"].items()
            if columns is None or c in columns
            or (c.endswith("$valid") and c[:-6] in columns)
        })
        return logical_frame(arrays, valids, t["types"], t["dicts"])
