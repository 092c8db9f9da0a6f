"""Catalog: table resolution + metadata for analysis and planning.

Counterpart of ``presto_tpu/plan/catalog.py``: it resolves tables
across connectors and serves their unique keys, functional dependencies
and column statistics, and keeps each table's DDL version. Every write
to the memory connector (CTAS, INSERT, DROP) routes through
``invalidate``, which drops the cached ``TableMeta``, bumps the version
and notifies the listeners.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Mapping

from presto_tpu_torch.types import DataType

#: primary/unique keys per TPC-H table — drives the FK->PK unique-probe
#: fast path and the functional-dependency passengers
TPCH_UNIQUE_KEYS: dict[str, tuple[tuple[str, ...], ...]] = {
    "customer": (("c_custkey",), ("c_name",)),  # c_name = 'Customer#<key>'
    "orders": (("o_orderkey",),),
    "lineitem": (("l_orderkey", "l_linenumber"),),
    "part": (("p_partkey",),),
    "supplier": (("s_suppkey",), ("s_name",)),  # s_name = 'Supplier#<key>'
    "partsupp": (("ps_partkey", "ps_suppkey"),),
    "nation": (("n_nationkey",), ("n_name",)),
    "region": (("r_regionkey",), ("r_name",)),
}


@dataclass(frozen=True)
class TableMeta:
    connector_name: str
    table: str
    schema: Mapping[str, DataType]
    row_count: int
    unique_keys: tuple[tuple[str, ...], ...]
    #: declared functional dependencies: determined column -> its
    #: determinant columns
    func_deps: Mapping[str, tuple[str, ...]] = None


_catalog_seq = itertools.count(1)


class Catalog:
    def __init__(self, connectors: Mapping[str, object], default: str = "tpch"):
        self.connectors = dict(connectors)
        self.default = default
        self._meta_cache: dict[str, TableMeta] = {}
        #: table -> DDL version, bumped by ``invalidate``
        self._versions: dict[str, int] = {}
        #: callbacks fired with the table name on each ``invalidate``
        self._invalidation_listeners: list = []
        self._token = f"cat{next(_catalog_seq)}"

    def connector(self, name: str):
        return self.connectors[name]

    def cache_token(self) -> str:
        """Stable identity of this catalog instance (never reused within
        a process, unlike ``id()``)."""
        return self._token

    def version(self, table: str) -> int:
        """Monotonic DDL version of a table (0 until its first DDL)."""
        return self._versions.get(table, 0)

    def add_invalidation_listener(self, cb) -> None:
        self._invalidation_listeners.append(cb)

    def invalidate(self, table: str) -> None:
        """After DDL changed ``table``: drop its cached metadata (a CTAS
        after a DROP of the same name must not resolve the old schema),
        bump its version and notify the listeners."""
        self._meta_cache.pop(table, None)
        self._versions[table] = self._versions.get(table, 0) + 1
        for cb in self._invalidation_listeners:
            cb(table)

    def resolve(self, table: str) -> TableMeta:
        meta = self._meta_cache.get(table)
        if meta is None:
            meta = self._meta_cache[table] = self._resolve_uncached(table)
        return meta

    def _resolve_uncached(self, table: str) -> TableMeta:
        for cname, conn in self.connectors.items():
            if table in conn.tables():
                uk = getattr(conn, "unique_keys", lambda t: ())(table)
                if not uk and table in TPCH_UNIQUE_KEYS and cname == "tpch":
                    uk = TPCH_UNIQUE_KEYS[table]
                fd = getattr(conn, "func_deps", lambda t: {})(table)
                return TableMeta(cname, table, dict(conn.schema(table)),
                                 conn.row_count(table), tuple(uk), dict(fd))
        raise KeyError(f"table not found in any catalog: {table}")

    def unique_keys(self, table: str) -> tuple[tuple[str, ...], ...]:
        try:
            return self.resolve(table).unique_keys
        except KeyError:
            return ()

    def func_deps(self, table: str) -> Mapping[str, tuple[str, ...]]:
        try:
            return self.resolve(table).func_deps or {}
        except KeyError:
            return {}

    def stats(self, connector_name: str, table: str, column: str):
        conn = self.connectors[connector_name]
        if hasattr(conn, "stats"):
            return conn.stats(table, column)
        return None
