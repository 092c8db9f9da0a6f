"""Catalog: table resolution + metadata for analysis and planning.

Counterpart of ``presto_tpu/plan/catalog.py`` without the DDL versioning
and invalidation listeners (the port has no writable catalog yet): it
resolves tables across connectors and serves their unique keys,
functional dependencies and column statistics.
"""

from __future__ import annotations

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


class Catalog:
    def __init__(self, connectors: Mapping[str, object], default: str = "tpch"):
        self.connectors = dict(connectors)
        self.default = default
        self._meta_cache: dict[str, TableMeta] = {}

    def connector(self, name: str):
        return self.connectors[name]

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
