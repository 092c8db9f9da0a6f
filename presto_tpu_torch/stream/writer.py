"""Micro-batch ingestion over the memory connector's append path.

Counterpart of ``presto_tpu/stream/writer.py``. ``StreamWriter.append(
table, micro_batch)`` is the ingest API: O(batch) encode and concatenate
on the connector (``connectors/memory.py``), exact incremental stats
merge, one version-epoch bump, and scoped cache invalidation through the
connector's DDL listeners: appending to table A never evicts cached
results that only touch table B. A micro-batch is the columns the port's
connector takes (name -> numpy array), where the JAX package takes a
pandas DataFrame. The returned :class:`AppendResult` carries the
post-append epoch, the value continuous-query freshness is measured
against.
"""

from __future__ import annotations

from dataclasses import dataclass

from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.metrics import REGISTRY


@dataclass(frozen=True)
class AppendResult:
    """One micro-batch landing: ``epoch`` is the table's version AFTER
    this append — any subscription refresh fired at or after this
    epoch reflects these rows."""

    table: str
    rows: int
    total_rows: int
    epoch: int
    created: bool


class StreamWriter:
    """Session-scoped ingest handle for one writable connector.

    Appends to a missing table create it (first micro-batch defines
    the schema; counted as ``stream.tables_created``). Appends within
    one writer serialize on the connector's write lock; run one writer
    per table for ordered epochs."""

    def __init__(self, session, connector: str = "memory"):
        self._session = session
        try:
            self._conn = session.catalog.connector(connector)
        except KeyError:
            raise UserError(f"unknown catalog: {connector}") from None
        for req in ("append", "create_table", "table_epoch", "row_count"):
            if not hasattr(self._conn, req):
                raise UserError(
                    f"catalog {connector!r} is not streamable: connector "
                    f"lacks {req}()"
                )

    def append(self, table: str, micro_batch) -> AppendResult:
        """Land one micro-batch (a mapping of column name -> numpy array,
        or a ``QueryResult``); returns the :class:`AppendResult` with the
        post-append epoch."""
        with REGISTRY.histogram("stream.append_s").time():
            created = table not in self._conn.tables()
            if created:
                rows = self._conn.create_table(table, micro_batch)
                REGISTRY.counter("stream.tables_created").add()
            else:
                rows = self._conn.append(table, micro_batch)
        REGISTRY.counter("stream.appends").add()
        REGISTRY.counter("stream.rows").add(rows)
        return AppendResult(
            table=table,
            rows=rows,
            total_rows=self._conn.row_count(table),
            epoch=self._conn.table_epoch(table),
            created=created,
        )

    def epoch(self, table: str) -> int:
        """The table's current version epoch (0 = never written)."""
        return self._conn.table_epoch(table)
