"""Per-row byte widths of plan nodes (``node_row_bytes``, the one part of
``presto_tpu/runtime/memory.py`` that EXPLAIN ANALYZE's estimates read).
Memory pools, budgets and spill accounting are not ported."""

from __future__ import annotations

from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.types import DataType, TypeKind


def column_bytes(dtype: DataType) -> int:
    """Per-row device bytes of a column (data + validity mask)."""
    if dtype.kind is TypeKind.BYTES:
        return dtype.width + 1
    return dtype.np_dtype.itemsize + 1


def node_row_bytes(node: N.PlanNode, catalog=None) -> int:
    """Per-row device bytes of a node's output (+1 for the live mask).
    With a ``catalog``, columns that resolve to a source scan column count
    at their narrowed physical width; computed columns stay canonical."""
    total = 1
    for f in node.fields:
        dt = f.dtype
        if catalog is not None and not dt.is_narrowed:
            dt = _physical_field_type(node, f.name, dt, catalog)
        total += column_bytes(dt)
    return total


def _physical_field_type(node, name: str, dtype: DataType, catalog) -> DataType:
    from presto_tpu_torch.plan.bounds import resolve_source_column

    src = resolve_source_column(node, name)
    if src is None:
        return dtype
    conn = catalog.connectors.get(src[0])
    if conn is None or not hasattr(conn, "physical_schema"):
        return dtype
    try:
        return conn.physical_schema(src[1], [src[2]])[src[2]]
    except KeyError:
        return dtype
