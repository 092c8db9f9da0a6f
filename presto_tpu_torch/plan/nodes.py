"""Logical plan nodes.

Counterpart of ``presto_tpu/plan/nodes.py`` for the node kinds the
ported analyzer produces: TableScan, Filter, Project, Aggregate, Window,
Join, SemiJoin, Values, Union, Sort, TopN, Limit, ScalarValue,
BindScalars and Output.
Fields are named, typed columns; expressions are the typed IR of
``presto_tpu_torch.expr``. The JAX
package's runtime join filters are not ported, so scans carry none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from presto_tpu_torch.exec.operators import AggSpec, SortKey
from presto_tpu_torch.expr import Expr
from presto_tpu_torch.types import DataType


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType


class PlanNode:
    @property
    def children(self) -> tuple["PlanNode", ...]:
        return ()

    @property
    def fields(self) -> tuple[Field, ...]:
        raise NotImplementedError

    def field_names(self) -> list[str]:
        return [f.name for f in self.fields]


@dataclass(frozen=True)
class TableScan(PlanNode):
    connector: str
    table: str
    columns: tuple[tuple[str, str], ...]  # (output field name, source column)
    types: tuple[DataType, ...]
    predicate: Optional[Expr] = None  # pushed-down filter

    @property
    def fields(self):
        return tuple(Field(n, t) for (n, _), t in zip(self.columns, self.types))


@dataclass(frozen=True)
class Filter(PlanNode):
    child: PlanNode
    predicate: Expr

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return self.child.fields


@dataclass(frozen=True)
class Project(PlanNode):
    child: PlanNode
    exprs: tuple[tuple[str, Expr], ...]  # (output name, expr)

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return tuple(Field(n, e.dtype) for n, e in self.exprs)


@dataclass(frozen=True)
class Aggregate(PlanNode):
    child: PlanNode
    keys: tuple[tuple[str, Expr], ...]  # (output name, key expr over child)
    aggs: tuple[AggSpec, ...]
    #: functionally-determined columns carried per group without being
    #: grouped on (a unique key of their table is among ``keys``)
    passengers: tuple[tuple[str, Expr], ...] = ()
    #: alternative output-name sets each unique per output row
    unique_sets: tuple[tuple[str, ...], ...] = ()

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return (tuple(Field(n, e.dtype) for n, e in self.keys)
                + tuple(Field(n, e.dtype) for n, e in self.passengers)
                + tuple(Field(a.name, a.dtype) for a in self.aggs))


@dataclass(frozen=True)
class Window(PlanNode):
    """Window functions over partitioned, ordered row frames. ``funcs``
    reuse AggSpec; kinds also include rank / dense_rank / row_number and
    lag / lead / first_value. frame: 'range' | 'rows' | 'full' (see
    ``sql.ast.WindowSpec``)."""

    child: PlanNode
    partition_by: tuple[Expr, ...]
    order_by: tuple[SortKey, ...]
    funcs: tuple[AggSpec, ...]
    frame: str = "range"

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return self.child.fields + tuple(Field(f.name, f.dtype) for f in self.funcs)


@dataclass(frozen=True)
class Join(PlanNode):
    """Equi-join. probe = left child (streamed), build = right child.
    unique: build keys are unique (FK->PK fast path, no expansion)."""

    left: PlanNode
    right: PlanNode
    kind: str  # inner | left | full
    left_keys: tuple[Expr, ...]
    right_keys: tuple[Expr, ...]
    unique: bool
    output_right: tuple[str, ...]  # build-side fields to carry

    @property
    def children(self):
        return (self.left, self.right)

    @property
    def fields(self):
        rmap = {f.name: f for f in self.right.fields}
        return self.left.fields + tuple(rmap[n] for n in self.output_right)


@dataclass(frozen=True)
class SemiJoin(PlanNode):
    """left WHERE left_key [NOT] IN (right keys) — filter-only join."""

    left: PlanNode
    right: PlanNode
    left_keys: tuple[Expr, ...]
    right_keys: tuple[Expr, ...]
    negated: bool = False

    @property
    def children(self):
        return (self.left, self.right)

    @property
    def fields(self):
        return self.left.fields


@dataclass(frozen=True)
class Values(PlanNode):
    """One row with no columns: the source of a SELECT without FROM.
    Projections over it evaluate the select list's constants."""

    @property
    def fields(self):
        return ()


@dataclass(frozen=True)
class Union(PlanNode):
    """UNION ALL: the bag concatenation of children with the same field
    names and types (the analyzer inserts coercing Projects). UNION
    DISTINCT, INTERSECT and EXCEPT plan an Aggregate above it."""

    inputs: tuple[PlanNode, ...]

    @property
    def children(self):
        return self.inputs

    @property
    def fields(self):
        return self.inputs[0].fields


@dataclass(frozen=True)
class Sort(PlanNode):
    child: PlanNode
    keys: tuple[SortKey, ...]

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return self.child.fields


@dataclass(frozen=True)
class TopN(PlanNode):
    child: PlanNode
    keys: tuple[SortKey, ...]
    count: int

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return self.child.fields


@dataclass(frozen=True)
class Limit(PlanNode):
    child: PlanNode
    count: int

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return self.child.fields


@dataclass(frozen=True)
class ScalarValue(PlanNode):
    """An uncorrelated scalar subquery: child must produce at most one
    row of one column; the value is bound as a literal under ``name``."""

    child: PlanNode
    name: str
    dtype: DataType

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        return (Field(self.name, self.dtype),)


@dataclass(frozen=True)
class BindScalars(PlanNode):
    """Execute the scalar subplans first, bind their values into the
    child's ``Unbound`` expression slots."""

    child: PlanNode
    scalars: tuple[ScalarValue, ...]

    @property
    def children(self):
        return (self.child,) + self.scalars

    @property
    def fields(self):
        return self.child.fields


@dataclass(frozen=True)
class Output(PlanNode):
    """Final projection to client column names."""

    child: PlanNode
    names: tuple[str, ...]  # client-visible names
    sources: tuple[str, ...]  # child field names

    @property
    def children(self):
        return (self.child,)

    @property
    def fields(self):
        smap = {f.name: f for f in self.child.fields}
        return tuple(Field(n, smap[s].dtype) for n, s in zip(self.names, self.sources))


def plan_tree_str(node: PlanNode, indent: int = 0, catalog=None,
                  approx_join: bool = False, _filters=None) -> str:
    """EXPLAIN-style rendering. With a ``catalog``, joins and semi joins
    render the stats-planned probe strategy
    (``strategy=pallas|dense|unique|expand``), aggregates the planned
    aggregation strategy (``agg_strategy=fused|bypass|partial|single``)
    and probe-side scans the runtime join filters pushed into them
    (``runtime_filter=['l_orderkey']``), as the JAX package does. With
    ``approx_join`` (the session property), semi joins that would probe
    the Bloom sketch render ``strategy=sketch(approx)``: the approximate
    mode is never silent."""
    if _filters is None and catalog is not None:
        from presto_tpu_torch.plan.joinfilters import filter_edges

        _filters = {}
        for _join, scan, col in filter_edges(node):
            _filters.setdefault(id(scan), []).append(col)
    pad = "  " * indent
    detail = ""
    if isinstance(node, TableScan):
        rf = (_filters or {}).get(id(node))
        detail = (f" {node.table}{' [pred]' if node.predicate is not None else ''}"
                  f" -> {[c for c, _ in node.columns]}"
                  + (f" runtime_filter={rf}" if rf else ""))
    elif isinstance(node, Aggregate):
        detail = f" keys={[n for n, _ in node.keys]} aggs={[a.name for a in node.aggs]}"
        if catalog is not None:
            from presto_tpu_torch.exec.leaf_route import agg_strategy_for

            detail += f" agg_strategy={agg_strategy_for(node, catalog)}"
    elif isinstance(node, (Join, SemiJoin)):
        if isinstance(node, Join):
            detail = f" {node.kind}{' unique' if node.unique else ''}"
        else:
            detail = " anti" if node.negated else ""
        if catalog is not None:
            from presto_tpu_torch.exec.local_planner import planned_join_strategy

            detail += f" strategy={planned_join_strategy(node, catalog, approx_join)}"
    elif isinstance(node, Window):
        detail = f" funcs={[f.name for f in node.funcs]} frame={node.frame}"
    elif isinstance(node, (TopN, Limit)):
        detail = f" n={node.count}"
    elif isinstance(node, Output):
        detail = f" {list(node.names)}"
    elif isinstance(node, Project):
        detail = f" {[n for n, _ in node.exprs]}"
    out = f"{pad}{type(node).__name__}{detail}\n"
    for c in node.children:
        out += plan_tree_str(c, indent + 1, catalog=catalog, approx_join=approx_join,
                             _filters=_filters)
    return out
