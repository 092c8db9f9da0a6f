"""Plan-template parameterization: literal slots and prepared statements.

Counterpart of ``presto_tpu/plan/templates.py``. ``parameterize_plan``
lifts each eligible literal of a pruned plan into a typed ``expr.Param``
slot; the executor evaluates a slot by broadcasting the bound device
scalar (``device_params``) on the batch's device. The JAX package does
this so one compiled program serves every binding; the port compiles no
program per plan, so here a template changes what the planner sees (a
slot has no static interval), EXPLAIN's text, the ``prepare.*`` counters
and the surface of PREPARE / EXECUTE, never an answer.

Eligibility (each carve-out counted under ``prepare.slot_ineligible.*``):

- ``leaf_route``: the literals of a fragment the leaf-route matcher
  would lower to a fused kernel stay baked: filter bounds and value
  coefficients are part of the kernel's admission proofs;
- ``limit``: LIMIT / TopN counts are plan shapes, never slots;
- ``string``: VARCHAR / BYTES literals encode against dictionaries;
- ``null``: typed NULL literals evaluate to an all-invalid column.

``prepare.slots_bound`` counts the slots made.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from presto_tpu_torch.expr import Call, Expr, Literal, Param
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.types import DataType, TypeKind

#: literal kinds a device scalar can carry
_SLOT_KINDS = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DOUBLE,
               TypeKind.DECIMAL, TypeKind.DATE, TypeKind.TIMESTAMP,
               TypeKind.BOOLEAN)


@dataclass(frozen=True)
class ParamSlot:
    """One extracted literal: the slot id, its declared type, and the
    logical value this query binds (the ``Literal.value`` convention)."""

    slot: int
    dtype: DataType
    value: Any


@dataclass
class PreparedStatement:
    """A prepared plan template: the parameterized plan plus its slot
    layout. ``user_slots`` are the explicit ``?`` placeholders (slot id
    == placeholder ordinal); ``auto_slots`` the parameterized literals
    with their statement-text values. Every binding runs this one
    ``plan`` object."""

    name: str
    sql: str
    plan: N.PlanNode
    user_slots: tuple  # ((slot, DataType), ...) in slot order
    auto_slots: tuple  # (ParamSlot, ...)

    @property
    def n_user(self) -> int:
        return len(self.user_slots)

    def bind(self, args: Sequence[Any]) -> tuple:
        """Full slot-ordered (dtype, logical value) vector for one
        execution: user args by position, auto defaults after."""
        if len(args) != self.n_user:
            raise UserError(
                f"prepared statement {self.name!r} takes {self.n_user} "
                f"parameter(s), got {len(args)}"
            )
        out = {}
        for (slot, dt), v in zip(self.user_slots, args):
            out[slot] = (dt, _coerce_value(dt, v))
        for s in self.auto_slots:
            out[s.slot] = (s.dtype, s.value)
        return tuple(out[i] for i in range(len(out)))


def _coerce_value(dt: DataType, v: Any):
    """Validate and coerce one user-supplied parameter value to the
    slot's declared type (logical convention); loud on a mismatch."""
    try:
        if dt.kind in (TypeKind.INTEGER, TypeKind.BIGINT):
            out = int(v)
            if out != float(v):
                raise ValueError(v)
            return out
        if dt.kind is TypeKind.BOOLEAN:
            return bool(v)
        if dt.kind in (TypeKind.DOUBLE, TypeKind.DECIMAL):
            float(v)  # validates
            return v
        if dt.kind in (TypeKind.DATE, TypeKind.TIMESTAMP):
            dt.to_physical(v)  # validates (str or int forms)
            return v
    except (TypeError, ValueError):
        raise UserError(f"cannot bind {v!r} as a {dt} parameter") from None
    raise UserError(f"unsupported parameter type {dt}")


def device_params(bound: Sequence[tuple], device) -> tuple:
    """(dtype, logical value) pairs -> 0-d tensors on ``device`` in each
    slot's canonical physical dtype (what ``evaluate`` broadcasts)."""
    return tuple(
        torch.tensor(dt.to_physical(v), dtype=dt.canonical().torch_dtype, device=device)
        for dt, v in bound
    )


def logical_values(bound: Sequence[tuple]) -> tuple:
    """The value half of a binding."""
    return tuple(v for _dt, v in bound)


def _count(reason: str, n: int = 1) -> None:
    if n <= 0:
        return
    REGISTRY.counter("prepare.slot_ineligible").add(n)
    REGISTRY.counter(f"prepare.slot_ineligible.{reason}").add(n)


class _Parameterizer:
    def __init__(self, catalog, start_slot: int):
        self.catalog = catalog
        self.next_slot = start_slot
        self.slots: list[ParamSlot] = []

    # ---- expressions -----------------------------------------------------
    def expr(self, e: Optional[Expr]) -> Optional[Expr]:
        if e is None or isinstance(e, Param):
            return e
        if isinstance(e, Literal):
            if e.dtype.kind not in _SLOT_KINDS:
                if e.dtype.kind in (TypeKind.VARCHAR, TypeKind.BYTES):
                    _count("string")
                return e
            if e.value is None:
                _count("null")
                return e
            slot = self.next_slot
            self.next_slot += 1
            self.slots.append(ParamSlot(slot, e.dtype, e.value))
            return Param(e.dtype, slot)
        if isinstance(e, Call):
            args = tuple(self.expr(a) for a in e.args)
            if all(a is b for a, b in zip(args, e.args)):
                return e
            return Call(e.dtype, e.fn, args)
        return e  # InputRef / Unbound: no literals below

    def _pairs(self, pairs):
        return tuple((n, self.expr(e)) for n, e in pairs)

    def _sort_keys(self, keys):
        return tuple(dataclasses.replace(k, expr=self.expr(k.expr)) for k in keys)

    def _agg_specs(self, aggs):
        return tuple(dataclasses.replace(a, input=self.expr(a.input))
                     if a.input is not None else a for a in aggs)

    def _leaf_routes(self, node: N.Aggregate) -> bool:
        """Would the leaf-route matcher lower this fragment to a fused
        kernel? Its literals then feed the kernel's admission proofs and
        stay baked. Conservative on any matcher error: keep baked."""
        try:
            from presto_tpu_torch.exec.leaf_route import match_leaf_fragment

            route, reason = match_leaf_fragment(node, self.catalog)
            # a fragment past one kernel launch's limits is one the JAX
            # package routes (ROADMAP C9): its literals stay baked there,
            # so here too
            return route is not None or reason == "kernel_limits"
        except Exception:  # noqa: BLE001 -- advisory; never fail planning
            return True

    # ---- plan walk -------------------------------------------------------
    def node(self, node: N.PlanNode) -> N.PlanNode:
        if isinstance(node, N.Aggregate):
            if self._leaf_routes(node):
                # the whole fragment stays the same object, so the
                # executor's matcher sees what this decision saw
                _count("leaf_route", _count_eligible_literals(node))
                return node
            return N.Aggregate(self.node(node.child), self._pairs(node.keys),
                               self._agg_specs(node.aggs), self._pairs(node.passengers),
                               node.unique_sets)
        if isinstance(node, N.TableScan):
            if node.predicate is None:
                return node
            return dataclasses.replace(node, predicate=self.expr(node.predicate))
        if isinstance(node, N.Filter):
            return N.Filter(self.node(node.child), self.expr(node.predicate))
        if isinstance(node, N.Project):
            return N.Project(self.node(node.child), self._pairs(node.exprs))
        if isinstance(node, (N.Join, N.SemiJoin)):
            return dataclasses.replace(
                node, left=self.node(node.left), right=self.node(node.right),
                left_keys=tuple(self.expr(k) for k in node.left_keys),
                right_keys=tuple(self.expr(k) for k in node.right_keys))
        if isinstance(node, N.Window):
            return dataclasses.replace(
                node, child=self.node(node.child),
                partition_by=tuple(self.expr(e) for e in node.partition_by),
                order_by=self._sort_keys(node.order_by), funcs=self._agg_specs(node.funcs))
        if isinstance(node, N.Sort):
            return N.Sort(self.node(node.child), self._sort_keys(node.keys))
        if isinstance(node, N.TopN):
            _count("limit")  # the count is a static output shape
            return N.TopN(self.node(node.child), self._sort_keys(node.keys), node.count)
        if isinstance(node, N.Limit):
            _count("limit")
            return N.Limit(self.node(node.child), node.count)
        if isinstance(node, N.Union):
            return N.Union(tuple(self.node(c) for c in node.inputs))
        if isinstance(node, N.Output):
            return dataclasses.replace(node, child=self.node(node.child))
        if isinstance(node, N.BindScalars):
            return N.BindScalars(self.node(node.child),
                                 tuple(dataclasses.replace(s, child=self.node(s.child))
                                       for s in node.scalars))
        if isinstance(node, N.ScalarValue):
            return dataclasses.replace(node, child=self.node(node.child))
        return node  # Values, and any node kind without literals


def _count_eligible_literals(obj) -> int:
    """Would-be-slot literals in a subtree (eligible kind, non-NULL)."""
    if isinstance(obj, Literal):
        return int(obj.dtype.kind in _SLOT_KINDS and obj.value is not None)
    if isinstance(obj, Call):
        return sum(_count_eligible_literals(a) for a in obj.args)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_count_eligible_literals(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_count_eligible_literals(x) for x in obj)
    return 0


#: aggregate kinds the batched dispatcher's global-aggregation replay
#: covers (GlobalAggregationOperator's exact update and finish)
_BATCHABLE_AGG_KINDS = frozenset({"sum", "count", "count_star", "min", "max"})


def unbatchable_reason(plan: N.PlanNode, catalog) -> Optional[str]:
    """Why a plan template cannot take the cross-query batched dispatch
    (``server/batcher.py``), or None when it can.

    The batched dispatcher scans the template's one table once and
    replays its operator steps once per queued binding. That is sound
    only for plans whose execution is a pure function of (scan data,
    params): one table scan feeding streaming filter/project steps into
    at most one pipeline breaker (global aggregation, sort, top-N).
    Everything else (joins, grouped aggregation, windows, set operations,
    subqueries, LIMIT, VALUES, volatile system scans, and a fragment the
    leaf-route matcher would lower to a fused kernel) falls back to the
    serialized template slot, counted per reason under
    ``batch.fallback.*``; the reasons are the JAX package's."""
    breakers = 0

    def walk(node: N.PlanNode) -> Optional[str]:
        nonlocal breakers
        if isinstance(node, N.Output):
            return walk(node.child)
        if isinstance(node, (N.TopN, N.Sort)):
            breakers += 1
            if breakers > 1:
                return "multi_breaker"
            return walk(node.child)
        if isinstance(node, N.Aggregate):
            # the serial executor's global-aggregation condition: no
            # keys, no passengers
            if node.keys or node.passengers:
                return "grouped_agg"
            if any(a.kind not in _BATCHABLE_AGG_KINDS for a in node.aggs):
                return "agg_kind"
            try:
                from presto_tpu_torch.exec.leaf_route import match_leaf_fragment

                route, _ = match_leaf_fragment(node, catalog)
                if route is not None:
                    # the serial path launches the fused kernel; batching
                    # must not re-route it through the generic replay
                    return "leaf_route"
            except Exception:  # noqa: BLE001 -- conservative: no batch
                return "leaf_route"
            breakers += 1
            if breakers > 1:
                return "multi_breaker"
            return walk(node.child)
        if isinstance(node, (N.Filter, N.Project)):
            return walk(node.child)
        if isinstance(node, N.TableScan):
            conn = catalog.connectors.get(node.connector)
            if conn is None or getattr(conn, "volatile", False):
                return "volatile"
            return None
        if isinstance(node, (N.Join, N.SemiJoin)):
            return "join"
        if isinstance(node, N.Window):
            return "window"
        if isinstance(node, N.Union):
            return "union"
        if isinstance(node, (N.BindScalars, N.ScalarValue)):
            return "subquery"
        if isinstance(node, N.Limit):
            return "limit"
        if isinstance(node, N.Values):
            return "values"
        return "unsupported"

    try:
        return walk(plan)
    except Exception:  # noqa: BLE001 -- an advisory gate never fails a query
        return "unsupported"


def parameterize_plan(plan: N.PlanNode, catalog, start_slot: int = 0):
    """Auto-parameterize a pruned plan: every eligible ``Literal`` becomes
    a typed ``Param`` slot, numbered from ``start_slot`` (after any
    explicit ``?`` placeholders) in deterministic pre-order. Returns
    ``(plan, auto_slots)``; counts ``prepare.slots_bound`` and the
    per-reason ineligibility counters."""
    p = _Parameterizer(catalog, start_slot)
    out = p.node(plan)
    if p.slots:
        REGISTRY.counter("prepare.slots_bound").add(len(p.slots))
    return out, tuple(p.slots)
