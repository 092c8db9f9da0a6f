"""Semantic analysis: AST -> typed logical plan (the ported subset).

Counterpart of ``presto_tpu/sql/analyzer.py`` for the SELECT shapes of
all 22 TPC-H queries and all 15 SSB queries and the SQL surface around
them: ``WITH`` (each reference to a CTE is analyzed again, as a derived
table); set operations (UNION [ALL], INTERSECT, EXCEPT; a UNION is a
``Union`` node, UNION DISTINCT a keys-only Aggregate above it, INTERSECT
and EXCEPT a tagged union with grouped tag sums) at the top level, in
WITH, in derived tables and in IN / EXISTS / scalar subqueries; SELECT
[DISTINCT] with or without FROM (a ``Values`` row), comma joins,
explicit ``JOIN ... ON``, ``LEFT`` / ``RIGHT`` / ``FULL [OUTER] JOIN
... ON`` (ON conjuncts over the build side alone filter the build; a
RIGHT join is planned as the LEFT join with its sides swapped) and
derived tables; WHERE conjuncts; GROUP BY (or none: one keyless
aggregate row); ORDER BY; LIMIT (a ``TopN`` under ORDER BY, else a
``Limit``); [NOT] EXISTS with equality correlation and [NOT] IN
(subquery), each a ``SemiJoin`` (anti when negated); ``count`` (and
``count(DISTINCT x)``, a pre-aggregation on the keys plus ``x``),
``sum``, ``avg`` (``sum`` / ``count`` in DOUBLE), ``min``, ``max``,
``stddev`` / ``stddev_samp`` / ``variance`` / ``var_samp`` (sums of x
and x^2 and a count, a negative variance clamped to 0 before the root);
arithmetic with ``%`` (floor modulo) and ``||``, comparisons, [NOT]
BETWEEN, [NOT] IN (a list), [NOT] LIKE, IS [NOT] NULL, AND, OR and NOT;
scalar subqueries: uncorrelated ones (in a comparison, a value position
or a BETWEEN bound) as a ``ScalarValue`` bound into ``Unbound`` slots by
a ``BindScalars`` over the plan, equality-correlated ones in a
comparison decorrelated into a group-by on the correlation columns plus
a unique inner join; EXISTS with equality correlation plus one ``<>``
correlation (a min/max per correlation group, LEFT-joined, then a
filter); EXISTS leaves under OR/AND (the mark join); simple and searched
CASE, COALESCE, NULLIF; CAST to ``double``, ``bigint`` / ``int`` /
``integer``, ``decimal(p,s)``, ``varchar[(n)]``, ``timestamp`` and
``date``; ``SUBSTRING`` / ``substr`` over BYTES and dictionary VARCHAR;
every ``EXTRACT`` field; the scalar function library of the JAX package
(``_scalar_function``: math, string and date families, with its arity
table and literal-argument rules); ``date '...'`` and ``timestamp
'...'`` literals and ``date +/- interval`` folding.
The relational planning is the JAX package's, copied: predicate
pushdown into the owning relation, greedy stats-driven join ordering,
unique-build detection from table keys, and functional-dependency
grouping (keys covered by a table's unique key ride as passengers), so
both packages build the same plan tree for the same statement.

Window functions (``row_number``, ``rank``, ``dense_rank``, ``lag`` /
``lead`` with a literal offset, ``first_value`` and ``sum`` / ``count`` /
``min`` / ``max`` / ``avg`` over the RANGE, ROWS and whole-partition
frames) in SELECT and ORDER BY: one ``Window`` node per distinct OVER
spec, chained in first-seen order, above the aggregation and HAVING.
GROUP BY ROLLUP / CUBE / GROUPING SETS with ``grouping()``: a UNION ALL
of one grouped branch per set (absent keys typed NULLs outside aggregate
arguments, ``grouping()`` folded to 0 or 1); with windows, the branches
feed an outer query that carries them. A ``?`` parameter takes the type
of the typed operand beside it (a comparison or arithmetic operand, an
IN list's value, BETWEEN's value) and lowers to an ``expr.Param`` slot;
``param_types`` holds the slot types of the last statement. Statements
other than queries raise ``NotSupported`` naming the construct (the
session never sends one here). Every other refusal is the JAX package's
``AnalysisError``, word for word.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np

from presto_tpu_torch.exec.operators import AggSpec, SortKey
from presto_tpu_torch.expr import (
    Call, Expr, InputRef, Literal, Param, Unbound, cast_varchar_fn, date_add_fn, date_diff_fn,
    date_trunc_fn, parse_date_fn, parse_timestamp_fn, rescale_decimal, result_type,
    split_part_fn, substr_dict_fn, substr_fn)
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.catalog import Catalog, TableMeta
from presto_tpu_torch.plan.prune import expr_refs
from presto_tpu_torch.runtime.errors import NotSupported, UserError
from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, TIMESTAMP, DataType, TypeKind,
    common_super_type, decimal, fixed_bytes, varchar)

AGG_FUNCS = {"count", "sum", "avg", "min", "max",
             "stddev_samp", "stddev", "var_samp", "variance"}

_CMP_OPS = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
_ARITH_OPS = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod"}


class AnalysisError(UserError):
    """Semantic errors — unknown tables/columns, type mismatches
    (taxonomy: USER_ERROR; ValueError ancestry preserved)."""


def _unsupported(what: str) -> NotSupported:
    return NotSupported(f"{what} is not ported to presto_tpu_torch yet")


@dataclass(frozen=True)
class FieldRef:
    name: str  # unique internal field name (Batch column name)
    dtype: DataType
    binding: str  # relation alias/table name
    column: str  # source column name within the relation
    table: Optional[str] = None  # base table (for unique-key reasoning)


class Scope:
    def __init__(self, fields: Sequence[FieldRef]):
        self.fields = list(fields)

    def try_resolve(self, parts: tuple[str, ...]) -> FieldRef | None:
        if len(parts) == 1:
            hits = [f for f in self.fields if f.column == parts[0]]
        else:
            q, c = parts[-2], parts[-1]
            hits = [f for f in self.fields if f.binding == q and f.column == c]
        if len(hits) > 1:
            raise AnalysisError(f"ambiguous column {'.'.join(parts)}")
        return hits[0] if hits else None

    def resolve(self, parts: tuple[str, ...]) -> FieldRef:
        f = self.try_resolve(parts)
        if f is None:
            raise AnalysisError(f"column not found: {'.'.join(parts)}")
        return f

    def __add__(self, other: "Scope") -> "Scope":
        return Scope(self.fields + other.fields)


@dataclass
class Rel:
    """One relation instance in the FROM clause."""

    binding: str
    plan: N.PlanNode
    scope: Scope
    meta: Optional[TableMeta]  # None for derived tables
    group_keys: tuple[tuple[str, ...], ...] = ()  # alternative unique internal-name sets (grouped subquery)
    est_rows: float = 0.0
    filters: list[Expr] = field(default_factory=list)


def conjuncts(node: A.Node) -> list[A.Node]:
    if isinstance(node, A.BinaryOp) and node.op == "and":
        return conjuncts(node.left) + conjuncts(node.right)
    return [node]


def _ast_fields(n: A.Node):
    for f in getattr(n, "__dataclass_fields__", {}):
        yield getattr(n, f)


def collect_identifiers(n, out: list[A.Identifier]):
    if isinstance(n, A.Identifier):
        out.append(n)
        return
    if isinstance(n, (A.Exists, A.InSubquery, A.ScalarSubquery)):
        return  # bounded: inner queries resolved separately
    if isinstance(n, A.Node):
        for v in _ast_fields(n):
            collect_identifiers(v, out)
    elif isinstance(n, tuple):
        for v in n:
            collect_identifiers(v, out)


def contains_agg(n) -> bool:
    if isinstance(n, A.FunctionCall) and n.name in AGG_FUNCS and n.over is None:
        return True
    if isinstance(n, (A.Exists, A.InSubquery, A.ScalarSubquery)):
        return False
    if isinstance(n, A.Node):
        return any(contains_agg(v) for v in _ast_fields(n))
    if isinstance(n, tuple):
        return any(contains_agg(v) for v in n)
    return False


def collect_aggs(n, out: list[A.FunctionCall]):
    """Plain aggregates; window calls (``over`` set) are skipped as
    aggregates but their args/spec are searched (rank() over
    (order by sum(x)) contributes sum(x))."""
    if isinstance(n, A.FunctionCall) and n.name in AGG_FUNCS and n.over is None:
        out.append(n)
        return
    if isinstance(n, (A.Exists, A.InSubquery, A.ScalarSubquery)):
        return
    if isinstance(n, A.Node):
        for v in _ast_fields(n):
            collect_aggs(v, out)
    elif isinstance(n, tuple):
        for v in n:
            collect_aggs(v, out)


WINDOW_ONLY_FUNCS = {"rank", "dense_rank", "row_number"}


def _collect_grouping_calls(n, out: list):
    """``grouping(col)`` calls (fold to 0/1 per grouping-set branch)."""
    if isinstance(n, A.FunctionCall) and n.name == "grouping":
        if n not in out:
            out.append(n)
        return
    if isinstance(n, (A.Exists, A.InSubquery, A.ScalarSubquery)):
        return
    if isinstance(n, A.Node):
        for v in _ast_fields(n):
            _collect_grouping_calls(v, out)
    elif isinstance(n, tuple):
        for v in n:
            _collect_grouping_calls(v, out)


def collect_windows(n, out: list[A.FunctionCall]):
    """Window function calls (FunctionCall with an OVER spec). Does not
    descend into subqueries (analyzed separately) or into the window
    call itself (SQL forbids nested windows)."""
    if isinstance(n, A.FunctionCall) and n.over is not None:
        if n not in out:
            out.append(n)
        return
    if isinstance(n, (A.Exists, A.InSubquery, A.ScalarSubquery)):
        return
    if isinstance(n, A.Node):
        for v in _ast_fields(n):
            collect_windows(v, out)
    elif isinstance(n, tuple):
        for v in n:
            collect_windows(v, out)


def _resolved_refs(n, out: set[str]):
    """Collect InputRef names inside Resolved (pre-lowered) AST slots."""
    if isinstance(n, A.Resolved):
        expr_refs(n.expr, out)
        return
    if isinstance(n, A.Node):
        for v in _ast_fields(n):
            _resolved_refs(v, out)
    elif isinstance(n, tuple):
        for v in n:
            _resolved_refs(v, out)


def _substitute_outside_aggs(n, mapping):
    """Like substitute_nodes, but leaves plain aggregate-call subtrees
    untouched — grouping-sets NULL substitution must not rewrite
    aggregate arguments. Window calls ARE entered (their partition/
    order specs reference grouping keys), and the aggregates inside
    them stay opaque via the same rule."""
    if isinstance(n, A.FunctionCall) and n.name in AGG_FUNCS and n.over is None:
        return n
    if isinstance(n, A.Node) and not isinstance(n, A.Query):
        try:
            if n in mapping:
                return mapping[n]
        except TypeError:
            pass
    if isinstance(n, A.Query) or not isinstance(n, (A.Node, tuple)):
        return n
    if isinstance(n, tuple):
        return tuple(_substitute_outside_aggs(v, mapping) for v in n)
    changes = {}
    for f in n.__dataclass_fields__:
        v = getattr(n, f)
        nv = _substitute_outside_aggs(v, mapping)
        if nv is not v:
            changes[f] = nv
    return replace(n, **changes) if changes else n


def substitute_nodes(n, mapping):
    """Structurally replace AST nodes found in ``mapping`` (by value
    equality) with their replacements; subqueries are left untouched."""
    if isinstance(n, A.Node) and not isinstance(n, A.Query):
        try:
            if n in mapping:
                return mapping[n]
        except TypeError:
            pass
    if isinstance(n, A.Query) or not isinstance(n, (A.Node, tuple)):
        return n
    if isinstance(n, tuple):
        return tuple(substitute_nodes(v, mapping) for v in n)
    changes = {}
    for f in n.__dataclass_fields__:
        v = getattr(n, f)
        nv = substitute_nodes(v, mapping)
        if nv is not v:
            changes[f] = nv
    return replace(n, **changes) if changes else n


# selectivity guesses for cardinality estimation (ReorderJoins-lite)
_SEL = {"eq": 0.05, "ne": 0.9, "lt": 0.35, "le": 0.35, "gt": 0.35, "ge": 0.35,
        "between": 0.2, "like": 0.15, "in": 0.2, "starts_with": 0.1}


def _estimate_selectivity(e: Expr) -> float:
    if isinstance(e, Call):
        if e.fn == "and":
            return _estimate_selectivity(e.args[0]) * _estimate_selectivity(e.args[1])
        if e.fn == "or":
            a = _estimate_selectivity(e.args[0])
            b = _estimate_selectivity(e.args[1])
            return min(1.0, a + b)
        if e.fn == "not":
            return max(0.05, 1 - _estimate_selectivity(e.args[0]))
        return _SEL.get(e.fn, 0.5)
    return 0.5


class Analyzer:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._uniq = 0
        #: ``?`` placeholder types of the last analyze() (ordinal ->
        #: DataType): Session.prepare builds the user-slot layout from it
        self.param_types: dict[int, DataType] = {}

    # ------------------------------------------------------------------
    def fresh(self, base: str) -> str:
        self._uniq += 1
        return f"{base}${self._uniq}"

    def analyze(self, query: A.Node) -> N.PlanNode:
        # the gensym counter restarts per statement, as in the JAX
        # package, so both name the same internal fields alike
        self._uniq = 0
        self.param_types = {}
        if not isinstance(query, (A.Query, A.SetQuery)):
            raise _unsupported(f"statement {type(query).__name__}")
        plan, _scope = self._analyze_any(query, outer=None, ctes={})
        return plan

    def _param(self, ph: A.Placeholder, dtype: DataType) -> Expr:
        """Type one ``?`` placeholder from its context and lower it to a
        ``Param`` slot (slot id == lexical ordinal). A placeholder reached
        through two conflicting typed contexts is rejected."""
        if dtype.kind in (TypeKind.VARCHAR, TypeKind.BYTES):
            raise AnalysisError(
                "string parameters are not supported (dictionary "
                "encoding is a trace-time decision); inline the literal"
            )
        dtype = dtype.canonical()
        seen = self.param_types.get(ph.ordinal)
        if seen is not None and seen != dtype:
            raise AnalysisError(
                f"parameter ?{ph.ordinal + 1} used with conflicting "
                f"types {seen} and {dtype}"
            )
        self.param_types[ph.ordinal] = dtype
        return Param(dtype, ph.ordinal)

    def _analyze_any(
        self, q: A.Node, outer: Scope | None, ctes: dict
    ) -> tuple[N.PlanNode, Scope]:
        """Dispatch: a SELECT core or a set operation chain."""
        if isinstance(q, A.SetQuery):
            return self._analyze_setquery(q, outer, ctes)
        return self._analyze_query(q, outer, ctes)

    def _analyze_setquery(
        self, q: A.SetQuery, outer: Scope | None, ctes: dict
    ) -> tuple[N.PlanNode, Scope]:
        """A UNION [ALL] / INTERSECT / EXCEPT chain, left-associative:
        each term coerced to the common column types through a Project
        to fresh internal names (the client names, from the first term,
        may repeat); UNION DISTINCT a keys-only Aggregate over everything
        so far; INTERSECT and EXCEPT ``_plan_set_diff``; ORDER BY and
        LIMIT over the whole set."""
        ctes = dict(ctes)
        for name, cq in q.ctes:
            ctes[name] = cq
        planned = [self._analyze_any(t, outer, ctes) for t in q.terms]
        names = list(planned[0][0].names)
        for out, _scope in planned[1:]:
            if len(out.names) != len(names):
                raise AnalysisError(
                    f"UNION terms have {len(names)} vs {len(out.names)} columns")
        types = []
        for i in range(len(names)):
            t = planned[0][1].fields[i].dtype
            for _, scope in planned[1:]:
                t = common_super_type(t, scope.fields[i].dtype)
            types.append(t)
        internal = [self.fresh(n) for n in names]

        def as_union_input(out: N.Output, scope: Scope) -> N.PlanNode:
            exprs = []
            for i, n in enumerate(internal):
                e: Expr = InputRef(scope.fields[i].dtype, out.sources[i])
                exprs.append((n, self._coerce_to(e, types[i])))
            return N.Project(out.child, tuple(exprs))

        acc = as_union_input(*planned[0])
        for op, (out, scope) in zip(q.ops, planned[1:]):
            rhs = as_union_input(out, scope)
            if op in ("intersect", "except"):
                acc = self._plan_set_diff(acc, rhs, internal, types, op)
                continue
            acc = N.Union((acc, rhs))
            if op == "union":  # DISTINCT: dedup everything so far
                acc = N.Aggregate(
                    acc, tuple((n, InputRef(t, n)) for n, t in zip(internal, types)), ())
        plan = acc
        out_scope = Scope([FieldRef(i_, t, "", n) for i_, n, t in zip(internal, names, types)])
        if q.order_by:
            keys = []
            scalar_binds: list[N.ScalarValue] = []
            for item in q.order_by:
                e = self._order_expr(item.expr, out_scope, out_scope, None, ctes,
                                     scalar_binds, {}, {})
                keys.append(SortKey(e, item.descending, bool(item.nulls_first)))
            if q.limit is not None:
                plan = N.TopN(plan, tuple(keys), q.limit)
            else:
                plan = N.Sort(plan, tuple(keys))
            if scalar_binds:
                plan = N.BindScalars(plan, tuple(scalar_binds))
        elif q.limit is not None:
            plan = N.Limit(plan, q.limit)
        return N.Output(plan, tuple(names), tuple(internal)), out_scope

    def _plan_set_diff(self, left, right, internal, types, op: str):
        """INTERSECT / EXCEPT (distinct) as a tagged union and grouped tag
        sums, the JAX package's plan:

            UNION ALL(left tagged a=1, right tagged b=1)
            GROUP BY every column, summing the tags
            HAVING a > 0 AND (b > 0 | b = 0)
        """
        la, lb = self.fresh("seta"), self.fresh("setb")
        cols = tuple((n, InputRef(t, n)) for n, t in zip(internal, types))

        def tagged(p, a, b):
            return N.Project(p, cols + ((la, Literal(BIGINT, a)), (lb, Literal(BIGINT, b))))

        u = N.Union((tagged(left, 1, 0), tagged(right, 0, 1)))
        sa, sb = self.fresh("seta"), self.fresh("setb")
        agg = N.Aggregate(u, cols, (AggSpec("sum", InputRef(BIGINT, la), sa, BIGINT),
                                    AggSpec("sum", InputRef(BIGINT, lb), sb, BIGINT)))
        zero = Literal(BIGINT, 0)
        in_a = Call(BOOLEAN, "gt", (InputRef(BIGINT, sa), zero))
        in_b = Call(BOOLEAN, "gt", (InputRef(BIGINT, sb), zero))
        not_b = Call(BOOLEAN, "eq", (InputRef(BIGINT, sb), zero))
        cond = Call(BOOLEAN, "and", (in_a, in_b if op == "intersect" else not_b))
        return N.Project(N.Filter(agg, cond), cols)

    @staticmethod
    def _coerce_to(e: Expr, t: DataType) -> Expr:
        """Lift ``e`` to the set's unified type ``t`` (a common super type
        of ``e.dtype``)."""
        if e.dtype == t:
            return e
        if t.kind is TypeKind.DOUBLE:
            return Call(t, "cast_double", (e,))
        if t.kind is TypeKind.BIGINT:
            return Call(t, "cast_bigint", (e,))
        if t.kind is TypeKind.DECIMAL:
            return Call(t, rescale_decimal(t.scale), (e,))
        if t.kind is e.dtype.kind:
            return e  # width or parameter variations of one kind
        raise AnalysisError(f"cannot unify UNION column types {e.dtype} and {t}")

    def _expand_grouping_sets(
        self, q: A.Query, outer, ctes: dict
    ) -> A.SetQuery | None:
        """GROUP BY ROLLUP/CUBE/GROUPING SETS -> UNION ALL of one
        grouped branch per set (the reference plans GroupingSets as a
        GroupIdNode; re-aggregation per set is the equivalent here).
        In each branch, grouping columns absent from its set become
        typed NULL literals in SELECT/HAVING, and grouping(col) folds
        to its 0/1 constant for that branch."""
        gs_items = [g for g in q.group_by if isinstance(g, A.GroupingSets)]
        if not gs_items:
            return None
        if len(gs_items) > 1:
            raise AnalysisError("multiple GROUPING SETS elements not supported")
        prefix = tuple(g for g in q.group_by if not isinstance(g, A.GroupingSets))
        gs = gs_items[0]
        all_keys: list[A.Node] = []
        for s in gs.sets:
            for k in s:
                if k not in all_keys:
                    all_keys.append(k)
        # type each grouping key against the FROM scope once, so absent
        # keys can be replaced by *typed* NULLs (the union type checker
        # needs them); this pre-analysis of FROM is throwaway
        ctes2 = dict(ctes)
        for name, cq in q.ctes:
            ctes2[name] = cq
        rels: list[Rel] = []
        edges: list[dict] = []
        if q.from_ is not None:
            self._flatten_from(q.from_, rels, edges, ctes2, outer)
        probe_scope = Scope([f for r in rels for f in r.scope.fields])
        key_null: dict[A.Node, A.Node] = {}
        for k in all_keys:
            e = self._expr(k, probe_scope, outer, ctes2, [])
            key_null[k] = A.Resolved(Literal(e.dtype, None))
        wins: list[A.FunctionCall] = []
        for it in q.select:
            collect_windows(it.expr, wins)
        if wins:
            # window functions rank/aggregate across ALL grouping sets
            # (q67: rank over the whole rollup), so they cannot run per
            # branch — hoist them above the union
            return self._expand_gs_with_windows(
                q, gs, prefix, all_keys, key_null
            )
        branches = []
        for s in gs.sets:
            grouped = set(prefix) | set(s)
            g_map: dict[A.Node, A.Node] = {}
            null_map: dict[A.Node, A.Node] = {}
            for k in all_keys:
                g_map[A.FunctionCall("grouping", (k,))] = A.NumberLit(
                    "0" if k in grouped else "1"
                )
                if k not in grouped:
                    null_map[k] = key_null[k]

            def sub(n):
                # grouping() folds anywhere; key->NULL only OUTSIDE
                # aggregate arguments (SUM(a) in a subtotal row still
                # sums the real column, standard grouping-sets
                # semantics)
                n = substitute_nodes(n, g_map)
                return _substitute_outside_aggs(n, null_map)

            branches.append(replace(
                q,
                group_by=prefix + tuple(s),
                select=tuple(sub(it) for it in q.select),
                having=sub(q.having) if q.having is not None else None,
                order_by=(),
                limit=None,
                ctes=(),
            ))
        return A.SetQuery(
            terms=tuple(branches),
            ops=("union_all",) * (len(branches) - 1),
            order_by=q.order_by,
            limit=q.limit,
            ctes=q.ctes,
        )

    def _expand_gs_with_windows(self, q: A.Query, gs, prefix, all_keys,
                                key_null) -> A.Query:
        """Grouping sets + window functions: per-branch grouped inner
        queries (no windows) UNION ALL'd, with the windows applied in an
        outer query over the union — window partitions/orders see every
        grouping set at once, matching the reference's GroupIdNode →
        WindowNode plan order [SURVEY §2.1 planner row].

        Inner branches emit: each grouping key under its terminal
        column name, every distinct plain-aggregate subtree as
        ``__agg{i}``, and every ``grouping(...)`` call folded to its
        per-branch constant as ``__grp{i}``. The outer query is the
        original select/order/limit with those subtrees replaced by
        references."""
        key_items: list[A.Node] = []
        for k in tuple(prefix) + tuple(all_keys):
            if k not in key_items:
                key_items.append(k)
        for k in key_items:
            if not isinstance(k, A.Identifier):
                raise AnalysisError(
                    "window functions over grouping sets require "
                    "identifier grouping keys"
                )
        key_map = {k: A.Identifier((k.parts[-1],)) for k in key_items}

        aggs: list[A.FunctionCall] = []
        grps: list[A.FunctionCall] = []
        for it in q.select:
            collect_aggs(it.expr, aggs)
            _collect_grouping_calls(it.expr, grps)
        for oi in q.order_by:
            collect_aggs(oi.expr, aggs)
            _collect_grouping_calls(oi.expr, grps)
        uniq_aggs: list[A.FunctionCall] = []
        for a in aggs:
            if a not in uniq_aggs:
                uniq_aggs.append(a)
        uniq_grps: list[A.FunctionCall] = []
        for g in grps:
            if g not in uniq_grps:
                uniq_grps.append(g)
        agg_map = {a: A.Identifier((f"__agg{i}",))
                   for i, a in enumerate(uniq_aggs)}
        grp_map = {g: A.Identifier((f"__grp{i}",))
                   for i, g in enumerate(uniq_grps)}

        branches = []
        for s in gs.sets:
            grouped = set(prefix) | set(s)
            inner_items = []
            for k in key_items:
                e = k if k in grouped else key_null[k]
                inner_items.append(A.SelectItem(e, k.parts[-1]))
            for a, ref in agg_map.items():
                inner_items.append(A.SelectItem(a, ref.parts[0]))
            for g, ref in grp_map.items():
                folded = A.NumberLit("0" if g.args[0] in grouped else "1")
                inner_items.append(A.SelectItem(folded, ref.parts[0]))
            g_fold = {g: A.NumberLit("0" if g.args[0] in grouped else "1")
                      for g in uniq_grps}
            having = q.having
            if having is not None:
                having = _substitute_outside_aggs(
                    substitute_nodes(having, g_fold),
                    {k: key_null[k] for k in all_keys if k not in grouped},
                )
            branches.append(replace(
                q, select=tuple(inner_items),
                group_by=tuple(prefix) + tuple(s),
                having=having, order_by=(), limit=None, ctes=(),
            ))

        def rewrite(n):
            return substitute_nodes(
                substitute_nodes(substitute_nodes(n, agg_map), grp_map),
                key_map,
            )

        outer_select = tuple(
            A.SelectItem(rewrite(it.expr), it.alias) for it in q.select
        )
        outer_order = tuple(
            replace(oi, expr=rewrite(oi.expr)) for oi in q.order_by
        )
        inner = A.SetQuery(
            terms=tuple(branches), ops=("union_all",) * (len(branches) - 1)
        )
        return A.Query(
            select=outer_select,
            from_=A.SubqueryRelation(inner, self.fresh("gsw")),
            order_by=outer_order, limit=q.limit, ctes=q.ctes,
        )

    def _analyze_query(
        self, q: A.Query, outer: Scope | None, ctes: dict[str, A.Query]
    ) -> tuple[N.PlanNode, Scope]:
        expanded = self._expand_grouping_sets(q, outer, ctes)
        if isinstance(expanded, A.Query):
            return self._analyze_query(expanded, outer, ctes)
        if expanded is not None:
            return self._analyze_setquery(expanded, outer, ctes)
        ctes = dict(ctes)
        for name, cq in q.ctes:
            ctes[name] = cq

        # ---- FROM: relations + join graph -----------------------------
        rels: list[Rel] = []
        edges: list[dict] = []  # {a, b, akeys, bkeys, kind, residual}
        if q.from_ is not None:
            self._flatten_from(q.from_, rels, edges, ctes, outer)
        scope = Scope([f for r in rels for f in r.scope.fields])

        # ---- WHERE classification -------------------------------------
        residual: list[A.Node] = []
        sub_preds: list[A.Node] = []
        scalar_binds: list[N.ScalarValue] = []
        if q.where is not None:
            for c in conjuncts(q.where):
                self._classify_conjunct(
                    c, rels, edges, residual, sub_preds, scope, outer, ctes
                )

        # ---- order the joins ------------------------------------------
        plan = self._build_join_tree(rels, edges, scope)

        # residual filters (multi-relation, non-equi)
        for c in residual:
            e = self._expr(c, scope, outer, ctes, scalar_binds)
            plan = N.Filter(plan, e)

        # semi/anti joins & correlated scalar rewrites from WHERE
        for c in sub_preds:
            plan = self._apply_subquery_pred(c, plan, scope, outer, ctes, scalar_binds)

        # ---- aggregation ----------------------------------------------
        has_agg = (
            bool(q.group_by)
            or any(contains_agg(it.expr) for it in q.select)
            or (q.having is not None and contains_agg(q.having))
        )
        if has_agg:
            plan, scope, agg_map, key_map = self._plan_aggregate(
                q, plan, scope, outer, ctes, scalar_binds
            )
        else:
            agg_map, key_map = {}, {}
            if q.having is not None:
                raise AnalysisError("HAVING without aggregation")

        # ---- HAVING ----------------------------------------------------
        if q.having is not None:
            e = self._expr(q.having, scope, outer, ctes, scalar_binds,
                           agg_map=agg_map, key_map=key_map)
            plan = N.Filter(plan, e)

        # ---- window functions (evaluated over the grouped/filtered
        # rows, before the SELECT projection) ---------------------------
        win_calls: list[A.FunctionCall] = []
        for it in q.select:
            collect_windows(it.expr, win_calls)
        order_only_wins: list[A.FunctionCall] = []
        for ob in q.order_by:
            collect_windows(ob.expr, order_only_wins)
        order_only_wins = [w for w in order_only_wins if w not in win_calls]
        win_fields: list[N.Field] = []
        if win_calls or order_only_wins:
            plan, win_map, win_fields = self._plan_windows(
                win_calls + order_only_wins, plan, scope, outer, ctes,
                scalar_binds, agg_map, key_map,
            )
            mapping = {w: A.Resolved(e) for w, e in win_map.items()}
            q = replace(
                q,
                select=tuple(substitute_nodes(it, mapping) for it in q.select),
                order_by=tuple(substitute_nodes(ob, mapping) for ob in q.order_by),
            )

        # ---- SELECT projection ----------------------------------------
        out_names: list[str] = []
        out_exprs: list[tuple[str, Expr]] = []
        for i, item in enumerate(q.select):
            if isinstance(item.expr, A.Star):
                for f in scope.fields:
                    out_names.append(f.column)
                    out_exprs.append((f.column, InputRef(f.dtype, f.name)))
                continue
            e = self._expr(item.expr, scope, outer, ctes, scalar_binds,
                           agg_map=agg_map, key_map=key_map)
            name = item.alias or self._default_name(item.expr, i)
            out_names.append(name)
            out_exprs.append((name, e))
        # window outputs consumed only by ORDER BY ride the projection
        # as hidden columns (pruned away when unreferenced); they are
        # not client-visible fields
        hidden: list[tuple[str, Expr]] = []
        if win_fields and q.order_by:
            produced = {n for n, _ in out_exprs}
            ob_refs: set[str] = set()
            for ob in q.order_by:
                _resolved_refs(ob.expr, ob_refs)
            hidden = [
                (f.name, InputRef(f.dtype, f.name))
                for f in win_fields
                if f.name in ob_refs and f.name not in produced
            ]
            if q.distinct and hidden:
                raise AnalysisError(
                    "DISTINCT with window expressions repeated in ORDER BY "
                    "is not supported; order by the select alias instead"
                )
        plan = N.Project(plan, tuple(out_exprs) + tuple(hidden))
        out_scope = Scope(
            [FieldRef(n, e.dtype, "", n) for n, e in out_exprs]
        )

        # ---- DISTINCT: a keys-only Aggregate over the output fields -----
        if q.distinct:
            plan = N.Aggregate(
                plan,
                tuple((f.name, InputRef(f.dtype, f.name)) for f in out_scope.fields),
                (),
            )

        # ---- ORDER BY / LIMIT -----------------------------------------
        if q.order_by:
            keys = []
            src_map = {
                e.name: n for n, e in out_exprs if isinstance(e, InputRef)
            }
            for item in q.order_by:
                e = self._order_expr(item.expr, out_scope, scope, outer, ctes,
                                     scalar_binds, agg_map, key_map,
                                     src_map=src_map)
                keys.append(SortKey(e, item.descending, bool(item.nulls_first)))
            if q.limit is not None:
                plan = N.TopN(plan, tuple(keys), q.limit)
            else:
                plan = N.Sort(plan, tuple(keys))
        elif q.limit is not None:
            plan = N.Limit(plan, q.limit)

        # scalar-value bindings wrap the plan (executed first)
        if scalar_binds:
            plan = N.BindScalars(plan, tuple(scalar_binds))

        out = N.Output(plan, tuple(out_names), tuple(n for n, _ in out_exprs))
        return out, out_scope

    def _default_name(self, e: A.Node, i: int) -> str:
        if isinstance(e, A.Identifier):
            return e.parts[-1]
        return f"_col{i}"

    # ------------------------------------------------------------------
    # FROM flattening
    # ------------------------------------------------------------------
    def _flatten_from(self, rel: A.Node, rels, edges, ctes, outer):
        if isinstance(rel, A.Table):
            binding = rel.alias or rel.name
            if rel.name in ctes:
                # a CTE is analyzed again at every reference (Q15 plans
                # its ``revenue`` twice), as in the JAX package
                plan, sub_scope = self._analyze_any(ctes[rel.name], None, ctes)
                self._add_derived(rels, binding, plan, sub_scope)
                return
            meta = self.catalog.resolve(rel.name)
            fields = []
            cols = []
            types = []
            # internal names must be unique ACROSS the FROM clause: an
            # unaliased table keeps its plain column names only while
            # they don't collide with an earlier relation's
            used = {f.name for r in rels for f in r.scope.fields}
            for cname, t in meta.schema.items():
                if rel.alias or cname in used:
                    iname = self.fresh(f"{binding}.{cname}")
                else:
                    iname = cname
                fields.append(FieldRef(iname, t, binding, cname, meta.table))
                cols.append((iname, cname))
                types.append(t)
            scan = N.TableScan(meta.connector_name, meta.table, tuple(cols), tuple(types))
            rels.append(Rel(binding, scan, Scope(fields), meta,
                            est_rows=float(meta.row_count)))
            return
        if isinstance(rel, A.SubqueryRelation):
            binding = rel.alias or self.fresh("subq")
            plan, sub_scope = self._analyze_any(rel.query, None, ctes)
            self._add_derived(rels, binding, plan, sub_scope)
            return
        if isinstance(rel, A.Join):
            l0 = len(rels)
            self._flatten_from(rel.left, rels, edges, ctes, outer)
            nleft = len(rels)
            self._flatten_from(rel.right, rels, edges, ctes, outer)
            if rel.kind == "cross":
                return
            # ON condition -> equi keys + residual, between the two sides
            left_scope = Scope([f for r in rels[:nleft] for f in r.scope.fields])
            right_scope = Scope([f for r in rels[nleft:] for f in r.scope.fields])
            akeys, bkeys, res = [], [], []
            for c in conjuncts(rel.on) if rel.on is not None else []:
                pair = self._equi_pair(c, left_scope, right_scope)
                if pair is not None:
                    akeys.append(pair[0])
                    bkeys.append(pair[1])
                else:
                    res.append(c)
            kind = rel.kind
            # the relations on an outer join's NULL-extended side(s):
            # WHERE conjuncts over them stay post-join filters (pushed
            # into the scan they would change the outer join's result)
            nullable: set[int] = set()
            if kind in ("left", "full"):
                nullable |= set(range(nleft, len(rels)))
            if kind in ("right", "full"):
                nullable |= set(range(l0, nleft))
            if kind == "right":
                # A RIGHT JOIN B == B LEFT JOIN A: swap the key
                # orientation (akeys are spine-side) and record a left
                # join; the join-tree builder then makes the preserved
                # (original right) side the spine
                akeys, bkeys = bkeys, akeys
                kind = "left"
            edges.append(dict(kind=kind, left=nleft, akeys=akeys, bkeys=bkeys,
                              residual=res, nullable=nullable))
            return
        raise AnalysisError(f"unsupported relation {type(rel).__name__}")

    def _agg_key_outputs(self, node) -> tuple[tuple[str, ...], ...]:
        """Alternative output-name sets (at ``node``'s level) each
        unique per row of an Aggregate below — possibly through Project
        renames / Filters. () when not provably grouped-unique."""
        mappings: list[dict[str, str]] = []  # out name -> in name
        while True:
            if isinstance(node, N.Filter):
                node = node.child
                continue
            if isinstance(node, N.Project):
                mappings.append({n2: e.name for n2, e in node.exprs
                                 if isinstance(e, InputRef)})
                node = node.child
                continue
            break
        if not isinstance(node, N.Aggregate):
            return ()
        sets = list(node.unique_sets) or [tuple(n for n, _ in node.keys)]
        out: list[tuple[str, ...]] = []
        for names in sets:
            names = list(names)
            ok = True
            for m in reversed(mappings):
                inv: dict[str, str] = {}
                for out_n, in_n in m.items():
                    inv.setdefault(in_n, out_n)
                mapped = [inv.get(n) for n in names]
                if any(n is None for n in mapped):
                    ok = False  # a member is not exposed upward
                    break
                names = mapped
            if ok:
                out.append(tuple(names))
        return tuple(out)

    def _add_derived(self, rels, binding, plan, sub_scope):
        """A derived table as one relation: its Output is stripped and its
        columns re-projected to FRESH internal names, so two derived tables
        exposing the same column name never collide."""
        group_keys = self._agg_key_outputs(
            plan.child if isinstance(plan, N.Output) else plan)
        inner = plan.child if isinstance(plan, N.Output) else plan
        if isinstance(plan, N.Output):
            exprs = []
            fields = []
            iname_of = {}
            smap = {f.name: f for f in inner.fields}
            for n, s in zip(plan.names, plan.sources):
                iname = self.fresh(f"{binding}.{n}")
                exprs.append((iname, InputRef(smap[s].dtype, s)))
                fields.append(FieldRef(iname, smap[s].dtype, binding, n, None))
                iname_of.setdefault(s, iname)
            inner = N.Project(inner, tuple(exprs))
            if group_keys:
                group_keys = tuple(tuple(iname_of.get(k, k) for k in s)
                                   for s in group_keys)
        else:
            fields = [FieldRef(f.name, f.dtype, binding, f.name, None)
                      for f in plan.fields]
        rels.append(Rel(binding, inner, Scope(fields), None,
                        group_keys=group_keys, est_rows=1e5))

    # ------------------------------------------------------------------
    # WHERE conjunct classification
    # ------------------------------------------------------------------
    @staticmethod
    def _rel_has(r, f: FieldRef) -> bool:
        """Does rel ``r`` own field ``f``? Matched on (name, binding) —
        name alone is ambiguous when two unaliased tables expose the
        same column name (t1.k = t2.k must not resolve both sides to
        the first rel and silently degenerate to a cross join)."""
        return any(
            sf.name == f.name and sf.binding == f.binding
            for sf in r.scope.fields
        )

    def _rel_of(self, ident_fields: list[FieldRef], rels) -> int | None:
        owners = set()
        for f in ident_fields:
            for i, r in enumerate(rels):
                if self._rel_has(r, f):
                    owners.add(i)
        if len(owners) == 1:
            return owners.pop()
        return None

    def _classify_conjunct(self, c, rels, edges, residual, sub_preds, scope, outer, ctes):
        # subquery predicates go to the dedicated path
        if self._contains_subquery(c):
            sub_preds.append(c)
            return
        ids: list[A.Identifier] = []
        collect_identifiers(c, ids)
        refs = []
        unresolved_outer = False
        for i in ids:
            f = scope.try_resolve(i.parts) if i.parts != ("null",) else None
            if f is None and i.parts != ("null",):
                unresolved_outer = True
            elif f is not None:
                refs.append(f)
        if unresolved_outer:
            residual.append(c)
            return
        nullable = set()
        for e2 in edges:
            nullable |= e2.get("nullable", set())
        # equi-join conjunct?
        pair = self._equi_pair_any(c, rels, scope)
        if pair is not None:
            a, b, ae, be = pair
            if a in nullable or b in nullable:
                # a WHERE equality over a NULL-extended side of an
                # outer join must filter AFTER the join (it drops the
                # null-extended rows); merging it into the outer join
                # as a key would retain them
                residual.append(c)
                return
            edges.append(dict(kind="inner", pair=(a, b), akeys=[ae], bkeys=[be],
                              residual=[]))
            return
        owner = self._rel_of(refs, rels)
        if owner is not None:
            if owner in nullable:
                # nullable-side predicate: SQL applies it AFTER the
                # outer join (it sees the null-extended rows)
                residual.append(c)
                return
            e = self._expr(c, rels[owner].scope, outer, ctes, [])
            rels[owner].filters.append(e)
            rels[owner].est_rows *= _estimate_selectivity(e)
            return
        # OR-of-ANDs (Q19 shape): factor equi conjuncts common to every
        # branch into join edges; the OR itself stays as a residual.
        if isinstance(c, A.BinaryOp) and c.op == "or":
            branches = self._disjuncts(c)
            sets = [conjuncts(b) for b in branches]
            common = [x for x in sets[0] if all(x in s for s in sets[1:])]
            for cc in common:
                pair = self._equi_pair_any(cc, rels, scope)
                if pair is not None:
                    a, b, ae, be = pair
                    if a in nullable or b in nullable:
                        continue  # same outer-join guard as above
                    edges.append(dict(kind="inner", pair=(a, b),
                                      akeys=[ae], bkeys=[be], residual=[]))
        residual.append(c)

    def _disjuncts(self, n: A.Node) -> list[A.Node]:
        if isinstance(n, A.BinaryOp) and n.op == "or":
            return self._disjuncts(n.left) + self._disjuncts(n.right)
        return [n]

    def _contains_subquery(self, n) -> bool:
        if isinstance(n, (A.Exists, A.InSubquery, A.ScalarSubquery)):
            return True
        if isinstance(n, A.Node):
            return any(self._contains_subquery(v) for v in _ast_fields(n))
        if isinstance(n, tuple):
            return any(self._contains_subquery(v) for v in n)
        return False

    def _equi_pair(self, c, left_scope: Scope, right_scope: Scope):
        """col = col across two scopes -> (left_field, right_field)."""
        if not (isinstance(c, A.BinaryOp) and c.op == "="):
            return None
        if not (isinstance(c.left, A.Identifier) and isinstance(c.right, A.Identifier)):
            return None
        lf = left_scope.try_resolve(c.left.parts)
        rf = right_scope.try_resolve(c.right.parts)
        if lf is not None and rf is not None:
            return lf, rf
        lf2 = left_scope.try_resolve(c.right.parts)
        rf2 = right_scope.try_resolve(c.left.parts)
        if lf2 is not None and rf2 is not None:
            return lf2, rf2
        return None

    def _equi_pair_any(self, c, rels, scope):
        if not (isinstance(c, A.BinaryOp) and c.op == "="):
            return None
        if not (isinstance(c.left, A.Identifier) and isinstance(c.right, A.Identifier)):
            return None
        lf = scope.try_resolve(c.left.parts)
        rf = scope.try_resolve(c.right.parts)
        if lf is None or rf is None:
            return None
        ra = self._owner_index(rels, lf)
        rb = self._owner_index(rels, rf)
        if ra is None or rb is None or ra == rb:
            return None
        return ra, rb, lf, rf

    def _owner_index(self, rels, f: FieldRef) -> int | None:
        for i, r in enumerate(rels):
            if self._rel_has(r, f):
                return i
        return None

    # ------------------------------------------------------------------
    # join tree construction (greedy, stats-driven)
    # ------------------------------------------------------------------
    def _build_join_tree(self, rels: list[Rel], edges: list[dict], scope: Scope):
        if not rels:
            return N.Values()  # a SELECT without FROM: one row
        # apply pushdown filters
        plans: list[N.PlanNode] = []
        for r in rels:
            p = r.plan
            for e in r.filters:
                p = N.Filter(p, e)
            plans.append(p)
        if len(rels) == 1:
            return plans[0]

        # normalize edges: explicit-ON edges have 'left' marker; WHERE
        # edges have 'pair'
        norm = []
        for e in edges:
            if "pair" in e:
                norm.append(e)
            else:
                # explicit join: between rel index e['left']-1 side...
                # find owners of its key fields
                a = self._owner_index(rels, e["akeys"][0]) if e["akeys"] else None
                b = self._owner_index(rels, e["bkeys"][0]) if e["bkeys"] else None
                if a is None or b is None:
                    raise AnalysisError("unsupported join condition")
                norm.append(dict(kind=e["kind"], pair=(a, b),
                                 akeys=e["akeys"], bkeys=e["bkeys"],
                                 residual=e["residual"]))
        edges = norm

        # pick the spine: preserved side of a LEFT/FULL join wins, else
        # largest (for FULL the probe side is the spine; the build side's
        # unmatched rows are emitted by the kernel's tail pass)
        forced = [e["pair"][0] for e in edges if e["kind"] in ("left", "full")]
        if forced:
            spine = forced[0]
        else:
            spine = max(range(len(rels)), key=lambda i: rels[i].est_rows)

        joined = {spine}
        plan = plans[spine]
        cur_fields = list(rels[spine].scope.fields)
        remaining = set(range(len(rels))) - joined
        pending_edges = list(edges)

        while remaining:
            # candidate edges connecting joined <-> one unjoined rel
            best = None
            for e in pending_edges:
                a, b = e["pair"]
                if (a in joined) == (b in joined):
                    continue
                inner_rel = b if a in joined else a
                key = rels[inner_rel].est_rows
                if best is None or key < best[0]:
                    best = (key, e, inner_rel)
            if best is None:
                # cartesian product: no edge reaches the joined set
                # (TPC-DS q88/q90 cross-join single-row derived counts).
                # Join on a constant key — every probe row matches every
                # build row; smallest relation first bounds the blowup.
                bidx = min(remaining, key=lambda i: rels[i].est_rows)
                build_rel = rels[bidx]
                one = Literal(BIGINT, 1)
                plan = N.Join(
                    plan, plans[bidx], "inner", (one,), (one,),
                    False,
                    tuple(f.name for f in build_rel.scope.fields),
                )
                joined.add(bidx)
                remaining.discard(bidx)
                cur_fields += build_rel.scope.fields
                continue
            _, e, bidx = best
            a, b = e["pair"]
            # merge every edge between `joined` and bidx into one
            # multi-key join
            akeys: list[FieldRef] = []
            bkeys: list[FieldRef] = []
            kind = "inner"
            used = []
            on_residual: list[A.Node] = []
            for e2 in pending_edges:
                p2 = e2["pair"]
                if set(p2) <= joined | {bidx} and bidx in p2:
                    used.append(e2)
                    if e2["kind"] in ("left", "full"):
                        kind = e2["kind"]
                    on_residual.extend(e2.get("residual", ()))
                    for ak, bk in zip(e2["akeys"], e2["bkeys"]):
                        # orient: probe key in joined set, build key in bidx
                        if self._owner_index(rels, ak) == bidx:
                            ak, bk = bk, ak
                        akeys.append(ak)
                        bkeys.append(bk)
            for u in used:
                pending_edges.remove(u)
            if not akeys:
                raise AnalysisError("join without equi keys")
            # ON-clause residual conjuncts: build-side-only ones filter
            # the build input (required for LEFT semantics); others are
            # legal as post-join filters only for INNER joins.
            post_join: list[A.Node] = []
            for c in on_residual:
                ids: list[A.Identifier] = []
                collect_identifiers(c, ids)
                bscope = rels[bidx].scope
                if all(bscope.try_resolve(i.parts) is not None for i in ids):
                    plans[bidx] = N.Filter(
                        plans[bidx], self._expr(c, bscope, None, {}, [])
                    )
                elif kind == "inner":
                    post_join.append(c)
                else:
                    raise AnalysisError(
                        "outer-join ON condition spanning both sides is "
                        "not supported"
                    )
            build_rel = rels[bidx]
            unique = self._is_unique_key(build_rel, bkeys)
            plan = N.Join(
                plan,
                plans[bidx],
                kind,
                tuple(InputRef(k.dtype, k.name) for k in akeys),
                tuple(InputRef(k.dtype, k.name) for k in bkeys),
                unique,
                tuple(f.name for f in build_rel.scope.fields
                      if f.name not in {k.name for k in bkeys}) +
                tuple(k.name for k in bkeys),
            )
            joined.add(bidx)
            remaining.discard(bidx)
            cur_fields += build_rel.scope.fields
            for c in post_join:
                plan = N.Filter(plan, self._expr(c, Scope(cur_fields), None, {}, []))
        return plan

    def _is_unique_key(self, rel: Rel, keys: list[FieldRef]) -> bool:
        # meta unique_keys name SOURCE columns (FieldRef.column);
        # derived-rel group_keys holds ALTERNATIVE unique sets of
        # INTERNAL field names (FieldRef.name) from _agg_key_outputs
        colset = {k.column for k in keys} | {k.name for k in keys}
        # a pushdown equality-literal filter pins a column to one value,
        # so it counts toward uniqueness (q74: each year_total instance
        # is filtered to one sale_type and one year)
        for e in rel.filters:
            if isinstance(e, Call) and e.fn == "eq":
                a, b = e.args
                if isinstance(a, InputRef) and isinstance(b, Literal):
                    colset.add(a.name)
                elif isinstance(b, InputRef) and isinstance(a, Literal):
                    colset.add(b.name)
        if rel.meta is not None:
            return any(set(uk) <= colset for uk in rel.meta.unique_keys)
        return any(set(s) <= colset for s in rel.group_keys)

    # ------------------------------------------------------------------
    # aggregation planning
    # ------------------------------------------------------------------
    def _plan_aggregate(self, q, plan, scope, outer, ctes, scalar_binds):
        # group keys
        keys: list[tuple[str, Expr]] = []
        key_map: dict[A.Node, tuple[str, DataType]] = {}
        for g in q.group_by:
            e = self._expr(g, scope, outer, ctes, scalar_binds)
            if isinstance(g, A.Identifier):
                f = scope.resolve(g.parts)
                name = f.name
            else:
                name = self.fresh("gkey")
            keys.append((name, e))
            key_map[g] = (name, e.dtype)

        # aggregates from select/having/order, deduplicated by AST equality
        agg_calls: list[A.FunctionCall] = []
        for it in q.select:
            collect_aggs(it.expr, agg_calls)
        if q.having is not None:
            collect_aggs(q.having, agg_calls)
        for ob in q.order_by:
            collect_aggs(ob.expr, agg_calls)
        uniq: list[A.FunctionCall] = []
        for a in agg_calls:
            if a not in uniq:
                uniq.append(a)

        specs: list[AggSpec] = []
        agg_map: dict[A.FunctionCall, Expr] = {}
        distinct_key_exprs: list[tuple[str, Expr]] = []
        for a in uniq:
            specs_a, mapped = self._plan_one_agg(a, scope, outer, ctes, scalar_binds,
                                                 distinct_key_exprs)
            specs.extend(specs_a)
            agg_map[a] = mapped

        if distinct_key_exprs:
            if len(distinct_key_exprs) > 1:
                raise AnalysisError(
                    "multiple distinct DISTINCT-aggregate arguments are not supported")
            # pre-aggregate on the keys plus the distinct column: the
            # DISTINCT count becomes a count of the pre-groups, and the
            # plain aggregates decompose through partials (a sum of sums,
            # a sum of counts, a min of mins, ...)
            dn, de = distinct_key_exprs[0]
            cds = [s for s in specs if s.kind == "count_distinct"]
            partial: list[AggSpec] = []
            final: list[AggSpec] = []
            for s in specs:
                if s.kind == "count_distinct":
                    continue
                if s.kind not in ("sum", "count", "min", "max"):
                    raise AnalysisError(f"{s.kind} cannot combine with DISTINCT aggregates")
                pn = self.fresh("pdist")
                partial.append(AggSpec(s.kind, s.input, pn, s.dtype))
                outer_kind = "sum" if s.kind in ("sum", "count") else s.kind
                final.append(AggSpec(outer_kind, InputRef(s.dtype, pn), s.name, s.dtype))
            plan = N.Aggregate(plan, tuple(keys + distinct_key_exprs), tuple(partial))
            keys = [(n, InputRef(e.dtype, n)) for n, e in keys]
            specs = [AggSpec("count", InputRef(de.dtype, dn), s.name, s.dtype)
                     for s in cds] + final

        # functional dependencies: keys covered by a unique key of the
        # same relation instance become passengers (Q10/Q18 shape)
        grouping, passengers, bij_subst = self._split_passengers(keys, scope)
        key_names = tuple(n for n, _ in grouping)
        unique_sets = [key_names]
        if bij_subst:
            # substitute each hidden-PK group by its bijective named keys
            alt: list[str] = []
            consumed: set[str] = set()
            for hn, named in bij_subst.items():
                consumed |= set(hn)
            for n in key_names:
                if n not in consumed:
                    alt.append(n)
            for hn, named in bij_subst.items():
                alt.extend(named)
            unique_sets.append(tuple(alt))
        agg = N.Aggregate(plan, tuple(grouping), tuple(specs),
                          tuple(passengers), tuple(unique_sets))
        new_scope = Scope(
            [FieldRef(n, e.dtype, self._binding_of(scope, n), self._column_of(scope, n),
                      self._table_of(scope, n))
             for n, e in keys]
            + [FieldRef(s.name, s.dtype, "", s.name) for s in specs]
        )
        return agg, new_scope, agg_map, key_map

    def _split_passengers(self, keys, scope):
        """Partition group keys into (grouping, passengers)."""
        by_binding: dict[str, list[tuple[str, Expr]]] = {}
        fmap = {f.name: f for f in scope.fields}
        for n, e in keys:
            f = fmap.get(n)
            b = f.binding if f is not None and f.table is not None else None
            by_binding.setdefault(b, []).append((n, e))
        grouping: list[tuple[str, Expr]] = []
        passengers: list[tuple[str, Expr]] = []
        bij_subst: dict[tuple[str, ...], tuple[str, ...]] = {}

        def narrow(t: DataType) -> bool:
            return not (t.kind is TypeKind.BYTES and t.width > 7)

        for b, ks in by_binding.items():
            if b is None:
                grouping.extend(ks)
                continue
            f0 = fmap[ks[0][0]]
            uks = self.catalog.unique_keys(f0.table) if f0.table else ()
            cols = {fmap[n].column for n, _ in ks}
            # declared functional dependencies (connector metadata, e.g.
            # tpcds i_brand <- i_brand_id): a determined column whose
            # determinants are all among the keys rides as a passenger
            fdeps = self.catalog.func_deps(f0.table) if f0.table else {}
            if fdeps:
                # closure-grounded demotion: a key may become a
                # passenger only when it is in the functional CLOSURE of
                # the keys that would remain — sound under transitive
                # chains (b<-a, c<-b demotes both b and c) AND under
                # cyclic declared deps (b<-c, c<-b keeps one of them;
                # naive one-shot demotion collapsed the grouping)
                def closure(base: set) -> set:
                    out = set(base)
                    grew = True
                    while grew:
                        grew = False
                        for c, dets in fdeps.items():
                            if c not in out and set(dets) <= out:
                                out.add(c)
                                grew = True
                    return out

                remaining = list(ks)
                det = []
                for k in list(remaining):
                    if len(remaining) == 1:
                        break
                    cand_cols = {
                        fmap[n].column for n, _ in remaining if n != k[0]
                    }
                    if fmap[k[0]].column in closure(cand_cols):
                        remaining = [x for x in remaining if x[0] != k[0]]
                        det.append(k)
                if det:
                    passengers.extend(det)
                    ks = remaining
                    cols = {fmap[n].column for n, _ in ks}
                    if not ks:
                        continue
            chosen = None
            for uk in uks:
                if set(uk) <= cols and all(
                    narrow(fmap[n].dtype) for n, _ in ks if fmap[n].column in set(uk)
                ):
                    chosen = set(uk)
                    break
            if chosen is not None:
                for n, e in ks:
                    if fmap[n].column in chosen:
                        grouping.append((n, e))
                    else:
                        passengers.append((n, e))
                continue
            if all(narrow(e.dtype) for _, e in ks):
                # all keys groupable directly — no dependency tricks
                grouping.extend(ks)
                continue
            # hidden-PK grouping (only when a wide BYTES key forces it):
            # the named keys COVER some unique key of the relation (so
            # row groups == named-key groups, a bijection), but that key
            # is wide — substitute a narrow unique key from the child
            # scope and demote every named key to a passenger.
            covered = any(set(uk) <= cols for uk in uks)
            hidden = None
            if covered:
                for uk in uks:
                    fs = [
                        f for c in uk
                        for f in scope.fields
                        if f.binding == b and f.column == c
                    ]
                    if len(fs) == len(uk) and all(narrow(f.dtype) for f in fs):
                        hidden = fs
                        break
            if hidden is not None:
                for f in hidden:
                    grouping.append((f.name, InputRef(f.dtype, f.name)))
                passengers.extend(ks)
                # bijection: named-key groups == hidden-PK groups, so
                # the named keys covering a unique key of the relation
                # (the smallest covered one — tighter unique sets make
                # more joins provably unique) substitute for the hidden
                # PK in the alternative unique set
                cover = min(
                    (set(uk) for uk in uks if set(uk) <= cols),
                    key=len,
                )
                bij_subst[tuple(f.name for f in hidden)] = tuple(
                    n for n, _ in ks if fmap[n].column in cover
                )
                continue
            grouping.extend(ks)
        # wide BYTES group keys are supported directly (chunked int64
        # surrogates); the unique-key/FD demotions above remain as
        # optimizations, not requirements
        return grouping, passengers, bij_subst

    def _binding_of(self, scope, name):
        for f in scope.fields:
            if f.name == name:
                return f.binding
        return ""

    def _column_of(self, scope, name):
        for f in scope.fields:
            if f.name == name:
                return f.column
        return name

    def _table_of(self, scope, name):
        for f in scope.fields:
            if f.name == name:
                return f.table
        return None

    def _plan_one_agg(self, a: A.FunctionCall, scope, outer, ctes, scalar_binds,
                      distinct_keys_out):
        """One AST aggregate -> ([AggSpec...], post-agg Expr). ``avg`` is
        ``sum`` and ``count`` with a DOUBLE ``div`` above the Aggregate,
        as in the JAX package. ``count(DISTINCT x)`` appends its key
        ``(name, x)`` to ``distinct_keys_out`` and counts that key after
        the pre-aggregation ``_plan_aggregate`` adds."""
        nm = self.fresh(a.name)
        if a.name == "count":
            if a.is_star or not a.args:
                return [AggSpec("count_star", None, nm, BIGINT)], InputRef(BIGINT, nm)
            arg = self._expr(a.args[0], scope, outer, ctes, scalar_binds)
            if a.distinct:
                dk = self.fresh("dkey")
                distinct_keys_out.append((dk, arg))
                spec = AggSpec("count_distinct", InputRef(arg.dtype, dk), nm, BIGINT)
                return [spec], InputRef(BIGINT, nm)
            return [AggSpec("count", arg, nm, BIGINT)], InputRef(BIGINT, nm)
        arg = self._expr(a.args[0], scope, outer, ctes, scalar_binds)
        if a.distinct:
            raise AnalysisError(f"DISTINCT {a.name} not supported")
        if a.name == "avg":
            s = self.fresh("avgsum")
            c = self.fresh("avgcnt")
            sum_t = self._sum_type(arg.dtype)
            specs = [AggSpec("sum", arg, s, sum_t), AggSpec("count", arg, c, BIGINT)]
            return specs, Call(DOUBLE, "div", (InputRef(sum_t, s), InputRef(BIGINT, c)))
        if a.name == "sum":
            t = self._sum_type(arg.dtype)
            return [AggSpec("sum", arg, nm, t)], InputRef(t, nm)
        if a.name in ("min", "max"):
            return [AggSpec(a.name, arg, nm, arg.dtype)], InputRef(arg.dtype, nm)
        if a.name in ("stddev_samp", "stddev", "var_samp", "variance"):
            # (sum x, sum x^2, count): var = (q - s^2/c) / (c - 1); c <= 1
            # gives NULL through the division by zero
            d = Call(DOUBLE, "cast_double", (arg,))
            s, qn, c = self.fresh("vsum"), self.fresh("vsq"), self.fresh("vcnt")
            specs = [AggSpec("sum", d, s, DOUBLE),
                     AggSpec("sum", Call(DOUBLE, "mul", (d, d)), qn, DOUBLE),
                     AggSpec("count", arg, c, BIGINT)]
            sr, qr, cr = InputRef(DOUBLE, s), InputRef(DOUBLE, qn), InputRef(BIGINT, c)
            mean_sq = Call(DOUBLE, "div", (Call(DOUBLE, "mul", (sr, sr)), cr))
            var = Call(DOUBLE, "div", (Call(DOUBLE, "sub", (qr, mean_sq)),
                                       Call(BIGINT, "sub", (cr, Literal(BIGINT, 1)))))
            if a.name in ("stddev_samp", "stddev"):
                # a rounding-negative variance clamps to 0 before the root
                clamped = Call(DOUBLE, "if", (Call(BOOLEAN, "lt", (var, Literal(DOUBLE, 0.0))),
                                              Literal(DOUBLE, 0.0), var))
                return specs, Call(DOUBLE, "sqrt", (clamped,))
            return specs, var
        raise AnalysisError(f"unknown aggregate {a.name}")

    def _sum_type(self, t: DataType) -> DataType:
        if t.kind is TypeKind.DECIMAL:
            return decimal(38, t.scale)
        if t.kind is TypeKind.INTEGER:
            return BIGINT
        return t

    # ------------------------------------------------------------------
    # subquery predicates: EXISTS / IN as semi and anti joins, scalar
    # comparisons, the <> EXISTS rewrite and the mark join
    # ------------------------------------------------------------------
    def _as_plain_query(self, q: A.Node) -> A.Query:
        """A set operation as ``SELECT * FROM (<set>)``, so the subquery
        rewrites (which read a Query's fields) take it in IN / EXISTS /
        scalar positions. A correlated reference inside the set does not
        resolve (the outer scope is not threaded through the wrapper)."""
        if isinstance(q, A.SetQuery):
            return A.Query(select=(A.SelectItem(A.Star(), None),),
                           from_=A.SubqueryRelation(q, self.fresh("u")))
        return q

    def _apply_subquery_pred(self, c, plan, scope, outer, ctes, scalar_binds):
        # EXISTS / NOT EXISTS
        node = c
        negated = False
        while isinstance(node, A.UnaryOp) and node.op == "not":
            negated = not negated
            node = node.operand
        if isinstance(node, A.Exists):
            return self._plan_exists(
                self._as_plain_query(node.query), negated != node.negated,
                plan, scope, ctes,
            )
        if isinstance(node, A.InSubquery):
            value = self._expr(node.value, scope, outer, ctes, scalar_binds)
            sub_plan, _sub_scope = self._analyze_query(
                self._as_plain_query(node.query), None, ctes
            )
            inner = sub_plan.child if isinstance(sub_plan, N.Output) else sub_plan
            key_name = (
                sub_plan.sources[0] if isinstance(sub_plan, N.Output)
                else inner.field_names()[0]
            )
            kf = {f.name: f for f in inner.fields}[key_name]
            return N.SemiJoin(
                plan, inner, (value,), (InputRef(kf.dtype, kf.name),),
                negated != node.negated,
            )
        if isinstance(node, A.BinaryOp) and node.op in _CMP_OPS:
            # comparison against a scalar subquery
            sub = None
            other = None
            flip = False
            if isinstance(node.right, A.ScalarSubquery):
                sub, other = node.right, node.left
            elif isinstance(node.left, A.ScalarSubquery):
                sub, other, flip = node.left, node.right, True
            if sub is not None:
                return self._plan_scalar_compare(
                    node.op, other, sub.query, negated, flip, plan, scope, outer,
                    ctes, scalar_binds,
                )
        if isinstance(node, A.Between) and not negated and not node.negated:
            # BETWEEN with scalar-subquery bounds: split into two range
            # conjuncts and plan each
            for op_, bound in ((">=", node.low), ("<=", node.high)):
                c2 = A.BinaryOp(op_, node.value, bound)
                if self._contains_subquery(c2):
                    plan = self._apply_subquery_pred(
                        c2, plan, scope, outer, ctes, scalar_binds
                    )
                else:
                    plan = N.Filter(
                        plan, self._expr(c2, scope, outer, ctes, scalar_binds)
                    )
            return plan
        if isinstance(node, A.BinaryOp) and node.op in ("or", "and") and not negated:
            # a boolean combination of EXISTS leaves: the mark join
            return self._apply_mark_bool(node, plan, scope, outer, ctes,
                                         scalar_binds)
        raise AnalysisError(f"unsupported subquery predicate: {type(node).__name__}")

    def _apply_mark_bool(self, c, plan, scope, outer, ctes, scalar_binds):
        """Rewrite a boolean expression whose subquery leaves are all
        positive equality-correlated EXISTS: each leaf adds a mark
        column to ``plan``; the expression is then a plain filter."""
        added: list[FieldRef] = []

        def walk(n):
            nonlocal plan
            if isinstance(n, A.Exists):
                if n.negated:
                    raise AnalysisError(
                        "NOT EXISTS inside OR predicates is not supported"
                    )
                plan, mark = self._plan_exists_mark(
                    self._as_plain_query(n.query), plan, scope, ctes
                )
                added.append(mark)
                return A.Identifier((mark.column,))
            if isinstance(n, (A.InSubquery, A.ScalarSubquery)):
                raise AnalysisError(
                    "only EXISTS is supported inside OR predicates"
                )
            if isinstance(n, A.BinaryOp):
                return A.BinaryOp(n.op, walk(n.left), walk(n.right))
            if isinstance(n, A.UnaryOp):
                return A.UnaryOp(n.op, walk(n.operand))
            return n

        new_ast = walk(c)
        ext = Scope(list(scope.fields) + added)
        pred = self._expr(new_ast, ext, outer, ctes, scalar_binds)
        return N.Filter(plan, pred)

    def _plan_exists_mark(self, sub_q: A.Query, plan, scope, ctes):
        """Plan one EXISTS as a mark: dedup the inner correlation keys
        (GROUP BY -> unique build), LEFT-join them onto ``plan``, and
        project a BOOLEAN mark = key-matched. Returns (plan, mark_field)."""
        probe = self._inner_scope_probe(sub_q, ctes)
        new_where, corr, neq = self._split_correlation(sub_q, probe, scope, ctes)
        if not corr or neq:
            raise AnalysisError(
                "EXISTS inside OR must be equality-correlated"
            )
        inner_cols = tuple(A.Identifier(ip) for _, ip in corr)
        rewritten = A.Query(
            select=tuple(A.SelectItem(ic, None) for ic in inner_cols),
            from_=sub_q.from_, where=new_where, group_by=inner_cols,
        )
        sub_plan, _ = self._analyze_query(rewritten, None, ctes)
        inner = sub_plan.child if isinstance(sub_plan, N.Output) else sub_plan
        sources = (sub_plan.sources if isinstance(sub_plan, N.Output)
                   else inner.field_names())
        imap = {f.name: f for f in inner.fields}
        carried = self.fresh("mark")
        ren = N.Project(
            inner,
            tuple(
                (carried if f.name == sources[0] else f.name,
                 InputRef(f.dtype, f.name))
                for f in inner.fields
            ),
        )
        right_keys = tuple(
            InputRef(imap[s].dtype, carried if i == 0 else s)
            for i, s in enumerate(sources)
        )
        left_keys = tuple(
            InputRef(scope.resolve(op_).dtype, scope.resolve(op_).name)
            for op_, _ in corr
        )
        joined = N.Join(plan, ren, "left", left_keys, right_keys, True,
                        (carried,))
        mark_name = self.fresh("markb")
        kd = imap[sources[0]].dtype
        exprs = tuple(
            (f.name, InputRef(f.dtype, f.name))
            for f in joined.fields if f.name != carried
        ) + ((mark_name, Call(BOOLEAN, "is_not_null",
                              (InputRef(kd, carried),))),)
        return (
            N.Project(joined, exprs),
            FieldRef(mark_name, BOOLEAN, "", mark_name, None),
        )

    def _split_correlation(self, q: A.Query, inner_scope_probe, outer_scope: Scope,
                           ctes):
        """Analyze a possibly-correlated subquery: returns
        (decorrelated_query_where, corr_pairs, neq_pairs) where each
        pair list holds (outer_parts, inner_parts) from ``=`` / ``<>``
        conjuncts correlating inner and outer columns."""
        corr = []
        neq = []
        keep = []
        if q.where is not None:
            for c in conjuncts(q.where):
                if (isinstance(c, A.BinaryOp) and c.op in ("=", "<>")
                        and isinstance(c.left, A.Identifier)
                        and isinstance(c.right, A.Identifier)):
                    sink = corr if c.op == "=" else neq
                    li = inner_scope_probe(c.left.parts)
                    ri = inner_scope_probe(c.right.parts)
                    lo = outer_scope.try_resolve(c.left.parts) if outer_scope else None
                    ro = outer_scope.try_resolve(c.right.parts) if outer_scope else None
                    if li is None and lo is not None and ri is not None:
                        sink.append((c.left.parts, c.right.parts))
                        continue
                    if ri is None and ro is not None and li is not None:
                        sink.append((c.right.parts, c.left.parts))
                        continue
                keep.append(c)
        new_where = None
        for c in keep:
            new_where = c if new_where is None else A.BinaryOp("and", new_where, c)
        return new_where, corr, neq

    def _inner_scope_probe(self, q: A.Query, ctes):
        """Build a resolver over the subquery's own FROM scope."""
        rels: list[Rel] = []
        edges: list[dict] = []
        if q.from_ is not None:
            self._flatten_from(q.from_, rels, edges, ctes, None)
        sc = Scope([f for r in rels for f in r.scope.fields])
        return lambda parts: sc.try_resolve(parts)

    def _plan_exists(self, sub_q: A.Query, negated: bool, plan, scope, ctes):
        probe = self._inner_scope_probe(sub_q, ctes)
        new_where, corr, neq = self._split_correlation(sub_q, probe, scope, ctes)
        if not corr:
            raise AnalysisError("uncorrelated EXISTS not supported")
        if neq:
            return self._plan_exists_with_neq(sub_q, negated, plan, scope, ctes,
                                              new_where, corr, neq)
        inner_cols = tuple(A.Identifier(ip) for _, ip in corr)
        rewritten = A.Query(
            select=tuple(A.SelectItem(ic, None) for ic in inner_cols),
            from_=sub_q.from_, where=new_where,
        )
        sub_plan, _sub_scope = self._analyze_query(rewritten, None, ctes)
        inner = sub_plan.child if isinstance(sub_plan, N.Output) else sub_plan
        sources = sub_plan.sources if isinstance(sub_plan, N.Output) else inner.field_names()
        imap = {f.name: f for f in inner.fields}
        right_keys = tuple(InputRef(imap[s].dtype, s) for s in sources)
        left_keys = []
        for op_, _ in corr:
            f = scope.resolve(op_)
            left_keys.append(InputRef(f.dtype, f.name))
        return N.SemiJoin(plan, inner, tuple(left_keys), right_keys, negated)

    def _plan_exists_with_neq(self, sub_q, negated, plan, scope, ctes,
                              new_where, corr, neq):
        """EXISTS with equality correlation plus ONE ``<>`` correlation
        (Q21 shape): per correlation group, gather min/max of the inner
        inequality column; 'another row with a different value exists'
        iff min <> X or max <> X. NOT EXISTS keeps the rows with no
        group (min NULL) or a group of X alone."""
        if len(neq) > 1:
            raise AnalysisError("at most one <> correlation supported in EXISTS")
        outer_x, inner_y = neq[0]
        rewritten = A.Query(
            select=(
                A.SelectItem(A.FunctionCall("min", (A.Identifier(inner_y),)), "mn"),
                A.SelectItem(A.FunctionCall("max", (A.Identifier(inner_y),)), "mx"),
            )
            + tuple(
                A.SelectItem(A.Identifier(ip), f"ck{i}")
                for i, (_, ip) in enumerate(corr)
            ),
            from_=sub_q.from_, where=new_where,
            group_by=tuple(A.Identifier(ip) for _, ip in corr),
        )
        sub_plan, _ = self._analyze_query(rewritten, None, ctes)
        inner = sub_plan.child if isinstance(sub_plan, N.Output) else sub_plan
        sources = sub_plan.sources if isinstance(sub_plan, N.Output) else inner.field_names()
        names = sub_plan.names if isinstance(sub_plan, N.Output) else sources
        smap = dict(zip(names, sources))
        imap = {f.name: f for f in inner.fields}
        mn_n, mx_n = self.fresh("exmn"), self.fresh("exmx")
        ren = N.Project(
            inner,
            tuple(
                (mn_n if f.name == smap["mn"] else mx_n if f.name == smap["mx"]
                 else f.name, InputRef(f.dtype, f.name))
                for f in inner.fields
            ),
        )
        right_keys = tuple(
            InputRef(imap[smap[f"ck{i}"]].dtype, smap[f"ck{i}"])
            for i in range(len(corr))
        )
        left_keys = tuple(
            InputRef(scope.resolve(op_).dtype, scope.resolve(op_).name)
            for op_, _ in corr
        )
        joined = N.Join(plan, ren, "left", left_keys, right_keys, True,
                        (mn_n, mx_n))
        xf = scope.resolve(outer_x)
        x = InputRef(xf.dtype, xf.name)
        mn = InputRef(imap[smap["mn"]].dtype, mn_n)
        mx = InputRef(imap[smap["mx"]].dtype, mx_n)
        matched = Call(BOOLEAN, "is_not_null", (mn,))
        if not negated:
            differs = Call(BOOLEAN, "or", (
                Call(BOOLEAN, "ne", (mn, x)), Call(BOOLEAN, "ne", (mx, x))))
            pred = Call(BOOLEAN, "and", (matched, differs))
        else:
            same = Call(BOOLEAN, "and", (
                Call(BOOLEAN, "eq", (mn, x)), Call(BOOLEAN, "eq", (mx, x))))
            pred = Call(BOOLEAN, "or", (Call(BOOLEAN, "is_null", (mn,)), same))
        return N.Filter(joined, pred)

    def _plan_scalar_compare(self, op, other_ast, sub_q: A.Query, negated, flip,
                             plan, scope, outer, ctes, scalar_binds):
        """``other <op> (subquery)``: uncorrelated, a ``ScalarValue``
        bound into an ``Unbound`` slot; equality-correlated, a group-by
        on the correlation columns joined (inner, unique) on them, so an
        outer row whose group is missing drops out."""
        sub_q = self._as_plain_query(sub_q)
        probe = self._inner_scope_probe(sub_q, ctes)
        new_where, corr, neq = self._split_correlation(sub_q, probe, scope, ctes)
        if neq:
            raise AnalysisError("<> correlation in scalar subquery unsupported")
        fn = _CMP_OPS[op]
        if not corr:
            # uncorrelated: ScalarValue binding
            sub_plan, sub_scope = self._analyze_query(sub_q, None, ctes)
            if len(sub_scope.fields) != 1:
                raise AnalysisError("scalar subquery must produce one column")
            sname = self.fresh("scalar")
            sdtype = sub_scope.fields[0].dtype
            scalar_binds.append(N.ScalarValue(sub_plan, sname, sdtype))
            other = self._expr(other_ast, scope, outer, ctes, scalar_binds)
            args = (Unbound(sdtype, sname), other) if flip else (other, Unbound(sdtype, sname))
            e = Call(BOOLEAN, fn, args)
            if negated:
                e = Call(BOOLEAN, "not", (e,))
            return N.Filter(plan, e)
        # correlated: decorrelate via group-by on correlation columns
        if len(sub_q.select) != 1:
            raise AnalysisError("correlated scalar subquery must select one value")
        val_name = "val"
        rewritten = A.Query(
            select=(A.SelectItem(sub_q.select[0].expr, val_name),)
            + tuple(A.SelectItem(A.Identifier(ip), f"ck{i}") for i, (_, ip) in enumerate(corr)),
            from_=sub_q.from_, where=new_where,
            group_by=tuple(A.Identifier(ip) for _, ip in corr),
        )
        sub_plan, sub_scope = self._analyze_query(rewritten, None, ctes)
        inner = sub_plan.child if isinstance(sub_plan, N.Output) else sub_plan
        # inner fields: val + ck0.. — via Output projection mapping
        sources = sub_plan.sources if isinstance(sub_plan, N.Output) else inner.field_names()
        names = sub_plan.names if isinstance(sub_plan, N.Output) else sources
        smap = dict(zip(names, sources))
        imap = {f.name: f for f in inner.fields}
        right_keys = tuple(
            InputRef(imap[smap[f"ck{i}"]].dtype, smap[f"ck{i}"])
            for i in range(len(corr))
        )
        left_keys = tuple(
            InputRef(scope.resolve(op_).dtype, scope.resolve(op_).name)
            for op_, _ in corr
        )
        vfield = imap[smap[val_name]]
        vname = self.fresh("subval")
        # rename the value column to avoid collisions
        ren = N.Project(
            inner,
            tuple(
                (vname if f.name == vfield.name else f.name,
                 InputRef(f.dtype, f.name))
                for f in inner.fields
            ),
        )
        joined = N.Join(
            plan, ren, "inner", left_keys, right_keys, True, (vname,)
        )
        other = self._expr(other_ast, scope, outer, ctes, scalar_binds)
        vref = InputRef(vfield.dtype, vname)
        args = (vref, other) if flip else (other, vref)
        e = Call(BOOLEAN, fn, args)
        if negated:
            e = Call(BOOLEAN, "not", (e,))
        return N.Filter(joined, e)

    # ------------------------------------------------------------------
    # window planning
    # ------------------------------------------------------------------
    def _plan_windows(self, win_calls, plan, scope, outer, ctes, scalar_binds,
                      agg_map, key_map):
        """Plan all window calls: one Window node per distinct OVER
        spec, chained (reference: WindowNode per window; the planner
        merges same-spec functions into one node)."""
        win_map: dict[A.FunctionCall, Expr] = {}
        groups: dict[A.WindowSpec, list[A.FunctionCall]] = {}
        for w in win_calls:
            groups.setdefault(w.over, []).append(w)
        new_fields: list[N.Field] = []
        for spec, calls in groups.items():
            part = tuple(
                self._expr(p, scope, outer, ctes, scalar_binds, agg_map, key_map)
                for p in spec.partition_by
            )
            okeys = tuple(
                SortKey(
                    self._expr(it.expr, scope, outer, ctes, scalar_binds,
                               agg_map, key_map),
                    it.descending, bool(it.nulls_first),
                )
                for it in spec.order_by
            )
            funcs: list[AggSpec] = []
            for w in calls:
                if w in win_map:
                    continue
                specs, mapped = self._plan_one_window_func(
                    w, spec, scope, outer, ctes, scalar_binds, agg_map, key_map
                )
                funcs.extend(specs)
                win_map[w] = mapped
            plan = N.Window(plan, part, okeys, tuple(funcs), spec.frame)
            # window outputs are NOT added to the name scope: they are
            # referenced only through Resolved slots, so SELECT * never
            # leaks the synthetic columns
            new_fields += [N.Field(f.name, f.dtype) for f in funcs]
        return plan, win_map, new_fields

    def _plan_one_window_func(self, w: A.FunctionCall, spec, scope, outer, ctes,
                              scalar_binds, agg_map, key_map):
        nm = self.fresh(w.name)
        if w.distinct:
            raise AnalysisError(f"DISTINCT in window function {w.name}")
        if w.name in WINDOW_ONLY_FUNCS:
            if w.args:
                raise AnalysisError(f"{w.name}() takes no arguments")
            if not spec.order_by:
                raise AnalysisError(f"{w.name}() requires ORDER BY in its window")
            return [AggSpec(w.name, None, nm, BIGINT)], InputRef(BIGINT, nm)
        if w.name in ("lag", "lead", "first_value"):
            if not spec.order_by:
                raise AnalysisError(f"{w.name}() requires ORDER BY in its window")
            offset = 1
            if w.name in ("lag", "lead") and len(w.args) == 2:
                if not isinstance(w.args[1], A.NumberLit):
                    raise AnalysisError(f"{w.name}() offset must be a literal")
                try:
                    offset = int(w.args[1].text)
                except ValueError:
                    raise AnalysisError(
                        f"{w.name}() offset must be an integer literal, "
                        f"got {w.args[1].text!r}"
                    ) from None
            elif len(w.args) != 1:
                raise AnalysisError(f"{w.name}() takes one argument")
            arg = self._expr(w.args[0], scope, outer, ctes, scalar_binds,
                             agg_map, key_map)
            spec_ = AggSpec(w.name, arg, nm, arg.dtype, offset=offset)
            return [spec_], InputRef(arg.dtype, nm)
        if w.name == "count":
            if w.is_star or not w.args:
                return [AggSpec("count_star", None, nm, BIGINT)], InputRef(BIGINT, nm)
            arg = self._expr(w.args[0], scope, outer, ctes, scalar_binds,
                             agg_map, key_map)
            return [AggSpec("count", arg, nm, BIGINT)], InputRef(BIGINT, nm)
        if w.name not in AGG_FUNCS:
            raise AnalysisError(f"unknown window function {w.name}")
        if len(w.args) != 1:
            raise AnalysisError(f"{w.name}() window aggregate takes one argument")
        arg = self._expr(w.args[0], scope, outer, ctes, scalar_binds,
                         agg_map, key_map)
        if w.name == "avg":
            s, c = self.fresh("wavgsum"), self.fresh("wavgcnt")
            sum_t = self._sum_type(arg.dtype)
            specs = [AggSpec("sum", arg, s, sum_t), AggSpec("count", arg, c, BIGINT)]
            return specs, Call(DOUBLE, "div", (InputRef(sum_t, s), InputRef(BIGINT, c)))
        if w.name == "sum":
            t = self._sum_type(arg.dtype)
            return [AggSpec("sum", arg, nm, t)], InputRef(t, nm)
        # min / max: numeric and dictionary VARCHAR (order-preserving
        # codes); raw byte strings have no 1-D scan representation
        if arg.dtype.kind is TypeKind.BYTES:
            raise AnalysisError(
                f"{w.name}() window over byte-string columns is not supported"
            )
        return [AggSpec(w.name, arg, nm, arg.dtype)], InputRef(arg.dtype, nm)

    # ------------------------------------------------------------------
    # order-by resolution
    # ------------------------------------------------------------------
    def _order_expr(self, e, out_scope, pre_scope, outer, ctes, scalar_binds,
                    agg_map, key_map, src_map=None):
        if isinstance(e, A.Identifier) and len(e.parts) == 1:
            f = out_scope.try_resolve(e.parts)
            if f is not None:
                return InputRef(f.dtype, f.name)
            if src_map:
                # ORDER BY a source column that the select ALIASES
                # (ORDER BY c_customer_id with `c_customer_id as id`)
                f = pre_scope.try_resolve(e.parts)
                if f is not None and f.name in src_map:
                    return InputRef(f.dtype, src_map[f.name])
        if isinstance(e, A.Identifier) and len(e.parts) > 1 and src_map:
            # qualified ref (ORDER BY t.col): resolve in the FROM scope,
            # then map back to the output column that projects it — the
            # Sort sits above the projection
            f = pre_scope.try_resolve(e.parts)
            if f is not None and f.name in src_map:
                return InputRef(f.dtype, src_map[f.name])
        if isinstance(e, A.NumberLit):
            idx = int(e.text) - 1
            f = out_scope.fields[idx]
            return InputRef(f.dtype, f.name)
        # fall back: expression over output scope fields by column name
        return self._expr(e, out_scope, outer, ctes, scalar_binds,
                          agg_map=agg_map, key_map=key_map)

    # ------------------------------------------------------------------
    # expression building
    # ------------------------------------------------------------------
    def _expr(self, n: A.Node, scope: Scope, outer, ctes, scalar_binds,
              agg_map=None, key_map=None) -> Expr:
        if isinstance(n, A.Resolved):
            return n.expr
        if key_map and n in key_map:
            name, t = key_map[n]
            return InputRef(t, name)
        if agg_map and isinstance(n, A.FunctionCall) and n in agg_map:
            return agg_map[n]
        if isinstance(n, A.FunctionCall) and n.over is not None:
            raise AnalysisError(
                f"window function {n.name}() is only allowed in SELECT/ORDER BY"
            )
        if isinstance(n, A.Identifier):
            if n.parts == ("null",):
                raise AnalysisError("bare NULL literal needs a typed context")
            f = scope.resolve(n.parts)
            return InputRef(f.dtype, f.name)
        if isinstance(n, A.NumberLit):
            return self._number(n.text)
        if isinstance(n, A.StringLit):
            return Literal(DataType(TypeKind.VARCHAR), n.value)
        if isinstance(n, A.DateLit):
            days = int(
                (np.datetime64(n.value, "D") - np.datetime64("1970-01-01", "D")).astype(int)
            )
            return Literal(DATE, days)
        if isinstance(n, A.TimestampLit):
            return Literal(TIMESTAMP, TIMESTAMP.to_physical(n.value))
        if isinstance(n, A.Placeholder):
            raise AnalysisError(
                f"cannot infer the type of parameter ?{n.ordinal + 1}: use "
                "it in a comparison or arithmetic with a typed operand"
            )
        if isinstance(n, A.BinaryOp):
            # placeholder typing: one side a ``?``, the other typed; the
            # parameter takes the typed side's type
            l_ph = isinstance(n.left, A.Placeholder)
            r_ph = isinstance(n.right, A.Placeholder)
            if (l_ph or r_ph) and n.op in (_CMP_OPS | _ARITH_OPS):
                if l_ph and r_ph:
                    raise AnalysisError(
                        "cannot infer parameter types: both comparison "
                        "sides are ?")
                typed = self._expr(n.right if l_ph else n.left, scope, outer,
                                   ctes, scalar_binds, agg_map, key_map)
                ph = self._param(n.left if l_ph else n.right, typed.dtype)
                l, r = (ph, typed) if l_ph else (typed, ph)
                if n.op in _CMP_OPS:
                    return Call(BOOLEAN, _CMP_OPS[n.op], (l, r))
                fn = _ARITH_OPS[n.op]
                return Call(result_type(fn, [l.dtype, r.dtype]), fn, (l, r))
            if n.op in ("and", "or"):
                l = self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map)
                r = self._expr(n.right, scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(BOOLEAN, n.op, (l, r))
            if n.op in _CMP_OPS:
                l = self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map)
                r = self._expr(n.right, scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(BOOLEAN, _CMP_OPS[n.op], (l, r))
            if n.op == "||":
                return self._concat(n, scope, outer, ctes, scalar_binds, agg_map, key_map)
            if n.op in _ARITH_OPS:
                # date +/- interval folding
                folded = self._fold_date_arith(n, scope, outer, ctes, scalar_binds,
                                               agg_map, key_map)
                if folded is not None:
                    return folded
                l = self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map)
                r = self._expr(n.right, scope, outer, ctes, scalar_binds, agg_map, key_map)
                fn = _ARITH_OPS[n.op]
                t = result_type(fn, [l.dtype, r.dtype])
                return Call(t, fn, (l, r))
            raise AnalysisError(f"unknown operator {n.op}")
        if isinstance(n, A.UnaryOp):
            if n.op == "not":
                return Call(BOOLEAN, "not", (self._expr(n.operand, scope, outer, ctes,
                                                        scalar_binds, agg_map, key_map),))
            v = self._expr(n.operand, scope, outer, ctes, scalar_binds, agg_map, key_map)
            return Call(v.dtype, "neg", (v,))
        if isinstance(n, A.Between):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)

            def bound(b):
                if isinstance(b, A.Placeholder):
                    return self._param(b, v.dtype)
                return self._expr(b, scope, outer, ctes, scalar_binds, agg_map, key_map)

            e = Call(BOOLEAN, "between", (v, bound(n.low), bound(n.high)))
            return Call(BOOLEAN, "not", (e,)) if n.negated else e
        if isinstance(n, A.InList):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            items = tuple(self._param(i, v.dtype) if isinstance(i, A.Placeholder)
                          else self._expr(i, scope, outer, ctes, scalar_binds, agg_map, key_map)
                          for i in n.items)
            e = Call(BOOLEAN, "in", (v,) + items)
            return Call(BOOLEAN, "not", (e,)) if n.negated else e
        if isinstance(n, A.IsNull):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            return Call(BOOLEAN, "is_not_null" if n.negated else "is_null", (v,))
        if isinstance(n, A.CaseExpr):
            return self._case(n, scope, outer, ctes, scalar_binds, agg_map, key_map)
        if isinstance(n, A.Cast):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            return self._cast(v, n.type_name)
        if isinstance(n, A.Like):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            if not isinstance(n.pattern, A.StringLit):
                raise AnalysisError("LIKE pattern must be a literal")
            e = Call(BOOLEAN, "like", (v, Literal(varchar(), n.pattern.value)))
            return Call(BOOLEAN, "not", (e,)) if n.negated else e
        if isinstance(n, A.Extract):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            field = {"dow": "day_of_week", "doy": "day_of_year"}.get(n.field, n.field)
            if field not in ("year", "month", "day", "quarter", "day_of_week",
                             "day_of_year", "hour", "minute", "second"):
                raise AnalysisError(f"EXTRACT({n.field}) unsupported")
            return Call(INTEGER, field, (v,))
        if isinstance(n, A.Substring):
            return self._substring(n, scope, outer, ctes, scalar_binds, agg_map, key_map)
        if isinstance(n, A.FunctionCall):
            if n.name in AGG_FUNCS:
                raise AnalysisError(f"aggregate {n.name} in scalar context")
            if n.name in ("year", "month", "day"):
                v = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(INTEGER, n.name, (v,))
            if n.name == "abs":
                v = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(v.dtype, "abs", (v,))
            if n.name in ("upper", "lower"):
                v = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                if v.dtype.kind is not TypeKind.BYTES:
                    raise AnalysisError(f"{n.name}() requires a BYTES string")
                return Call(v.dtype, n.name, (v,))
            if n.name in ("sqrt", "floor", "ceil", "ceiling"):
                v = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(DOUBLE, "ceil" if n.name == "ceiling" else n.name, (v,))
            if n.name == "round":
                v = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                if len(n.args) == 2:
                    # round(x, n): multiply, round, divide in DOUBLE
                    if not isinstance(n.args[1], A.NumberLit):
                        raise AnalysisError("round() scale must be a literal")
                    scale = Literal(DOUBLE, float(10 ** int(n.args[1].text)))
                    scaled = Call(DOUBLE, "mul", (Call(DOUBLE, "cast_double", (v,)), scale))
                    return Call(DOUBLE, "div", (Call(DOUBLE, "round", (scaled,)), scale))
                return Call(DOUBLE, "round", (v,))
            if n.name == "nullif":
                a = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                b = self._expr(n.args[1], scope, outer, ctes, scalar_binds, agg_map, key_map)
                eq = Call(BOOLEAN, "eq", (a, b))
                return Call(a.dtype, "if", (eq, Literal(a.dtype, None), a))
            if n.name == "coalesce":
                args = tuple(self._expr(a, scope, outer, ctes, scalar_binds, agg_map, key_map)
                             for a in n.args)
                return Call(result_type("coalesce", [a.dtype for a in args]), "coalesce", args)
            handled = self._scalar_function(n, scope, outer, ctes, scalar_binds,
                                            agg_map, key_map)
            if handled is not None:
                return handled
            raise AnalysisError(f"unknown function {n.name}")
        if isinstance(n, A.ScalarSubquery):
            # scalar subquery in a value position (uncorrelated only)
            sub_plan, sub_scope = self._analyze_any(n.query, None, ctes)
            if len(sub_scope.fields) != 1:
                raise AnalysisError("scalar subquery must produce one column")
            sname = self.fresh("scalar")
            t = sub_scope.fields[0].dtype
            scalar_binds.append(N.ScalarValue(sub_plan, sname, t))
            return Unbound(t, sname)
        raise AnalysisError(f"unsupported expression {type(n).__name__}")

    def _case(self, n: A.CaseExpr, scope, outer, ctes, scalar_binds, agg_map, key_map):
        """Simple and searched CASE -> ``case(when1, then1, ..., [else])``.
        A bare NULL branch takes the common type of the typed branches."""
        def is_bare_null(x):
            return isinstance(x, A.Identifier) and x.parts == ("null",)

        values = [v for _, v in n.whens]
        if n.else_ is not None:
            values.append(n.else_)
        analyzed: list[Expr | None] = [
            None if is_bare_null(v)
            else self._expr(v, scope, outer, ctes, scalar_binds, agg_map, key_map)
            for v in values
        ]
        if any(e is None for e in analyzed):
            typed = [e.dtype for e in analyzed if e is not None]
            if not typed:
                raise AnalysisError("CASE with only NULL branches")
            null_t = result_type("coalesce", typed)
            analyzed = [Literal(null_t, None) if e is None else e for e in analyzed]
        args: list[Expr] = []
        for (c, _), v in zip(n.whens, analyzed):
            if n.operand is not None:
                c = A.BinaryOp("=", n.operand, c)
            args.extend([self._expr(c, scope, outer, ctes, scalar_binds, agg_map, key_map), v])
        if n.else_ is not None:
            args.append(analyzed[-1])
        return Call(result_type("case", [a.dtype for a in args]), "case", tuple(args))

    #: argument counts of the scalar functions (the JAX package's table)
    _ARITY = {"quarter": 1, "day_of_week": 1, "dow": 1, "day_of_year": 1, "doy": 1,
              "last_day_of_month": 1, "hour": 1, "minute": 1, "second": 1,
              "date_trunc": 2, "date_add": 3, "date_diff": 3,
              "length": 1, "char_length": 1, "character_length": 1,
              "trim": 1, "ltrim": 1, "rtrim": 1, "reverse": 1,
              "strpos": 2, "replace": 3, "split_part": 3, "regexp_like": 2,
              "power": 2, "pow": 2, "exp": 1, "ln": 1, "log10": 1, "log2": 1,
              "truncate": 1, "sign": 1, "mod": 2}

    def _scalar_function(self, n: A.FunctionCall, scope, outer, ctes, scalar_binds,
                         agg_map, key_map) -> Expr | None:
        """The math, string and date function library: arity checks,
        literal arguments folded into the function's name where the JAX
        package folds them. None for an unknown name (the caller
        raises)."""
        want = self._ARITY.get(n.name)
        if want is not None and len(n.args) != want:
            raise AnalysisError(f"{n.name}() expects {want} argument(s), got {len(n.args)}")
        if n.name == "substr" and len(n.args) not in (2, 3):
            raise AnalysisError("substr() expects 2 or 3 arguments")
        if n.name in ("greatest", "least") and len(n.args) < 2:
            raise AnalysisError(f"{n.name}() expects at least 2 arguments")

        def sub(i):
            return self._expr(n.args[i], scope, outer, ctes, scalar_binds, agg_map, key_map)

        def str_lit(i, what):
            a = n.args[i]
            if not isinstance(a, A.StringLit):
                raise AnalysisError(f"{n.name}() {what} must be a string literal")
            return a.value

        def int_lit(i, what):
            a = n.args[i]
            neg = False
            if isinstance(a, A.UnaryOp) and a.op == "-":
                neg, a = True, a.operand
            if not isinstance(a, A.NumberLit):
                raise AnalysisError(f"{n.name}() {what} must be an integer literal")
            return -int(a.text) if neg else int(a.text)

        name = n.name
        if name in ("hour", "minute", "second"):
            return Call(INTEGER, name, (sub(0),))
        if name in ("quarter", "day_of_week", "dow", "day_of_year", "doy"):
            canon = {"dow": "day_of_week", "doy": "day_of_year"}.get(name, name)
            return Call(INTEGER, canon, (sub(0),))
        if name == "last_day_of_month":
            return Call(DATE, "last_day_of_month", (sub(0),))
        if name == "date_trunc":
            v = sub(1)
            return Call(v.dtype, date_trunc_fn(str_lit(0, "unit")), (v,))
        if name == "date_add":
            return Call(DATE, date_add_fn(str_lit(0, "unit")), (sub(1), sub(2)))
        if name == "date_diff":
            return Call(BIGINT, date_diff_fn(str_lit(0, "unit")), (sub(1), sub(2)))
        if name in ("length", "char_length", "character_length"):
            return Call(INTEGER, "length", (sub(0),))
        if name in ("trim", "ltrim", "rtrim", "reverse"):
            v = sub(0)
            return Call(v.dtype, name, (v,))
        if name == "strpos":
            v = sub(0)
            return Call(INTEGER, "strpos", (v, Literal(varchar(), str_lit(1, "needle"))))
        if name == "replace":
            v = sub(0)
            return Call(v.dtype, "replace", (v, Literal(varchar(), str_lit(1, "search")),
                                             Literal(varchar(), str_lit(2, "replacement"))))
        if name == "split_part":
            v = sub(0)
            fn = split_part_fn(str_lit(1, "separator"), int_lit(2, "index"))
            return Call(v.dtype, fn, (v,))
        if name == "regexp_like":
            v = sub(0)
            return Call(BOOLEAN, "regexp_like", (v, Literal(varchar(), str_lit(1, "pattern"))))
        if name == "substr":
            length = A.NumberLit(str(int_lit(2, "length"))) if len(n.args) >= 3 else None
            return self._expr(A.Substring(n.args[0], n.args[1], length), scope, outer, ctes,
                              scalar_binds, agg_map, key_map)
        if name in ("greatest", "least"):
            args = tuple(sub(i) for i in range(len(n.args)))
            t = args[0].dtype
            for a in args[1:]:
                t = common_super_type(t, a.dtype)
            return Call(t, name, args)
        if name in ("power", "pow"):
            return Call(DOUBLE, "power", (sub(0), sub(1)))
        if name in ("exp", "ln", "log10", "log2", "truncate"):
            return Call(DOUBLE, name, (sub(0),))
        if name == "sign":
            return Call(INTEGER, "sign", (sub(0),))
        if name == "mod":
            a, b = sub(0), sub(1)
            return Call(common_super_type(a.dtype, b.dtype), "mod", (a, b))
        return None

    def _concat(self, n: A.BinaryOp, scope, outer, ctes, scalar_binds, agg_map,
                key_map) -> Expr:
        """``a || b`` over BYTES and string literals: fixed_bytes of the
        summed widths, chained concats flattened into one call."""
        width = 0
        args: tuple = ()
        for side in (self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map),
                     self._expr(n.right, scope, outer, ctes, scalar_binds, agg_map, key_map)):
            if side.dtype.kind is TypeKind.BYTES:
                width += side.dtype.width
            elif isinstance(side, Literal) and side.dtype.kind is TypeKind.VARCHAR:
                width += len(side.value)
            else:
                raise AnalysisError("|| requires string operands")
            args += side.args if isinstance(side, Call) and side.fn == "concat" else (side,)
        return Call(fixed_bytes(width), "concat", args)

    def _cast(self, v: Expr, type_name: str) -> Expr:
        """CAST to DOUBLE, BIGINT (``int``/``integer`` too),
        ``decimal(p,s)``, VARCHAR (``varchar(n)`` too: fixed-width text),
        TIMESTAMP and DATE."""
        if type_name == "double":
            return Call(DOUBLE, "cast_double", (v,))
        if type_name in ("bigint", "int", "integer"):
            return Call(BIGINT, "cast_bigint", (v,))
        if type_name.startswith("decimal"):
            m = re.match(r"decimal\((\d+),(\d+)\)", type_name)
            if not m:
                raise AnalysisError(f"bad decimal type {type_name}")
            fn = rescale_decimal(int(m.group(2)))
            return Call(decimal(int(m.group(1)), int(m.group(2))), fn, (v,))
        if type_name == "varchar" or type_name.startswith("varchar("):
            m = re.match(r"varchar\((\d+)\)", type_name)
            if v.dtype.kind is TypeKind.VARCHAR and m is None:
                return v  # identity
            if m is not None:
                w = int(m.group(1))
            elif v.dtype.kind is TypeKind.BYTES:
                w = v.dtype.width
            else:
                w = {TypeKind.INTEGER: 11, TypeKind.BIGINT: 20, TypeKind.DATE: 10,
                     TypeKind.TIMESTAMP: 19}.get(v.dtype.kind)
                if w is None and v.dtype.kind is TypeKind.DECIMAL:
                    w = v.dtype.precision + 2
                if w is None:
                    raise AnalysisError(f"cast {v.dtype} to varchar unsupported")
            return Call(fixed_bytes(w), cast_varchar_fn(w), (v,))
        if type_name == "timestamp":
            if isinstance(v, Literal) and isinstance(v.value, str):
                return Literal(TIMESTAMP, v.value)
            if v.dtype.kind is TypeKind.TIMESTAMP:
                return v
            if v.dtype.kind is TypeKind.DATE:
                return Call(TIMESTAMP, "cast_timestamp", (v,))
            if v.dtype.kind is TypeKind.VARCHAR:
                return Call(TIMESTAMP, parse_timestamp_fn(), (v,))
            raise AnalysisError(f"cast {v.dtype} to timestamp unsupported")
        if type_name == "date":
            if isinstance(v, Literal) and isinstance(v.value, str):
                return Literal(DATE, v.value)  # parsed on the host by to_physical
            if v.dtype.kind is TypeKind.DATE:
                return v
            if v.dtype.kind is TypeKind.VARCHAR:
                return Call(DATE, parse_date_fn(), (v,))
            raise AnalysisError(f"cast {v.dtype} to date unsupported")
        raise AnalysisError(f"unsupported cast to {type_name}")

    def _substring(self, n: A.Substring, scope, outer, ctes, scalar_binds,
                   agg_map, key_map) -> Expr:
        """SUBSTRING with literal bounds: over dictionary VARCHAR a derived
        dictionary (a negative start counts from the end), over BYTES the
        static byte slice."""
        v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
        start_node = n.start
        start_neg = False
        if isinstance(start_node, A.UnaryOp) and start_node.op == "-":
            start_neg, start_node = True, start_node.operand
        if not (isinstance(start_node, A.NumberLit)
                and (n.length is None or isinstance(n.length, A.NumberLit))):
            raise AnalysisError("SUBSTRING bounds must be literals")
        start = -int(start_node.text) if start_neg else int(start_node.text)
        if start < 1 and v.dtype.kind is not TypeKind.VARCHAR:
            raise AnalysisError("negative SUBSTRING start requires a dictionary VARCHAR")
        if v.dtype.kind is TypeKind.VARCHAR:
            length = int(n.length.text) if n.length is not None else 1 << 20
            return Call(v.dtype, substr_dict_fn(start, length), (v,))
        length = int(n.length.text) if n.length is not None else v.dtype.width - start + 1
        return Call(fixed_bytes(length), substr_fn(start, length), (v,))

    def _number(self, text: str) -> Literal:
        if "." in text:
            frac = text.split(".")[1]
            scale = len(frac)
            prec = len(text.replace(".", ""))
            return Literal(decimal(prec, scale), float(text))
        v = int(text)
        return Literal(INTEGER if -(2**31) <= v < 2**31 else BIGINT, v)

    def _fold_date_arith(self, n: A.BinaryOp, scope, outer, ctes, scalar_binds,
                         agg_map, key_map) -> Expr | None:
        """date_literal +/- interval -> folded DATE literal (calendar
        math on the host at plan time)."""
        if n.op not in ("+", "-"):
            return None
        if not isinstance(n.right, A.IntervalLit):
            return None
        base = self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map)
        if not (isinstance(base, Literal) and base.dtype == DATE):
            raise AnalysisError("interval arithmetic only on date literals")
        amount = int(n.right.value) * (1 if n.op == "+" else -1)
        d = np.datetime64("1970-01-01", "D") + np.int64(base.value)
        if n.right.unit == "day":
            d2 = d + amount
        elif n.right.unit == "month":
            m = d.astype("datetime64[M]") + amount
            rem = (d - d.astype("datetime64[M]").astype("datetime64[D]")).astype(int)
            d2 = m.astype("datetime64[D]") + rem
        else:  # year
            y = d.astype("datetime64[Y]") + amount
            rem = (d - d.astype("datetime64[Y]").astype("datetime64[D]")).astype(int)
            d2 = y.astype("datetime64[D]") + rem
        days = int((d2 - np.datetime64("1970-01-01", "D")).astype(int))
        return Literal(DATE, days)

