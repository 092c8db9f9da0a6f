"""Semantic analysis: AST -> typed logical plan (the ported subset).

Counterpart of ``presto_tpu/sql/analyzer.py`` for the SELECT shapes of
TPC-H Q1, Q3, Q6, Q9 and Q10 and the SSB Q1 flight and LIKE queries:
SELECT / FROM with comma joins (and explicit ``JOIN ... ON``) and derived
tables (``(SELECT ...) AS alias``) / WHERE conjuncts / GROUP BY (or
none: one keyless aggregate row) / ORDER BY / LIMIT; ``count``, ``sum``,
``avg`` (``sum`` / ``count`` in DOUBLE), ``min``, ``max``; DECIMAL and
DATE arithmetic, comparisons, [NOT] BETWEEN, [NOT] LIKE and NOT;
``SUBSTRING`` / ``substr`` over BYTES; ``EXTRACT`` (and the functions)
``year``, ``month`` and ``day``; ``date '...'`` literals and
``date +/- interval`` folding.
The relational planning is the JAX package's, copied: predicate
pushdown into the owning relation, greedy stats-driven join ordering,
unique-build detection from table keys, and functional-dependency
grouping (keys covered by a table's unique key ride as passengers), so
both packages build the same plan tree for the same statement.

Anything else (subquery predicates, CTEs, set operations, DISTINCT,
windows, grouping sets, OR, CASE, casts, the rest of the scalar function
library) raises ``NotSupported`` naming the construct.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from presto_tpu_torch.exec.operators import AggSpec, SortKey
from presto_tpu_torch.expr import Call, Expr, InputRef, Literal, result_type, substr_fn
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.catalog import Catalog, TableMeta
from presto_tpu_torch.runtime.errors import NotSupported, UserError
from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, DataType, TypeKind, decimal, fixed_bytes,
    varchar)

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

    # ------------------------------------------------------------------
    def fresh(self, base: str) -> str:
        self._uniq += 1
        return f"{base}${self._uniq}"

    def analyze(self, query: A.Node) -> N.PlanNode:
        # the gensym counter restarts per statement, as in the JAX
        # package, so both name the same internal fields alike
        self._uniq = 0
        if not isinstance(query, A.Query):
            raise _unsupported(f"statement {type(query).__name__}")
        plan, _scope = self._analyze_query(query, outer=None, ctes={})
        return plan

    def _analyze_query(
        self, q: A.Query, outer: Scope | None, ctes: dict[str, A.Query]
    ) -> tuple[N.PlanNode, Scope]:
        if q.ctes:
            raise _unsupported("WITH (common table expressions)")
        if q.distinct:
            raise _unsupported("SELECT DISTINCT")
        if any(isinstance(g, A.GroupingSets) for g in q.group_by):
            raise _unsupported("GROUPING SETS / ROLLUP / CUBE")
        for it in q.select:
            _reject_windows(it.expr)
        for ob in q.order_by:
            _reject_windows(ob.expr)

        # ---- FROM: relations + join graph -----------------------------
        rels: list[Rel] = []
        edges: list[dict] = []  # {a, b, akeys, bkeys, kind, residual}
        if q.from_ is None:
            raise _unsupported("SELECT without FROM")
        self._flatten_from(q.from_, rels, edges, ctes, outer)
        scope = Scope([f for r in rels for f in r.scope.fields])

        # ---- WHERE classification -------------------------------------
        residual: list[A.Node] = []
        sub_preds: list[A.Node] = []
        scalar_binds: list = []
        if q.where is not None:
            for c in conjuncts(q.where):
                self._classify_conjunct(
                    c, rels, edges, residual, sub_preds, scope, outer, ctes
                )
        if sub_preds:
            raise _unsupported("subquery predicates (EXISTS / IN / scalar)")

        # ---- order the joins ------------------------------------------
        plan = self._build_join_tree(rels, edges, scope)

        # residual filters (multi-relation, non-equi)
        for c in residual:
            e = self._expr(c, scope, outer, ctes, scalar_binds)
            plan = N.Filter(plan, e)

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
        plan = N.Project(plan, tuple(out_exprs))
        out_scope = Scope(
            [FieldRef(n, e.dtype, "", n) for n, e in out_exprs]
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
            if not isinstance(rel.query, A.Query):
                raise _unsupported(f"{type(rel.query).__name__} in a derived table")
            plan, sub_scope = self._analyze_query(rel.query, None, ctes)
            self._add_derived(rels, binding, plan, sub_scope)
            return
        if isinstance(rel, A.Join):
            if rel.kind != "inner" and rel.kind != "cross":
                raise _unsupported(f"{rel.kind.upper()} JOIN")
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
            edges.append(dict(kind="inner", left=nleft, akeys=akeys, bkeys=bkeys,
                              residual=res, nullable=set()))
            return
        raise _unsupported(f"relation {type(rel).__name__}")

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
        for a in uniq:
            specs_a, mapped = self._plan_one_agg(a, scope, outer, ctes, scalar_binds)
            specs.extend(specs_a)
            agg_map[a] = mapped

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

    def _plan_one_agg(self, a: A.FunctionCall, scope, outer, ctes, scalar_binds):
        """One AST aggregate -> ([AggSpec...], post-agg Expr). ``avg`` is
        ``sum`` and ``count`` with a DOUBLE ``div`` above the Aggregate,
        as in the JAX package."""
        if a.distinct:
            raise _unsupported(f"{a.name}(DISTINCT ...)")
        nm = self.fresh(a.name)
        if a.name == "count":
            if a.is_star or not a.args:
                return [AggSpec("count_star", None, nm, BIGINT)], InputRef(BIGINT, nm)
            arg = self._expr(a.args[0], scope, outer, ctes, scalar_binds)
            return [AggSpec("count", arg, nm, BIGINT)], InputRef(BIGINT, nm)
        if a.name not in ("sum", "avg", "min", "max"):
            raise _unsupported(f"aggregate {a.name}()")
        arg = self._expr(a.args[0], scope, outer, ctes, scalar_binds)
        if a.name == "avg":
            s = self.fresh("avgsum")
            c = self.fresh("avgcnt")
            sum_t = self._sum_type(arg.dtype)
            specs = [AggSpec("sum", arg, s, sum_t), AggSpec("count", arg, c, BIGINT)]
            return specs, Call(DOUBLE, "div", (InputRef(sum_t, s), InputRef(BIGINT, c)))
        if a.name == "sum":
            t = self._sum_type(arg.dtype)
            return [AggSpec("sum", arg, nm, t)], InputRef(t, nm)
        return [AggSpec(a.name, arg, nm, arg.dtype)], InputRef(arg.dtype, nm)

    def _sum_type(self, t: DataType) -> DataType:
        if t.kind is TypeKind.DECIMAL:
            return decimal(38, t.scale)
        if t.kind is TypeKind.INTEGER:
            return BIGINT
        return t

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
        if key_map and n in key_map:
            name, t = key_map[n]
            return InputRef(t, name)
        if agg_map and isinstance(n, A.FunctionCall) and n in agg_map:
            return agg_map[n]
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
        if isinstance(n, A.BinaryOp):
            if n.op == "and":
                l = self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map)
                r = self._expr(n.right, scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(BOOLEAN, n.op, (l, r))
            if n.op in _CMP_OPS:
                l = self._expr(n.left, scope, outer, ctes, scalar_binds, agg_map, key_map)
                r = self._expr(n.right, scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(BOOLEAN, _CMP_OPS[n.op], (l, r))
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
            raise _unsupported(f"operator {n.op!r}")
        if isinstance(n, A.UnaryOp):
            if n.op == "not":
                return Call(BOOLEAN, "not", (self._expr(n.operand, scope, outer, ctes,
                                                        scalar_binds, agg_map, key_map),))
            raise _unsupported(f"unary operator {n.op!r}")
        if isinstance(n, A.Between):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            lo = self._expr(n.low, scope, outer, ctes, scalar_binds, agg_map, key_map)
            hi = self._expr(n.high, scope, outer, ctes, scalar_binds, agg_map, key_map)
            e = Call(BOOLEAN, "between", (v, lo, hi))
            return Call(BOOLEAN, "not", (e,)) if n.negated else e
        if isinstance(n, A.Like):
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            if not isinstance(n.pattern, A.StringLit):
                raise AnalysisError("LIKE pattern must be a literal")
            e = Call(BOOLEAN, "like", (v, Literal(varchar(), n.pattern.value)))
            return Call(BOOLEAN, "not", (e,)) if n.negated else e
        if isinstance(n, A.Extract):
            if n.field not in ("year", "month", "day"):
                raise _unsupported(f"EXTRACT({n.field})")
            v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
            return Call(INTEGER, n.field, (v,))
        if isinstance(n, A.Substring):
            return self._substring(n, scope, outer, ctes, scalar_binds, agg_map, key_map)
        if isinstance(n, A.FunctionCall):
            if n.name in AGG_FUNCS:
                raise AnalysisError(f"aggregate {n.name} in scalar context")
            if n.name in ("year", "month", "day"):
                v = self._expr(n.args[0], scope, outer, ctes, scalar_binds, agg_map, key_map)
                return Call(INTEGER, n.name, (v,))
            if n.name == "substr":
                if len(n.args) not in (2, 3):
                    raise AnalysisError("substr() expects 2 or 3 arguments")
                length = None
                if len(n.args) == 3:
                    if not isinstance(n.args[2], A.NumberLit):
                        raise AnalysisError("substr() length must be an integer literal")
                    length = A.NumberLit(str(int(n.args[2].text)))
                return self._substring(A.Substring(n.args[0], n.args[1], length), scope,
                                       outer, ctes, scalar_binds, agg_map, key_map)
            raise _unsupported(f"function {n.name}()")
        raise _unsupported(f"expression {type(n).__name__}")

    def _substring(self, n: A.Substring, scope, outer, ctes, scalar_binds,
                   agg_map, key_map) -> Expr:
        """SUBSTRING with literal bounds over a BYTES column (the
        dictionary VARCHAR transform is not ported)."""
        v = self._expr(n.value, scope, outer, ctes, scalar_binds, agg_map, key_map)
        start_node = n.start
        start_neg = False
        if isinstance(start_node, A.UnaryOp) and start_node.op == "-":
            start_neg, start_node = True, start_node.operand
        if not (isinstance(start_node, A.NumberLit)
                and (n.length is None or isinstance(n.length, A.NumberLit))):
            raise AnalysisError("SUBSTRING bounds must be literals")
        start = -int(start_node.text) if start_neg else int(start_node.text)
        if v.dtype.kind is TypeKind.VARCHAR:
            raise _unsupported("SUBSTRING over dictionary VARCHAR")
        if start < 1:
            raise AnalysisError("negative SUBSTRING start requires a dictionary VARCHAR")
        if v.dtype.kind is not TypeKind.BYTES:
            raise _unsupported(f"SUBSTRING over {v.dtype}")
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


def _reject_windows(n) -> None:
    """Window calls (a FunctionCall with OVER) are outside the slice."""
    if isinstance(n, A.FunctionCall) and n.over is not None:
        raise _unsupported(f"window function {n.name}() OVER (...)")
    if isinstance(n, A.Node):
        for v in _ast_fields(n):
            _reject_windows(v)
    elif isinstance(n, tuple):
        for v in n:
            _reject_windows(v)
