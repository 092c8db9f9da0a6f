"""Static value-interval inference over plans and expressions.

Counterpart of ``presto_tpu/plan/bounds.py``: connector statistics
bound each column's PHYSICAL values (scaled ints for decimals, day
numbers for dates, dictionary codes for varchars) as a closed
[lo, hi]; ``None`` means unbounded or unknown. The planner reads these
intervals for ``AggSpec.value_bits``, the dense join domain and the
fused probe's table domain, and the coarse row and group estimates
for capacities and the aggregation bypass. Bounds are advisory: every
consumer has a runtime guard with an exact fallback, so a wrong stat
can cost time but never a wrong answer.
"""

from __future__ import annotations

import math
from typing import Optional

from presto_tpu_torch.expr import Call, Expr, InputRef, Literal
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.types import DataType, TypeKind

Interval = Optional[tuple[int, int]]


def _hull(a: Interval, b: Interval) -> Interval:
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def _rescale(iv: Interval, src: DataType, dst: DataType) -> Interval:
    """Mirror ``_to_physical`` for decimal/integer rescaling."""
    if iv is None:
        return None
    s_src = src.scale if src.kind is TypeKind.DECIMAL else 0
    s_dst = dst.scale if dst.kind is TypeKind.DECIMAL else 0
    if s_dst >= s_src:
        f = 10 ** (s_dst - s_src)
        return (iv[0] * f, iv[1] * f)
    f = 10 ** (s_src - s_dst)
    # round-half-away bound: |x/f| rounded <= |x|/f + 1
    lo = -(abs(iv[0]) // f + 1) if iv[0] < 0 else iv[0] // f
    hi = iv[1] // f + 1 if iv[1] > 0 else -(abs(iv[1]) // f)
    return (lo, hi)


_INTEGERISH = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DECIMAL, TypeKind.DATE)


def expr_interval(e: Expr, env: dict[str, Interval]) -> Interval:
    """Physical-value interval of ``e`` given column intervals ``env``."""
    if e.dtype.kind not in _INTEGERISH and e.dtype.kind is not TypeKind.BOOLEAN:
        return None  # floats/strings: no lane bound needed or derivable
    if isinstance(e, InputRef):
        return env.get(e.name)
    if isinstance(e, Literal):
        if e.value is None:
            return (0, 0)  # NULL slots hold the physical fill value 0
        try:
            v = int(e.dtype.to_physical(e.value))
        except (TypeError, ValueError):
            return None
        return (v, v)
    if not isinstance(e, Call):
        return None
    args = e.args

    def arg_iv(i: int, target: DataType | None = None) -> Interval:
        iv = expr_interval(args[i], env)
        if target is not None and iv is not None:
            return _rescale(iv, args[i].dtype, target)
        return iv

    fn = e.fn
    if fn in ("add", "sub"):
        a, b = arg_iv(0, e.dtype), arg_iv(1, e.dtype)
        if a is None or b is None:
            return None
        if fn == "add":
            return (a[0] + b[0], a[1] + b[1])
        return (a[0] - b[1], a[1] - b[0])
    if fn == "mul":
        a, b = arg_iv(0), arg_iv(1)
        if a is None or b is None:
            return None
        prods = [x * y for x in a for y in b]
        lo, hi = min(prods), max(prods)
        if e.dtype.kind is TypeKind.DECIMAL:
            sa = args[0].dtype.scale if args[0].dtype.kind is TypeKind.DECIMAL else 0
            sb = args[1].dtype.scale if args[1].dtype.kind is TypeKind.DECIMAL else 0
            excess = sa + sb - e.dtype.scale
            if excess > 0:
                f = 10**excess
                lo = -(abs(lo) // f + 1) if lo < 0 else lo // f
                hi = hi // f + 1 if hi > 0 else -(abs(hi) // f)
        return (lo, hi)
    if fn == "neg":
        a = arg_iv(0)
        return None if a is None else (-a[1], -a[0])
    if fn == "abs":
        a = arg_iv(0)
        if a is None:
            return None
        return (0 if a[0] <= 0 <= a[1] else min(abs(a[0]), abs(a[1])),
                max(abs(a[0]), abs(a[1])))
    if fn == "cast_bigint":
        return arg_iv(0, e.dtype)
    if fn in ("if", "case"):
        # if(cond, then, else); case(when1, then1, ..., [else])
        if fn == "if":
            branches = list(args[1:])
            out: Interval = None
        else:
            branches = [a for i, a in enumerate(args) if i % 2 == 1] + (
                [args[-1]] if len(args) % 2 == 1 else []
            )
            # an un-elsed CASE yields the physical fill 0 on no match
            out = (0, 0) if len(args) % 2 == 0 else None
        for i, b in enumerate(branches):
            iv = expr_interval(b, env)
            iv = None if iv is None else _rescale(iv, b.dtype, e.dtype)
            out = iv if i == 0 and out is None else _hull(out, iv)
            if out is None:
                return None
        return out
    if fn == "coalesce":
        out = None
        for i, a in enumerate(args):
            iv = expr_interval(a, env)
            iv = None if iv is None else _rescale(iv, a.dtype, e.dtype)
            out = iv if i == 0 else _hull(out, iv)
            if out is None:
                return None
        return out
    if fn == "year":
        return (0, 9999)
    if fn == "month":
        return (1, 12)
    if fn == "day":
        return (1, 31)
    if fn in ("eq", "ne", "lt", "le", "gt", "ge", "and", "or", "not",
              "between", "in", "is_null", "is_not_null", "like",
              "starts_with"):
        return (0, 1)
    if fn == "mod":
        b = arg_iv(1, e.dtype)
        if b is None:
            return None
        m = max(abs(b[0]), abs(b[1]))
        return (-m, m) if m else (0, 0)
    return None  # div and anything unknown: unbounded


def _stats_interval(stats, dtype: DataType) -> Interval:
    # the ONE logical->physical stats scaling rule, shared with scan
    # narrowing (spi.narrowed_schema): intervals and narrowed storage
    # must be derived identically or a narrowed column could hold
    # values its declared interval excludes
    from presto_tpu_torch.spi import stats_physical_interval

    return stats_physical_interval(stats, dtype)


def node_intervals(node: N.PlanNode, catalog) -> dict[str, Interval]:
    """Per-output-column physical intervals for a plan subtree.

    Conservative: anything not provably bounded maps to None. Filters
    pass their child through un-refined (a tighter bound is never
    required for correctness — the runtime guard has the last word).
    """
    if isinstance(node, N.TableScan):
        out: dict[str, Interval] = {}
        for (name, src), t in zip(node.columns, node.types):
            out[name] = _stats_interval(
                catalog.stats(node.connector, node.table, src), t
            )
        return out
    if isinstance(node, N.Project):
        env = node_intervals(node.child, catalog)
        return {n: expr_interval(e, env) for n, e in node.exprs}
    if isinstance(node, N.Aggregate):
        env = node_intervals(node.child, catalog)
        out = {n: expr_interval(e, env) for n, e in node.keys}
        for n, e in node.passengers:
            out[n] = expr_interval(e, env)
        for a in node.aggs:
            out[a.name] = None  # running sums: unbounded without row counts
        return out
    if isinstance(node, (N.Join,)):
        out = dict(node_intervals(node.left, catalog))
        right = node_intervals(node.right, catalog)
        if node.kind == "left":
            # unmatched probe rows carry the physical fill 0 on build cols
            right = {n: _hull(iv, (0, 0)) for n, iv in right.items()}
        out.update(right)
        return out
    if isinstance(node, N.SemiJoin):
        # a filter-only join: its rows (and their bounds) are the left's
        env = node_intervals(node.left, catalog)
        return {f.name: env.get(f.name) for f in node.fields}
    children = node.children
    if len(children) == 1:
        env = node_intervals(children[0], catalog)
        return {f.name: env.get(f.name) for f in node.fields}
    if children:
        # first child wins: BindScalars emits its first child's fields,
        # so a same-named column of a scalar subplan never shadows it;
        # a Union takes its first input's intervals, as in the JAX
        # package (advisory: the kernels' runtime guards decide)
        out = {}
        for c in children:
            for n, iv in node_intervals(c, catalog).items():
                out.setdefault(n, iv)
        return {f.name: out.get(f.name) for f in node.fields}
    return {f.name: None for f in node.fields}


def resolve_source_column(node: N.PlanNode, name: str):
    """Trace an output column back to its (connector, table, source
    column) through rename/project/filter/join chains; None when the
    column is computed. Lets the planner answer metadata questions
    (dictionary domains, stats) without scanning any data."""
    if isinstance(node, N.TableScan):
        for n, src in node.columns:
            if n == name:
                return (node.connector, node.table, src)
        return None
    if isinstance(node, N.Project):
        for n, e in node.exprs:
            if n == name:
                if isinstance(e, InputRef):
                    return resolve_source_column(node.child, e.name)
                return None
        return None
    if isinstance(node, N.Aggregate):
        for n, e in list(node.keys) + list(node.passengers):
            if n == name:
                if isinstance(e, InputRef):
                    return resolve_source_column(node.child, e.name)
                return None
        return None
    if isinstance(node, N.Join):
        if name in {f.name for f in node.left.fields}:
            return resolve_source_column(node.left, name)
        return resolve_source_column(node.right, name)
    if isinstance(node, N.SemiJoin):
        return resolve_source_column(node.left, name)
    children = node.children
    if len(children) == 1:
        return resolve_source_column(children[0], name)
    return None


def key_dictionary(node: N.PlanNode, name: str, catalog):
    """The ordered dictionary behind an output column, via metadata."""
    src = resolve_source_column(node, name)
    if src is None:
        return None
    connector, table, col = src
    conn = catalog.connector(connector)
    if not hasattr(conn, "dictionaries"):
        return None
    return conn.dictionaries(table).get(col)


def estimate_rows(node: N.PlanNode, catalog) -> int:
    """Coarse output-row estimate from connector stats. Used to size
    sort-strategy group capacities up front; always backed by the
    capacity-overflow retry loop, so a bad estimate costs a replay,
    never a wrong answer."""
    if isinstance(node, N.TableScan):
        conn = catalog.connector(node.connector)
        rows = int(conn.row_count(node.table)) if hasattr(conn, "row_count") else 1 << 16
        return max(1, rows // (3 if node.predicate is not None else 1))
    if isinstance(node, N.Filter):
        return max(1, estimate_rows(node.child, catalog) // 3)
    if isinstance(node, N.Aggregate):
        return max(1, estimate_rows(node.child, catalog) // 8)
    if isinstance(node, N.Join):
        left = estimate_rows(node.left, catalog)
        if node.unique:
            return left
        return max(left, estimate_rows(node.right, catalog))
    if isinstance(node, N.SemiJoin):
        return estimate_rows(node.left, catalog)
    if isinstance(node, N.TopN):
        return node.count
    if isinstance(node, N.Limit):
        return node.count
    if isinstance(node, N.Union):
        return sum(estimate_rows(c, catalog) for c in node.inputs)
    children = node.children
    if children:
        return max(estimate_rows(c, catalog) for c in children)
    return 1 << 10


def estimate_groups(node: "N.Aggregate", catalog) -> Optional[int]:
    """NDV-based group-cardinality estimate for a keyed Aggregate, or
    None when any key's distinct-value count is unknowable from
    metadata. The product of per-key NDVs (dictionary domain size for
    VARCHAR keys, connector ``stats.ndv`` for source-traceable numeric
    keys), clamped by the child's estimated rows — the left-hand side
    of the partial-aggregation bypass rule (*Partial Partial
    Aggregates* / *Global Hash Tables Strike Back!*): when groups
    approach rows, pre-aggregating per morsel reduces nothing."""
    if not isinstance(node, N.Aggregate) or not node.keys:
        return None
    prod = 1
    for name, e in node.keys:
        if not isinstance(e, InputRef):
            return None
        d = key_dictionary(node.child, name, catalog)
        if d is not None:
            prod *= max(len(d), 1)
            continue
        src = resolve_source_column(node.child, name)
        if src is None:
            return None
        stats = catalog.stats(*src)
        ndv = getattr(stats, "ndv", None) if stats is not None else None
        if not ndv:
            return None
        prod *= max(int(ndv), 1)
        if prod > (1 << 40):  # clamp before the product explodes
            break
    return max(1, min(prod, estimate_rows(node.child, catalog)))


def agg_value_bits(agg: N.Aggregate, catalog) -> list[int]:
    """``value_bits`` for each of ``agg.aggs`` (63 when unbounded)."""
    env = node_intervals(agg.child, catalog)
    out = []
    for a in agg.aggs:
        bits = 63
        if (
            a.kind == "sum"
            and a.input is not None
            and a.input.dtype.kind in _INTEGERISH
        ):
            iv = expr_interval(a.input, env)
            if iv is not None:
                bits = max(1, max(abs(iv[0]), abs(iv[1])).bit_length())
        out.append(min(bits, 63))
    return out


def upper_bound_rows(node: N.PlanNode, catalog) -> Optional[int]:
    """SOUND output-row upper bound from connector stats, or None. Unlike
    ``estimate_rows`` this never divides: only row counts, unique-build
    joins, limits and unions propagate."""
    ub = upper_bound_rows
    if isinstance(node, N.TableScan):
        conn = catalog.connector(node.connector)
        if hasattr(conn, "row_count"):
            return int(conn.row_count(node.table))
        return None
    if isinstance(node, (N.Filter, N.Project, N.Window, N.Sort, N.BindScalars, N.Output)):
        return ub(node.child, catalog)
    if isinstance(node, (N.ScalarValue, N.Values)):
        return 1
    if isinstance(node, N.Aggregate):
        c = ub(node.child, catalog)
        if not node.keys:
            # a keyless aggregate emits one row even over an empty input
            return 1 if c is None else max(1, c)
        return c
    if isinstance(node, N.Join):
        if node.unique and node.kind in ("inner", "left"):
            return ub(node.left, catalog)
        return None
    if isinstance(node, N.SemiJoin):
        return ub(node.left, catalog)
    if isinstance(node, (N.TopN, N.Limit)):
        c = ub(node.child, catalog)
        return node.count if c is None else min(c, node.count)
    if isinstance(node, N.Union):
        parts = [ub(c, catalog) for c in node.inputs]
        return None if any(p is None for p in parts) else sum(parts)
    return None


def is_unfiltered(node: N.PlanNode) -> bool:
    """True when ``upper_bound_rows`` is EXACT for this subtree: no
    predicate anywhere below."""
    if isinstance(node, N.TableScan):
        return node.predicate is None
    if isinstance(node, (N.Project, N.BindScalars)):
        return is_unfiltered(node.child)
    return isinstance(node, (N.Values, N.ScalarValue))


def estimate_record(node: N.PlanNode, catalog) -> dict:
    """The planner's full row prediction for one node (the plan-time half
    of EXPLAIN ANALYZE's estimate-vs-actual): ``estimate_rows``, the
    sound ``upper_bound_rows`` (None when unprovable), and whether that
    bound is exact."""
    ub = upper_bound_rows(node, catalog)
    return {
        "est_rows": estimate_rows(node, catalog),
        "upper_bound_rows": ub,
        "exact": ub is not None and is_unfiltered(node),
    }
