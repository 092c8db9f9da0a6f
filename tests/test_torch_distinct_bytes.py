"""DISTINCT and BYTES sort and group keys in the port against the JAX
package, exactly:

- ``ops/sort.bytes_sort_chunks`` and ``sort_indices`` over BYTES keys of
  widths crossing the 7-byte chunk edges (1-16, 40), with rows that
  differ only in zero against space padding (PAD SPACE: equal), NULLs
  first and last, ascending and descending, beside an integer key;
- the sort-strategy ``HashAggregationOperator`` grouping on BYTES keys
  (NULL keys their own group, zero and space padding one group, the
  state merged over several batches);
- through both ``Session.sql``s at sf 0.01 (frames and dtypes, the
  strategy counters) and both analyzers at sf 0.01 and SF1 (plans):
  ``SELECT DISTINCT``, ``count(DISTINCT ...)`` beside the plain
  aggregates it can combine with, ORDER BY and GROUP BY on BYTES columns
  (NULL-extended ones included) and on substrings of every width from 1
  to 40, and the SQL forms of unary minus, IN / NOT IN, CASE, IS [NOT]
  NULL, COALESCE, NULLIF and CAST, leaf fragments whose filter or value
  holds OR, IN or CASE included (the same leaf-route fallback reason);
  ``count(*)`` beside a DISTINCT aggregate is refused by both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import presto_tpu.exec.operators as JO
import presto_tpu.expr as JE
import presto_tpu.ops.sort as jsort
import presto_tpu.types as JT
import presto_tpu_torch.exec.operators as PO
import presto_tpu_torch.expr as PE
import presto_tpu_torch.ops.sort as psort
import presto_tpu_torch.types as PT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.sql.analyzer import AnalysisError as JAnalysisError
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.sql.analyzer import AnalysisError as PAnalysisError
from test_torch_sql import plan_shape
from torch_bridge import assert_same, port_batch

WIDTHS = [1, 6, 7, 8, 13, 14, 15, 16, 40]


def byte_rows(rng, n: int, width: int) -> np.ndarray:
    """Rows of 'a', 'b' and spaces with zero tails of random length, and
    pairs that differ only in a space against a zero padding byte."""
    alphabet = np.frombuffer(b"ab ", np.uint8)
    rows = alphabet[rng.integers(0, 3, (n, width))]
    rows[np.arange(width)[None, :] >= rng.integers(0, width + 1, n)[:, None]] = 0
    twin = rows[: n // 4].copy()
    twin[twin == 0] = 32  # the same values, space-padded
    rows[n // 4: n // 4 + len(twin)] = twin
    return rows


@pytest.mark.parametrize("width", WIDTHS)
def test_bytes_sort_chunks_equal_reference(width):
    data = byte_rows(np.random.default_rng(width), 257, width)
    got = psort.bytes_sort_chunks(torch.from_numpy(data))
    want = jsort.bytes_sort_chunks(jnp.asarray(data))
    assert len(got) == len(want) == -(-width // 7)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("nulls_first", [False, True])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_sort_indices_on_bytes_keys_equal_reference(width, descending, nulls_first):
    """A BYTES key with NULLs, then an int key in the other direction;
    rows tie on both often, so the order of ties is compared too."""
    rng = np.random.default_rng(100 + width)
    n = 301
    data = byte_rows(rng, n, width)
    valid = rng.random(n) > 0.15
    ints = rng.integers(-3, 3, n).astype(np.int32)
    live = rng.random(n) > 0.1
    args = dict(descending=[descending, not descending], nulls_first=[nulls_first, False])
    got = psort.sort_indices([torch.from_numpy(data), torch.from_numpy(ints)],
                             live=torch.from_numpy(live),
                             valids=[torch.from_numpy(valid), None], **args)
    want = jsort.sort_indices([jnp.asarray(data), jnp.asarray(ints)], live=jnp.asarray(live),
                              valids=[jnp.asarray(valid), None], **args)
    assert_same(got, np.asarray(want).astype(np.int64))


def _agg_batch(seed: int, width: int) -> JBatch:
    rng = np.random.default_rng(seed)
    n = 200
    live = rng.random(n) > 0.1
    cols = {
        "s": JColumn(jnp.asarray(byte_rows(rng, n, width)), jnp.asarray(rng.random(n) > 0.2),
                     JT.fixed_bytes(width)),
        "k": JColumn(jnp.asarray(rng.integers(0, 3, n).astype(np.int32)), jnp.asarray(live),
                     JT.INTEGER),
        "x": JColumn(jnp.asarray(rng.integers(-50, 50, n).astype(np.int16)),
                     jnp.asarray(rng.random(n) > 0.1), JT.INTEGER.with_physical(np.int16)),
    }
    return JBatch(cols, jnp.asarray(live))


def _agg_operator(m, T, O, width: int):
    keys = [("s", m.col("s", T.fixed_bytes(width))), ("k", m.col("k", T.INTEGER))]
    x = m.col("x", T.INTEGER.with_physical(np.int16))
    aggs = [O.AggSpec("count_star", None, "n", T.BIGINT), O.AggSpec("sum", x, "sx", T.BIGINT),
            O.AggSpec("min", x, "mn", T.INTEGER), O.AggSpec("count", x, "cx", T.BIGINT)]
    return O.HashAggregationOperator(keys, aggs, O.SortStrategy(1024)) if O is JO else \
        O.HashAggregationOperator(keys, aggs, O.SortStrategy(1024), device="cpu")


@pytest.mark.parametrize("width", [1, 7, 8, 15])
def test_bytes_group_keys_equal_reference(width):
    """Three batches folded into one sort-strategy state: the groups (keys,
    their validity and bytes), presence and every aggregate equal."""
    jop, pop = _agg_operator(JE, JT, JO, width), _agg_operator(PE, PT, PO, width)
    for seed in range(3):
        jb = _agg_batch(1000 * width + seed, width)
        jop.process(jb)
        pop.process(port_batch(jb))
    (want,), (got,) = jop.finish(), pop.finish()
    assert_same(got.live, want.live, "present")
    assert bool(got.live.sum() > 10)
    for name in ("s", "k", "n", "sx", "mn", "cx"):
        assert_same(got[name].data, want[name].data, name)
        assert_same(got[name].valid, want[name].valid, f"{name} valid")
        assert str(got[name].dtype) == str(want[name].dtype)


# ---------------------------------------------------------------------------
# SQL through both sessions
# ---------------------------------------------------------------------------

STATEMENTS = {
    "distinct": "select distinct l_returnflag, l_linestatus from lineitem "
                "order by l_returnflag, l_linestatus",
    "distinct bytes": "select distinct substring(c_phone, 1, 2) as cc from customer "
                      "order by cc desc",
    "count distinct": "select count(distinct l_suppkey) as n from lineitem",
    "count distinct grouped": "select l_returnflag, count(distinct l_suppkey) as n, "
                              "sum(l_quantity) as q, min(l_discount) as mn, max(l_tax) as mx, "
                              "avg(l_quantity) as a, count(l_comment) as c from lineitem "
                              "group by l_returnflag order by l_returnflag",
    "count distinct bytes key": "select substring(c_phone, 1, 2) as cc, "
                                "count(distinct c_mktsegment) as nn, sum(c_acctbal) as bal "
                                "from customer group by substring(c_phone, 1, 2) order by cc",
    "order bytes desc, or, minus": "select c_name, c_acctbal from customer "
                                   "where c_acctbal > 9990 or c_acctbal < -999 "
                                   "order by c_name desc",
    "order bytes nulls first": "select c_custkey, o_clerk from customer left join orders "
                               "on c_custkey = o_custkey and o_orderdate < date '1992-01-20' "
                               "where c_custkey < 400 order by o_clerk desc nulls first, "
                               "c_custkey",
    "order bytes nulls last": "select c_custkey, o_clerk from customer left join orders "
                              "on c_custkey = o_custkey and o_orderdate < date '1992-01-20' "
                              "where c_custkey < 400 order by o_clerk, c_custkey desc",
    "group bytes with nulls": "select o_clerk, count(*) as n from customer left join orders "
                              "on c_custkey = o_custkey and o_orderdate < date '1992-03-01' "
                              "group by o_clerk order by n desc, o_clerk",
    "group bytes top-n": "select substring(c_address, 1, 8) as a, count(*) as n from customer "
                         "group by substring(c_address, 1, 8) order by n desc, a limit 20",
    **{f"order substring {w}": f"select substring(c_address, 1, {w}) as a, c_custkey "
                               f"from customer where c_custkey < 300 order by a desc, c_custkey"
       for w in (1, 6, 7, 8, 12, 13, 14, 15)},
    **{f"group substring {w}": f"select substring(c_address, 1, {w}) as a, count(*) as n, "
                               f"sum(c_acctbal) as b from customer "
                               f"group by substring(c_address, 1, {w}) order by a"
       for w in (1, 2, 7, 14)},
    "order full bytes": "select c_address, c_custkey from customer where c_custkey < 200 "
                        "order by c_address desc, c_custkey",
    "unary minus": "select -l_quantity as nq, -l_discount as nd, -l_linenumber as nl "
                   "from lineitem where l_orderkey < 10 order by nq, nd, nl",
    "cast": "select l_orderkey, l_linenumber, cast(l_quantity as double) as d, "
            "cast(l_discount as bigint) as b, cast(l_extendedprice as decimal(12,1)) as e, "
            "cast(l_linenumber as integer) as i from lineitem where l_orderkey < 8 "
            "order by l_orderkey, l_linenumber",
    "nullif, coalesce": "select nullif(l_linenumber, 1) as x, "
                        "coalesce(nullif(l_linenumber, 1), 99) as y from lineitem "
                        "where l_orderkey < 8",
    "not in": "select count(*) as n from lineitem where l_shipmode not in ('MAIL', 'SHIP', 'NOPE')",
    "in numbers": "select count(*) as n from lineitem where l_linenumber in (1, 3, 9) "
                  "and l_quantity in (1, 2.00, 50)",
    "simple case group": "select case l_shipmode when 'MAIL' then 1 when 'SHIP' then 2 end as k, "
                         "count(*) as n from lineitem group by case l_shipmode when 'MAIL' then 1 "
                         "when 'SHIP' then 2 end order by k",
    "case null branch": "select sum(case when l_quantity > 40 then null else l_quantity end) "
                        "as s, count(case when l_quantity > 40 then null else 1 end) as c "
                        "from lineitem",
    "is null": "select l_orderkey, l_quantity from lineitem where l_orderkey < 40 "
               "and (l_quantity is null or l_quantity > 30) and l_discount is not null "
               "order by l_orderkey, l_quantity",
    "null-extended case and coalesce": "select count(*) as n, sum(case when o_orderkey is null "
                                       "then 1 else 0 end) as u, sum(coalesce(o_totalprice, 0)) "
                                       "as t, count(o_orderkey) as k from customer left join "
                                       "orders on c_custkey = o_custkey and o_orderstatus = 'F'",
    # leaf fragments (scan -> filter -> aggregate) whose filter or value
    # holds OR, IN or CASE: the same route and fallback reason as the
    # reference (exec.leaf_route_fallback.*)
    "leaf or": "select sum(l_quantity) as q, count(*) as n from lineitem "
               "where l_discount < 0.02 or l_tax > 0.07",
    "leaf in": "select l_returnflag, count(*) as n from lineitem "
               "where l_linenumber in (1, 2) group by l_returnflag order by l_returnflag",
    "leaf case value": "select sum(case when l_discount > 0.05 then l_quantity else 0 end) as q "
                       "from lineitem where l_shipdate < date '1995-01-01'",
    "or across relations": "select count(*) as n from orders, customer where o_custkey = c_custkey "
                           "and (o_orderpriority = '1-URGENT' or c_mktsegment = 'BUILDING') "
                           "and o_orderkey < 3000",
}

ROUTES = ("join.strategy.", "exec.pallas_join_route", "agg.strategy.", "exec.leaf_",
          "join.filter_rows_")


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


def jax_run(conn, sql):
    before = REGISTRY.snapshot()
    df = JSession({"tpch": conn}, properties={"result_cache_enabled": False}).sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after.get(k, 0) - before.get(k, 0) for k in after if k.startswith(ROUTES)}
    return df, {k: int(v) for k, v in routes.items() if v}


def port_run(conn, sql):
    COUNTERS.clear()
    res = PSession({"tpch": conn}, device="cpu").sql(sql)
    return res, {k: v for k, v in COUNTERS.items() if k.startswith(ROUTES) and v}


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax_session(conns, name):
    want, want_routes = jax_run(conns[0], STATEMENTS[name])
    res, routes = port_run(conns[1], STATEMENTS[name])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert len(want) > 0


def test_nulls_are_exercised(conns):
    """The NULL cases above do meet NULLs: the null-extended BYTES key
    sorts and groups NULL rows, and the CASE without ELSE groups some."""
    for name, col in (("order bytes nulls first", "o_clerk"), ("group bytes with nulls", "o_clerk"),
                      ("simple case group", "k")):
        res, _ = port_run(conns[1], STATEMENTS[name])
        assert any(v is None for v in res.column(col)), name
    res, _ = port_run(conns[1], STATEMENTS["order bytes nulls first"])
    assert res.column("o_clerk")[0] is None


def test_count_star_beside_distinct_is_refused(conns):
    sql = ("select substring(c_phone, 1, 2) as cc, count(*) as n, count(distinct c_mktsegment) "
           "as nn from customer group by substring(c_phone, 1, 2)")
    with pytest.raises(JAnalysisError, match="count_star cannot combine with DISTINCT"):
        JSession({"tpch": conns[0]}).sql(sql)
    with pytest.raises(PAnalysisError, match="count_star cannot combine with DISTINCT"):
        PSession({"tpch": conns[1]}, device="cpu").sql(sql)


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_analyzer_builds_the_same_plan(plan_sessions, name):
    js, ps = plan_sessions
    want = plan_shape(js.plan(STATEMENTS[name]), js.catalog, j_join_strategy, j_agg_strategy,
                      j_value_bits)
    got = plan_shape(ps.plan(STATEMENTS[name]), ps.catalog, p_join_strategy, p_agg_strategy,
                     p_value_bits)
    assert got == want


def test_distinct_plans_an_aggregate_without_aggregates(plan_sessions):
    """SELECT DISTINCT is a keys-only Aggregate over the projection, and
    count(DISTINCT x) a pre-aggregation on the keys plus x."""
    _js, ps = plan_sessions
    plan = ps.plan(STATEMENTS["distinct"])
    kinds = []
    node = plan
    while node.children:
        kinds.append(type(node).__name__)
        if kinds[-1] == "Aggregate":
            assert node.aggs == () and [n for n, _ in node.keys] == ["l_returnflag",
                                                                     "l_linestatus"]
        node = node.children[0]
    assert kinds[:3] == ["Output", "Sort", "Aggregate"]
    plan = ps.plan(STATEMENTS["count distinct grouped"])
    aggs = []

    def walk(n):
        if type(n).__name__ == "Aggregate":
            aggs.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    outer, inner = aggs
    assert len(inner.keys) == 2 and [a.kind for a in outer.aggs][0] == "count"
    assert dataclasses.asdict(outer.aggs[0])["input"]["name"] == inner.keys[1][0]
