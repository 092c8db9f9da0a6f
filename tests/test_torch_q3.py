"""TPC-H Q3 and Q10 through the port's ``Session.sql`` against the JAX
package's ``Session.sql`` and the pandas oracle, on the CPU at sf 0.01.

- values AND dtypes equal the JAX package's DataFrame (the port's
  ``QueryResult`` converted to a frame here: the port imports no pandas);
- the result equals ``presto_tpu/oracle/tpch_oracle.py``: keys and
  strings exactly, revenue as the scaled int64 equal to the oracle's
  float rounded to 4 decimals (its float sums of ~10 terms err by under
  1e-9 relative, far below half a unit of the 4th decimal);
- the same with ``pallas_join`` off (no fused route), and the fused
  route is counted on Q3's customer join (exists) and Q10's nation join
  (payload) exactly as the JAX package routes them;
- ``chip_smoke.py``'s exact numpy recomputation (the card's oracle)
  equals the port here, so the card compares against a checked oracle;
- the operator-level Q3 of ``tests/test_q3_milestone.py``, rebuilt from
  the port's operators, equals the JAX operators' result;
- ten more statements inside the ported subset (direct grouping, Sort,
  count/min/max, string range predicates, an empty result, a projected
  literal) equal the JAX package's frames.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.oracle import tpch_oracle
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.runtime.session import Session as PSession

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SF = 0.01
QS = ["q3", "q10"]


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture(scope="module")
def jax_results(conns):
    """The JAX package's frames and its join-route counters per query,
    each query in a fresh session (no plan-stats history)."""
    out = {}
    for q in QS:
        before = REGISTRY.snapshot()
        df = JSession({"tpch": conns[0]}).sql(QUERIES[q])
        after = REGISTRY.snapshot()
        routes = {k: after.get(k, 0) - before.get(k, 0) for k in after
                  if k.startswith("join.strategy.") or k == "exec.pallas_join_route"}
        out[q] = (df, {k: v for k, v in routes.items() if v})
    return out


def port_run(conn, q, **props):
    COUNTERS.clear()
    res = PSession({"tpch": conn}, properties=props, device="cpu").sql(QUERIES[q])
    routes = {k: v for k, v in COUNTERS.items()
              if k.startswith("join.strategy.") or k == "exec.pallas_join_route"}
    return res, routes


@pytest.mark.parametrize("q", QS)
def test_session_sql_equals_jax_session(conns, jax_results, q):
    want, want_routes = jax_results[q]
    res, routes = port_run(conns[1], q)
    got = pd.DataFrame(res.to_dict())
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert len(got) == (10 if q == "q3" else 20)
    # the same joins take the same probes, the fused one included
    assert routes == want_routes
    assert routes["exec.pallas_join_route"] == 1


@pytest.mark.parametrize("q", QS)
def test_pallas_join_off_gives_the_same_rows(conns, jax_results, q):
    res, routes = port_run(conns[1], q, pallas_join=False)
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), jax_results[q][0],
                                  check_exact=True)
    assert "exec.pallas_join_route" not in routes


@pytest.mark.parametrize("q", QS)
def test_fused_probe_kernel_is_the_one_each_query_routes(q):
    """Q3's fused join is the exists probe (its operator calls
    ``exists_keep``, which returns the new live mask), Q10's the payload
    probe (its operator calls ``payload_keep``, which also returns the
    values in their storage types and the new live mask), called once per
    lineitem batch (several splits here) with no fallback; on the CPU the
    wrappers compute their plain versions and count no launch (there is
    no kernel to launch)."""
    conn = PConnector(sf=SF, units_per_split=1 << 12, device="cpu")
    batches = len(conn.splits("lineitem"))
    assert batches > 1
    calls = []
    originals = {n: getattr(cuda_join, n) for n in ("exists_keep", "payload_keep")}

    def spy(name):
        def wrapper(*args):
            calls.append((name, args[3].dtype, args[3].shape[0]))
            return originals[name](*args)
        return wrapper

    launches = (cuda_join.exists_launches, cuda_join.payload_launches)
    try:
        for n in originals:
            setattr(cuda_join, n, spy(n))
        port_run(conn, q)
    finally:
        for n, f in originals.items():
            setattr(cuda_join, n, f)
    assert [c[0] for c in calls] == ["exists_keep" if q == "q3" else "payload_keep"] * batches
    assert COUNTERS["exec.pallas_join_route"] == 1
    assert COUNTERS["join.pallas_fallback"] == 0
    assert (cuda_join.exists_launches, cuda_join.payload_launches) == launches


@pytest.mark.parametrize("q", QS)
def test_session_sql_equals_the_oracle(conns, q):
    jconn = conns[0]
    tables = {t: jconn.table_pandas(t) for t in
              ("customer", "orders", "lineitem", "nation")}
    want = getattr(tpch_oracle, q)(tables)
    res, _ = port_run(conns[1], q)
    assert res.names == list(want.columns)
    for name in res.names:
        got = res.column(name)
        w = want[name].to_numpy()
        if name in ("revenue", "c_acctbal"):
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, np.round(w * 10**res.types[name].scale))
        elif name == "o_orderdate":
            np.testing.assert_array_equal(res.logical(name), w.astype("datetime64[D]"))
        else:
            assert list(got) == list(w), name


@pytest.mark.parametrize("q", QS)
def test_chip_oracle_equals_the_port(conns, q):
    want = getattr(chip_smoke, f"{q}_expected")(conns[1])
    res, _ = port_run(conns[1], q)
    chip_smoke.same_result(res, want, q)


def test_operator_level_q3_matches_reference(conns):
    """tests/test_q3_milestone.py's hand-built operator Q3 on both
    packages' operators (sorted probes, SortStrategy(8192), TopN)."""
    from test_q3_milestone import run_q3

    from presto_tpu_torch.exec.joins import BuildOutput, JoinBuildOperator, LookupJoinOperator
    from presto_tpu_torch.exec.operators import (
        AggSpec,
        FilterProjectOperator,
        HashAggregationOperator,
        SortKey,
        SortStrategy,
        TopNOperator,
    )
    from presto_tpu_torch.exec.pipeline import Pipeline, ScanSource
    from presto_tpu_torch.expr import Call, col, lit
    from presto_tpu_torch.types import BIGINT, BOOLEAN, DATE, INTEGER, decimal, varchar

    dec2, dec4 = decimal(12, 2), decimal(38, 4)
    cut = "1995-03-15"
    conn = conns[1]
    cust = JoinBuildOperator(col("c_custkey", BIGINT))
    Pipeline(ScanSource(conn, "customer", ["c_custkey", "c_mktsegment"]), [
        FilterProjectOperator(Call(BOOLEAN, "eq", (col("c_mktsegment", varchar()),
                                                   lit("BUILDING", varchar()))), None),
        cust]).run()
    orders = JoinBuildOperator(col("o_orderkey", BIGINT))
    Pipeline(ScanSource(conn, "orders", ["o_orderkey", "o_custkey", "o_orderdate",
                                         "o_shippriority"]), [
        FilterProjectOperator(Call(BOOLEAN, "lt", (col("o_orderdate", DATE),
                                                   lit(cut, DATE))), None),
        LookupJoinOperator(cust, col("o_custkey", BIGINT), (), "inner"),
        orders]).run()
    revenue = Call(dec4, "mul", (col("l_extendedprice", dec2),
                                 Call(dec2, "sub", (lit(1, dec2), col("l_discount", dec2)))))
    out = Pipeline(ScanSource(conn, "lineitem", ["l_orderkey", "l_extendedprice",
                                                 "l_discount", "l_shipdate"]), [
        FilterProjectOperator(Call(BOOLEAN, "gt", (col("l_shipdate", DATE),
                                                   lit(cut, DATE))), None),
        LookupJoinOperator(orders, col("l_orderkey", BIGINT),
                           [BuildOutput("o_orderdate", "o_orderdate"),
                            BuildOutput("o_shippriority", "o_shippriority")], "inner"),
        HashAggregationOperator([("l_orderkey", col("l_orderkey", BIGINT)),
                                 ("o_orderdate", col("o_orderdate", DATE)),
                                 ("o_shippriority", col("o_shippriority", INTEGER))],
                                [AggSpec("sum", revenue, "revenue", dec4)],
                                SortStrategy(8192), device="cpu"),
        TopNOperator([SortKey(col("revenue", dec4), descending=True),
                      SortKey(col("o_orderdate", DATE))], 10)]).run()
    want = run_q3(conns[0]).reset_index(drop=True)
    from presto_tpu_torch.batch import QueryResult

    got = QueryResult(list(want.columns), out)
    for name in want.columns:
        assert list(got.column(name)) == want[name].tolist(), name
        assert got.column(name).dtype == want[name].dtype, name


ADHOC = [
    # direct-strategy grouping on dictionary keys through SQL (the lane-sums
    # route), count/min/max, Sort without LIMIT
    "select l_returnflag, l_linestatus, sum(l_quantity) as q, count(*) as n, "
    "min(l_shipdate) as lo, max(l_discount) as hi from lineitem "
    "where l_shipdate <= date '1998-09-02' group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus",
    "select n_name, r_name from nation, region where n_regionkey = r_regionkey order by n_name",
    "select n_regionkey, count(*) as c, sum(n_nationkey) as s from nation "
    "group by n_regionkey order by c desc, n_regionkey",
    "select * from region",
    "select o_orderpriority, count(o_orderkey) as c from orders "
    "where o_orderdate >= date '1995-01-01' and o_orderdate < date '1995-01-01' "
    "+ interval '1' year group by o_orderpriority order by o_orderpriority",
    # range comparisons on dictionary codes, an absent literal, an empty result
    "select c_mktsegment, sum(c_acctbal) as b from customer "
    "where c_mktsegment > 'B' and c_mktsegment <= 'HOUSEHOLD' group by c_mktsegment "
    "order by b desc",
    "select c_name, c_acctbal from customer where c_mktsegment = 'NOSUCH' order by c_acctbal",
    "select s_name, s_acctbal from supplier, nation "
    "where s_nationkey = n_nationkey and n_name = 'GERMANY' order by s_acctbal desc limit 5",
    "select l_orderkey, l_linenumber, l_quantity * l_extendedprice as x from lineitem "
    "where l_orderkey < 20 order by x desc, l_orderkey limit 7",
    "select 'x' as lit, n_name from nation order by n_name limit 3",
]


@pytest.mark.parametrize("i", range(len(ADHOC)))
def test_other_statements_in_the_subset_equal_jax(conns, i):
    """Statements beyond Q3/Q10 that the ported subset accepts give the
    JAX package's frame exactly (values and dtypes)."""
    want = JSession({"tpch": conns[0]}).sql(ADHOC[i])
    res = PSession({"tpch": conns[1]}, device="cpu").sql(ADHOC[i])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
