"""Window functions through the port's ``Session.sql``, against the JAX
package's:

- ``tests/test_window.py``'s statements (not the distributed one) and
  the window statements of ``tests/test_sql_surface_gaps.py`` through
  both ``Session.sql``s at sf 0.01: frames compared in row order (a
  Window's output is in its sort order), dtypes exact, DOUBLE columns
  within rtol 1e-3, atol 0.02, and the route counters; a tied
  ``row_number`` (the order depends on the stable sort of the input);
  the refusals with the reference's words; the EXPLAIN line of a Window
  and the pruning of an unreferenced one; the plans
  (``test_torch_sql.plan_shape``) at sf 0.01 and SF1;
- ``chip_smoke.py`` phase 15's window statements through both sessions,
  and their numpy oracles and ``planned_routes`` against the port.

Every reference statement runs once, in the module-scoped ``ref``
fixture. ``same_frame`` and ``equal_session`` serve
``tests/test_torch_grouping_sets.py`` too.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.session import Session as PSession
from test_torch_sql import plan_shape
from torch_bridge import jax_run, port_frame, port_run

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# ---------------------------------------------------------------------------
# SQL through both Session.sql
# ---------------------------------------------------------------------------

STATEMENTS = {
    # tests/test_window.py
    "rank per partition": ("select n_name, n_regionkey, rank() over (partition by n_regionkey "
                           "order by n_name) as rk from nation"),
    "row_number desc": ("select s_suppkey, row_number() over (order by s_suppkey desc) as rn "
                        "from supplier"),
    "partition aggregates": ("select o_orderkey, o_custkey, sum(o_totalprice) over (partition by "
                             "o_custkey) as tot, avg(o_totalprice) over (partition by o_custkey) "
                             "as av, max(o_totalprice) over (partition by o_custkey) as mx, "
                             "count(*) over (partition by o_custkey) as cnt from orders"),
    "dense_rank over a dictionary": ("select c_custkey, dense_rank() over (partition by "
                                     "c_nationkey order by c_mktsegment) as dr from customer"),
    "running sum rows": ("select ps_partkey, ps_suppkey, sum(ps_availqty) over (partition by "
                         "ps_suppkey order by ps_partkey rows between unbounded preceding and "
                         "current row) as run from partsupp"),
    "running sum range": ("select o_orderkey, sum(o_totalprice) over (partition by o_custkey "
                          "order by o_orderdate) as run from orders"),
    "over a group-by": ("select l_returnflag, l_linestatus, sum(l_quantity) as s, rank() over "
                        "(order by sum(l_quantity) desc) as rk from lineitem "
                        "group by l_returnflag, l_linestatus"),
    "top-n per group": ("select s_suppkey, s_nationkey, rk from (select s_suppkey, s_nationkey, "
                        "rank() over (partition by s_nationkey order by s_acctbal desc) as rk "
                        "from supplier) ranked where rk <= 2"),
    "only in ORDER BY": "select n_name from nation order by rank() over (order by n_name desc)",
    "select star": "select *, rank() over (order by n_name) as rk from nation",
    "wide BYTES order key": "select s_suppkey, rank() over (order by s_name) as rk from supplier",
    "wide BYTES partition": ("select s_suppkey, count(*) over (partition by s_name) as c "
                             "from supplier"),
    "max over a dictionary": ("select c_custkey, max(c_mktsegment) over (partition by "
                              "c_nationkey) mx from customer"),
    "lag lead first_value": ("select l_orderkey k, l_linenumber ln, lag(l_quantity) over "
                             "(partition by l_orderkey order by l_linenumber) p1, lag(l_quantity, "
                             "2) over (partition by l_orderkey order by l_linenumber) p2, "
                             "lead(l_quantity) over (partition by l_orderkey order by "
                             "l_linenumber) nx, first_value(l_quantity) over (partition by "
                             "l_orderkey order by l_linenumber) fv from lineitem "
                             "order by k, ln limit 300"),
    # tests/test_sql_surface_gaps.py
    "rank and lag": ("select o_orderkey k, rank() over (partition by o_orderstatus order by "
                     "o_totalprice desc) r, lag(o_totalprice) over (order by o_orderkey) p "
                     "from orders order by o_orderkey"),
    # ties: the order within a (status, date) tie is the input's
    "tied row_number": ("select o_orderkey, o_custkey, row_number() over (partition by "
                        "o_orderstatus order by o_orderdate) rn from orders"),
    "tied row_number over a join": ("select c_custkey, o_orderkey, row_number() over (partition "
                                    "by c_nationkey order by o_orderpriority) rn from customer, "
                                    "orders where c_custkey = o_custkey"),
    "row_number top 3": ("select o_custkey, o_orderkey, rn from (select o_custkey, o_orderkey, "
                         "row_number() over (partition by o_custkey order by o_totalprice desc) "
                         "rn from orders) t where rn <= 3"),
    "lag and lead past the partition": ("select n_regionkey, n_name, lag(n_nationkey, 4) over "
                                        "(partition by n_regionkey order by n_name) l4, "
                                        "lead(n_name, 5) over (partition by n_regionkey order "
                                        "by n_name) l5 from nation"),
    "dense_rank, first_value, count over ()": (
        "select n_name, dense_rank() over (order by n_regionkey) d, first_value(n_name) over "
        "(partition by n_regionkey order by n_name desc) f, count(n_name) over () c "
        "from nation"),
    "whole-partition frame": ("select n_regionkey, sum(n_nationkey) over (partition by "
                              "n_regionkey order by n_name rows between unbounded preceding and "
                              "unbounded following) s from nation"),
    "running double sum": ("select l_orderkey, l_linenumber, sum(cast(l_quantity as double)) "
                           "over (partition by l_suppkey order by l_orderkey, l_linenumber rows "
                           "between unbounded preceding and current row) s from lineitem"),
    "RANGE min and count over dead rows": (
        "select l_orderkey, min(l_extendedprice) over (partition by l_returnflag order by "
        "l_shipdate range between unbounded preceding and current row) m, count(l_comment) "
        "over (partition by l_returnflag order by l_shipdate) c from lineitem "
        "where l_orderkey < 2000"),
    "wide BYTES keys, NULLs first": ("select s_name, s_phone, rank() over (partition by "
                                     "s_address order by s_phone desc nulls first) r "
                                     "from supplier"),
    "avg and min of a date": ("select l_shipmode, avg(l_quantity) over (partition by l_shipmode) "
                              "a, min(l_shipdate) over (partition by l_shipmode order by "
                              "l_orderkey rows between unbounded preceding and current row) d "
                              "from lineitem where l_orderkey < 100"),
    "distinct over a window": ("select distinct n_regionkey, rank() over (order by n_regionkey) "
                               "r from nation"),
    "lag of a sum over a join": (
        "select n_name, extract(year from o_orderdate) as y, sum(o_totalprice) as s, "
        "avg(sum(o_totalprice)) over (partition by n_name) as a, lag(sum(o_totalprice)) over "
        "(partition by n_name order by extract(year from o_orderdate)) as p from orders, "
        "customer, nation where o_custkey = c_custkey and c_nationkey = n_nationkey "
        "group by n_name, extract(year from o_orderdate)"),
    "nested sum over dates": ("select o_orderdate, sum(sum(o_totalprice)) over (order by "
                              "o_orderdate rows between unbounded preceding and current row) as c "
                              "from orders group by o_orderdate"),
    "max over an aggregate": ("select o_orderpriority, count(*) c, max(count(*)) over () m "
                              "from orders group by o_orderpriority"),
}

#: DOUBLE (float32) result columns, compared within rtol 1e-3, atol 0.02
DOUBLES = {"partition aggregates": ("av",), "running double sum": ("s",),
           "avg and min of a date": ("a",), "lag of a sum over a join": ("a",)}

#: what both packages refuse, with the same words
REFUSED = {
    "window in WHERE": ("select n_name from nation where rank() over (order by n_name) <= 2",
                        "window function rank() is only allowed in SELECT/ORDER BY"),
    "rank without ORDER BY": ("select rank() over (partition by n_regionkey) from nation",
                              "rank() requires ORDER BY in its window"),
    "lag without ORDER BY": ("select lag(l_quantity) over (partition by l_orderkey) x "
                             "from lineitem", "lag() requires ORDER BY in its window"),
    "DISTINCT in a window": ("select count(distinct n_name) over (order by n_name) from nation",
                             "DISTINCT in window function count"),
    "sum of nothing": ("select sum() over () from nation",
                       "sum() window aggregate takes one argument"),
    "min of BYTES": ("select min(s_name) over (partition by s_nationkey) from supplier",
                     "min() window over byte-string columns is not supported"),
    "rank with an argument": ("select rank(1) over (order by n_name) from nation",
                              "rank() takes no arguments"),
    "lag offset not a literal": ("select lag(n_name, n_regionkey) over (order by n_name) "
                                 "from nation", "lag() offset must be a literal"),
    "lag offset not an integer": ("select lag(n_name, 1.5) over (order by n_name) from nation",
                                  "lag() offset must be an integer literal, got '1.5'"),
    "DISTINCT beside a window in ORDER BY": (
        "select distinct rank() over (order by n_regionkey) r from nation "
        "order by rank() over (order by n_regionkey)",
        "DISTINCT with window expressions repeated in ORDER BY is not supported; "
        "order by the select alias instead"),
    "unknown window function": ("select ntile(4) over (order by n_name) from nation",
                                "unknown window function ntile"),
}

RUNS = {name: sql for name, (sql, _fn) in chip_smoke.window_runs().items()
        if name not in chip_smoke.GROUPING_SET_RUNS}


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


@pytest.fixture(scope="module")
def ref(conns):
    """Every statement through the JAX package's ``Session.sql`` once:
    (frame, route counters), or the exception it raised."""
    out = {}
    sqls = {**STATEMENTS, **{n: sql for n, (sql, _w) in REFUSED.items()},
            **{f"phase 15 {n}": sql for n, sql in RUNS.items()}}
    for name, sql in sqls.items():
        try:
            out[name] = jax_run(conns[0], sql)
        except Exception as e:  # noqa: BLE001 - the refusal is the answer
            out[name] = e
    return out


def same_frame(got: pd.DataFrame, want: pd.DataFrame, doubles=()) -> None:
    """Equal frames in row order with equal dtypes: exactly, but for the
    ``doubles`` columns, within rtol 1e-3, atol 0.02."""
    assert list(got.columns) == list(want.columns)
    for c in doubles:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_allclose(got[c].astype(np.float64), want[c].astype(np.float64),
                                   equal_nan=True, err_msg=c, **chip_smoke.DOUBLE_TOL)
    rest = [c for c in want.columns if c not in doubles]
    pd.testing.assert_frame_equal(got[rest], want[rest], check_exact=True)


def equal_session(conns, ref, name, sql, doubles=()):
    want = ref[name]
    assert not isinstance(want, Exception), f"the JAX package raised {want!r}"
    want, want_routes = want
    res, routes, _ = port_run(conns[1], sql)
    got = port_frame(res)
    same_frame(got, want, doubles)
    assert routes == want_routes
    assert len(want) > 0
    return got


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax_session(conns, ref, name):
    got = equal_session(conns, ref, name, STATEMENTS[name], DOUBLES.get(name, ()))
    if name == "only in ORDER BY":
        assert list(got.columns) == ["n_name"]
    if name == "select star":
        assert list(got.columns) == ["n_nationkey", "n_name", "n_regionkey", "n_comment", "rk"]


def test_tied_row_number_follows_the_input_order(conns, ref):
    """Within a (status, date) tie the row numbers follow the scan's row
    order (the stable sort), in both packages: the row numbers of a tie
    rise with the order key."""
    got = equal_session(conns, ref, "tied row_number", STATEMENTS["tied row_number"])
    o = conns[1].table_numpy("orders", ["o_orderkey", "o_orderdate", "o_orderstatus"])
    date = dict(zip(o["o_orderkey"].tolist(), o["o_orderdate"].tolist()))
    status = dict(zip(o["o_orderkey"].tolist(), o["o_orderstatus"].tolist()))
    keys = got["o_orderkey"].tolist()
    tie = [(status[k], date[k]) for k in keys]
    ties = sum(a == b for a, b in zip(tie, tie[1:]))
    assert ties > 100
    assert all(k1 < k2 for (k1, t1), (k2, t2) in zip(zip(keys, tie), zip(keys[1:], tie[1:]))
               if t1 == t2)


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusal_equals_jax_session(conns, ref, name):
    sql, words = REFUSED[name]
    want = ref[name]
    assert isinstance(want, Exception) and str(want) == words
    with pytest.raises(Exception) as got:
        port_run(conns[1], sql)
    assert type(got.value).__name__ == type(want).__name__
    assert str(got.value) == words


def test_explain_renders_the_window_as_the_reference(conns):
    sql = "select rank() over (partition by n_regionkey order by n_name) from nation"
    js = JSession({"tpch": conns[0]})
    ps = PSession({"tpch": conns[1]}, device="cpu")

    def window_lines(text):
        return [ln.strip() for ln in text.splitlines() if ln.strip().startswith("Window")]

    want = window_lines(js.explain(sql))
    assert want == ["Window funcs=['rank$1'] frame=range"]
    assert window_lines(ps.explain(sql)) == want


def test_unreferenced_window_functions_are_pruned(conns):
    sql = ("select n_name from (select n_name, rank() over (order by n_name) r, "
           "lag(n_name) over (order by n_name) l from nation) t")
    js = JSession({"tpch": conns[0]})
    ps = PSession({"tpch": conns[1]}, device="cpu")
    assert "funcs=[]" in ps.explain(sql)
    assert [ln.strip() for ln in ps.explain(sql).splitlines() if "Window" in ln] == \
        [ln.strip() for ln in js.explain(sql).splitlines() if "Window" in ln]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15 (the window statements)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_phase15_statement_equals_jax_session(conns, ref, name):
    equal_session(conns, ref, f"phase 15 {name}", RUNS[name],
                   chip_smoke.WINDOW_DOUBLES.get(name, ()))


@pytest.fixture(scope="module")
def cached(conns):
    return chip_smoke.ColumnCache(conns[1])


@pytest.mark.parametrize("name", list(RUNS))
def test_phase15_oracle_and_planned_routes_equal_the_port(conns, cached, name):
    """What phase 15 holds each statement to on the card, held here at sf
    0.01: its numpy oracle and the strategy counters its plan predicts."""
    sql, oracle = chip_smoke.window_runs()[name]
    res, routes, session = port_run(conns[1], sql)
    chip_smoke.close_result(res, oracle(cached), name, chip_smoke.WINDOW_DOUBLES.get(name, ()))
    got = {k: v for k, v in routes.items() if k.startswith(("join.strategy.", "agg.strategy."))}
    assert got == chip_smoke.planned_routes(session, sql)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


PLANNED = {**STATEMENTS, **{f"phase 15 {name}": sql for name, sql in RUNS.items()}}


@pytest.mark.parametrize("name", list(PLANNED))
def test_analyzer_builds_the_same_plan(plan_sessions, name):
    js, ps = plan_sessions
    want = plan_shape(js.plan(PLANNED[name]), js.catalog, j_join_strategy, j_agg_strategy,
                      j_value_bits)
    got = plan_shape(ps.plan(PLANNED[name]), ps.catalog, p_join_strategy, p_agg_strategy,
                     p_value_bits)
    assert got == want
