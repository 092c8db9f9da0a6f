"""GROUPING SETS, ROLLUP and CUBE with ``grouping()`` through the port's
``Session.sql``, against the JAX package's:

- ``tests/test_setops.py``'s rollup, ``grouping()``, explicit grouping
  sets and cube statements and ``tests/test_sql_surface_gaps.py``'s,
  with a prefix key beside the sets, HAVING and ORDER BY over
  ``grouping()``, sets over a join, absent DATE, DECIMAL-sum and BYTES
  keys (typed NULLs), and windows over the union of the sets (the q36 /
  q67 / q70 shapes): frames in row order (a UNION ALL of one grouped
  branch per set, each branch's batches in the JAX package's order),
  dtypes exact (a key with NULLs is ``object`` there, one frame per
  batch: ``torch_bridge.port_frame``), DOUBLE columns within rtol 1e-3,
  atol 0.02, and the route counters (one aggregate per set, the leaf
  route's ``fused`` where it takes a set);
- the names: a key absent from the first set is a NULL literal there,
  and the union takes the first term's names, so it is named ``_col1``
  in both packages (copied, not fixed);
- what both refuse, in the reference's words: two GROUPING SETS
  elements, and windows over sets with a key that is not an identifier;
- ``chip_smoke.py`` phase 15's grouping-set statements through both
  sessions, their numpy oracles and ``planned_routes`` against the port;
- the plans (``test_torch_sql.plan_shape``) at sf 0.01 and SF1.
"""

import os
import sys

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
from test_torch_window_sql import equal_session
from torch_bridge import jax_run, port_run

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

STATEMENTS = {
    # tests/test_setops.py
    "rollup ordered": ("select l_returnflag f, l_linestatus st, sum(l_quantity) q from lineitem "
                       "group by rollup(l_returnflag, l_linestatus) "
                       "order by f nulls last, st nulls last"),
    "grouping()": ("select grouping(n_regionkey) g, n_regionkey rk, count(*) c from nation "
                   "group by rollup(n_regionkey) order by g, rk"),
    "explicit sets": ("select n_regionkey rk, count(*) c from nation "
                      "group by grouping sets ((n_regionkey), ()) order by rk nulls last"),
    "cube": ("select l_returnflag f, l_linestatus st, count(*) c from lineitem "
             "group by cube(l_returnflag, l_linestatus)"),
    # tests/test_sql_surface_gaps.py
    "sets over a dictionary": ("select o_orderstatus g, count(*) c from orders "
                               "group by grouping sets ((o_orderstatus), ())"),
    "rollup of one key": ("select o_orderstatus g, count(*) c from orders "
                          "group by rollup (o_orderstatus)"),
    # the reference's answers to these, in row order
    "rollup with grouping()": ("select l_returnflag, l_linestatus, sum(l_quantity) s, count(*) "
                               "c, grouping(l_linestatus) g from lineitem "
                               "group by rollup(l_returnflag, l_linestatus)"),
    "cube of three keys with avg": ("select l_returnflag, l_linestatus, l_shipmode, count(*) c, "
                                    "avg(l_discount) a from lineitem group by "
                                    "cube(l_returnflag, l_linestatus, l_shipmode)"),
    "sets with an absent first key": ("select o_orderpriority, o_orderstatus, count(*) c, "
                                      "sum(o_totalprice) s from orders group by grouping sets "
                                      "((o_orderpriority), (o_orderstatus), ())"),
    "a prefix key beside the sets": ("select l_shipmode, l_returnflag, l_linestatus, "
                                     "sum(l_quantity) s from lineitem group by l_shipmode, "
                                     "grouping sets ((l_returnflag), (l_linestatus))"),
    "HAVING and ORDER BY over grouping()": (
        "select l_returnflag, l_linestatus, count(*) c, grouping(l_returnflag) + "
        "grouping(l_linestatus) lvl from lineitem group by rollup(l_returnflag, l_linestatus) "
        "having count(*) > 1000 or grouping(l_linestatus) = 1 order by lvl, l_returnflag, "
        "l_linestatus"),
    "rollup over a join": ("select n_name, c_mktsegment, count(*) c, sum(o_totalprice) s "
                           "from orders, customer, nation where o_custkey = c_custkey and "
                           "c_nationkey = n_nationkey group by rollup(n_name, c_mktsegment) "
                           "order by n_name nulls first, c_mktsegment nulls first"),
    "absent DATE and BYTES keys": ("select o_orderdate, o_clerk, count(*) c from orders where "
                                   "o_orderkey < 2000 group by grouping sets ((o_orderdate), "
                                   "(o_clerk)) order by 1 nulls last, 2 nulls last"),
    "an integer key in a cube": ("select o_shippriority, o_orderstatus, max(o_totalprice) m, "
                                 "min(o_orderdate) d from orders group by "
                                 "cube(o_shippriority, o_orderstatus)"),
    # windows over the union of the sets
    "rank over a rollup (q36 / q70)": (
        "select l_returnflag, l_linestatus, sum(l_extendedprice) s, rank() over (partition by "
        "grouping(l_returnflag) + grouping(l_linestatus), case when grouping(l_linestatus) = 0 "
        "then l_returnflag end order by sum(l_extendedprice) desc) r from lineitem "
        "group by rollup(l_returnflag, l_linestatus)"),
    "rank over a cube by key (q67)": (
        "select l_returnflag, l_linestatus, l_shipmode, sum(l_quantity) s, rank() over "
        "(partition by l_returnflag order by sum(l_quantity) desc) rk from lineitem "
        "group by rollup(l_returnflag, l_linestatus, l_shipmode) "
        "order by l_returnflag, l_linestatus, l_shipmode, rk"),
    "window sum over sets with ORDER BY": (
        "select o_orderpriority, o_orderstatus, count(*) c, sum(count(*)) over (partition by "
        "grouping(o_orderstatus)) t from orders group by cube(o_orderpriority, o_orderstatus) "
        "order by c desc, o_orderpriority, o_orderstatus"),
}

DOUBLES = {"cube of three keys with avg": ("a",)}

REFUSED = {
    "two GROUPING SETS elements": (
        "select l_returnflag, l_linestatus, count(*) from lineitem group by grouping sets "
        "((l_returnflag)), grouping sets ((l_linestatus))",
        "multiple GROUPING SETS elements not supported"),
    "windows over a non-identifier key": (
        "select l_returnflag, rank() over (order by sum(l_quantity)) from lineitem "
        "group by rollup(substring(l_returnflag, 1, 1), l_linestatus)",
        "window functions over grouping sets require identifier grouping keys"),
}

RUNS = {name: chip_smoke.window_runs()[name][0] for name in chip_smoke.GROUPING_SET_RUNS}


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


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax_session(conns, ref, name):
    equal_session(conns, ref, name, STATEMENTS[name], DOUBLES.get(name, ()))


def test_one_aggregate_per_set_on_the_leaf_route(ref):
    """The reference's counters, which the port's equal above: ROLLUP of
    two keys folds three sets on the leaf route; CUBE's four sets take
    it too; three keys' CUBE, eight."""
    assert ref["rollup with grouping()"][1] == {"exec.leaf_fused_route": 3,
                                                "agg.strategy.fused": 3}
    assert ref["cube"][1]["agg.strategy.fused"] + ref["cube"][1].get(
        "agg.strategy.single", 0) == 4
    assert ref["cube of three keys with avg"][1]["agg.strategy.fused"] == 8


def test_a_key_absent_from_the_first_set_is_named_col1(conns, ref):
    """Copied, not fixed (ROADMAP C): the UNION ALL of the sets takes its
    names from the first term, where ``o_orderstatus`` is a NULL literal
    with a default name."""
    got = equal_session(conns, ref, "sets with an absent first key",
                        STATEMENTS["sets with an absent first key"])
    assert list(got.columns) == ["o_orderpriority", "_col1", "c", "s"]
    assert got["_col1"].dtype == object and got["_col1"].notna().sum() == 3


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusal_equals_jax_session(conns, ref, name):
    sql, words = REFUSED[name]
    want = ref[name]
    assert isinstance(want, Exception) and str(want) == words
    with pytest.raises(Exception) as got:
        port_run(conns[1], sql)
    assert type(got.value).__name__ == type(want).__name__
    assert str(got.value) == words


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15 (the grouping-set statements)
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
