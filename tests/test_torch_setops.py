"""Set operations, LIMIT and SELECT without FROM in the port, against the
JAX package:

- ``LimitOperator`` (a limit inside a batch, across batches, over dead
  rows) and the UNION dictionary alignment (``union_target_dicts``,
  ``align_batch_dicts``: children with different dictionaries of one
  column re-encode into their sorted merge) against the reference's, on
  the same batches;
- ``tests/test_setops.py``'s union, intersect and except statements and
  ``tests/test_sql_surface_gaps.py``'s set operations through both
  ``Session.sql``s at sf 0.01: frames and dtypes exact, and the route
  counters; LIMIT without ORDER BY compares rows in stream order (the
  scan's split order), so both scans must yield the same order; INTERSECT
  ALL is refused by both parsers;
- the multi-row scalar over a UNION (ROADMAP C, copied): each term is a
  batch of its own and the one-row check reads a batch at a time, so the
  first term answers in both packages;
- ``chip_smoke.py`` phase 14's statements through both ``Session.sql``s
  at sf 0.01 (DOUBLE columns within ``chip_smoke.DOUBLE_TOL``), their
  numpy oracles and ``planned_routes`` against the port, and their plans
  (``test_torch_sql.plan_shape``) with this file's statements at sf 0.01
  and SF1 (plans only: no data is generated).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.batch import Dictionary as JDictionary
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.exec import operators as JO
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu.types import varchar as jvarchar
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import operators as PO
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.session import Session as PSession
from test_torch_sql import plan_shape
from torch_bridge import assert_same, jax_run, port_batch, port_run

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def _keyed_batch(seed: int, cap: int, live_p: float) -> JBatch:
    rng = np.random.default_rng(seed)
    live = rng.random(cap) < live_p
    k = rng.integers(-100, 100, cap)
    return JBatch({"k": JColumn(jnp.asarray(k), jnp.asarray(live), JBIGINT)}, jnp.asarray(live))


@pytest.mark.parametrize("n", [0, 1, 7, 40, 41, 120, 500])
def test_limit_operator_equals_reference(n):
    """Batches of 64, 32 and 128 rows with dead rows among them: the
    first ``n`` live rows in stream order; a batch past them is dropped,
    the one holding the boundary keeps its first live rows."""
    jbs = [_keyed_batch(s, cap, 0.7) for s, cap in ((1, 64), (2, 32), (3, 128))]
    jop, pop = JO.LimitOperator(n), PO.LimitOperator(n)
    for jb in jbs:
        want = jop.process(jb)
        got = pop.process(port_batch(jb))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g.live, w.live, f"limit {n}: live")
            assert_same(g["k"].data, w["k"].data, f"limit {n}: k")


def _dict_batch(values, table_values, seed: int) -> JBatch:
    d = JDictionary(table_values)
    rng = np.random.default_rng(seed)
    picked = [values[i] for i in rng.integers(0, len(values), 40)]
    codes = d.encode(picked).astype(np.int8)
    live = jnp.asarray(rng.random(40) < 0.9)
    return JBatch({"f": JColumn(jnp.asarray(codes), live, jvarchar().with_physical(np.int8), d)},
                  live)


def test_union_dictionary_alignment_equals_reference():
    """Three children: 'F'/'O' (l_linestatus's values), 'F'/'O'/'P'
    (o_orderstatus's) and one sharing the first child's dictionary: the
    target is the sorted merge, and every batch re-encodes into it."""
    jb = [_dict_batch(["F", "O"], ["F", "O"], 1), _dict_batch(["F", "P"], ["F", "O", "P"], 2)]
    jb.append(JBatch({"f": jb[0]["f"]}, jb[0].live))
    jt = JO.union_target_dicts(["f"], jb + [None])
    pb = [port_batch(b) for b in jb]
    pb[2] = type(pb[0])({"f": pb[0]["f"]}, pb[0].live)  # the first child's dictionary object
    pt = PO.union_target_dicts(["f"], pb + [None])
    assert list(pt["f"].values) == list(jt["f"].values) == ["F", "O", "P"]
    jcache, pcache = {}, {}
    for j, p in zip(jb, pb):
        want = JO.align_batch_dicts(j, jt, jcache)
        got = PO.align_batch_dicts(p, pt, pcache)
        assert_same(got["f"].data, want["f"].data, "codes")
        assert list(got["f"].dictionary.values) == list(want["f"].dictionary.values)
    assert len(pcache) == len(jcache) == 2  # one mapping per source dictionary
    assert PO.union_target_dicts(["f"], [pb[0], pb[2]]) == {}  # one shared dictionary


# ---------------------------------------------------------------------------
# SQL through both Session.sql
# ---------------------------------------------------------------------------

STATEMENTS = {
    # tests/test_setops.py
    "union all": "select n_regionkey k from nation union all select r_regionkey k from region",
    "union distinct": ("select n_regionkey k from nation union select r_regionkey k from region "
                       "order by k"),
    "union coercion": ("select n_nationkey v from nation where n_nationkey < 2 union all "
                       "select 0.5 + r_regionkey v from region where r_regionkey = 0 order by v"),
    "union across dictionaries": (
        "select l_returnflag f, count(*) c from lineitem group by l_returnflag union all "
        "select l_linestatus f, count(*) c from lineitem group by l_linestatus order by f, c"),
    "union in a cte": ("with k as (select n_regionkey v from nation union all "
                       "select r_regionkey v from region) select v, count(*) c from k group by v "
                       "order by v"),
    "union in a derived table": ("select count(*) c from (select n_regionkey v from nation "
                                 "union select r_regionkey v from region) t"),
    "intersect": ("select n_regionkey k from nation where n_regionkey < 3 intersect "
                  "select r_regionkey k from region where r_regionkey > 1 order by k"),
    "except": ("select n_regionkey k from nation except select r_regionkey k from region "
               "where r_regionkey >= 2 order by k"),
    "intersect binds tighter": (
        "select 0 k from region where r_regionkey = 4 union select n_regionkey k from nation "
        "where n_regionkey < 3 intersect select r_regionkey k from region where r_regionkey > 1 "
        "order by k"),
    "intersect over dictionaries": ("select l_returnflag f from lineitem intersect "
                                    "select l_linestatus f from lineitem order by f"),
    # tests/test_sql_surface_gaps.py
    "intersect customers": ("select o_custkey k from orders intersect select c_custkey "
                            "from customer order by k"),
    "except customers": ("select c_custkey k from customer except select o_custkey from orders "
                         "order by k"),
    # the rest of the surface: every term's column names, LIMIT, VALUES
    "except empty": "select n_regionkey from nation except select r_regionkey from region",
    "union of names": "select n_name from nation union all select r_name from region",
    "union then limit": ("select n_nationkey k from nation union all select r_regionkey k "
                         "from region limit 27"),
    "union order limit": ("select n_nationkey k from nation union all select r_regionkey k "
                          "from region order by k desc limit 4"),
    "union of literals": ("select 'nation' as src, n_regionkey k from nation union all "
                          "select 'region' as src, r_regionkey k from region order by src, k"),
    "union in a scalar": ("select count(*) as n from nation where n_regionkey < (select "
                          "max(r_regionkey) from (select r_regionkey from region union all "
                          "select 1 as r_regionkey) t)"),
    "in over a union": ("select count(*) as n from customer where c_custkey in (select o_custkey "
                        "from orders where o_orderpriority = '1-URGENT' union all select "
                        "c_custkey from customer where c_acctbal < 0)"),
    "exists over a union": ("select count(*) as n from orders where exists (select * from "
                            "(select l_orderkey as k from lineitem where l_quantity > 49 union "
                            "all select l_orderkey as k from lineitem where l_discount = 0.10) u "
                            "where k = o_orderkey)"),
    "limit": "select n_name from nation limit 3",
    "limit past the first batch": ("select l_orderkey, l_linenumber from lineitem "
                                   "where l_quantity > 45 limit 2000"),
    "limit in a derived table": ("select count(*) as n, sum(o_totalprice) as s from (select "
                                 "o_totalprice from orders where o_totalprice > 300000 "
                                 "limit 1000) t"),
    "values": "select 1 + 2 as x, 'a' as y",
    "values with dates": ("select date '1998-12-01' - interval '90' day as d, "
                          "cast('1995-03-15 13:45:30' as timestamp) as t, 2.5 * 4 as m"),
    "values aggregated": "select count(*) as n, sum(7) as s",
}

#: both parsers refuse it with the same words
INTERSECT_ALL = "select 1 x intersect all select 1 x"

SCALAR_OVER_UNION = ("select count(*) as n from lineitem where l_quantity < (select "
                     "avg(l_quantity) from lineitem union all select avg(l_discount) "
                     "from lineitem)")


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax_session(conns, name):
    want, want_routes = jax_run(conns[0], STATEMENTS[name])
    res, routes, _ = port_run(conns[1], STATEMENTS[name])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert len(want) > 0 or name in ("except empty", "intersect over dictionaries")


def test_intersect_all_is_refused_by_both(conns):
    with pytest.raises(Exception, match="INTERSECT ALL not supported") as want:
        jax_run(conns[0], INTERSECT_ALL)
    with pytest.raises(Exception, match="INTERSECT ALL not supported") as got:
        port_run(conns[1], INTERSECT_ALL)
    assert str(got.value) == str(want.value)


def test_multi_row_scalar_over_a_union_answers_with_its_first_term(conns):
    """Copied, not fixed (ROADMAP C): the scalar subquery's one-row check
    reads a batch at a time and each UNION term is a batch of its own, so
    the two-row UNION answers as its first term does, in both packages."""
    want, _ = jax_run(conns[0], SCALAR_OVER_UNION)
    res, _, _ = port_run(conns[1], SCALAR_OVER_UNION)
    got = pd.DataFrame(res.to_dict())
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    first_term = SCALAR_OVER_UNION.replace(
        " union all select avg(l_discount) from lineitem", "")
    alone, _, _ = port_run(conns[1], first_term)
    assert list(got["n"]) == list(pd.DataFrame(alone.to_dict())["n"])
    with pytest.raises(ValueError, match="more than one row"):
        port_run(conns[1], "select count(*) from lineitem where l_quantity < (select "
                           "avg(l_quantity) from lineitem group by l_returnflag)")


def test_limit_keeps_the_split_order():
    """LIMIT without ORDER BY over four ``lineitem`` splits: the first
    rows in split order, equal to the reference's and to the rows the
    splits hold, the limit falling inside the second split."""
    jconn = JConnector(sf=0.01, units_per_split=1 << 12)
    pconn = PConnector(sf=0.01, units_per_split=1 << 12, device="cpu")
    sql = STATEMENTS["limit past the first batch"]
    want, _ = jax_run(jconn, sql)
    res, _, _ = port_run(pconn, sql)
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    li = pconn.table_numpy("lineitem", ["l_orderkey", "l_linenumber", "l_quantity"])
    m = li["l_quantity"] > 4500
    assert list(res.column("l_orderkey")) == list(li["l_orderkey"][m][:2000])
    assert list(res.column("l_linenumber")) == list(li["l_linenumber"][m][:2000])
    per_split = [int((pconn.scan_numpy(sp, ["l_quantity"])["l_quantity"] > 4500).sum())
                 for sp in pconn.splits("lineitem")]
    assert len(per_split) == 4 and per_split[0] < 2000 < per_split[0] + per_split[1]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14
# ---------------------------------------------------------------------------

RUNS = chip_smoke.surface_runs()


@pytest.mark.parametrize("name", list(RUNS))
def test_phase14_statement_equals_jax_session(conns, name):
    sql = RUNS[name][0]
    want, want_routes = jax_run(conns[0], sql)
    res, routes, _ = port_run(conns[1], sql)
    got = pd.DataFrame(res.to_dict())
    if name in chip_smoke.DOUBLE_COLUMNS:
        pd.testing.assert_frame_equal(got, want, check_exact=False, **chip_smoke.DOUBLE_TOL)
    else:
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes


@pytest.fixture(scope="module")
def cached(conns):
    """The oracles read through one ``ColumnCache``, as phase 14 reads
    them."""
    return chip_smoke.ColumnCache(conns[1])


@pytest.mark.parametrize("name", list(RUNS))
def test_phase14_oracle_and_planned_routes_equal_the_port(conns, cached, name):
    """What phase 14 holds each statement to on the card, held here at sf
    0.01: its numpy oracle (DOUBLE columns within ``DOUBLE_TOL``), and the
    strategy counters its plan predicts."""
    sql, oracle = RUNS[name]
    res, routes, session = port_run(conns[1], sql)
    chip_smoke.close_result(res, oracle(cached), name, chip_smoke.DOUBLE_COLUMNS.get(name, ()))
    got = {k: v for k, v in routes.items() if k.startswith(("join.strategy.", "agg.strategy."))}
    assert got == chip_smoke.planned_routes(session, sql)


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


PLANNED = {**STATEMENTS, **{f"phase 14 {name}": sql for name, (sql, _fn) in RUNS.items()}}


@pytest.mark.parametrize("name", list(PLANNED))
def test_analyzer_builds_the_same_plan(plan_sessions, name):
    js, ps = plan_sessions
    want = plan_shape(js.plan(PLANNED[name]), js.catalog, j_join_strategy, j_agg_strategy,
                      j_value_bits)
    got = plan_shape(ps.plan(PLANNED[name]), ps.catalog, p_join_strategy, p_agg_strategy,
                     p_value_bits)
    assert got == want
