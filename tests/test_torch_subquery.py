"""Scalar subqueries, WITH, the ``<>``-correlated EXISTS and the mark
join in the port, against the JAX package:

- TPC-H Q2, Q11, Q15, Q17, Q20, Q21 and Q22 through both ``Session.sql``s
  at sf 0.01: frames exact (values and dtypes, ``check_exact``) and the
  route counters; each answers rows with no NULL there, so none needs a
  larger scale;
- their plans at sf 0.01 and SF1 (plans only: no data is generated), as
  ``test_torch_sql`` compares them;
- statements through both sessions: a scalar subquery in the select
  list, a BETWEEN with two scalar bounds, a scalar over an empty set
  (NULL: the filter keeps nothing), WITH with two CTEs (one named twice),
  a correlated scalar whose group is missing for some outer rows, Q21's
  shape over a group whose ``<>`` column is all one value, EXISTS under
  OR and AND (the mark join) and NOT EXISTS under OR (the parser makes
  ``not`` a UnaryOp over the EXISTS, so both packages answer it through
  the mark); and what both refuse: a scalar of two rows, IN and a scalar
  subquery under OR, a negated EXISTS node under OR (built by hand: the
  parser never makes one), an uncorrelated EXISTS, ``<>`` correlation in
  a scalar subquery (these two with the reference's class and words) and
  a UNION of two rows as a scalar subquery (one row a term, each term a
  batch: more than one row in both packages);
- ``bind_scalars``, ``Unbound`` and ``DataType.from_physical`` against
  the JAX package's on DECIMAL (Q15's SF1 magnitudes, sums near 2^47 at
  scale 4, included), DOUBLE, DATE, BIGINT and NULL;
- ``chip_smoke.py`` phase 12's numpy oracles against the port at sf
  0.01, and its ``planned_routes`` against the counters the port's run
  bumps.

Every reference run happens once, in the module-scoped ``ref`` fixture.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import presto_tpu.expr as JE
import presto_tpu.types as JT
import presto_tpu_torch.expr as PE
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.sql.analyzer import Analyzer as JAnalyzer
from presto_tpu.sql.parser import parse as jparse
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.sql.analyzer import AnalysisError
from presto_tpu_torch.sql.analyzer import Analyzer as PAnalyzer
from presto_tpu_torch.sql.parser import parse as pparse
from test_torch_sql import plan_shape
from torch_bridge import jax_run, port_run, port_type

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TPCH = list(chip_smoke.SUBQUERY_QUERIES)
PT_BOOLEAN = port_type(JT.BOOLEAN)

#: statements both packages answer
STATEMENTS = {
    "select list": "select n_name, (select max(r_regionkey) from region) as m, "
                   "(select count(*) from region where r_name like 'A%') as c from nation "
                   "where n_nationkey < 5 order by n_name",
    "between": "select count(*) as n, sum(o_totalprice) as s from orders where o_orderdate "
               "between (select min(l_shipdate) from lineitem where l_quantity > 49) "
               "and (select max(l_receiptdate) from lineitem where l_discount > 0.09 "
               "and l_quantity < 2)",
    "empty": "select count(*) as n from orders where o_totalprice > "
             "(select max(l_extendedprice) from lineitem where l_quantity > 1000)",
    "with two": "with big as (select o_custkey, sum(o_totalprice) as tot from orders "
                "group by o_custkey), seg as (select c_custkey, c_mktsegment from customer "
                "where c_acctbal > 0) select s.c_mktsegment, count(*) as n, max(b1.tot) as mx "
                "from seg s, big b1 where s.c_custkey = b1.o_custkey and b1.tot > "
                "(select avg(tot) from big) group by s.c_mktsegment order by s.c_mktsegment",
    "correlated, groups missing": "select count(*) as n, sum(c_acctbal) as s from customer "
                                  "where c_acctbal > (select avg(o_totalprice) / 100 from orders "
                                  "where o_custkey = c_custkey)",
    "not exists <>, one value": "select count(*) as n from orders o where o_orderstatus = 'F' "
                                "and not exists (select * from lineitem l where l.l_orderkey = "
                                "o.o_orderkey and l.l_linenumber <> 1)",
    "exists or": "select count(*) as n, sum(c_acctbal) as s from customer where exists "
                 "(select * from orders where o_custkey = c_custkey and o_totalprice > 300000) "
                 "or c_acctbal > 9000",
    "exists and-or": "select c_mktsegment, count(*) as n from customer where (exists "
                     "(select * from orders where o_custkey = c_custkey and o_orderpriority = "
                     "'1-URGENT') and c_acctbal > 0) or exists (select * from orders where "
                     "o_custkey = c_custkey and o_totalprice > 350000) group by c_mktsegment "
                     "order by c_mktsegment",
    "not exists or": "select count(*) as n from customer where not exists (select * from orders "
                     "where o_custkey = c_custkey) or c_acctbal > 9000",
}

#: statements both packages refuse: the port's error type and message
REFUSED = {
    "two rows": ("select count(*) as n from nation where n_regionkey = "
                 "(select r_regionkey from region where r_name like 'A%')",
                 ValueError, "scalar subquery returned more than one row"),
    "in under or": ("select count(*) as n from customer where c_custkey in "
                    "(select o_custkey from orders) or c_acctbal > 9000",
                    ValueError, "only EXISTS is supported inside OR predicates"),
    "scalar under or": ("select count(*) as n from customer where c_acctbal > "
                        "(select avg(c_acctbal) from customer) or c_custkey < 10",
                        ValueError, "only EXISTS is supported inside OR predicates"),
    "uncorrelated exists": ("select count(*) as n from nation where exists "
                            "(select * from region where r_name = 'ASIA')",
                            AnalysisError, "uncorrelated EXISTS not supported"),
    "<> in a scalar": ("select count(*) as n from nation where n_regionkey = (select "
                       "max(r_regionkey) from region where r_regionkey <> n_nationkey)",
                       AnalysisError, "<> correlation in scalar subquery unsupported"),
    "union as a scalar": ("select count(*) as n from nation where n_regionkey = "
                          "(select r_regionkey from region union all "
                          "select r_regionkey from region)",
                          ValueError, "scalar subquery returned more than one row"),
}


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


@pytest.fixture(scope="module")
def ref(conns):
    """Every reference run of the module, once: name -> (frame, route
    counters), or the exception the JAX package raised."""
    out = {}
    sqls = {**{q: QUERIES[q] for q in TPCH}, **STATEMENTS,
            **{name: sql for name, (sql, _t, _m) in REFUSED.items()}}
    for name, sql in sqls.items():
        try:
            out[name] = jax_run(conns[0], sql)
        except Exception as e:  # noqa: BLE001 - the refusal is the answer
            out[name] = e
    return out


def same_frames(conns, ref, name, sql):
    want = ref[name]
    assert not isinstance(want, Exception), f"the JAX package raised {want!r}"
    want, want_routes = want
    res, routes, _ = port_run(conns[1], sql)
    got = pd.DataFrame(res.to_dict())
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes
    return got


@pytest.mark.parametrize("q", TPCH)
def test_tpch_query_equals_jax_session(conns, ref, q):
    got = same_frames(conns, ref, q, QUERIES[q])
    assert len(got) > 0
    # rows with no NULL at sf 0.01: no larger scale is needed to match a value
    assert got.notna().all().all()


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax_session(conns, ref, name):
    got = same_frames(conns, ref, name, STATEMENTS[name])
    assert len(got) > 0
    if name == "empty":
        # a scalar over no row is NULL: the comparison keeps nothing
        assert list(got["n"]) == [0]
    elif name == "correlated, groups missing":
        # customers without orders have no group: the inner join drops them
        orders = pd.DataFrame(port_run(conns[1], "select count(*) as n from (select o_custkey "
                                                 "from orders group by o_custkey) x")[0].to_dict())
        assert 0 < got["n"][0] < orders["n"][0]
    elif name == "not exists <>, one value":
        assert got["n"][0] > 0
    elif name == "between":
        total = pd.DataFrame(port_run(conns[1], "select count(*) as n from orders")[0].to_dict())
        assert 0 < got["n"][0] < total["n"][0]


@pytest.mark.parametrize("name", list(REFUSED))
def test_both_packages_refuse(conns, ref, name):
    sql, port_error, message = REFUSED[name]
    assert isinstance(ref[name], Exception), f"the JAX package answered {name}"
    assert message in str(ref[name])
    with pytest.raises(port_error, match=message) as err:
        port_run(conns[1], sql)
    if port_error is AnalysisError:
        # the analyzer's own refusals: the reference's class and words
        assert (type(err.value).__name__, str(err.value)) == (
            type(ref[name]).__name__, str(ref[name]))


def _negate_exists(node):
    """``node`` with every Exists made ``negated`` (a dataclass AST of
    either package)."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        kw = {f.name: _negate_exists(getattr(node, f.name)) for f in dataclasses.fields(node)}
        if type(node).__name__ == "Exists":
            kw["negated"] = True
        return type(node)(**kw)
    if isinstance(node, tuple):
        return tuple(_negate_exists(v) for v in node)
    return node


def test_negated_exists_node_under_or_refused_by_both(conns):
    sql = ("select count(*) as n from customer where exists (select * from orders "
           "where o_custkey = c_custkey) or c_acctbal > 9000")
    jsession = JSession({"tpch": conns[0]})
    with pytest.raises(ValueError, match="NOT EXISTS inside OR predicates is not supported"):
        JAnalyzer(jsession.catalog).analyze(_negate_exists(jparse(sql)))
    psession = PSession({"tpch": conns[1]}, device="cpu")
    with pytest.raises(ValueError, match="NOT EXISTS inside OR predicates is not supported"):
        PAnalyzer(psession.catalog).analyze(_negate_exists(pparse(sql)))


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


@pytest.mark.parametrize("q", TPCH + ["with two", "exists and-or", "not exists <>, one value"])
def test_analyzer_builds_the_same_plan(plan_sessions, q):
    js, ps = plan_sessions
    sql = QUERIES.get(q) or STATEMENTS[q]
    want = plan_shape(js.plan(sql), js.catalog, j_join_strategy, j_agg_strategy, j_value_bits)
    got = plan_shape(ps.plan(sql), ps.catalog, p_join_strategy, p_agg_strategy, p_value_bits)
    assert got == want


# ---------------------------------------------------------------------------
# bind_scalars, Unbound and from_physical
# ---------------------------------------------------------------------------

#: Q15's SF1 revenue sums reach about 2^47 at scale 4
SCALARS = [
    ("decimal(38,4) near 2^47", JT.decimal(38, 4), [2**47 - 1, 2**47 + 12345, 140737488355327,
                                                    17_928_163_420_937, -(2**47) + 7]),
    ("decimal(38,2)", JT.decimal(38, 2), [0, 1, -1, 99_999_999, 123_456_789_012]),
    ("decimal(12,2)", JT.decimal(12, 2), [50, 99_999]),
    ("double", JT.DOUBLE, [np.float32(0.1).item(), np.float32(4537.2319).item(), -2.5]),
    ("date", JT.DATE, [0, 9131, 10471]),
    ("bigint", JT.BIGINT, [0, -7, 2**40 + 3]),
]


@pytest.mark.parametrize("name", [s[0] for s in SCALARS])
def test_from_physical_round_trip_equals_reference(name):
    jt, values = next((t, v) for n, t, v in SCALARS if n == name)
    pt = port_type(jt)
    for v in values:
        assert pt.from_physical(v) == jt.from_physical(v)
        logical = pt.from_physical(v) if jt.kind is not JT.TypeKind.DATE else v
        assert pt.to_physical(logical) == jt.to_physical(logical)
        if jt.kind is JT.TypeKind.DECIMAL:
            assert pt.to_physical(pt.from_physical(v)) == v


def _port_batch(values: dict) -> Batch:
    n = len(next(iter(values.values()))[0])
    live = torch.ones(n, dtype=torch.bool)
    return Batch({k: Column(torch.as_tensor(a), live, port_type(t))
                  for k, (a, t) in values.items()}, live)


@pytest.mark.parametrize("name", [s[0] for s in SCALARS] + ["null"])
def test_bind_scalars_equals_reference(name):
    """An ``Unbound`` slot in a comparison and an arithmetic, bound as
    the executor binds a scalar subquery's value, evaluates as the
    reference's does."""
    if name == "null":
        jt, value, column = JT.decimal(38, 4), None, np.array([0, 5, -5], np.int64)
    else:
        jt, values = next((t, v) for n, t, v in SCALARS if n == name)
        value = jt.from_physical(values[-1]) if jt.kind is not JT.TypeKind.DATE else values[-1]
        column = np.array(values, dtype=jt.np_dtype)
    slot = {"scalar$1": value}
    pt = port_type(jt)
    jexprs = [JE.Call(JT.BOOLEAN, op, (JE.InputRef(jt, "x"), JE.Unbound(jt, "scalar$1")))
              for op in ("eq", "lt", "ge")]
    pexprs = [PE.Call(PT_BOOLEAN, op, (PE.InputRef(pt, "x"), PE.Unbound(pt, "scalar$1")))
              for op in ("eq", "lt", "ge")]
    if jt.kind is JT.TypeKind.DECIMAL:
        jexprs.append(JE.Call(jt, "add", (JE.InputRef(jt, "x"), JE.Unbound(jt, "scalar$1"))))
        pexprs.append(PE.Call(pt, "add", (PE.InputRef(pt, "x"), PE.Unbound(pt, "scalar$1"))))
    jlive = jnp.ones(len(column), jnp.bool_)
    jb = JBatch({"x": JColumn(jnp.asarray(column), jlive, jt)}, jlive)
    pb = _port_batch({"x": (column, jt)})
    for je, pe in zip(jexprs, pexprs):
        jbound, pbound = JE.bind_scalars(je, slot), PE.bind_scalars(pe, slot)
        assert pbound.args[1].value == jbound.args[1].value
        jv, pv = JE.evaluate(jbound, jb), PE.evaluate(pbound, pb)
        np.testing.assert_array_equal(np.asarray(pv.data), np.asarray(jv.data))
        np.testing.assert_array_equal(np.asarray(pv.valid), np.asarray(jv.valid))


def test_unbound_slot_is_never_read():
    t = port_type(JT.BIGINT)
    e = PE.Call(PT_BOOLEAN, "eq", (PE.InputRef(t, "x"), PE.Unbound(t, "scalar$3")))
    with pytest.raises(KeyError, match="unbound scalar scalar\\$3"):
        PE.bind_scalars(e, {"scalar$1": 1})
    with pytest.raises(KeyError, match="unbound scalar scalar\\$3"):
        JE.bind_scalars(JE.Call(JT.BOOLEAN, "eq", (JE.InputRef(JT.BIGINT, "x"),
                                                   JE.Unbound(JT.BIGINT, "scalar$3"))),
                        {"scalar$1": 1})
    with pytest.raises(TypeError):
        PE.evaluate(e, _port_batch({"x": (np.arange(3, dtype=np.int64), JT.BIGINT)}))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12 at sf 0.01
# ---------------------------------------------------------------------------

#: at sf 0.01 these payload joins plan the fused probe but run the dense
#: table in both packages: BYTES payload columns are not fused (Q2's part
#: and supplier joins, Q15's supplier join) and an aggregate's int64
#: output cannot ride its int32 value tables (Q2's and Q17's subquery
#: joins, Q21's EXISTS join); the stats-only plan rule does not see
#: either. At SF1 phase 12 holds every query to its plan exactly.
PALLAS_RUN_DENSE = {"q2": 3, "q15": 1, "q17": 1, "q21": 1}


@pytest.fixture(scope="module")
def cached(conns):
    return chip_smoke.ColumnCache(conns[1])


@pytest.mark.parametrize("q", TPCH)
def test_chip_oracle_and_planned_routes_equal_the_port(conns, cached, q):
    """What phase 12 holds each query to on the card, held here at sf
    0.01: its numpy oracle, and the strategy counters its plan predicts
    (up to the pallas joins that run dense here, named above)."""
    sql, oracle = chip_smoke.subquery_runs()[q]
    res, routes, session = port_run(conns[1], sql)
    chip_smoke.same_result(res, oracle(cached), q)
    got = {k: v for k, v in routes.items() if k.startswith(("join.strategy.", "agg.strategy."))}
    planned = chip_smoke.planned_routes(session, sql)
    moved = PALLAS_RUN_DENSE.get(q, 0)
    if moved:
        planned["join.strategy.pallas"] -= moved
        planned["join.strategy.dense"] = planned.get("join.strategy.dense", 0) + moved
        planned = {k: v for k, v in planned.items() if v}
    assert got == planned


def test_scalar_round_trip_of_the_oracles_is_the_engines():
    """The oracles' decimal scalar round trip is ``from_physical`` then
    ``to_physical`` of the port's decimal(38,4)."""
    t = port_type(JT.decimal(38, 4))
    for v in (0, 1, 14_280_739_710, 2**47 - 1, 17_928_163_420_937):
        assert chip_smoke.scalar_round_trip(v, 4) == t.to_physical(t.from_physical(v))
