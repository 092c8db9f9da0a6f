"""The port's SQL front end against the JAX package's.

- the parser: the same AST (class names and fields, recursively) for
  TPC-H Q3 and Q10 and a few more statements;
- the analyzer + pruning: the same plan-node tree — node kinds, scan
  columns and types, predicates, join order, join kinds, ``unique``
  flags, keys, the keys/passengers split, aggregates and their value
  bounds, sort keys — and the same planned join and aggregation
  strategies (``fused`` on the leaf route), for TPC-H Q1, Q3, Q6 and Q10
  and SSB Q1.1, at sf 0.01 and at SF1 (plans only: no data is
  generated);
- constructs both packages refuse (the ``<>`` correlation in a scalar
  subquery) raise the same class with the same words, and the ones this file pinned before the
  port answered them (among them windows, GROUPING SETS / ROLLUP / CUBE,
  CREATE TABLE AS and EXPLAIN ANALYZE) equal the JAX package's answers,
  frames built as it builds them (``torch_bridge.port_frame``).
Exact comparisons throughout, but for the DOUBLE columns of ``ANSWERED``
(rtol 1e-3, atol 0.02: the tolerance tests/test_tpch_sql.py holds DOUBLE
aggregates to).
"""

import dataclasses

import pandas as pd
import pytest

from presto_tpu.connectors.ssb import SsbConnector as JSsb
from presto_tpu.connectors.ssb.queries import QUERIES as SSB
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan import nodes as JN
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.sql.parser import parse as jparse
from presto_tpu_torch.connectors.ssb import SsbConnector as PSsb
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.sql.parser import parse as pparse
from torch_bridge import ANALYZER_REFUSALS, refused_alike

STATEMENTS = [
    QUERIES["q3"],
    QUERIES["q10"],
    QUERIES["q1"],
    "select a.x, count(*) from t a join u on a.k = u.k where a.y between 1 and 2 "
    "group by a.x having count(*) > 3 order by 2 desc nulls first limit 5",
    "select case when x like 'a%' then 1 else 0 end from t where x in ('a', 'b')",
]


def ast_shape(n):
    """A package-independent structure of an AST or IR value."""
    if hasattr(n, "kind") and hasattr(n, "phys"):  # a DataType
        return ("type", n.kind.value, n.precision, n.scale, n.width, n.phys)
    if dataclasses.is_dataclass(n) and not isinstance(n, type):
        return (type(n).__name__,
                tuple((f.name, ast_shape(getattr(n, f.name))) for f in dataclasses.fields(n)))
    if isinstance(n, (tuple, list)):
        return tuple(ast_shape(v) for v in n)
    return n


@pytest.mark.parametrize("i", range(len(STATEMENTS)))
def test_parser_builds_the_same_ast(i):
    assert ast_shape(pparse(STATEMENTS[i])) == ast_shape(jparse(STATEMENTS[i]))


def filter_edge(node):
    """The runtime join filter a join or semi join pushes: (probe table,
    scan column), by the package's own ``filter_edge_for``."""
    if type(node).__module__.startswith("presto_tpu_torch."):
        from presto_tpu_torch.plan.joinfilters import filter_edge_for
    else:
        from presto_tpu.plan.joinfilters import filter_edge_for
    tgt = filter_edge_for(node)
    return None if tgt is None else (tgt[0].table, tgt[1])


def plan_shape(node, catalog, join_strategy, agg_strategy, value_bits):
    """Node kinds and every planning decision, recursively (the JAX
    and port node classes share names and field names), the runtime
    join filters' placement included."""
    out = ast_shape(dataclasses.replace(node, **{
        f.name: None for f in dataclasses.fields(node)
        if f.name in ("child", "left", "right")}))
    if type(node).__name__ in ("Join", "SemiJoin"):
        out += ("filter", filter_edge(node))
    if type(node).__name__ == "Join":
        out += ("strategy", join_strategy(node, catalog))
    if type(node).__name__ == "Aggregate":
        out += ("agg_strategy", agg_strategy(node, catalog), "bits",
                tuple(value_bits(node, catalog)))
    kids = tuple(plan_shape(c, catalog, join_strategy, agg_strategy, value_bits)
                 for c in node.children)
    return out + (kids,)


@pytest.fixture(scope="module", params=[0.01, 1])
def sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf), "ssb": JSsb(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu"), "ssb": PSsb(sf=sf, device="cpu")},
                     device="cpu"))


PLANNED = {"q3": QUERIES["q3"], "q10": QUERIES["q10"], "q1": QUERIES["q1"],
           "q6": QUERIES["q6"], "ssb q1_1": SSB["q1_1"]}


@pytest.mark.parametrize("q", list(PLANNED))
def test_analyzer_builds_the_same_plan(sessions, q):
    js, ps = sessions
    jplan, pplan = js.plan(PLANNED[q]), ps.plan(PLANNED[q])
    assert isinstance(pplan, PN.Output) and isinstance(jplan, JN.Output)
    want = plan_shape(jplan, js.catalog, j_join_strategy, j_agg_strategy, j_value_bits)
    got = plan_shape(pplan, ps.catalog, p_join_strategy, p_agg_strategy, p_value_bits)
    assert got == want


@pytest.mark.parametrize("q", ["q3", "q10"])
def test_plan_routes_the_probe_kernels(sessions, q):
    """Q3's customer join plans the fused exists probe and Q10's nation
    join the payload probe; the explain text shows it."""
    _js, ps = sessions
    text = ps.explain(QUERIES[q])
    assert "strategy=pallas" in text and "agg_strategy=bypass" in text
    joins = []

    def walk(n):
        if isinstance(n, PN.Join):
            joins.append(n)
        for c in n.children:
            walk(c)

    walk(ps.plan(QUERIES[q]))
    top = joins[0]  # the last join applied: customer (Q3) / nation (Q10)
    assert p_join_strategy(top, ps.catalog) == "pallas"
    assert bool(top.output_right) == (q == "q10")


UNSUPPORTED = [
    ("select count(*) from nation where n_regionkey = "
     "(select max(r_regionkey) from region where r_regionkey <> n_nationkey)",
     "<> correlation in a scalar subquery"),
]


@pytest.mark.parametrize("sql,what", UNSUPPORTED)
def test_constructs_outside_the_slice_raise_naming_them(sql, what):
    js = JSession({"tpch": JConnector(sf=0.01)})
    ps = PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu")
    err = refused_alike(lambda: js.sql(sql), lambda: ps.sql(sql))
    assert str(err) == ANALYZER_REFUSALS[what]


def test_explain_analyze_equals_jax_session():
    """EXPLAIN ANALYZE (``Session.explain_analyze``), each node's wall
    masked, equals the JAX package's rendering without its span lines
    (ROADMAP C14; tests/test_torch_explain_analyze.py holds more)."""
    import re

    sql = "select n_regionkey, count(*) c from nation group by n_regionkey"

    def masked(text):
        return [re.sub(r"wall [\d.]+ms", "wall ?ms", line) for line in text.splitlines()
                if not line.startswith("cache: ")]

    js = JSession({"tpch": JConnector(sf=0.01)}, properties={"result_cache_enabled": False})
    ps = PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu")
    assert masked(ps.explain_analyze(sql)) == masked(js.explain_analyze(sql))


#: constructs this file pinned as refused until the port answered them:
#: each now equals the JAX package's answer at sf 0.01 (DOUBLE columns
#: within the tests/test_tpch_sql.py tolerance)
ANSWERED = {
    "stddev": "select l_returnflag, stddev(l_quantity) as s from lineitem group by l_returnflag "
              "order by l_returnflag",
    "sqrt": "select l_orderkey, l_linenumber, sqrt(l_quantity) as r from lineitem "
            "order by l_orderkey, l_linenumber limit 100",
    "with a union": "with t as (select n_name from nation union all select r_name from region) "
                    "select n_name from t",
    "a union": "select n_name from nation union all select r_name from region",
    "rank": "select l_orderkey, rank() over (order by l_quantity) from lineitem",
    "lag": "select o_orderkey, lag(o_totalprice) over (order by o_orderkey) from orders",
    "grouping sets": ("select l_returnflag, count(*) from lineitem "
                      "group by grouping sets ((l_returnflag), ())"),
    "rollup": ("select l_returnflag, l_linestatus, count(*) from lineitem "
               "group by rollup(l_returnflag, l_linestatus)"),
    "cube": ("select l_returnflag, l_linestatus, count(*) from lineitem "
             "group by cube(l_returnflag, l_linestatus)"),
    "create table as": "create table t as select n_name from nation",
}


@pytest.mark.parametrize("name", list(ANSWERED))
def test_constructs_the_slice_answers_equal_jax_session(name):
    from torch_bridge import jax_run, port_frame, port_run

    want, want_routes = jax_run(JConnector(sf=0.01), ANSWERED[name])
    res, routes, _ = port_run(PConnector(sf=0.01, device="cpu"), ANSWERED[name])
    pd.testing.assert_frame_equal(port_frame(res), want, check_exact=False,
                                  rtol=1e-3, atol=0.02)
    assert routes == want_routes
    assert len(want) > 0


OTHER_QUERIES = []


def test_the_refused_queries_are_exactly_the_unported_ones():
    """All 22 TPC-H queries are ported, each compared with the reference
    elsewhere: Q3 and Q10 in tests/test_torch_q3.py, Q1 and Q6 in
    tests/test_torch_leaf_route.py, Q9 in tests/test_torch_like_sql.py,
    Q4 and Q18 in tests/test_torch_semi.py, Q5 and Q13 in
    tests/test_torch_outer_join.py, Q7, Q8, Q12, Q14, Q16 and Q19 in
    tests/test_torch_conditional_sql.py, Q2, Q11, Q15, Q17, Q20, Q21 and
    Q22 in tests/test_torch_subquery.py; none is refused."""
    ported = ["q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10", "q11", "q12", "q13",
              "q14", "q15", "q16", "q17", "q18", "q19", "q20", "q21", "q22"]
    assert sorted(ported + OTHER_QUERIES) == sorted(QUERIES)
    assert OTHER_QUERIES == []
