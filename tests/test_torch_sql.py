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
- constructs outside the ported subset raise ``NotSupported`` naming
  them.
Exact comparisons throughout.
"""

import dataclasses

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
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.sql.parser import parse as pparse

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
        # AggSpec.offset is the lag/lead window row offset: windows are
        # not ported, so the port's AggSpec has no such field
        return (type(n).__name__,
                tuple((f.name, ast_shape(getattr(n, f.name))) for f in dataclasses.fields(n)
                      if not (type(n).__name__ == "AggSpec" and f.name == "offset")))
    if isinstance(n, (tuple, list)):
        return tuple(ast_shape(v) for v in n)
    return n


@pytest.mark.parametrize("i", range(len(STATEMENTS)))
def test_parser_builds_the_same_ast(i):
    assert ast_shape(pparse(STATEMENTS[i])) == ast_shape(jparse(STATEMENTS[i]))


def plan_shape(node, catalog, join_strategy, agg_strategy, value_bits):
    """Node kinds and every planning decision, recursively (the JAX
    and port node classes share names and field names)."""
    out = ast_shape(dataclasses.replace(node, **{
        f.name: None for f in dataclasses.fields(node)
        if f.name in ("child", "left", "right")}))
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
    ("select count(*) from lineitem where l_orderkey in (select o_orderkey from orders)",
     "subquery"),
    ("select l_orderkey, rank() over (order by l_quantity) from lineitem", "window"),
    ("select distinct l_returnflag from lineitem", "DISTINCT"),
    ("select stddev(l_quantity) from lineitem group by l_returnflag", "stddev"),
    ("select case when l_quantity > 10 then 1 else 0 end from lineitem", "CaseExpr"),
    ("with t as (select 1 as x from nation) select x from t", "WITH"),
    ("select n_name from nation union all select r_name from region", "SetQuery"),
    ("create table t as select n_name from nation", "CreateTableAs"),
]


@pytest.mark.parametrize("sql,what", UNSUPPORTED)
def test_constructs_outside_the_slice_raise_naming_them(sql, what):
    ps = PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu")
    with pytest.raises(NotSupported, match=what):
        ps.sql(sql)


OTHER_QUERIES = sorted((q for q in QUERIES if q not in ("q1", "q3", "q6", "q9", "q10")),
                       key=lambda q: int(q[1:]))


@pytest.mark.parametrize("q", OTHER_QUERIES)
def test_other_tpch_queries_refuse_rather_than_answer(q):
    """Every TPC-H query outside the slice raises NotSupported (none
    returns a silently wrong answer); Q3 and Q10 are compared with the
    reference in tests/test_torch_q3.py, Q1 and Q6 in
    tests/test_torch_leaf_route.py, Q9 in tests/test_torch_like_sql.py."""
    ps = PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu")
    with pytest.raises(NotSupported, match="not ported"):
        ps.sql(QUERIES[q])
