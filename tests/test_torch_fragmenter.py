"""The port's plan fragmenter (``presto_tpu_torch/plan/fragmenter.py``)
against the JAX package's: the cases of ``tests/test_fragmenter.py``
(sound row bounds, plan-time join distribution, the rendering) run on
both packages' plans with equal answers, and ``explain_distributed``'s
text equals the JAX package's letter for letter for the 22 TPC-H
queries at sf 0.01, from a local session and from a mesh session.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402
import torch_bridge  # noqa: E402,F401  (pins one intra-op thread)

from presto_tpu.connectors.tpch import TpchConnector as JT  # noqa: E402
from presto_tpu.connectors.tpch.queries import QUERIES  # noqa: E402
from presto_tpu.parallel.mesh import make_mesh as jmesh  # noqa: E402
from presto_tpu.plan import fragmenter as JF  # noqa: E402
from presto_tpu.plan import nodes as JN  # noqa: E402
from presto_tpu.runtime.session import Session as JSession  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PT  # noqa: E402
from presto_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from presto_tpu_torch.plan import fragmenter as PF  # noqa: E402
from presto_tpu_torch.plan import nodes as PN  # noqa: E402
from presto_tpu_torch.runtime.session import Session as PSession  # noqa: E402

SF = 0.002

Q3ISH = (
    "select o_orderdate, sum(l_extendedprice * (1 - l_discount)) rev "
    "from lineitem join orders on l_orderkey = o_orderkey "
    "where o_orderdate < date '1995-03-15' "
    "group by o_orderdate order by rev desc limit 10"
)


@pytest.fixture(scope="module")
def sessions():
    return (JSession({"tpch": JT(sf=SF)}),
            PSession({"tpch": PT(sf=SF, device="cpu")}, device="cpu"))


def _joins(plan, nodes):
    found = []

    def walk(n):
        if isinstance(n, nodes.Join):
            found.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    return found


def _both(sessions, sql):
    js, ps = sessions
    return (js, js.plan(sql), JF, JN), (ps, ps.plan(sql), PF, PN)


@pytest.mark.parametrize("sql", [
    "select count(*) from orders where o_orderdate < date '1995-01-01'",
    "select count(*) c from (select * from nation limit 0) t",
    "select count(*) from lineitem join orders on l_orderkey = o_orderkey",
    Q3ISH,
    "select l_orderkey, l_quantity from lineitem order by l_quantity limit 5",
    "select n_name from nation union all select r_name from region",
])
def test_upper_bound_rows_equal_reference(sessions, sql):
    (js, jplan, jf, _), (ps, pplan, pf, _) = _both(sessions, sql)
    assert pf.upper_bound_rows(pplan, ps.catalog) == jf.upper_bound_rows(jplan, js.catalog)
    assert pf.is_unfiltered(pplan.child) == jf.is_unfiltered(jplan.child)
    assert pf.output_partitioned(pplan) == jf.output_partitioned(jplan)


@pytest.mark.parametrize("sql,limit,budget", [
    (Q3ISH, 1 << 21, 1 << 30),
    ("select count(*) from supplier join nation on s_nationkey = n_nationkey",
     1 << 21, 1 << 30),
    ("select count(*) from lineitem join orders on l_orderkey = o_orderkey", 10, 1 << 30),
    ("select count(*) from lineitem join orders on l_orderkey = o_orderkey", 1 << 21, 1),
    ("select count(*) from lineitem join orders on l_orderkey = o_orderkey", 1 << 21, 1 << 40),
    ("select count(*) from lineitem join orders on l_orderkey = o_orderkey", 1 << 21, None),
])
def test_join_distribution_equals_reference(sessions, sql, limit, budget):
    """The reference's plan-time broadcast cases: the filtered Q3 build
    (broadcast, no fast path), the unfiltered dimension build (fast
    path), the forced ``auto``, and the tentative ``broadcast?``."""
    (js, jplan, jf, jn), (ps, pplan, pf, pn) = _both(sessions, sql)
    jfp = jf.fragment_plan(jplan, js.catalog, limit, budget)
    pfp = pf.fragment_plan(pplan, ps.catalog, limit, budget)
    (jj,), (pj,) = _joins(jplan, jn), _joins(pplan, pn)
    assert pfp.join_strategy[id(pj)] == jfp.join_strategy[id(jj)]
    assert pfp.join_fits_budget[id(pj)] == jfp.join_fits_budget[id(jj)]
    assert pfp.join_rows_ub.get(id(pj)) == jfp.join_rows_ub.get(id(jj))
    assert [(f.fid, f.partitioning, [(c, e.kind, e.keys) for c, e in f.consumes])
            for f in pfp.fragments] == \
        [(f.fid, f.partitioning, [(c, e.kind, e.keys) for c, e in f.consumes])
         for f in jfp.fragments]
    assert pfp.render() == jfp.render()


def test_render_with_skew_history_equals_reference(sessions):
    (js, jplan, jf, _), (ps, pplan, pf, _) = _both(sessions, Q3ISH)
    jfp = jf.fragment_plan(jplan, js.catalog, 1 << 21, 1 << 30)
    pfp = pf.fragment_plan(pplan, ps.catalog, 1 << 21, 1 << 30)
    jagg = jplan.child.child.child
    pagg = pplan.child.child.child
    assert type(pagg).__name__ == type(jagg).__name__ == "Aggregate"
    want = jfp.render(skew_history={id(jagg): 3.5})
    assert "skew~3.5x (observed)" in want
    assert pfp.render(skew_history={id(pagg): 3.5}) == want


def test_root_sort_renders_gather(sessions):
    _js, ps = sessions
    out = ps.explain_distributed("select l_orderkey, l_quantity from lineitem "
                                 "order by l_quantity limit 5")
    assert "gather <- fragment" in out.replace("[", "").replace("]", "")
    assert out.count("TableScan[tpch.lineitem]") == 1


@pytest.fixture(scope="module")
def tpch_sessions():
    jc, pc = JT(sf=0.01), PT(sf=0.01, device="cpu")
    return ((JSession({"tpch": jc}), PSession({"tpch": pc}, device="cpu")),
            (JSession({"tpch": jc}, mesh=jmesh(4)),
             PSession({"tpch": pc}, device="cpu", mesh=make_mesh(4, device="cpu"))))


@pytest.mark.parametrize("name", sorted(QUERIES, key=lambda q: int(q[1:])))
def test_explain_distributed_equals_reference(tpch_sessions, name):
    for js, ps in tpch_sessions:
        assert ps.explain_distributed(QUERIES[name]) == js.explain_distributed(QUERIES[name])
