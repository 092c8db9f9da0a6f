"""Semi and anti joins in the port against the JAX package, exactly.

- ``ops/join``: ``probe_exists`` and ``probe_exists_dense`` equal the
  JAX package's on the same sides, NULL and dead rows included.
- ``exec/joins``: ``LookupJoinOperator`` semi and anti joins on every
  route (the fused exists probe, the fused sketch for semi, the dense
  table, the sorted keys) keep the JAX operators' rows on the same
  batches, NULL keys on both sides and duplicate build keys included,
  and take the same route; an empty build side raises in both packages.
- SQL at sf 0.01 through both ``Session.sql``s: TPC-H Q4 and its
  NOT EXISTS / IN / NOT IN variants, the JAX tests' ``semi`` and
  ``anti`` statements, ``semi_anti_part``, and Q18 (an IN over a
  grouped subquery): frames and dtypes, and the route counters
  (``join.strategy.*``, ``exec.pallas_join_route``,
  ``exec.leaf_fused_route``, ``exec.leaf_route_fallback.*``,
  ``agg.strategy.*``).
- plans at sf 0.01 and SF1 stats (no data generated), with
  ``approx_join`` off and on: the same tree, the same planned join and
  aggregation strategies, and the same ``SemiJoin`` lines in EXPLAIN.
- the approximate route end to end at sf 0.1 (the smallest scale where
  ``o_orderkey``'s domain, 600,000, is past the exists table's 2^19
  keys): the port's answer equals the JAX package's with
  ``runtime_join_filters`` off (ROADMAP C11: the JAX package's runtime
  Bloom filter would prune some of the sketch's false positives, and
  the port has none yet), is a superset of the exact answer, and
  ``QueryResult.approximate`` equals ``QueryInfo.approximate``.
- the analyzer's refusals of the subquery shapes both packages refuse
  (the same class and words), the set operations inside subqueries equal to the JAX
  package's (answers, or the same refusal), and ``chip_smoke``'s
  oracles at sf 0.01.
Tolerance: exact everywhere.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from presto_tpu.batch import Batch as JBatch
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.exec.pipeline import BatchSource as JBatchSource
from presto_tpu.exec.pipeline import Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.ops import join as jjoin
from presto_tpu.ops import pallas_join
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.types import INTEGER as JINTEGER
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.expr import col as pcol
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops import join as pjoin
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.session import Session as PSession
from test_torch_sql import ast_shape, filter_edge
from torch_bridge import (
    assert_same,
    counters,
    mark_counters,
    port_batch,
    port_type,
    ANALYZER_REFUSALS,
    refused_alike,
    to_numpy,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SF = 0.01
_Q4_HEAD = ("select o_orderpriority, count(*) as order_count from orders "
            "where o_orderdate >= date '1993-07-01' "
            "and o_orderdate < date '1993-07-01' + interval '3' month and ")
_Q4_TAIL = " group by o_orderpriority order by o_orderpriority"
_LATE = "(select * from lineitem where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)"
_LATE_KEYS = "(select l_orderkey from lineitem where l_commitdate < l_receiptdate)"

SQL = {
    "q4": QUERIES["q4"],
    "q4 not exists": _Q4_HEAD + "not exists " + _LATE + _Q4_TAIL,
    "q4 in": _Q4_HEAD + "o_orderkey in " + _LATE_KEYS + _Q4_TAIL,
    "q4 not in": _Q4_HEAD + "o_orderkey not in " + _LATE_KEYS + _Q4_TAIL,
    "semi": chip_smoke.SEMI_SQL["semi"],
    "anti": chip_smoke.SEMI_SQL["anti"],
    "semi_anti_part": chip_smoke.SEMI_SQL["semi_anti_part"],
    "q18": QUERIES["q18"],
    "q18 over 200": QUERIES["q18"].replace("> 300", "> 200"),
}
ROUTES = ("join.strategy.", "exec.pallas_join_route", "exec.leaf_fused_route",
          "exec.leaf_route_fallback", "agg.strategy.", "join.pallas_fallback",
          "join.filter_rows_")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


# ---------------------------------------------------------------------------
# ops and operators
# ---------------------------------------------------------------------------


def test_membership_probes_match_reference():
    rng = np.random.default_rng(4)
    bk = rng.integers(-500, 500, 800)  # duplicates
    blive = rng.random(800) < 0.8
    pk = rng.integers(-700, 700, 3000)
    plive = rng.random(3000) < 0.85
    jside = jjoin.build_lookup(jnp.asarray(bk), jnp.asarray(blive), 1024)
    pside = pjoin.build_lookup(_t(bk), _t(blive), 1024)
    assert_same(pjoin.probe_exists(pside, _t(pk), _t(plive)),
                jjoin.probe_exists(jside, jnp.asarray(pk), jnp.asarray(plive)), "probe_exists")
    jd = jjoin.build_dense(jnp.asarray(bk), jnp.asarray(blive), -500, 1000)
    pd_ = pjoin.build_dense(_t(bk), _t(blive), -500, 1000)
    assert_same(pjoin.probe_exists_dense(pd_, _t(pk), _t(plive)),
                jjoin.probe_exists_dense(jd, jnp.asarray(pk), jnp.asarray(plive)),
                "probe_exists_dense")


# (join type, route): the fused routes get a spec, the dense route a
# dense domain, the sorted route neither
OP_CASES = [(jt, route) for jt in ("semi", "anti") for route in ("exists", "dense", "unique")]
OP_CASES.insert(1, ("semi", "sketch"))


@pytest.mark.parametrize("jt,route", OP_CASES)
def test_operator_routes_match_reference(jt, route):
    """NULL probe keys (kept by anti, dropped by semi), NULL build keys
    (match nothing), duplicate build keys, keys outside the build
    domain: the port keeps the JAX operator's rows on the same route."""
    rng = np.random.default_rng(len(jt) * 7 + len(route))
    bk = rng.integers(-40, 400, 200)
    pk = rng.integers(-80, 460, 1500)
    bvalid, pvalid = rng.random(200) < 0.9, rng.random(1500) < 0.9
    types = {"bk": JINTEGER, "pk": JINTEGER, "pval": JINTEGER}
    jb = JBatch.from_numpy({"bk": bk}, types, capacity=1024, valids={"bk": bvalid})
    jp = JBatch.from_numpy({"pk": pk, "pval": np.arange(1500)}, types, capacity=2048,
                           valids={"pk": pvalid})
    kw_j, kw_p = {}, {}
    if route == "exists":
        kw_j["pallas"] = pallas_join.PallasJoinSpec("exists", -40, 399)
        kw_p["pallas"] = cuda_join.PallasJoinSpec("exists", -40, 399)
    elif route == "sketch":
        kw_j["pallas"] = pallas_join.PallasJoinSpec("sketch", nbits=pallas_join.SKETCH_BITS)
        kw_p["pallas"] = cuda_join.PallasJoinSpec("sketch", nbits=cuda_join.SKETCH_BITS)
    elif route == "dense":
        kw_j["dense_domain"] = kw_p["dense_domain"] = (-40, 440)
    jbuild = JJ.JoinBuildOperator(jcol("bk", JINTEGER), **kw_j)
    JPipeline(JBatchSource([jb]), [jbuild]).run()
    jop = JJ.LookupJoinOperator(jbuild, jcol("pk", JINTEGER), (), jt)
    (jout,) = JPipeline(JBatchSource([jp]), [jop]).run()
    t = port_type(JINTEGER)
    pbuild = PJ.JoinBuildOperator(pcol("bk", t), **kw_p)
    pbuild.process(port_batch(jb))
    pbuild.finish()
    pop = PJ.LookupJoinOperator(pbuild, pcol("pk", t), (), jt)
    (pout,) = pop.process(port_batch(jp))
    want = {"exists": "pallas", "sketch": "pallas", "dense": "dense", "unique": "unique"}[route]
    assert jop._strategy == pop._strategy == want
    assert_same(pout.live, jout.live, f"{jt} {route} keep mask")
    kept = to_numpy(pout.live)
    if jt == "anti":
        assert kept[:1500][~pvalid].all(), "anti dropped a NULL probe key"
    else:
        assert not kept[:1500][~pvalid].any(), "semi kept a NULL probe key"


def test_empty_build_side_raises_in_both_packages():
    """A join build that never received a batch: the JAX package raises
    RuntimeError, the port NotSupported; neither answers."""
    jbuild = JJ.JoinBuildOperator(jcol("bk", JINTEGER))
    with pytest.raises(RuntimeError, match="empty build side"):
        jbuild.finish()
    pbuild = PJ.JoinBuildOperator(pcol("bk", port_type(JINTEGER)))
    with pytest.raises(NotSupported, match="empty join build side"):
        pbuild.finish()


# ---------------------------------------------------------------------------
# SQL at sf 0.01
# ---------------------------------------------------------------------------


def _jax_run(conn, sql, **props):
    before = REGISTRY.snapshot()
    df = JSession({"tpch": conn}, properties=props).sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after.get(k, 0) - before.get(k, 0) for k in after if k.startswith(ROUTES)}
    return df, {k: v for k, v in routes.items() if v}


def _port_run(conn, sql, **props):
    mark_counters()
    res = PSession({"tpch": conn}, properties=props, device="cpu").sql(sql)
    return res, {k: v for k, v in counters().items() if k.startswith(ROUTES) and v}


@pytest.mark.parametrize("name", list(SQL))
def test_session_sql_equals_jax_session(conns, name):
    want, want_routes = _jax_run(conns[0], SQL[name])
    res, routes = _port_run(conns[1], SQL[name])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert not res.approximate
    if name in ("q4", "q4 in", "semi"):
        assert routes.get("exec.leaf_fused_route") == 1  # the semi membership fold
    if name == "semi_anti_part":
        assert routes.get("exec.pallas_join_route") == 2


@pytest.mark.parametrize("name", ["q4", "semi", "anti", "semi_anti_part"])
def test_chip_oracles_equal_the_port(conns, name):
    """``chip_smoke``'s exact numpy recomputations (the card's oracles)."""
    res, _ = _port_run(conns[1], SQL[name])
    want = (chip_smoke.q4_expected(conns[1]) if name == "q4"
            else chip_smoke.semi_expected(conns[1], name))
    chip_smoke.same_result(res, want, name)


def test_pallas_join_off_gives_the_same_rows(conns):
    for name in ("q4 not exists", "anti", "semi_anti_part"):
        res, routes = _port_run(conns[1], SQL[name], pallas_join=False)
        want, _ = _jax_run(conns[0], SQL[name], pallas_join=False)
        pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
        assert "exec.pallas_join_route" not in routes


# ---------------------------------------------------------------------------
# plans at sf 0.01 and SF1 stats, approx_join off and on
# ---------------------------------------------------------------------------


def _shape(node, catalog, join_strategy, agg_strategy, approx):
    import dataclasses

    out = ast_shape(dataclasses.replace(node, **{
        f.name: None for f in dataclasses.fields(node) if f.name in ("child", "left", "right")}))
    kind = type(node).__name__
    if kind in ("Join", "SemiJoin"):
        out += ("strategy", join_strategy(node, catalog, approx_join=approx),
                "filter", filter_edge(node))
    if kind == "Aggregate":
        out += ("agg_strategy", agg_strategy(node, catalog))
    return out + tuple(_shape(c, catalog, join_strategy, agg_strategy, approx)
                       for c in node.children)


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return {a: (JSession({"tpch": JConnector(sf=sf)}, properties={"approx_join": a}),
                PSession({"tpch": PConnector(sf=sf, device="cpu")},
                         properties={"approx_join": a}, device="cpu"))
            for a in (False, True)}


def _join_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines() if "Join" in ln]


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("name", ["q4", "q4 not exists", "q4 in", "semi", "anti",
                                  "semi_anti_part", "q18"])
def test_plans_match_reference(plan_sessions, name, approx):
    js, ps = plan_sessions[approx]
    want = _shape(js.plan(SQL[name]), js.catalog, j_join_strategy, j_agg_strategy, approx)
    got = _shape(ps.plan(SQL[name]), ps.catalog, p_join_strategy, p_agg_strategy, approx)
    assert got == want
    jlines, plines = _join_lines(js.explain(SQL[name])), _join_lines(ps.explain(SQL[name]))
    assert plines == jlines
    if approx and name in ("q4", "semi") and ps.catalog.connector("tpch").sf == 1:
        assert "SemiJoin strategy=sketch(approx)" in plines
    if name == "anti":
        assert not any("sketch" in ln for ln in plines)


# ---------------------------------------------------------------------------
# the approximate route end to end
# ---------------------------------------------------------------------------

APPROX_SQL = ("select o_orderkey, o_orderpriority from orders "
              "where o_orderdate >= date '1993-07-01' "
              "and o_orderdate < date '1993-07-01' + interval '3' month "
              "and exists " + _LATE + " order by o_orderkey")


def test_approximate_answer_equals_reference_and_is_flagged():
    """At sf 0.1 ``approx_join`` plans the sketch for the EXISTS (600,000
    keys do not fit the exists table). Both sessions run with
    ``runtime_join_filters`` off, so the answer is the sketch's alone
    (the twin below runs both at their defaults). Not aggregate-shaped,
    so the leaf route's exact membership fold cannot take it."""
    jc, pc = JConnector(sf=0.1), PConnector(sf=0.1, device="cpu")
    js = JSession({"tpch": jc}, properties={"approx_join": True, "runtime_join_filters": False,
                                            "result_cache_enabled": False})
    want, info = js.execute(APPROX_SQL)
    ps = PSession({"tpch": pc}, properties={"approx_join": True, "runtime_join_filters": False},
                  device="cpu")
    assert "strategy=sketch(approx)" in ps.explain(APPROX_SQL)
    mark_counters()
    res = ps.sql(APPROX_SQL)
    assert counters()["exec.pallas_join_route"] == 1 and counters()["join.pallas_fallback"] == 0
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert res.approximate is True and info.approximate is True
    exact = PSession({"tpch": pc}, device="cpu").sql(APPROX_SQL)
    assert exact.approximate is False and "sketch" not in PSession(
        {"tpch": pc}, device="cpu").explain(APPROX_SQL)
    got_keys, exact_keys = res.column("o_orderkey"), exact.column("o_orderkey")
    assert set(exact_keys) <= set(got_keys) and len(got_keys) > len(exact_keys)
    # the approximate rows are exactly the numpy Bloom oracle's
    o = pc.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    li = pc.table_numpy("lineitem", ["l_orderkey", "l_commitdate", "l_receiptdate"])
    build = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
    m = ((o["o_orderdate"] >= chip_smoke.days("1993-07-01"))
         & (o["o_orderdate"] < chip_smoke.days("1993-10-01"))
         & chip_smoke.np_bloom_member(build, o["o_orderkey"]))
    np.testing.assert_array_equal(got_keys, np.sort(o["o_orderkey"][m]))


def test_approximate_answer_with_runtime_filters_equals_reference():
    """The twin of the test above with both sessions at their defaults:
    the runtime join filter (on in both packages) prunes some of the
    sketch's false positives at the ``orders`` scan, so the answer is
    the sketch's AND the filter's, equal to the reference's and to a
    numpy oracle of both (range, a Bloom test at the filter's bits, the
    sketch's Bloom test); the pruned counts equal the reference's.
    The reference runs through ``Session.sql``: its tracked ``execute``
    materializes every node's output for its statistics, so the scan
    drains before the build publishes the filter's products."""
    from presto_tpu.runtime.metrics import REGISTRY as JREG

    jc, pc = JConnector(sf=0.1), PConnector(sf=0.1, device="cpu")
    js = JSession({"tpch": jc}, properties={"approx_join": True, "result_cache_enabled": False})
    before = JREG.snapshot()
    want = js.sql(APPROX_SQL)
    after = JREG.snapshot()
    want_filters = {k: int(after.get(k, 0) - before.get(k, 0)) for k in after
                    if k.startswith("join.filter_rows_")}
    ps = PSession({"tpch": pc}, properties={"approx_join": True}, device="cpu")
    mark_counters()
    res = ps.sql(APPROX_SQL)
    assert counters()["exec.pallas_join_route"] == 1 and counters()["join.pallas_fallback"] == 0
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert res.approximate is True
    got_filters = {k: v for k, v in counters().items() if k.startswith("join.filter_rows_")}
    assert got_filters == want_filters and got_filters["join.filter_rows_pruned"] > 0
    unfiltered = PSession({"tpch": pc}, properties={"approx_join": True,
                                                    "runtime_join_filters": False},
                          device="cpu").sql(APPROX_SQL)
    exact = PSession({"tpch": pc}, device="cpu").sql(APPROX_SQL)
    got_keys = res.column("o_orderkey")
    assert set(exact.column("o_orderkey")) <= set(got_keys) <= set(unfiltered.column("o_orderkey"))
    assert len(got_keys) < len(unfiltered.column("o_orderkey"))
    o = pc.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    li = pc.table_numpy("lineitem", ["l_orderkey", "l_commitdate", "l_receiptdate"])
    build = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
    nbits = chip_smoke.plan_filter_bits(ps, APPROX_SQL)
    m = ((o["o_orderdate"] >= chip_smoke.days("1993-07-01"))
         & (o["o_orderdate"] < chip_smoke.days("1993-10-01"))
         & chip_smoke.np_bloom_member(build, o["o_orderkey"])
         & chip_smoke.np_filter_keep(build, o["o_orderkey"], nbits))
    np.testing.assert_array_equal(got_keys, np.sort(o["o_orderkey"][m]))


def test_approximate_flag_follows_the_reference(conns):
    """tests/test_join_route.py's QueryInfo.approximate contract: a run
    that planned no sketch is exact under ``approx_join`` too (here the
    exists table fits at sf 0.01), in both packages."""
    js = JSession({"tpch": conns[0]}, properties={"approx_join": True,
                                                  "result_cache_enabled": False})
    for name in ("anti", "semi_anti_part"):
        _df, info = js.execute(SQL[name])
        res, _ = _port_run(conns[1], SQL[name], approx_join=True)
        assert res.approximate is info.approximate is False


# ---------------------------------------------------------------------------
# the analyzer's refusals
# ---------------------------------------------------------------------------

REFUSED = [
    ("select count(*) from lineitem l1 where l_quantity < (select avg(l2.l_quantity) from "
     "lineitem l2 where l2.l_orderkey = l1.l_orderkey and l2.l_suppkey <> l1.l_suppkey)",
     "<> correlation in a scalar subquery"),
    ("select count(*) from orders where exists (select * from lineitem where l_quantity > 49)",
     "uncorrelated EXISTS"),
]


@pytest.mark.parametrize("sql,what", REFUSED)
def test_subquery_shapes_outside_the_slice_raise_naming_them(conns, sql, what):
    err = refused_alike(lambda: JSession({"tpch": conns[0]}).sql(sql),
                        lambda: PSession({"tpch": conns[1]}, device="cpu").sql(sql))
    assert str(err) == ANALYZER_REFUSALS[what]


#: set operations inside subqueries, as both packages take them: the
#: scalar over a UNION of two one-row terms answers (each term is a batch
#: of its own, and the one-row check sees a batch at a time), the IN over
#: a UNION build is a semi join, and an EXISTS under OR whose correlated
#: reference sits inside a UNION does not resolve, in both
SET_SUBQUERIES = {
    "scalar over a union": ("select count(*) from lineitem where l_quantity < (select "
                            "avg(l_quantity) from lineitem union all select avg(l_discount) "
                            "from lineitem)"),
    "correlated exists over a union under or": (
        "select count(*) from orders where o_orderkey < 10 or exists "
        "(select l_orderkey from lineitem where l_orderkey = o_orderkey "
        "union all select ps_partkey from partsupp)"),
    "in over a union": ("select count(*) from orders where o_orderkey in "
                        "(select l_orderkey from lineitem union all select ps_partkey "
                        "from partsupp)"),
}


@pytest.mark.parametrize("name", list(SET_SUBQUERIES))
def test_set_operation_subqueries_equal_jax_session(conns, name):
    sql = SET_SUBQUERIES[name]
    try:
        want, want_routes = _jax_run(conns[0], sql)
    except Exception as e:  # noqa: BLE001 - a refusal must be the port's too
        with pytest.raises(ValueError) as got:
            _port_run(conns[1], sql)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        assert name == "correlated exists over a union under or"
        return
    res, routes = _port_run(conns[1], sql)
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert name != "correlated exists over a union under or"
