"""EXPLAIN ANALYZE and ``Session.execute`` in the port against the JAX
package's.

- ``explain_analyze`` text, with each node's ``wall ...ms`` masked, equal
  line for line to the reference's for TPC-H Q1, Q3 and Q10, SSB Q1.1, a
  window and a UNION at sf 0.01 (rows in and out, estimates, MISEST
  flags, bytes, calls, strategies, ``not executed``) and the ``cache:``
  span lines (``exec_cache:build``, ``stats_cache:minmax_probe``) with
  their walls masked, from cleared executable and stats caches
  (``test_cache_span_lines_equal_reference``);
- ``execute``: the same frame, ``QueryInfo.state`` and ``output_rows``,
  and the same ``node_stats`` rows (every field but the wall);
  ``collect_node_stats`` on ``Session.sql`` runs the recorder, with the
  same route counters (the recorder skips the leaf route);
- ``tests/test_plan_stats.py``'s recorder, estimate and rendering unit
  cases and ``tests/test_trace.py``'s node-id cases on the port's
  ``runtime/stats.py`` (the plan-stats history has cases of its own in
  ``test_torch_plan_stats.py``).
"""

import gc
import re

import pandas as pd
import pytest

import presto_tpu.cache.exec_cache as JEC
import presto_tpu.cache.stats_cache as JSC
import presto_tpu_torch.cache.exec_cache as PEC
import presto_tpu_torch.cache.stats_cache as PSC
from presto_tpu.connectors.ssb import SsbConnector as JSsb
from presto_tpu.connectors.ssb.queries import QUERIES as SSB
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.ssb import SsbConnector as PSsb
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.runtime.stats import (
    MISEST_FACTOR,
    NodeIds,
    StatsRecorder,
    misestimate_ratio,
)
from torch_bridge import ROUTES, counters, mark_counters, port_frame

#: every case starts from cleared executable and stats caches
pytestmark = pytest.mark.resets_global_state

SF = 0.01

Q_AGG = ("select l_returnflag, count(*) c, sum(l_quantity) q "
         "from lineitem group by l_returnflag order by l_returnflag")

ANALYZED = {
    "q1": ("tpch", QUERIES["q1"]),
    "q3": ("tpch", QUERIES["q3"]),
    "q10": ("tpch", QUERIES["q10"]),
    "ssb q1_1": ("ssb", SSB["q1_1"]),
    "window": ("tpch", "select o_orderkey, lag(o_totalprice) over (order by o_orderkey) p "
                       "from orders where o_orderkey < 500"),
    "union": ("tpch", "select n_name from nation union all select r_name from region"),
    "agg": ("tpch", Q_AGG),
}


@pytest.fixture(scope="module")
def conns():
    return {"tpch": (JConnector(sf=SF), PConnector(sf=SF, device="cpu")),
            "ssb": (JSsb(sf=SF), PSsb(sf=SF, device="cpu"))}


@pytest.fixture(autouse=True)
def cold_caches():
    """Both packages' executable and stats caches start empty: a miss
    records the span a ``cache:`` line renders."""
    JEC.EXEC_CACHE.clear()
    PEC.EXEC_CACHE.clear()
    JSC.clear()
    PSC.clear()


def sessions_for(conns, key: str, **props):
    j, p = conns[key]
    props = {"result_cache_enabled": False, **props}
    return (JSession({key: j}, properties=props),
            PSession({key: p}, properties=props, device="cpu"))


def masked(text: str) -> list:
    """The rendering's lines with each wall masked (the ``cache:`` span
    lines' too)."""
    return [re.sub(r"(wall |^cache: \S+ )[\d.]+ms", r"\1?ms", line)
            for line in text.splitlines()]


@pytest.mark.parametrize("name", list(ANALYZED))
def test_explain_analyze_equals_jax_session(conns, name):
    key, sql = ANALYZED[name]
    js, ps = sessions_for(conns, key)
    want = js.explain_analyze(sql)
    got = ps.explain_analyze(sql)
    assert masked(got) == masked(want)


def test_cache_span_lines_equal_reference(conns):
    """Both packages append their executable cache's ``cache:`` span
    lines, one per building miss, equal with the walls masked."""
    js, ps = sessions_for(conns, "tpch")
    sql = ("select n_regionkey, count(*) c from nation where n_nationkey < 17 "
           "group by n_regionkey order by n_regionkey")
    want = js.explain_analyze(sql)
    got = ps.explain_analyze(sql)
    assert masked(got) == masked(want)
    assert any(line.startswith("cache: exec_cache:build") for line in got.splitlines())


def node_rows(info) -> list:
    return sorted(({k: v for k, v in st.items() if k != "wall_s"} for st in info.node_stats),
                  key=lambda st: st["nodeId"])


@pytest.mark.parametrize("name", ["q3", "agg", "union"])
def test_execute_equals_jax_session(conns, name):
    key, sql = ANALYZED[name]
    js, ps = sessions_for(conns, key)
    want, jinfo = js.execute(sql)
    res, info = ps.execute(sql)
    pd.testing.assert_frame_equal(port_frame(res), want)
    assert info.state == jinfo.state == "FINISHED"
    assert info.output_rows == jinfo.output_rows == len(want)
    assert len(info.node_stats) == len(jinfo.node_stats)
    assert node_rows(info) == node_rows(jinfo)
    assert info.planning_s > 0 and info.execution_s > 0
    assert not (info.cache_hit or info.template_hit or info.coalesced or info.batched)


def test_collect_node_stats_property_routes_alike(conns):
    """``collect_node_stats`` runs ``Session.sql`` with the recorder: the
    leaf route is skipped (Q6 aggregates as ``single``), in both."""
    js, ps = sessions_for(conns, "tpch", collect_node_stats=True)
    before = REGISTRY.snapshot()
    want = js.sql(QUERIES["q6"])
    after = REGISTRY.snapshot()
    want_routes = {k: int(after[k] - before.get(k, 0)) for k in after
                   if k.startswith(ROUTES) and after[k] != before.get(k, 0)}
    mark_counters()
    got = port_frame(ps.sql(QUERIES["q6"]))
    pd.testing.assert_frame_equal(got, want)
    assert {k: v for k, v in counters().items() if k.startswith(ROUTES) and v} == want_routes
    assert counters()["agg.strategy.single"] == 1 and not counters()["exec.leaf_fused_route"]
    assert ps.query_history[-1].node_stats


# ---------------------------------------------------------------------------
# tests/test_plan_stats.py and tests/test_trace.py unit cases
# ---------------------------------------------------------------------------


class _FakeNode:
    children = ()


def test_record_output_rows_accumulates_across_invocations():
    rec = StatsRecorder()
    n = _FakeNode()
    rec.record(n, 0.1, 10, output_bytes=100)
    rec.record(n, 0.1, 15, output_bytes=150)
    rec.record(n, 0.1)  # unmeasured invocation: must not reset rows
    st = rec.stats_for(n)
    assert (st.output_rows, st.output_bytes, st.invocations) == (25, 250, 3)


def test_finalize_input_rows_rollup_uses_accumulated_rows():
    class _Parent:
        def __init__(self, *children):
            self.children = children

    child = _FakeNode()
    parent = _Parent(child)
    rec = StatsRecorder()
    rec.record(child, 0.1, 7)
    rec.record(child, 0.1, 8)
    rec.record(parent, 0.2, 3)
    rec.finalize(parent)
    assert rec.stats_for(parent).input_rows == 15


def test_misestimate_ratio_edges():
    assert misestimate_ratio(100, 100) == 1.0
    assert misestimate_ratio(10, 1000) == 100.0
    assert misestimate_ratio(1000, 10) == 100.0
    assert misestimate_ratio(500, 0) == 500.0
    assert misestimate_ratio(0, 100) == 0.0
    assert misestimate_ratio(None, 100) == 0.0
    assert misestimate_ratio(100, -1) == 0.0


def test_node_ids_pin_their_nodes():
    ids = NodeIds()
    first = _FakeNode()
    first_id = ids.of(first)
    addr = id(first)
    del first
    gc.collect()
    assert ids._pinned and id(ids._pinned[0]) == addr
    others = [_FakeNode() for _ in range(64)]
    assert all(ids.of(o) != first_id for o in others)


def test_stats_recorder_keys_by_stable_id():
    rec = StatsRecorder()
    a, b = _FakeNode(), _FakeNode()
    rec.record(a, 0.5, 10)
    rec.record(b, 0.25, 20)
    rec.record(a, 0.5)
    sa, sb = rec.stats_for(a), rec.stats_for(b)
    assert sa is not sb and sa.wall_s == pytest.approx(1.0) and sa.invocations == 2
    assert sb.output_rows == 20 and sa.node_id != sb.node_id


def test_attach_estimates_equals_reference(conns):
    """Every node's estimate snapshot (rows, sound bound, exactness,
    strategy, row bytes) equals the reference's, Q3 and the aggregate."""
    from presto_tpu.runtime.stats import StatsRecorder as JRecorder

    js, ps = sessions_for(conns, "tpch")
    for sql in (QUERIES["q3"], Q_AGG):
        jplan, pplan = js.plan(sql), ps.plan(sql)
        jrec, prec = JRecorder(), StatsRecorder()
        jrec.attach_plan(jplan)
        prec.attach_plan(pplan)
        jrec.attach_estimates(jplan, js.catalog)
        prec.attach_estimates(pplan, ps.catalog)
        assert [e.to_dict() for e in prec.estimates.values()] == \
            [e.to_dict() for e in jrec.estimates.values()]

    def count(n):
        return 1 + sum(count(c) for c in n.children)

    assert len(prec.estimates) == count(pplan)
    scan = pplan
    while scan.children:
        scan = scan.children[0]
    est = prec.estimate_for(scan)
    assert est.est_rows == ps.catalog.connector("tpch").row_count("lineitem")
    assert est.upper_bound_rows == est.est_rows and est.exact and est.row_bytes > 0


def test_estimate_record_exactness_tracks_predicates(conns):
    from presto_tpu_torch.plan.bounds import estimate_record

    _js, ps = sessions_for(conns, "tpch")
    exact = estimate_record(ps.plan("select l_orderkey from lineitem").children[0], ps.catalog)
    filtered = estimate_record(ps.plan("select l_orderkey from lineitem where l_quantity < 10")
                               .children[0], ps.catalog)
    assert exact["exact"] and exact["upper_bound_rows"] is not None
    assert not filtered["exact"]


def test_join_estimate_snapshots_planned_strategy(conns):
    _js, ps = sessions_for(conns, "tpch")
    plan = ps.plan(QUERIES["q3"])
    rec = StatsRecorder()
    rec.attach_plan(plan)
    rec.attach_estimates(plan, ps.catalog)
    joins = [e.strategy for e in rec.estimates.values() if e.node_type in ("Join", "SemiJoin")]
    assert joins and all(s in ("pallas", "dense", "unique", "expand") for s in joins)
    aggs = [e.strategy for e in rec.estimates.values() if e.node_type == "Aggregate"]
    assert aggs and all(s in ("bypass", "partial", "single") for s in aggs)
    assert all(not e.strategy for e in rec.estimates.values()
               if e.node_type not in ("Join", "SemiJoin", "Aggregate"))


def test_explain_analyze_renders_est_actual_and_misest(conns):
    _js, ps = sessions_for(conns, "tpch")
    out = ps.explain_analyze(Q_AGG)
    assert re.search(r"est [\d,]+->[\d,]+ \(\d+(\.\d+)?x", out), out
    assert "MISEST" in out
    scan_line = next(line for line in out.splitlines() if "TableScan" in line)
    assert "MISEST" not in scan_line
    q3 = ps.explain_analyze(QUERIES["q3"])
    assert any("strategy=" in line for line in q3.splitlines() if "Join" in line)


def test_node_stats_carry_estimates_bytes_and_input_rows(conns):
    _js, ps = sessions_for(conns, "tpch")
    _res, info = ps.execute(Q_AGG)
    by_type = {st["node"]: st for st in info.node_stats}
    agg, scan = by_type["Aggregate"], by_type["TableScan"]
    assert agg["est_rows"] > 0 and agg["misest"] >= MISEST_FACTOR
    assert scan["est_rows"] > 0 and scan["misest"] < MISEST_FACTOR
    assert agg["output_rows"] == 3 and agg["input_rows"] > 100
    assert 0 < agg["output_bytes"] <= agg["device_bytes"] and agg["nodeId"] >= 0


# ---------------------------------------------------------------------------
# tests/test_session.py: fresh executors, the property's coercion
# ---------------------------------------------------------------------------


def test_each_query_gets_a_fresh_executor(conns, monkeypatch):
    _js, ps = sessions_for(conns, "tpch")
    seen = []
    orig = PSession.executor

    def spy(self):
        ex = orig(self)
        seen.append(ex)
        return ex

    monkeypatch.setattr(PSession, "executor", spy)
    ps.sql("select count(*) c from nation")
    out = ps.explain_analyze("select count(*) c from region")
    assert "rows" in out and len(seen) == 2 and seen[0] is not seen[1]
    assert seen[0].recorder is None and seen[1].recorder is not None
    assert ps.executor().recorder is None


def test_collect_node_stats_coerces_like_the_reference(conns):
    js, ps = sessions_for(conns, "tpch", collect_node_stats="true")
    assert ps.prop("collect_node_stats") is True and js.prop("collect_node_stats") is True
    assert ps.prop("plan_templates") is True and js.prop("plan_templates") is True
    with pytest.raises(ValueError, match="cannot interpret"):
        PSession({"tpch": conns["tpch"][1]}, properties={"plan_templates": "maybe"},
                 device="cpu")
