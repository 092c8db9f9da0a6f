"""The port's plan-stats history (``presto_tpu_torch/cache/plan_stats.py``,
``Session._record_plan_stats`` / ``_plan_hints``) against the JAX
package's, case for case after ``tests/test_plan_stats.py``.

Both packages run the same statements at sf 0.005 (result cache off):
the recorder's semantics, the estimate snapshot, EXPLAIN ANALYZE's
est->actual rendering, and the fingerprint-keyed history (its entries,
runs, DDL invalidation, LRU bound, export and import) equal, and
``system.plan_stats`` answers the same rows with the fingerprint column
masked (each package's digest is its own). The history's first consumer,
the aggregation bypass, decides alike on a recurring plan.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.runtime.stats import MISEST_FACTOR, StatsRecorder, misestimate_ratio
from torch_bridge import port_frame

Q_AGG = ("select l_returnflag, count(*) c, sum(l_quantity) q "
         "from lineitem group by l_returnflag order by l_returnflag")
SF = 0.005


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture()
def sessions(conns):
    props = {"result_cache_enabled": False}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def history(session) -> list:
    """The history's entries, oldest first: (query position, runs, the
    tables read, each record without its wall)."""
    ids = [i.query_id for i in session.query_history]
    return [(ids.index(e.query_id), e.runs, [t for t, _v in e.versions],
             [{k: v for k, v in r.items() if k != "wall_s"} for r in e.records])
            for e in session.plan_stats.entries()]


def plan_stats_rows(session, port: bool) -> dict:
    """``system.plan_stats`` as column lists, the fingerprint masked and
    the query ids replaced by their positions in the session."""
    sql = ("select fingerprint, query_id, node_id, node_type, est_rows, actual_rows, "
           "selectivity, strategy, misest, skew, runs from plan_stats")
    frame = port_frame(session.sql(sql)) if port else session.sql(sql)
    ids = [i.query_id for i in session.query_history]
    out = {}
    for c in frame.columns:
        vals = frame[c].tolist()
        if c in ("fingerprint",):
            out[c] = [len(v.rstrip(b"\x00") if isinstance(v, bytes) else v.rstrip())
                      for v in vals]
            continue
        if isinstance(vals[0] if vals else None, bytes):
            vals = [v.rstrip(b"\x00").decode() for v in vals]
        elif vals and isinstance(vals[0], str):
            vals = [v.rstrip("\x00 ") for v in vals]
        if c == "query_id":
            vals = [ids.index(v) for v in vals]
        out[c] = [float(v) if isinstance(v, (float, np.floating)) else v for v in vals]
    return out


# ---------------------------------------------------------------------------
# StatsRecorder semantics
# ---------------------------------------------------------------------------


class _FakeNode:
    children = ()


def test_record_output_rows_accumulates_across_invocations():
    from presto_tpu.runtime.stats import StatsRecorder as JRecorder

    got = []
    for R in (JRecorder, StatsRecorder):
        rec = R()
        n = _FakeNode()
        rec.record(n, 0.1, 10, output_bytes=100)
        rec.record(n, 0.1, 15, output_bytes=150)
        rec.record(n, 0.1)  # an unmeasured invocation keeps the rows
        st = rec.stats_for(n)
        got.append((st.output_rows, st.output_bytes, st.invocations))
    assert got[0] == got[1] == (25, 250, 3)


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
    from presto_tpu.runtime.stats import misestimate_ratio as jratio

    cases = [(100, 100), (10, 1000), (1000, 10), (500, 0), (0, 100), (None, 100), (100, -1)]
    assert [misestimate_ratio(*c) for c in cases] == [jratio(*c) for c in cases] == \
        [1.0, 100.0, 100.0, 500.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# plan-time estimate snapshot
# ---------------------------------------------------------------------------


def estimates(session, sql, recorder_cls):
    plan = session.plan(sql)
    rec = recorder_cls()
    rec.attach_plan(plan)
    rec.attach_estimates(plan, session.catalog)
    return sorted((e.node_id, e.node_type, e.est_rows, e.upper_bound_rows, e.exact,
                   e.strategy, e.row_bytes) for e in rec.estimates.values())


def test_attach_estimates_covers_every_node(sessions):
    from presto_tpu.runtime.stats import StatsRecorder as JRecorder

    js, ps = sessions
    got, want = estimates(ps, Q_AGG, StatsRecorder), estimates(js, Q_AGG, JRecorder)
    assert got == want

    def count(n):
        return 1 + sum(count(c) for c in n.children)

    assert len(got) == count(ps.plan(Q_AGG))
    scan = [e for e in got if e[1] == "TableScan"][0]
    assert scan[2] == ps.catalog.connector("tpch").row_count("lineitem")
    assert scan[3] == scan[2] and scan[4] and scan[6] > 0


def test_estimate_record_exactness_tracks_predicates(sessions):
    from presto_tpu.plan.bounds import estimate_record as jrec
    from presto_tpu_torch.plan.bounds import estimate_record as prec

    js, ps = sessions
    out = []
    for s, rec in ((js, jrec), (ps, prec)):
        exact = rec(s.plan("select l_orderkey from lineitem").children[0], s.catalog)
        filtered = rec(s.plan("select l_orderkey from lineitem where l_quantity < 10")
                       .children[0], s.catalog)
        out.append((exact["exact"], exact["upper_bound_rows"], filtered["exact"],
                    filtered["est_rows"]))
    assert out[0] == out[1]
    assert out[1][0] and not out[1][2]


def test_join_estimate_snapshots_planned_strategy(sessions):
    from presto_tpu.runtime.stats import StatsRecorder as JRecorder

    js, ps = sessions
    got = estimates(ps, QUERIES["q3"], StatsRecorder)
    assert got == estimates(js, QUERIES["q3"], JRecorder)
    joins = [e[5] for e in got if e[1] in ("Join", "SemiJoin")]
    assert joins and all(joins)
    aggs = [e[5] for e in got if e[1] == "Aggregate"]
    assert aggs and all(s in ("fused", "bypass", "partial", "single") for s in aggs)


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE rendering
# ---------------------------------------------------------------------------


def masked(text: str) -> list:
    return [re.sub(r"(wall |^cache: \S+ )[\d.]+ms", r"\1?ms", line)
            for line in text.splitlines() if not line.startswith("cache: ")]


def test_explain_analyze_renders_est_actual_and_misest(sessions):
    js, ps = sessions
    out = ps.explain_analyze(Q_AGG)
    assert masked(out) == masked(js.explain_analyze(Q_AGG))
    assert re.search(r"est [\d,]+->[\d,]+ \(\d+(\.\d+)?x", out), out
    assert "MISEST" in out
    scan_line = next(line for line in out.splitlines() if "TableScan" in line)
    assert "MISEST" not in scan_line


def test_explain_analyze_renders_join_strategy(sessions):
    js, ps = sessions
    out = ps.explain_analyze(QUERIES["q3"])
    assert masked(out) == masked(js.explain_analyze(QUERIES["q3"]))
    assert any("strategy=" in line for line in out.splitlines() if "Join" in line), out


def test_node_stats_json_carries_estimates(sessions):
    js, ps = sessions
    by_type = {}
    for s in sessions:
        _res, info = s.execute(Q_AGG)
        by_type[s is ps] = {st["node"]: (st["est_rows"], st["misest"]) for st in info.node_stats}
    assert by_type[True] == by_type[False]
    agg, scan = by_type[True]["Aggregate"], by_type[True]["TableScan"]
    assert agg[0] > 0 and agg[1] >= MISEST_FACTOR
    assert scan[0] > 0 and scan[1] < MISEST_FACTOR


def test_estimate_snapshot_carries_sound_bounds(sessions):
    """The JAX package renders sound upper bounds on its fragment
    headers (``explain_distributed``, with the distributed tier); the
    port's estimate snapshot carries the same bounds per node."""
    from presto_tpu.runtime.stats import StatsRecorder as JRecorder

    sql = "select l_returnflag, count(*) c from lineitem group by l_returnflag"
    js, ps = sessions
    got = estimates(ps, sql, StatsRecorder)
    assert got == estimates(js, sql, JRecorder)
    assert any(e[3] is not None and e[3] >= e[2] for e in got)


# ---------------------------------------------------------------------------
# plan-stats history store + system.plan_stats
# ---------------------------------------------------------------------------


def test_plan_stats_records_fingerprint_keyed_history(sessions):
    out = []
    for s in sessions:
        assert len(s.plan_stats) == 0
        s.execute(Q_AGG)
        n1 = len(s.plan_stats)
        s.execute(Q_AGG)
        runs = list(s.plan_stats.entries())[0].runs
        s.execute("select count(*) c from nation")
        out.append((n1, runs, len(s.plan_stats), history(s)))
    assert out[0] == out[1]
    assert out[1][:3] == (1, 2, 2)


def test_system_plan_stats_table(sessions):
    rows = []
    for s, port in zip(sessions, (False, True)):
        s.execute(Q_AGG)
        s.execute(QUERIES["q3"])
        rows.append(plan_stats_rows(s, port))
    assert rows[0] == rows[1]
    assert rows[1]["fingerprint"] and set(rows[1]["fingerprint"]) == {64}
    assert min(rows[1]["runs"]) >= 1


def test_plan_stats_invalidated_by_ddl(sessions):
    out = []
    for s, port in zip(sessions, (False, True)):
        s.sql("create table obs_t as select l_orderkey, l_quantity from lineitem "
              "where l_quantity < 5")
        s.execute("select count(*) c from obs_t")
        s.execute(Q_AGG)
        n = len(s.plan_stats)
        tables = [t for e in s.plan_stats.entries() for t, _v in e.versions]
        s.sql("insert into obs_t select l_orderkey, l_quantity from lineitem "
              "where l_quantity > 49")
        after = [t for e in s.plan_stats.entries() for t, _v in e.versions]
        rows = plan_stats_rows(s, port)
        s.sql("drop table obs_t")
        out.append((n, "obs_t" in tables, len(s.plan_stats), "obs_t" in after,
                    len(rows["node_type"]),
                    sum(len(e.records) for e in s.plan_stats.entries())))
    assert out[0] == out[1]
    n, before, kept, after, nrows, nrecords = out[1]
    assert before and not after and kept == n - 1 and nrows == nrecords


def test_plan_stats_skips_volatile_plans(sessions):
    for s in sessions:
        before = len(s.plan_stats)
        s.execute("select count(*) c from runtime_metrics")
        assert len(s.plan_stats) == before


def test_plan_stats_lru_bound(sessions):
    out = []
    for s in sessions:
        s.set_property("plan_stats_limit", 2)
        for t in ("nation", "region", "supplier"):
            s.execute(f"select count(*) c from {t}")
        n2 = len(s.plan_stats)
        s.set_property("plan_stats_limit", 1)  # evicts at once
        out.append((n2, len(s.plan_stats), history(s)))
    assert out[0] == out[1]
    assert out[1][:2] == (2, 1)


def test_selectivity_histogram_rides_ratio_buckets():
    from presto_tpu_torch.runtime.metrics import (
        DEFAULT_BOUNDS,
        HISTOGRAM_BOUNDS,
        REGISTRY,
        SELECTIVITY_BOUNDS,
    )

    assert REGISTRY.histogram("join.filter_selectivity").bounds == SELECTIVITY_BOUNDS
    assert HISTOGRAM_BOUNDS["join.filter_selectivity"] == SELECTIVITY_BOUNDS
    assert REGISTRY.histogram("some.latency_metric").bounds == tuple(DEFAULT_BOUNDS)


def test_history_bypass_equals_reference(sessions):
    """The history's first consumer (ROADMAP C6, lifted): a recurring
    fingerprint's recorded actuals replace the NDV estimate in the
    aggregation bypass decision. After two recorded runs both packages'
    EXPLAIN renders the same ``agg_strategy`` from the history, and the
    third run routes and answers alike."""
    sql = ("select l_orderkey, l_partkey, count(*) c from lineitem "
           "group by l_orderkey, l_partkey order by l_orderkey, l_partkey limit 5")
    out = []
    for s, port in zip(sessions, (False, True)):
        fresh = s.explain(sql)
        s.execute(sql)
        s.execute(sql)
        hints = s._plan_hints(s.plan(sql))
        res = s.sql(sql)
        out.append((fresh, s.explain(sql), len(hints),
                    (port_frame(res) if port else res).to_dict("list")))
    assert out[0] == out[1]
    assert out[1][2] > 0
