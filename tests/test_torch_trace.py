"""The port's span traces against the JAX package's
(``presto_tpu/runtime/trace.py`` and the pipeline's spans).

Q3 and Q10 run through both packages' sessions at sf 0.01 (result
cache off, executable and stats caches cleared first), once with one
split a table and once with 2,048 units a split (several batches a
table, so the scan prefetch worker runs): the sequences of (name, cat,
depth) equal, the caches' ``exec_cache:build`` and ``plan_stats:record``
spans included (every span: ROADMAP C14, the missing ``degrade_to_local``
span, is closed). The multi-split run also shows that every span was opened
on the query's thread and that the prefetch worker sees the plan
template's parameters but neither the trace recorder nor the metric
delta. Then the recorder's bounds, the Chrome export and its errors, and
``trace_enabled`` / ``profile_annotations``.
"""

from __future__ import annotations

import json
import threading

import pytest

import presto_tpu.cache.exec_cache as JEC
import presto_tpu.cache.stats_cache as JSC
import presto_tpu.runtime.trace as JT
import presto_tpu_torch.cache.exec_cache as PEC
import presto_tpu_torch.cache.stats_cache as PSC
import presto_tpu_torch.runtime.trace as PT
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.runtime.metrics import REGISTRY as JREGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch import expr as PE
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import pipeline as PP
from presto_tpu_torch.runtime import metrics as PM
from presto_tpu_torch.runtime.metrics import REGISTRY as PREGISTRY
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import ROUTES, comparable_metrics, span_tree

#: every case starts from cleared executable and stats caches
pytestmark = pytest.mark.resets_global_state

SF = 0.01
UNITS = 2048


@pytest.fixture(autouse=True)
def cold_caches():
    """Both packages' executable and stats caches start empty: a miss
    records an ``exec_cache:build`` span, so both must miss alike."""
    JEC.EXEC_CACHE.clear()
    PEC.EXEC_CACHE.clear()
    JSC.clear()
    PSC.clear()


@pytest.fixture(scope="module")
def conns():
    return {None: (JConnector(sf=SF), PConnector(sf=SF, device="cpu")),
            UNITS: (JConnector(sf=SF, units_per_split=UNITS),
                    PConnector(sf=SF, units_per_split=UNITS, device="cpu"))}


def sessions(pair, **props):
    props = {"result_cache_enabled": False, **props}
    return (JSession({"tpch": pair[0]}, properties=props),
            PSession({"tpch": pair[1]}, properties=props, device="cpu"))


@pytest.mark.parametrize("units", [None, UNITS])
@pytest.mark.parametrize("q", ["q3", "q10"])
def test_span_tree_equals_reference(conns, q, units):
    js, ps = sessions(conns[units])
    js.execute(QUERIES[q])
    ps.execute(QUERIES[q])
    want, got = span_tree(js.traces.latest()), span_tree(ps.traces.latest())
    assert got == want
    assert got[0] == ("query", "query", 0)
    if units:
        scans = [n for n, _c, _d in got if n == "step:filter_project"]
        assert len(scans) > 3, "the multi-split run should push several batches a table"


@pytest.mark.parametrize("q", ["q3", "q1"])
def test_span_tree_under_sql_equals_reference(conns, q):
    """``Session.sql`` (the leaf route, plan templates, no recorder): the
    node spans open at dispatch and the drain runs under node:Output."""
    js, ps = sessions(conns[UNITS])
    js.sql(QUERIES[q])
    ps.sql(QUERIES[q])
    assert span_tree(ps.traces.latest()) == span_tree(js.traces.latest())


def test_prefetch_worker_sees_params_not_recorder_or_delta(conns, monkeypatch):
    """Several splits a table: every span opens on the query's thread, the
    worker's loads see the template's parameter scope but no recorder and
    no metric delta, and the global totals equal the reference's."""
    monkeypatch.setattr(PP, "prefetch_enabled", lambda: True)
    jconn, pconn = conns[UNITS]
    query_thread = threading.get_ident()
    seen = []
    original_scan = pconn.scan

    def scan(*args, **kwargs):
        seen.append((threading.get_ident(), PT.current(), PM.current_delta(),
                     PE._PARAM_VALUES.get()))
        return original_scan(*args, **kwargs)

    opened = []
    original_span = PT.TraceRecorder.span

    def span(self, *args, **kwargs):
        opened.append(threading.get_ident())
        return original_span(self, *args, **kwargs)

    monkeypatch.setattr(pconn, "scan", scan)
    monkeypatch.setattr(PT.TraceRecorder, "span", span)
    jbefore, pbefore = JREGISTRY.snapshot(), PREGISTRY.snapshot()
    js, ps = sessions((jconn, pconn))
    js.sql(QUERIES["q3"])
    ps.sql(QUERIES["q3"])
    jafter, pafter = JREGISTRY.snapshot(), PREGISTRY.snapshot()
    workers = [s for s in seen if s[0] != query_thread]
    assert workers, "the prefetch worker never loaded a split"
    assert all(rec is None and delta is None for _t, rec, delta, _p in workers)
    info = ps.query_history[-1]
    assert all(p is not None and len(p) > 0 for _t, _r, _d, p in workers), \
        "the worker lost the plan template's parameters"
    assert set(opened) == {query_thread}
    assert span_tree(ps.traces.latest()) == span_tree(js.traces.latest())

    def moved(before, after):
        return {k: after[k] - before.get(k, 0) for k in after
                if k.startswith(ROUTES) and after[k] != before.get(k, 0)}

    assert moved(pbefore, pafter) == moved(jbefore, jafter)
    assert comparable_metrics(info.metrics) == comparable_metrics(
        js.query_history[-1].metrics)


def test_node_spans_carry_plan_node_ids(conns):
    js, ps = sessions(conns[None])
    ps.execute(QUERIES["q3"])
    rec = ps.traces.latest()
    ids = {s.args["plan_node_id"] for s in rec.spans_by_cat("node")}
    plan = ps.plan(QUERIES["q3"])

    def count(n):
        return 1 + sum(count(c) for c in n.children)

    assert ids == set(range(count(plan)))
    assert all(isinstance(v, (int, float, str, bool)) for s in rec.spans
               for v in s.args.values()), "span args hold Python values only"


def test_trace_disabled_records_nothing(conns, tmp_path):
    js, ps = sessions(conns[None], trace_enabled=False)
    js.sql("select count(*) c from nation")
    ps.sql("select count(*) c from nation")
    assert len(ps.traces) == 0 == len(js.traces)
    with pytest.raises(Exception) as jerr:
        js.export_trace(str(tmp_path / "j.json"))
    with pytest.raises(Exception) as perr:
        ps.export_trace(str(tmp_path / "p.json"))
    assert (type(perr.value).__name__, str(perr.value)) == \
        (type(jerr.value).__name__, str(jerr.value))


def test_max_spans_drops_and_counts(conns):
    # warm the process-wide executable cache: no build spans below
    sessions(conns[None])[1].execute(QUERIES["q3"])
    _js, full = sessions(conns[None])
    full.execute(QUERIES["q3"])
    total = len(full.traces.latest().spans)
    _js, ps = sessions(conns[None], trace_max_spans=5)
    before = PREGISTRY.snapshot().get("trace.spans_dropped", 0.0)
    ps.execute(QUERIES["q3"])
    rec = ps.traces.latest()
    assert len(rec.spans) == 5 and rec.dropped == total - 5
    assert PREGISTRY.snapshot()["trace.spans_dropped"] - before == total - 5


def test_export_trace_is_chrome_json_filtered_to_one_query(conns, tmp_path):
    _js, ps = sessions(conns[None])
    ps.trace_token = "tok-q3"
    ps.sql("select count(*) c from nation")
    _res, info = ps.execute(QUERIES["q3"])
    data = json.loads(open(ps.export_trace(str(tmp_path / "all.json"))).read())
    assert len(data["otherData"]["queries"]) == 2
    one = json.loads(open(ps.export_trace(str(tmp_path / "q3.json"),
                                          query_id=info.query_id)).read())
    assert one["otherData"]["queries"] == [info.query_id]
    assert one["otherData"]["trace_tokens"] == ["tok-q3"]
    xs = [e for e in one["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == len(ps.traces.for_query(info.query_id).spans)
    assert all(e["args"]["trace_token"] == "tok-q3" and e["dur"] >= 0 for e in xs)
    assert {e["pid"] for e in one["traceEvents"]} == {1}


def test_export_trace_of_an_unknown_query_raises_like_reference(conns, tmp_path):
    js, ps = sessions(conns[None])
    js.sql("select count(*) c from nation")
    ps.sql("select count(*) c from nation")
    with pytest.raises(Exception) as jerr:
        js.export_trace(str(tmp_path / "j.json"), query_id="q_missing")
    with pytest.raises(Exception) as perr:
        ps.export_trace(str(tmp_path / "p.json"), query_id="q_missing")
    assert (type(perr.value).__name__, str(perr.value)) == \
        (type(jerr.value).__name__, str(jerr.value))


def test_profile_annotations_wrap_spans_in_record_function(conns):
    """Each span opens a ``torch.profiler.record_function`` named
    ``<span>#<token>`` (on the CPU here; on the card it spans the kernels
    the span launched)."""
    from torch.profiler import ProfilerActivity, profile

    ps = PSession({"tpch": conns[None][1]}, properties={"profile_annotations": True},
                  device="cpu", trace_token="tok")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ps.execute(QUERIES["q3"])
    names = {e.name for e in prof.events()}
    spans = {f"{s.name}#tok" for s in ps.traces.latest().spans}
    assert spans <= names
    assert {"query#tok", "step:probe_inner#tok", "node:Join#tok"} <= names


# ---------------------------------------------------------------------------
# the recorder and the store, unit for unit against the reference's
# ---------------------------------------------------------------------------


def record(mod):
    rec = mod.TraceRecorder("q", "tok", max_spans=6)
    token = mod.install(rec)
    try:
        with mod.span("query", "query", {"query_id": "q"}):
            with mod.span("node:Join", "node", {"plan_node_id": 0}) as sp:
                sp.args["rows"] = 7
                with mod.span("step:probe_inner"):
                    mod.add_complete("join_filter", "join", 1.0, 0.5, {"column": "k"})
            for i in range(4):
                with mod.span(f"step:{i}"):
                    pass
    finally:
        mod.uninstall(token)
    assert mod.current() is None
    return rec


def shape(rec):
    return ([(s.span_id, s.parent_id, s.name, s.cat, s.args) for s in rec.spans], rec.dropped,
            [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in rec.to_events(3)])


def test_recorder_equals_reference():
    assert shape(record(PT)) == shape(record(JT))
    assert PT.CATEGORIES == JT.CATEGORIES
    assert PT.span("x") is PT._NOOP and PT.current() is None


def test_trace_store_ring_equals_reference():
    assert PT.TRACE_RING == JT.TRACE_RING == 64
    got, want = PT.TraceStore(maxlen=3), JT.TraceStore(maxlen=3)
    for i in range(5):
        got.add(PT.TraceRecorder(f"q{i}"))
        want.add(JT.TraceRecorder(f"q{i}"))
    assert [r.query_id for r in got.recorders()] == [r.query_id for r in want.recorders()]
    assert got.for_query("q1") is None and got.for_query("q3").query_id == "q3"
    assert got.latest().query_id == "q4" and len(got) == 3
    pc = PT.to_chrome_trace(got.recorders())
    jc = JT.to_chrome_trace(want.recorders())
    assert pc["otherData"]["queries"] == jc["otherData"]["queries"]
    assert pc["traceEvents"] == jc["traceEvents"]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 18, whole, on the CPU at a small scale
# ---------------------------------------------------------------------------


def test_chip_smoke_phase18_on_the_cpu(monkeypatch):
    """Phase 18 (``chip_smoke.run_observability_queries``) runs its checks
    on the CPU at sf 0.01: the answers against numpy, the strategies in
    ``QueryInfo.metrics`` against the plans, every wrapper call inside a
    step/finish/node span, the exported node spans against the plans,
    the shapes held to plain, and the injected fault retried. The
    overhead rule's walls are the card's to measure (phase 18 on the
    card); here its rounds are skipped."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "tracing_overhead", lambda conn, device: {})
    out = chip_smoke.run_observability_queries(PConnector(sf=SF, device="cpu"), device="cpu")
    assert out["retried"] == 1
    assert out["routes"]["q3"] == {"agg.strategy.bypass": 1, "join.strategy.dense": 1,
                                   "join.strategy.pallas": 1}
    assert out["infos"]["q3"]["join_strategy"] == "dense,pallas"
    assert out["routes"]["q1 shaped"] == {"agg.strategy.partial": 1}
