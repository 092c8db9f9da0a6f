"""The port's flight recorder (``presto_tpu_torch/runtime/flight.py``) and
the executable cache's ledger against the JAX package's, case for case
after ``tests/test_flight.py``.

Both packages run the same statements under the same fault injections
at sf 0.005 (result cache off): a query that fails, degrades down the
OOM ladder, retries a fragment or overruns its deadline leaves one
post-mortem whose fields (triggers, error code, rung history, retry
events, span names, metric-delta keys, pool state) equal the
reference's with the walls masked; the ring's bound and resize, the
JSON export and ``system.flight_recorder`` answer alike. The ledger
cases hold ``system.exec_cache``'s hits and calls to the reference's.
The reference's exchange-skew cases run on its 8-device mesh; their
counterparts here check that a local run records no skew in either
package (the distributed tier is not ported).
"""

from __future__ import annotations

import json
import re
import time

import pytest

import presto_tpu.cache.exec_cache as JE
import presto_tpu.cache.stats_cache as JSC
import presto_tpu.runtime.faults as JF
import presto_tpu_torch.cache.exec_cache as PE
import presto_tpu_torch.cache.stats_cache as PSC
import presto_tpu_torch.runtime.faults as PF
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.errors import ExceededTimeLimit as JExceeded
from presto_tpu.runtime.errors import TransientFailure as JTransient
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.errors import ExceededTimeLimit as PExceeded
from presto_tpu_torch.runtime.errors import TransientFailure as PTransient
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import comparable_metrics, port_frame

#: every case starts from cleared executable and stats caches
pytestmark = pytest.mark.resets_global_state

Q_AGG = ("select l_returnflag, l_linestatus, count(*) c, sum(l_quantity) q "
         "from lineitem group by l_returnflag, l_linestatus "
         "order by l_returnflag, l_linestatus")
Q_JOIN = ("select n_name, count(*) c, sum(s_acctbal) b "
          "from supplier join nation on s_nationkey = n_nationkey "
          "group by n_name order by n_name")
SF = 0.005


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture(autouse=True)
def cold_caches():
    """Both packages' executable and stats caches start empty: a record's
    metric delta names the cache families its run moved (an eviction
    among them once a cache is full)."""
    JE.EXEC_CACHE.clear()
    PE.EXEC_CACHE.clear()
    JSC.clear()
    PSC.clear()


def sessions(conns, **props):
    props = {"result_cache_enabled": False, **props}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def pkgs(conns, **props):
    """(session, faults module, TransientFailure, ExceededTimeLimit) per
    package, the reference first."""
    js, ps = sessions(conns, **props)
    return ((js, JF, JTransient, JExceeded), (ps, PF, PTransient, PExceeded))


def record_fields(rec) -> dict:
    """A post-mortem's comparable fields: no walls, query ids or
    timestamps; spans by (name, cat) and the metric delta by its
    comparable keys."""
    d = rec.to_dict()
    return {
        "state": d["state"], "triggers": d["triggers"], "errorCode": d["errorCode"],
        "retryable": d["retryable"], "oomRung": d["oomRung"],
        # an injected backend OOM's message names each package's
        # allocator: compared up to it
        "rungHistory": [{k: (v.split("BackendOom")[0] if k == "error" else v)
                         for k, v in e.items()
                         if k not in ("device_headroom_bytes", "host_bytes")}
                        for e in d["rungHistory"]],
        "retryEvents": d["retryEvents"], "fragmentRetries": d["fragmentRetries"],
        "degradedToLocal": d["degradedToLocal"], "deadlineS": d["deadlineS"],
        "planRender": d["planRender"],
        "spans": [(s["name"], s["cat"]) for s in d["spans"]],
        "metrics": sorted(comparable_metrics(d["metrics"])),
        "exchangeSkew": d["exchangeSkew"], "hotPartitions": d["hotPartitions"],
        "adaptive": d["adaptive"], "pool": d["pool"]["reserved_bytes"],
        "traceEnabled": d["traceEnabled"],
    }


def frame_of(res, port: bool):
    return port_frame(res) if port else res


# ---------------------------------------------------------------------------
# auto-capture triggers
# ---------------------------------------------------------------------------


def test_failed_query_captures_complete_postmortem(conns):
    got = []
    for s, F, Transient, _ in pkgs(conns):
        inj = F.FaultInjector()
        inj.inject("scan", times=None)
        with F.injected(inj):
            with pytest.raises(Transient):
                s.sql("select n_name from nation order by n_name")
        assert len(s.flight) == 1
        got.append(record_fields(s.flight.latest()))
    assert got[0] == got[1]
    rec = got[1]
    assert rec["state"] == "FAILED" and "failed" in rec["triggers"]
    assert rec["errorCode"] == "TRANSIENT_FAILURE"
    assert "TableScan" in rec["planRender"]
    assert any(cat == "node" for _n, cat in rec["spans"]) and rec["metrics"]
    assert rec["rungHistory"] == [] and rec["oomRung"] == 0 and rec["pool"] == 0


def test_successes_not_captured_by_default(conns):
    for s in sessions(conns):
        s.sql(Q_AGG)
        assert len(s.flight) == 0


def test_success_capture_on_demand(conns):
    got = []
    for s in sessions(conns, flight_record_successes=True):
        s.sql(Q_AGG)
        assert len(s.flight) == 1
        got.append(record_fields(s.flight.latest()))
    assert got[0] == got[1]
    assert got[1]["state"] == "FINISHED" and got[1]["triggers"] == ["requested"]
    assert "Aggregate" in got[1]["planRender"] and got[1]["spans"]


def test_oom_degradation_captures_rung_history(conns):
    got = []
    for s, F, _, _ in pkgs(conns):
        inj = F.FaultInjector()
        inj.inject_oom("step.join_build", times=None)
        with F.injected(inj):
            res = s.sql(Q_JOIN)
        assert len(res) > 0  # the ladder recovered
        got.append(record_fields(s.flight.latest()))
    assert got[0] == got[1]
    rec = got[1]
    assert rec["state"] == "FINISHED" and "degraded" in rec["triggers"] and rec["oomRung"] == 1
    ladder = [e for e in rec["rungHistory"] if e.get("kind", "ladder") == "ladder"]
    assert len(ladder) == 1 and ladder[0]["rung"] == 1
    assert ladder[0]["error"].startswith("backend out of memory at fragment:")
    assert all(e["kind"].startswith("planned_") for e in rec["rungHistory"] if e not in ladder)


def test_fragment_retry_captures_events(conns):
    got = []
    for (s, F, _, _), port in zip(pkgs(conns, retry_count=2, retry_backoff_s=0.0),
                                  (False, True)):
        inj = F.FaultInjector()
        inj.inject("scan", times=1)
        with F.injected(inj):
            res = s.sql("select count(*) c from region")
        assert int(frame_of(res, port)["c"][0]) == 5  # the retry succeeded
        got.append(record_fields(s.flight.latest()))
    assert got[0] == got[1]
    rec = got[1]
    assert "retried" in rec["triggers"] and rec["fragmentRetries"] >= 1
    assert rec["retryEvents"][0]["error"] == "TransientFailure"
    assert rec["retryEvents"][0]["site"].startswith("fragment:")


def test_deadline_blowout_captures_deadline_trigger(conns):
    got = []
    for s, _F, _, Exceeded in pkgs(conns, query_max_run_time=1e-6):
        with pytest.raises(Exceeded):
            s.sql(Q_AGG)
        rec = s.flight.latest()
        got.append((rec.triggers, rec.error_code, rec.deadline_s))
    assert got[0] == got[1]
    triggers, code, deadline = got[1]
    assert "deadline" in triggers and "failed" in triggers
    assert code == "EXCEEDED_TIME_LIMIT" and deadline == pytest.approx(1e-6)


# ---------------------------------------------------------------------------
# export surfaces
# ---------------------------------------------------------------------------


def test_export_round_trips_json(conns, tmp_path):
    docs = []
    for (s, F, Transient, _), tag in zip(pkgs(conns), ("j", "p")):
        inj = F.FaultInjector()
        inj.inject("aggregation", times=None)
        with F.injected(inj):
            with pytest.raises(Transient):
                s.sql(Q_AGG)
        rec = s.flight.latest()
        p = tmp_path / f"flight_{tag}.json"
        text = s.export_flight_record(str(p), query_id=rec.query_id)
        assert p.read_text() == text
        d = json.loads(text)
        assert d["queryId"] == rec.query_id and d["planRender"] == rec.plan_render
        assert d["spans"] and isinstance(d["spans"][0]["args"], dict)
        ring = json.loads(s.export_flight_record())
        assert ring[-1]["queryId"] == rec.query_id
        docs.append(d)
    assert sorted(docs[0]) == sorted(docs[1])  # the same keys
    assert docs[1]["errorCode"] == docs[0]["errorCode"] == "TRANSIENT_FAILURE"


def test_system_flight_recorder_table(conns):
    got = []
    for (s, F, Transient, _), port in zip(pkgs(conns), (False, True)):
        inj = F.FaultInjector()
        inj.inject("scan", times=None)
        with F.injected(inj):
            with pytest.raises(Transient):
                s.sql("select count(*) c from nation")
        frame = frame_of(s.sql(
            "select state, triggers, error_code, oom_rung, rungs, rungs_total, "
            "fragment_retries, degraded, spans, trace_enabled, metric_deltas, "
            "hot_partitions, pool_reserved_bytes from flight_recorder"), port)
        rows = {c: [v.rstrip(b"\x00").decode() if isinstance(v, bytes) else v
                    for v in frame[c].tolist()] for c in frame.columns}
        got.append(rows)
    # the metric delta's key count differs by the ``exec.traces`` probe
    # only the reference has (ROADMAP C17)
    for rows in got:
        rows.pop("metric_deltas")
    assert got[0] == got[1]
    assert got[1]["state"] == ["FAILED"] and got[1]["triggers"] == ["failed"]
    assert got[1]["spans"][0] > 0 and got[1]["pool_reserved_bytes"] == [0]


def test_unknown_query_id_export_is_typed(conns):
    _js, ps = sessions(conns)
    with pytest.raises(UserError):
        ps.export_flight_record(query_id="nope")


# ---------------------------------------------------------------------------
# ring bound + resize
# ---------------------------------------------------------------------------


def test_ring_respects_bound_under_200_round_sweep(conns):
    _js, s = sessions(conns, flight_recorder_limit=16, retry_count=0)
    inj = PF.FaultInjector()
    inj.inject("scan", times=None)
    with PF.injected(inj):
        for _ in range(200):
            with pytest.raises(PTransient):
                s.sql("select n_name from nation order by n_name")
    assert len(s.flight) == 16
    assert len({r.query_id for r in s.flight.records()}) == 16
    assert s.pool().snapshot()["reserved_bytes"] == 0


def test_ring_resize_takes_effect_immediately(conns):
    got = []
    for s, F, Transient, _ in pkgs(conns, flight_recorder_limit=8):
        inj = F.FaultInjector()
        inj.inject("scan", times=None)
        with F.injected(inj):
            for _ in range(8):
                with pytest.raises(Transient):
                    s.sql("select count(*) c from region")
        n = len(s.flight)
        s.set_property("flight_recorder_limit", 3)
        got.append((n, len(s.flight)))
    assert got[0] == got[1] == (8, 3)


# ---------------------------------------------------------------------------
# steady-state overhead: armed but idle
# ---------------------------------------------------------------------------


def test_flight_armed_idle_overhead_under_5pct(conns):
    props = {"result_cache_enabled": False}
    s_on = PSession({"tpch": conns[1]}, properties=props, device="cpu")
    s_off = PSession({"tpch": conns[1]}, properties={**props, "trace_enabled": False},
                     device="cpu")
    s_on.sql(Q_AGG)
    s_off.sql(Q_AGG)

    def best_of(rounds):
        on, off = [], []
        for _ in range(rounds):
            t0 = time.perf_counter()
            s_off.sql(Q_AGG)
            off.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            s_on.sql(Q_AGG)
            on.append(time.perf_counter() - t0)
        return min(on), min(off)

    for rounds in (5, 9, 13):
        best_on, best_off = best_of(rounds)
        if best_on <= best_off * 1.05 + 0.005:
            assert len(s_on.flight) == 0  # armed, idle: nothing captured
            return
    raise AssertionError(f"flight-armed overhead too high: on={best_on:.4f}s "
                         f"off={best_off:.4f}s")


# ---------------------------------------------------------------------------
# the executable cache's ledger (system.exec_cache)
# ---------------------------------------------------------------------------


def ledger(session, port: bool):
    frame = frame_of(session.sql(
        "select kind, hits, calls, cold_call_s, warm_call_s, compile_s_saved "
        "from exec_cache"), port)
    return frame


def test_exec_cache_ledger_measures_amortization(conns):
    """From cleared caches, a cold and a warm run of one statement leave
    ledger rows with the reference's kinds, hits and calls, and the
    warm hits show a saving."""
    got = []
    for s, port in zip(sessions(conns), (False, True)):
        JE.EXEC_CACHE.clear()
        PE.EXEC_CACHE.clear()
        s.sql(Q_AGG)
        s.sql(Q_AGG)
        frame = ledger(s, port)
        assert (frame["cold_call_s"] >= frame["warm_call_s"]).all()
        reused = frame[frame["hits"] > 0]
        assert len(reused) >= 1 and float(reused["compile_s_saved"].max()) > 0.0
        kinds = [k.rstrip(b"\x00").decode() if isinstance(k, bytes) else k.rstrip()
                 for k in frame["kind"]]
        got.append(list(zip(kinds, frame["hits"].tolist(), frame["calls"].tolist())))
    assert got[0] == got[1]
    assert all(k for k, _h, _c in got[1])


def test_exec_cache_ledger_rows_shape(conns):
    sessions(conns)[1].sql("select count(*) c from region")
    rows = PE.EXEC_CACHE.stats_rows()
    assert rows
    keys = {"kind", "key", "hits", "calls", "cold_call_s", "warm_call_s", "compile_s_saved",
            "age_s", "idle_s"}
    for r in rows[:5]:
        assert set(r) == keys and r["age_s"] >= 0 and r["idle_s"] >= 0
    assert set(JE.EXEC_CACHE.stats_rows()[0]) == keys if JE.EXEC_CACHE.stats_rows() else True


def test_warm_window_builds_nothing(conns):
    """The port's counterpart of the reference's ``trace_delta`` window
    case: there is no trace to count, so a repeated statement's warm run
    builds no executable-cache entry (no miss) where the cold one may."""
    _js, s = sessions(conns)
    q = "select count(*) c from orders where o_orderkey < 424243"
    before = PE.EXEC_CACHE.stats_rows()
    s.sql(q)
    cold = len(PE.EXEC_CACHE) - len(before)
    misses = []
    from presto_tpu_torch.runtime.metrics import REGISTRY

    m0 = REGISTRY.snapshot().get("exec_cache.miss", 0)
    s.sql(q)
    misses.append(REGISTRY.snapshot().get("exec_cache.miss", 0) - m0)
    assert misses == [0] and cold >= 0


# ---------------------------------------------------------------------------
# exchange skew (the reference's mesh cases)
# ---------------------------------------------------------------------------


def test_local_run_records_no_exchange_skew(conns):
    """A local run has no exchange: both packages record skew 0 in the
    plan-stats history and render no ``skew`` in EXPLAIN ANALYZE."""
    got = []
    for s in sessions(conns):
        s.execute(Q_JOIN)
        out = s.explain_analyze(Q_JOIN)
        skews = [r.get("skew", 0.0) for e in s.plan_stats.entries() for r in e.records]
        got.append((sorted(set(skews)), bool(re.search(r"skew [\d.]+x", out))))
    assert got[0] == got[1] == ([0.0], False)


def test_skew_lands_in_failure_postmortem(conns):
    """A failed local run's post-mortem carries the skew fields, empty in
    both packages."""
    got = []
    for s, F, Transient, _ in pkgs(conns):
        inj = F.FaultInjector()
        inj.inject("aggregation", times=None)
        with F.injected(inj):
            with pytest.raises(Transient):
                s.sql(Q_JOIN)
        rec = s.flight.latest()
        got.append((rec.exchange_skew, rec.hot_partitions))
    assert got[0] == got[1] == ([], [])
