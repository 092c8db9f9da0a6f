"""The port's ``system`` catalog (``presto_tpu_torch/connectors/system.py``)
against the JAX package's.

Both packages' sessions run one scenario at sf 0.005 from cleared
executable caches: a statement twice (the second a result-cache hit),
a recorded aggregation three times with the result cache off (its
history steers the third run: a ``bucket`` decision), a failing query
under a scan fault (a flight record), a fair scheduler's admissions, a
tenant SLO tracker and a health monitor attached by hand (sampled, never
started). Then each of the 14
tables answers through ``Session.sql``:

- its schema (names, types, dictionaries) equals the reference's;
- its rows equal the reference's in every column that is not a wall, a
  timestamp, a device id or a digest (those are masked; query ids are
  compared by their position in the session's history);
- ``runtime_metrics`` (and ``health``'s ``cache_hit_rate``) read each
  process's own registry: its rows are held to the port's
  ``REGISTRY.snapshot()``;
- ``runtime_nodes`` names the CPU here (on the card, each CUDA device).
"""

from __future__ import annotations

import numpy as np
import pytest

import presto_tpu.cache.exec_cache as JE
import presto_tpu.connectors.system as JSys
import presto_tpu.runtime.faults as JF
import presto_tpu.runtime.health as JH
import presto_tpu.server.scheduler as JS
import presto_tpu_torch.cache.exec_cache as PE
import presto_tpu_torch.connectors.system as PSys
import presto_tpu_torch.runtime.faults as PF
import presto_tpu_torch.runtime.health as PH
import presto_tpu_torch.server.scheduler as PS
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.metrics import REGISTRY as PREGISTRY
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import port_dictionary, port_frame, port_type

#: the scenario starts from cleared executable caches
pytestmark = pytest.mark.resets_global_state

SF = 0.005
Q_FAST = "select count(*) c from nation"
Q_AGG = ("select l_returnflag, count(*) c, sum(l_quantity) q "
         "from lineitem group by l_returnflag order by l_returnflag")
TABLES = list(JSys.SCHEMAS)

#: columns that hold walls, timestamps, device ids or digests
MASKED = {
    "runtime_queries": {"elapsed_s"},
    "query_history": {"queued_s", "planning_s", "execution_s", "elapsed_s",
                      "memory_queued_s"},
    "plan_stats": {"fingerprint"},
    "adaptive": {"fingerprint", "created_at"},
    "flight_recorder": {"execution_s", "captured_at", "metric_deltas"},
    "exec_cache": {"key", "cold_call_s", "warm_call_s", "compile_s_saved", "age_s",
                   "idle_s"},
    "runtime_nodes": {"node_id"},
    "device_stats": {"device_id", "bytes_in_use", "peak_bytes", "bytes_limit",
                     "dispatch_wall_s", "dispatches"},
    # cache_hit_rate reads each process's registry (runtime_metrics' case)
    "health": {"ts", "qps", "p50_s", "p99_s", "cache_hit_rate"},
    "trace_spans": {"start_s", "duration_s", "trace_token"},
    "memory_pool": set(),
}


def scenario(session, F, H, port: bool):
    S = PS if port else JS
    # a fair scheduler's admissions (system.tenants): the same script in
    # both packages
    sched = S.FairScheduler([S.TenantSpec("ana", weight=2.0),
                             S.TenantSpec("bot", max_concurrent=2)], total_slots=2)
    for tenant in ("ana", "bot", "ana", "walk-in"):
        sched.release(sched.acquire(tenant))
    session.tenants = sched
    session.slo = H.SloTracker(latency_objective_s=120.0)
    session.health = H.HealthMonitor(session, min_samples=3)
    session.sql(Q_FAST)
    session.sql(Q_FAST)  # a result-cache hit
    session.set_property("result_cache_enabled", False)
    for _ in range(3):
        session.execute(Q_AGG)  # the third run: a history decision
    session.set_property("result_cache_enabled", True)
    inj = F.FaultInjector()
    inj.inject("scan", times=None)
    with F.injected(inj):
        with pytest.raises(Exception):
            session.sql("select count(*) c from region")
    session.health.sample()
    session.health.sample()
    return session


@pytest.fixture(scope="module")
def scenarios():
    out = []
    JE.EXEC_CACHE.clear()
    PE.EXEC_CACHE.clear()
    for make, F, H, port in (
            (lambda p: JSession({"tpch": JConnector(sf=SF)}, properties=p), JF, JH, False),
            (lambda p: PSession({"tpch": PConnector(sf=SF, device="cpu")}, properties=p,
                                device="cpu"), PF, PH, True)):
        out.append(scenario(make({"memory_pool_bytes": 1 << 30}), F, H, port))
    return out


#: tables whose row count is the number of devices (the reference's
#: CPU runs on 8 virtual devices): compared by their distinct platforms
PER_DEVICE = ("runtime_nodes", "device_stats")


def decoded(frame, session, table) -> dict:
    """Column lists: bytes decoded, masked columns dropped, query ids as
    positions in the session's history. The history's scans of the
    per-device tables answer one row a device: their ``output_rows`` is
    masked."""
    ids = [i.query_id for i in session.query_history]
    out = {}
    if table in PER_DEVICE:
        return {"platform": sorted(set(
            p.rstrip(b"\x00").decode() if isinstance(p, bytes) else p
            for p in frame["platform"].tolist()))}
    for c in frame.columns:
        if c in MASKED.get(table, ()):
            continue
        vals = frame[c].tolist()
        vals = [v.rstrip(b"\x00").decode() if isinstance(v, bytes) else v for v in vals]
        vals = [v.rstrip("\x00 ") if isinstance(v, str) else v for v in vals]
        if c == "query_id":
            vals = [ids.index(v) if v in ids else v for v in vals]
        out[c] = [float(v) if isinstance(v, (float, np.floating)) else v for v in vals]
    if "output_rows" in out and "query" in out:
        out["output_rows"] = [-2 if any(t in q for t in PER_DEVICE) else n
                              for q, n in zip(out["query"], out["output_rows"])]
    return out


@pytest.mark.parametrize("table", TABLES)
def test_schema_equals_reference(table):
    jschema, pschema = JSys.SCHEMAS[table], PSys.SCHEMAS[table]
    assert list(pschema) == list(jschema)
    for col, t in jschema.items():
        assert pschema[col] == port_type(t), (table, col)
    jdicts = {c: port_dictionary(d).values.tolist()
              for c, d in JSys.SystemConnector(None).dictionaries(table).items()}
    pdicts = {c: d.values.tolist()
              for c, d in PSys.SystemConnector(None).dictionaries(table).items()}
    assert pdicts == jdicts


@pytest.mark.parametrize("table", [t for t in TABLES if t != "runtime_metrics"])
def test_rows_equal_reference(scenarios, table):
    js, ps = scenarios
    want = decoded(js.sql(f"select * from {table}"), js, table)
    got = decoded(port_frame(ps.sql(f"select * from {table}")), ps, table)
    assert got == want
    assert got and all(len(v) == len(next(iter(got.values()))) for v in got.values())


def test_runtime_metrics_answer_the_registry(scenarios):
    _js, ps = scenarios
    frame = port_frame(ps.sql("select name, value from runtime_metrics"))
    snap = PREGISTRY.snapshot()
    rows = dict(zip((n.rstrip(b"\x00").decode() if isinstance(n, bytes) else n
                     for n in frame["name"]), frame["value"]))
    for name in ("result_cache.hit", "exec_cache.hit", "plan_stats.recorded",
                 "adaptive.bucket_override", "flight.captured"):
        assert rows[name] <= snap[name] and rows[name] >= 1, name


def test_where_clauses_answer_from_the_session_stores(scenarios):
    """``select ... where ...`` over the tables, each row held to the
    session's own store."""
    _js, ps = scenarios
    hist = port_frame(ps.sql("select query_id, cache_hit from query_history "
                             "where cache_hit = 1"))
    assert [q.rstrip(b"\x00").decode() if isinstance(q, bytes) else q
            for q in hist["query_id"]] == [i.query_id for i in ps.history.infos()
                                          if i.cache_hit]
    stats = port_frame(ps.sql("select node_type, actual_rows from plan_stats "
                              "where actual_rows >= 0"))
    want = [(r["node_type"], r["actual_rows"]) for e in ps.plan_stats.entries()
            for r in e.records if r["actual_rows"] >= 0]
    assert list(zip(stats["node_type"], stats["actual_rows"])) == want
    pool = port_frame(ps.sql("select capacity_bytes, reserved_bytes from memory_pool "
                             "where capacity_bytes > 0"))
    assert int(pool["capacity_bytes"][0]) == ps.pool().snapshot()["capacity_bytes"] == 1 << 30
    nodes = port_frame(ps.sql("select node_id, platform from runtime_nodes "
                              "where platform = 'cpu'"))
    assert len(nodes) == 1
    rec = port_frame(ps.sql("select query_id, triggers from flight_recorder "
                            "where oom_rung = 0"))
    assert len(rec) == len(ps.flight) == 1
