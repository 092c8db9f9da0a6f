"""The port's serving tier (``presto_tpu_torch/server``) against the JAX
package's, case for case after ``tests/test_server.py``, the server cases
of ``tests/test_overload.py`` and ``tests/test_health.py`` and the warmer
of ``tests/test_adaptive.py``, at the reference tests' sf 0.005.

- ``FairScheduler``: the same grant order as the reference's under
  scripted arrivals (one slot, each waiter queued before the next
  starts), quotas, shedding, the overflow lane;
- batched dispatch: ``run_batched`` lanes bit-identical to the port's
  serial run and the reference's; the gate fuses concurrent bindings
  (``batch.fallback.error`` stays 0), counts the same ``batch.*`` moves
  as the reference's gate on the same script, falls back with the
  reference's reason, keeps the result cache per binding;
  ``unbatchable_reason`` equal to the reference's on a template per
  reason;
- the server: tenant attribution, the prepared surface, submit / poll,
  cancel, drain, the submit limit, brown-out, deadlines, HTTP (the result
  page's JSON equal to the reference's for DOUBLE, DECIMAL, DATE and NULL
  columns), the template warmer;
- the property table: every property the port defines equals the
  reference's in type and default and refuses the same out-of-bound
  values;
- phase 21 of ``chip_smoke.py`` on the CPU.

Every ``QueryServer`` and ``HttpFrontend`` shuts down in a ``finally``;
every wait is bounded and waits on the condition under test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import presto_tpu.plan.nodes as JN
import presto_tpu.runtime.metrics as JM
import presto_tpu_torch.plan.nodes as PN
import presto_tpu_torch.runtime.metrics as PM
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.lifecycle import QueryManager as JQueryManager
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.errors import (
    ExceededTimeLimit,
    ResourceExhausted,
    ServerOverloaded,
    UserError,
)
from presto_tpu_torch.runtime.lifecycle import REQUEST_DEADLINE
from presto_tpu_torch.runtime.lifecycle import QueryManager as PQueryManager
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.server.batcher import TemplateBatchGate, run_batched
from presto_tpu_torch.server.frontend import (
    HttpFrontend,
    QueryServer,
    _df_payload,
    _parse_traceparent,
    _trace_context,
)
from presto_tpu_torch.server.scheduler import FairScheduler, TenantSpec
from torch_bridge import same_frame

SF = 0.005
JCONN = JConnector(sf=SF)
CONN = PConnector(sf=SF, device="cpu")
WAIT_S = 30.0

TOPN_FMT = ("select l_orderkey, l_linenumber, l_quantity from lineitem"
            " where l_extendedprice < {}"
            " order by l_orderkey, l_linenumber limit 25")
AGG_FMT = ("select sum(l_extendedprice + {}) s, count(*) c,"
           " max(l_quantity) m from lineitem where l_partkey < {}")
JOIN_FMT = ("select o_orderpriority, count(*) c from lineitem"
            " join orders on l_orderkey = o_orderkey"
            " where l_extendedprice < {} group by o_orderpriority"
            " order by o_orderpriority")
OVERLOAD_SQL = ("select n_name, count(*) c, sum(s_acctbal) b "
                "from supplier join nation on s_nationkey = n_nationkey "
                "group by n_name order by n_name")
QUIET = {"health_monitor": False, "result_cache_enabled": False}


def counter(name: str) -> float:
    return PM.REGISTRY.snapshot().get(name, 0.0)


def make_session(**props):
    props.setdefault("result_cache_enabled", False)
    return PSession({"tpch": CONN}, properties=props, device="cpu")


@contextlib.contextmanager
def serving(connectors=None, **kwargs):
    """A port ``QueryServer`` on the CPU, shut down however the case ends."""
    kwargs.setdefault("properties", dict(QUIET))
    srv = QueryServer({"tpch": CONN} if connectors is None else connectors,
                      device="cpu", **kwargs)
    try:
        yield srv
    finally:
        srv.shutdown(drain_timeout_s=WAIT_S)


@contextlib.contextmanager
def http_front(srv):
    fe = HttpFrontend(srv, port=0).start_background()
    try:
        yield f"http://127.0.0.1:{fe.port}"
    finally:
        fe.shutdown()


def wait_until(cond, what: str, timeout_s: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def gate_depth(gate) -> int:
    return sum(gate.queue_depth(fp) for fp in list(gate._templates))


def serial_rows(res) -> dict:
    return res.to_dict(logical=False)


def assert_same_result(got, want, what=""):
    a, b = serial_rows(got), serial_rows(want)
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# the fairness scheduler
# ---------------------------------------------------------------------------


def grant_order(scheduler_cls, spec_cls, tenants, hold, arrivals):
    """Grant order under a scripted arrival sequence: ``hold`` takes the
    only slot, each of ``arrivals`` queues (its waiter counted before the
    next starts), then the slot frees and every grant releases at once."""
    sched = scheduler_cls([spec_cls(n, weight=w) for n, w in tenants], total_slots=1)
    tok = sched.acquire(hold)
    order, threads = [], []

    def grab(name):
        sched.acquire(name, timeout_s=WAIT_S)
        order.append(name)
        sched.release(name)

    for i, name in enumerate(arrivals):
        t = threading.Thread(target=grab, args=(name,))
        t.start()
        threads.append(t)
        wait_until(lambda n=i + 1: sched.queue_depth() == n, f"waiter {i} queued")
    sched.release(tok)
    for t in threads:
        t.join(WAIT_S)
    return order


GRANT_SCRIPTS = {
    "light_overtakes": ([("heavy", 1.0), ("light", 4.0)], "heavy", ["heavy", "light"]),
    "burst_backlog": ([("heavy", 1.0), ("light", 4.0)], "heavy",
                      ["heavy", "heavy", "heavy", "heavy", "light"]),
    "three_tenants": ([("a", 1.0), ("b", 2.0), ("c", 4.0)], "a",
                      ["a", "a", "b", "b", "c", "c", "a", "c"]),
}


@pytest.mark.parametrize("script", sorted(GRANT_SCRIPTS))
def test_grant_order_equals_reference(script):
    from presto_tpu.server.scheduler import FairScheduler as JFairScheduler
    from presto_tpu.server.scheduler import TenantSpec as JTenantSpec

    tenants, hold, arrivals = GRANT_SCRIPTS[script]
    got = grant_order(FairScheduler, TenantSpec, tenants, hold, arrivals)
    want = grant_order(JFairScheduler, JTenantSpec, tenants, hold, arrivals)
    assert got == want and sorted(got) == sorted(arrivals), (got, want)
    if script == "light_overtakes":
        assert got == ["light", "heavy"]
    if script == "burst_backlog":
        assert got[0] == "light"


def test_concurrency_quota_blocks_and_counts():
    sched = FairScheduler([TenantSpec("t", max_concurrent=1)])
    blocked0 = counter("tenant.over_quota_blocked")
    tok = sched.acquire("t")
    with pytest.raises(ResourceExhausted):
        sched.acquire("t", timeout_s=0.05)
    assert counter("tenant.over_quota_blocked") == blocked0 + 1
    snap = sched.snapshot()[0]
    assert snap["over_quota_blocked"] == 1 and snap["queue_timeouts"] == 1
    sched.release(tok)
    sched.release(sched.acquire("t", timeout_s=5))


def test_byte_quota_reads_tenant_tagged_pool_reservations():
    from presto_tpu_torch.runtime.memory import MemoryPool

    pool = MemoryPool(1 << 30, name="quota-test")
    sched = FairScheduler([TenantSpec("t", max_bytes=1000)], pool=pool)
    try:
        pool.reserve("q1", 4096, tenant="t")
        assert pool.tenant_reserved_bytes("t") == 4096
        with pytest.raises(ResourceExhausted):
            sched.acquire("t", timeout_s=0.05)
        pool.release("q1")
        assert pool.tenant_reserved_bytes("t") == 0
        sched.release(sched.acquire("t", timeout_s=5))
    finally:
        sched.close()


def test_unknown_tenant_auto_registers_with_default_spec():
    sched = FairScheduler(default_spec=TenantSpec("default", weight=2.0))
    sched.release(sched.acquire("walk-in"))
    snap = {r["tenant"]: r for r in sched.snapshot()}
    assert snap["walk-in"]["admitted"] == 1 and snap["walk-in"]["weight"] == 2.0


def test_tenant_cardinality_capped_by_overflow_lane():
    sched = FairScheduler(max_tenants=2)
    for name in ("a", "b", "c", "d", "e"):
        sched.release(sched.acquire(name))
    names = {r["tenant"] for r in sched.snapshot()}
    assert names == {"a", "b", "__overflow__"}, names
    over = next(r for r in sched.snapshot() if r["tenant"] == "__overflow__")
    assert over["admitted"] == 3


def _queue_waiters(sched, tenant: str, n: int, expect_depth: int | None = None):
    """Start ``n`` waiters for ``tenant`` and wait until the scheduler holds
    ``expect_depth`` (default ``n``) waiters; returns a join function."""
    threads = []
    for _ in range(n):
        t = threading.Thread(target=lambda: sched.release(sched.acquire(tenant, timeout_s=WAIT_S)),
                             daemon=True)
        t.start()
        threads.append(t)
    depth = n if expect_depth is None else expect_depth
    wait_until(lambda: sched.queue_depth() >= depth, f"{depth} queued")

    def drain():
        for t in threads:
            t.join(WAIT_S)

    return drain


def test_shed_spares_light_tenant_with_no_backlog():
    sched = FairScheduler(total_slots=1, global_queue_limit=2)
    hold = sched.acquire("aggressor")
    try:
        drain = _queue_waiters(sched, "aggressor", 2)
        with pytest.raises(ServerOverloaded) as ei:
            sched.check_shed("aggressor")
        assert ei.value.retryable and ei.value.retry_after_s > 0
        sched.check_shed("light")
        with pytest.raises(ServerOverloaded):
            sched.acquire("aggressor", timeout_s=1.0)
    finally:
        sched.release(hold)
        drain()
    assert sched.queue_depth() == 0


def test_shed_retry_after_grows_with_queue_depth():
    sched = FairScheduler(total_slots=1, global_queue_limit=2)
    hold = sched.acquire("agg")
    drains = []
    try:
        drains.append(_queue_waiters(sched, "agg", 2))
        with pytest.raises(ServerOverloaded) as e1:
            sched.check_shed("agg")
        drains.append(_queue_waiters(sched, "o1", 1, expect_depth=3))
        drains.append(_queue_waiters(sched, "o2", 1, expect_depth=4))
        with pytest.raises(ServerOverloaded) as e2:
            sched.check_shed("agg")
        assert e2.value.retry_after_s > e1.value.retry_after_s
    finally:
        sched.release(hold)
        for d in drains:
            d()
    assert sched.queue_depth() == 0


def test_tenant_ceiling_sheds_before_global():
    sched = FairScheduler(total_slots=1, tenant_queue_limit=1)
    hold = sched.acquire("t")
    try:
        drain = _queue_waiters(sched, "t", 1)
        with pytest.raises(ServerOverloaded):
            sched.check_shed("t")
        sched.check_shed("fresh")
    finally:
        sched.release(hold)
        drain()


# ---------------------------------------------------------------------------
# batched dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,bindings", [
    (TOPN_FMT, [(2000,), (50000,), (91000,)]),
    (AGG_FMT, [(10, 500), (99, 1500)]),
], ids=["topn", "agg"])
def test_run_batched_bit_identical_to_serial(fmt, bindings):
    """One scan, one lane per binding: each lane equals the binding's
    serial run in the port and the reference's serial frame."""
    s = make_session()
    handle = s.prepare(fmt.replace("{}", "?"))
    scans = counter("exec_cache.miss") + counter("exec_cache.hit")
    results = run_batched(s.catalog, handle.plan, [handle.bind(list(b)) for b in bindings])
    assert counter("exec_cache.miss") + counter("exec_cache.hit") > scans
    off = make_session(plan_templates=False)
    joff = JSession({"tpch": JCONN}, properties={"result_cache_enabled": False,
                                                 "plan_templates": False})
    for b, res in zip(bindings, results):
        sql = fmt.format(*b)
        assert_same_result(res, off.sql(sql), sql)
        same_frame(res, joff.sql(sql), sql)


def held_leader(monkeypatch, manager_cls):
    """Hold the first ``run_plan`` call until released: the test_server
    idiom that lets followers queue at the gate first."""
    release, first = threading.Event(), threading.Event()
    orig = manager_cls.run_plan

    def gated(self, executor, plan, info, recorder):
        if not first.is_set():
            first.set()
            release.wait(WAIT_S)
        return orig(self, executor, plan, info, recorder)

    monkeypatch.setattr(manager_cls, "run_plan", gated)
    return first, release


def fuse_through_gate(monkeypatch, session, manager_cls, fmt, lits, followers):
    """Issue ``fmt`` at each literal concurrently with the first leader
    held until ``followers`` bindings wait at the gate; returns the
    results by literal."""
    first, release = held_leader(monkeypatch, manager_cls)
    results, errors = {}, []

    def worker(v):
        try:
            results[v] = session.sql(fmt.format(v))
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(v,)) for v in lits]
    threads[0].start()
    assert first.wait(WAIT_S)
    for t in threads[1:]:
        t.start()
    gate = session.query_manager.batch_gate
    wait_until(lambda: gate_depth(gate) >= followers, f"{followers} bindings at the gate")
    release.set()
    for t in threads:
        t.join(WAIT_S)
    assert not errors, errors
    return results


BATCH_KEYS = ("batch.dispatched", "batch.queries", "batch.served", "batch.fallback",
              "batch.fallback.error", "batch.size.count", "batch.trimmed")


def batch_moves(registry, before) -> dict:
    after = registry.snapshot()
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in BATCH_KEYS}


def test_batched_gate_fuses_concurrent_bindings(monkeypatch):
    """Four concurrent bindings, the first leader held until three wait:
    the next leader drains all three into one batched dispatch; every
    result equals the serial run; the ``batch.*`` moves equal the
    reference's gate on the same script."""
    lits = (2000, 20000, 50000, 91000)
    s = make_session(batched_dispatch=True)
    s.sql(TOPN_FMT.format(1000))
    before = PM.REGISTRY.snapshot()
    results = fuse_through_gate(monkeypatch, s, PQueryManager, TOPN_FMT, lits, 3)
    moved = batch_moves(PM.REGISTRY, before)
    assert moved["batch.dispatched"] >= 1 and moved["batch.fallback.error"] == 0, moved
    off = make_session(plan_templates=False)
    for v in lits:
        assert_same_result(results[v], off.sql(TOPN_FMT.format(v)), f"binding {v}")
    infos = s.query_history[-len(lits):]
    assert sum(i.batched for i in infos) >= 2
    assert {i.batch_size for i in infos if i.batched} == {3}

    js = JSession({"tpch": JCONN}, properties={"result_cache_enabled": False,
                                               "batched_dispatch": True})
    js.sql(TOPN_FMT.format(1000))
    jbefore = JM.REGISTRY.snapshot()
    jres = fuse_through_gate(monkeypatch, js, JQueryManager, TOPN_FMT, lits, 3)
    assert batch_moves(JM.REGISTRY, jbefore) == moved
    for v in lits:
        same_frame(results[v], jres[v], f"binding {v}")


def test_unbatchable_template_falls_back_with_reason(monkeypatch):
    """A join-bearing template never batches: the leader that drains two
    bindings counts ``batch.fallback`` and its reason (the reference's:
    the grouped aggregation over the join); results stay right."""
    s = make_session(batched_dispatch=True)
    s.sql(JOIN_FMT.format(1000))
    before = PM.REGISTRY.snapshot()
    lits = (2000, 50000, 91000)
    results = fuse_through_gate(monkeypatch, s, PQueryManager, JOIN_FMT, lits, 2)
    after = PM.REGISTRY.snapshot()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in after
             if k.startswith("batch.") and after.get(k, 0) != before.get(k, 0)}
    assert moved.get("batch.fallback", 0) >= 1 and "batch.dispatched" not in moved, moved
    assert moved.get("batch.fallback.grouped_agg", 0) == moved["batch.fallback"], moved
    off = make_session(plan_templates=False)
    for v in lits:
        assert_same_result(results[v], off.sql(JOIN_FMT.format(v)), f"binding {v}")


def test_batched_results_populate_result_cache_per_binding(monkeypatch):
    s = PSession({"tpch": CONN}, properties={"batched_dispatch": True}, device="cpu")
    s.sql(TOPN_FMT.format(1000))
    lits = (7000, 44000)
    results = fuse_through_gate(monkeypatch, s, PQueryManager, TOPN_FMT, lits, 1)
    h0 = counter("result_cache.hit")
    for v in lits:
        assert_same_result(s.sql(TOPN_FMT.format(v)), results[v], f"binding {v}")
    assert counter("result_cache.hit") >= h0 + 2


def test_gate_abandoned_member_does_not_strand_the_queue():
    gate = TemplateBatchGate()
    fp = "tmpl"
    leader = gate.enqueue(fp, ((None, 1),))
    role, members = gate.lead_or_wait(fp, leader, 0.0)
    assert role == "lead" and members == [leader]
    drained = gate.enqueue(fp, ((None, 2),))
    queued = gate.enqueue(fp, ((None, 3),))
    with gate._lock:
        gate._templates[fp]["queue"].remove(drained)
    role2, _ = gate.lead_or_wait(fp, drained, 0.0)
    assert role2 == "timeout"
    gate.finish_lead(fp, leader, [leader, drained])
    role3, members3 = gate.lead_or_wait(fp, queued, 0.0)
    assert role3 == "lead" and members3 == [queued]
    gate.finish_lead(fp, queued, members3)
    assert gate.queue_depth(fp) == 0


def test_batched_dispatch_off_by_default_for_embedded_sessions():
    assert make_session().prop("batched_dispatch") is False
    with serving(properties={"health_monitor": False}) as qs:
        assert qs.session.prop("batched_dispatch") is True


def _with_agg_kind(plan, nodes_mod, kind):
    """``plan`` with its Aggregate's first aggregate turned into ``kind``
    (the analyzer decomposes every other kind into sums and counts)."""
    if isinstance(plan, nodes_mod.Aggregate):
        aggs = list(plan.aggs)
        aggs[0] = dataclasses.replace(aggs[0], kind=kind)
        return dataclasses.replace(plan, aggs=tuple(aggs) if isinstance(plan.aggs, tuple)
                                   else aggs)
    if hasattr(plan, "child"):
        return dataclasses.replace(plan, child=_with_agg_kind(plan.child, nodes_mod, kind))
    return plan


REASON_TEMPLATES = {
    "topn": TOPN_FMT.replace("{}", "?"),
    "agg": AGG_FMT.replace("{}", "?"),
    "scan": "select l_orderkey, l_quantity * ? q from lineitem where l_partkey < ?",
    "join": "select l_orderkey, o_orderdate from lineitem join orders on l_orderkey = o_orderkey"
            " where l_quantity < ?",
    "grouped_agg": "select l_returnflag, sum(l_quantity) q from lineitem where l_partkey < ?"
                   " group by l_returnflag",
    "leaf_route": "select sum(l_extendedprice) s, count(*) c from lineitem where l_orderkey in"
                  " (select o_orderkey from orders where o_totalprice < ?)",
    "multi_breaker": "select s from (select sum(l_quantity + ?) s from lineitem) t"
                     " order by s limit 1",
    "window": "select l_orderkey, rank() over (order by l_quantity) r from lineitem"
              " where l_partkey < ?",
    "union": "select l_orderkey from lineitem where l_partkey < ? union all"
             " select o_orderkey from orders",
    "subquery": "select count(*) c from lineitem where l_quantity >"
                " (select avg(l_quantity) from lineitem) and l_partkey < ?",
    "limit": "select l_orderkey from lineitem where l_partkey < ? limit 5",
    "values": "select ? + 1 as x",
    "volatile": "select count(*) c from query_history where output_rows > ?",
}


def test_unbatchable_reason_equals_reference():
    from presto_tpu.plan.templates import unbatchable_reason as jreason
    from presto_tpu_torch.plan.templates import unbatchable_reason as preason

    js = JSession({"tpch": JCONN})
    ps = make_session()
    seen = {}
    for name, sql in REASON_TEMPLATES.items():
        jplan, pplan = js.prepare(sql).plan, ps.prepare(sql).plan
        got, want = preason(pplan, ps.catalog), jreason(jplan, js.catalog)
        assert got == want, (name, got, want)
        seen[name] = got
    # the kind the replay does not cover, and a node the walk never met
    agg_sql = REASON_TEMPLATES["agg"]
    got = preason(_with_agg_kind(ps.prepare(agg_sql).plan, PN, "stddev"), ps.catalog)
    want = jreason(_with_agg_kind(js.prepare(agg_sql).plan, JN, "stddev"), js.catalog)
    assert got == want == "agg_kind"

    class Odd(PN.PlanNode):
        pass

    class JOdd(JN.PlanNode):
        pass

    assert preason(Odd(), ps.catalog) == jreason(JOdd(), js.catalog) == "unsupported"
    assert {seen[k] for k in ("topn", "agg", "scan")} == {None}
    assert all(seen[k] == k for k in REASON_TEMPLATES if k not in ("topn", "agg", "scan"))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_tenant_attribution_and_system_tables():
    with serving(tenants=[TenantSpec("ana", weight=2.0),
                          TenantSpec("bot", max_concurrent=2)]) as qs:
        qs.execute("select count(*) c from orders", tenant="ana")
        qs.execute("select count(*) c from lineitem", tenant="bot")
        hist = qs.session.sql("select tenant, state from query_history where tenant <> ''")
        assert {"ana", "bot"} <= set(hist.column("tenant").tolist())
        ten = qs.session.sql("select tenant, admitted, max_concurrent from tenants "
                             "order by tenant").to_dict()
        rows = {t: (a, m) for t, a, m in zip(ten["tenant"], ten["admitted"],
                                              ten["max_concurrent"])}
        assert rows["ana"][0] >= 1 and rows["bot"][1] == 2
        rec = next(i for i in qs.session.query_history if i.tenant == "ana")
        assert json.loads(rec.to_json())["tenant"] == "ana"


def test_server_prepared_surface_and_submit_poll():
    with serving() as qs:
        name = qs.prepare("select count(*) c from orders where o_orderkey < ?", tenant="ana")
        a = qs.execute_prepared(name, [512], tenant="ana")
        b = qs.execute_prepared(name, [4096], tenant="ana")
        assert int(a.column("c")[0]) < int(b.column("c")[0])
        with pytest.raises(UserError):
            qs.execute_prepared(name, [512], tenant="bob")
        with pytest.raises(UserError):
            qs.deallocate(name, tenant="bob")
        qs.deallocate(name, tenant="ana")
        with pytest.raises(UserError):
            qs.execute_prepared(name, [512], tenant="ana")
        qid = qs.submit("select count(*) c from lineitem", tenant="bot")
        assert int(qs.result(qid, timeout_s=WAIT_S).column("c")[0]) > 0
        page = qs.poll(qid)
        assert page["state"] == "FINISHED" and page["columns"] == ["c"]


def test_server_shutdown_drains_and_refuses_new_work():
    qs = QueryServer({"tpch": CONN}, properties=dict(QUIET), device="cpu")
    try:
        qs.execute("select count(*) c from orders")
    finally:
        summary = qs.shutdown(drain_timeout_s=10)
    assert summary["drained"] and summary["pool_reserved_bytes"] == 0
    with pytest.raises(UserError):
        qs.execute("select 1 a")
    with pytest.raises(UserError):
        qs.submit("select 1 a")


def test_server_submit_limit_rejects_floods():
    with serving(submit_limit=1) as qs:
        qs._queries["stuck"] = {"state": "QUEUED"}
        with pytest.raises(ServerOverloaded) as ei:
            qs.submit("select 1 a")
        assert ei.value.retryable and ei.value.retry_after_s > 0
        del qs._queries["stuck"]
        qid = qs.submit("select count(*) c from orders")
        assert int(qs.result(qid, timeout_s=WAIT_S).column("c")[0]) > 0


def test_submitted_query_polls_queued_while_scheduler_starved():
    with serving(tenants=[TenantSpec("t", max_concurrent=1)]) as qs:
        token = qs.scheduler.acquire("t")
        try:
            qid = qs.submit("select count(*) c from orders", tenant="t")
            wait_until(lambda: qs.scheduler.queue_depth() == 1, "the submission queued")
            assert qs.poll(qid)["state"] == "QUEUED"
        finally:
            qs.scheduler.release(token)
        assert int(qs.result(qid, timeout_s=WAIT_S).column("c")[0]) > 0
        assert qs.poll(qid)["state"] == "FINISHED"


def test_shed_leaves_no_ghost_state():
    with serving(total_slots=1, shed_tenant_queue_limit=0) as srv:
        shed0 = counter("overload.shed")
        depth0 = srv.scheduler.queue_depth()
        records0 = set(srv._queries)
        with pytest.raises(ServerOverloaded):
            srv.submit(OVERLOAD_SQL, tenant="t")
        assert set(srv._queries) == records0
        assert srv.scheduler.queue_depth() == depth0
        assert counter("overload.shed") == shed0 + 1
        snap = {r["tenant"]: r for r in srv.scheduler.snapshot()}
        assert snap["t"]["queued"] == 0


def test_cancel_queued_query_is_typed_and_releases_nothing():
    with serving(total_slots=1) as srv:
        hold = srv.scheduler.acquire("default")
        try:
            qid = srv.submit(OVERLOAD_SQL)
            assert srv.cancel(qid, reason="test cancel")["cancelled"] is True
        finally:
            srv.scheduler.release(hold)
        assert srv._queries[qid]["done"].wait(WAIT_S)
        page = srv.poll(qid)
        assert page["state"] == "FAILED" and page["errorCode"] == "QUERY_CANCELLED"
        assert srv.session.pool().reserved_bytes == 0
        assert srv.cancel(qid)["cancelled"] is False
        with pytest.raises(UserError):
            srv.cancel("nope")


def test_execute_deadline_is_typed_and_pool_drains():
    with serving() as srv:
        with pytest.raises(ExceededTimeLimit):
            srv.execute(OVERLOAD_SQL, deadline_s=0.0)
        assert srv.session.pool().reserved_bytes == 0


def test_deadline_tightens_but_never_loosens_query_max_run_time():
    sess = make_session(query_max_run_time=3600.0)
    token = REQUEST_DEADLINE.set(time.monotonic())
    try:
        with pytest.raises(ExceededTimeLimit):
            sess.sql(OVERLOAD_SQL)
    finally:
        REQUEST_DEADLINE.reset(token)
    assert sess.pool().reserved_bytes == 0
    sess2 = make_session(query_max_run_time=0.0001)
    token = REQUEST_DEADLINE.set(time.monotonic() + 3600.0)
    try:
        with pytest.raises(ExceededTimeLimit):
            sess2.sql(OVERLOAD_SQL)
    finally:
        REQUEST_DEADLINE.reset(token)


def test_brownout_routes_approx_and_sheds_optin_tenants():
    with serving(tenants=[TenantSpec("dash", brownout="approx"),
                          TenantSpec("batch", brownout="shed"), TenantSpec("paying")],
                 properties=dict(QUIET, brownout_cooldown_s=3600.0)) as srv:
        def run(tenant):
            qid = srv.submit("select count(*) c from nation", tenant=tenant)
            assert srv._queries[qid]["done"].wait(WAIT_S)
            return srv.poll(qid)

        assert "approximate" not in run("dash")
        srv.overload.on_breach({"kind": "queue_depth"})
        routed0 = counter("brownout.approx_routed")
        page = run("dash")
        assert page["state"] == "FINISHED" and page.get("approximate") is True
        assert counter("brownout.approx_routed") == routed0 + 1
        with pytest.raises(ServerOverloaded) as ei:
            srv.submit("select count(*) c from nation", tenant="batch")
        assert ei.value.retryable
        assert "approximate" not in run("paying")
        srv.overload.force(True)
        srv.overload.force(False)
        assert "approximate" not in run("dash")


def _request(base, method, path, body=None, headers=None):
    r = urllib.request.Request(base + path, data=body, headers=headers or {}, method=method)
    return urllib.request.urlopen(r, timeout=WAIT_S)


def test_http_round_trip():
    with serving(tenants=[TenantSpec("web", weight=2.0)]) as qs, http_front(qs) as base:
        sub = json.loads(_request(base, "POST", "/v1/statement",
                                  b"select count(*) c from orders where o_orderkey < 1000",
                                  {"X-Presto-Tenant": "web"}).read())
        assert sub["state"] == "QUEUED" and sub["nextUri"]
        page = {}
        deadline = time.monotonic() + WAIT_S
        while page.get("state") not in ("FINISHED", "FAILED"):
            assert time.monotonic() < deadline
            page = json.loads(_request(base, "GET", sub["nextUri"]).read())
        assert page["state"] == "FINISHED" and page["columns"] == ["c"]
        assert page["data"][0][0] > 0
        prep = json.loads(_request(base, "POST", "/v1/prepared", json.dumps(
            {"action": "prepare", "name": "h1",
             "sql": "select count(*) c from orders where o_orderkey < ?"}).encode(),
            {"X-Presto-Tenant": "web"}).read())
        assert prep["prepared"] == "h1"
        got = json.loads(_request(base, "POST", "/v1/prepared", json.dumps(
            {"action": "execute", "name": "h1", "params": [512]}).encode(),
            {"X-Presto-Tenant": "web"}).read())
        assert got["columns"] == ["c"]
        mtext = _request(base, "GET", "/metrics").read().decode()
        assert mtext.splitlines()[-1] == "# EOF"
        assert "presto_tpu_query_completed_total" in mtext
        tens = json.loads(_request(base, "GET", "/v1/tenants").read())
        assert any(t["tenant"] == "web" and t["admitted"] >= 1 for t in tens)


def test_http_overload_surface():
    with serving(submit_limit=1, total_slots=1) as srv, http_front(srv) as base:
        srv._queries["stuck"] = {"state": "QUEUED"}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(base, "POST", "/v1/statement", b"select 1 a")
        assert ei.value.code == 429 and int(ei.value.headers["Retry-After"]) >= 1
        body = json.loads(ei.value.read())
        assert body["errorCode"] == "SERVER_OVERLOADED" and body["retryAfterS"] > 0
        del srv._queries["stuck"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(base, "POST", "/v1/statement", b"select 1 a",
                     {"X-Presto-Deadline": "not-a-number"})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _request(base, "DELETE", "/v1/statement/nope")
        assert ei.value.code == 400
        hold = srv.scheduler.acquire("default")
        try:
            out = json.loads(_request(base, "POST", "/v1/statement", OVERLOAD_SQL.encode(),
                                      {"X-Presto-Deadline": "600"}).read())
            qid = out["id"]
            out = json.loads(_request(base, "DELETE", f"/v1/statement/{qid}").read())
            assert out["cancelled"] is True
        finally:
            srv.scheduler.release(hold)
        assert srv._queries[qid]["done"].wait(WAIT_S)
        page = json.loads(_request(base, "GET", f"/v1/statement/{qid}").read())
        assert page["state"] == "FAILED" and page["errorCode"] == "QUERY_CANCELLED"


#: DECIMAL, DOUBLE (a division), DATE, a NULL-bearing BIGINT and
#: VARCHAR
PAGE_SQL = ("select l_orderkey, l_linenumber, l_extendedprice, "
            "cast(l_extendedprice as double) / 7 as d, "
            "l_shipdate, "
            "case when l_linenumber = 1 then null else l_partkey end as n, "
            "l_shipmode from lineitem where l_orderkey < 40 "
            "order by l_orderkey, l_linenumber")


def test_result_page_json_equals_reference():
    """The HTTP result page of a statement with DOUBLE, DECIMAL, DATE and
    NULL columns: the port's JSON equals the reference's pandas one."""
    from presto_tpu.server.frontend import _df_payload as jpayload

    with serving() as qs, http_front(qs) as base:
        out = json.loads(_request(base, "POST", "/v1/statement", PAGE_SQL.encode()).read())
        qs.result(out["id"], timeout_s=WAIT_S)
        page = json.loads(_request(base, "GET", out["nextUri"]).read())
    want = json.loads(json.dumps(jpayload(JSession(
        {"tpch": JCONN}, properties={"result_cache_enabled": False}).sql(PAGE_SQL))))
    assert page["columns"] == want["columns"]
    assert page["data"] == want["data"]
    assert any(row[5] is None for row in page["data"])
    assert page["data"][0][4].endswith("T00:00:00.000")


def test_double_json_equals_pandas_encoding():
    """DOUBLE values across the encoder's ranges (fixed 10 decimals, the
    exponent form past 1e16 and below 1e-15, zeros, NaN) carry the values
    the reference's pandas page carries."""
    import pandas as pd

    from presto_tpu.server.frontend import _df_payload as jpayload
    from presto_tpu_torch.server.frontend import _json_float

    rng = np.random.default_rng(21)
    vals = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-20, 25, 4000),
                           [0.0, -0.0, 1e16, -1e16, 1e-15, 0.99999e-15, 5e-11, 1.5e-10,
                            2.5e-10, 1234.56789012345678, float("nan")]])
    want = [row[0] for row in json.loads(json.dumps(jpayload(pd.DataFrame({"x": vals}))))["data"]]
    assert [_json_float(v) for v in vals] == want


def test_traceparent_and_trace_context_equal_reference():
    from presto_tpu.server.frontend import _parse_traceparent as jparse
    from presto_tpu.server.frontend import _trace_context as jcontext

    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    headers = [f"00-{tid}-00f067aa0ba902b7-01", None, "", "garbage",
               f"00-{tid[:-1]}-00f067aa0ba902b7-01", f"00-{'0' * 32}-00f067aa0ba902b7-01",
               f"zz-{tid}-00f067aa0ba902b7-01", f"00-{tid}-shortspan-01"]
    assert [_parse_traceparent(h) for h in headers] == [jparse(h) for h in headers]
    assert _parse_traceparent(headers[0]) == tid
    for kwargs in ({"token": "my-token", "traceparent_id": tid, "force": True},
                   {"traceparent_id": tid}, {"token": tid.upper()}):
        assert _trace_context(**kwargs) == jcontext(**kwargs)
    ctx = _trace_context()
    assert len(ctx["trace_id"]) == 32 and not ctx["force_trace"]


def test_submitted_trace_token_reaches_the_query_history():
    """A client's ``X-Presto-Trace`` token is the query's trace token and
    lands in ``system.query_history`` from the worker thread."""
    with serving(tenants=[TenantSpec("web")]) as qs, http_front(qs) as base:
        resp = _request(base, "POST", "/v1/statement", b"select count(*) c from nation",
                        {"X-Presto-Tenant": "web", "X-Presto-Trace": "tok-42"})
        out = json.loads(resp.read())
        assert resp.headers["X-Presto-Trace"] == "tok-42"
        qs.result(out["id"], timeout_s=WAIT_S)
        info = next(i for i in qs.session.query_history if i.trace_token == "tok-42")
        assert info.tenant == "web"
        page = qs.poll(out["id"])
        spans = {s.name for s in qs.session.traces.for_query(info.query_id).spans}
        assert page["state"] == "FINISHED" and {"frontend:submit", "frontend:poll"} <= spans


def test_slo_rides_serving_layer_to_system_table():
    with serving(tenants=[TenantSpec("gold", slo_latency_s=120.0)]) as qs:
        qs.execute("select count(*) c from nation", tenant="gold")
        qs.execute("select count(*) c from nation", tenant="walkin")
        d = qs.session.sql("select tenant, latency_objective_s, latency_good, latency_breach "
                           "from slo").to_dict()
        rows = {t: (o, g, b) for t, o, g, b in zip(d["tenant"], d["latency_objective_s"],
                                                     d["latency_good"], d["latency_breach"])}
        assert rows["gold"][0] == pytest.approx(120.0)
        assert rows["gold"][1] >= 1 and rows["gold"][2] == 0
        assert rows["walkin"][1] >= 1


def test_health_monitor_armed_and_closed_by_the_server():
    from presto_tpu_torch.runtime.health import live_monitors

    with serving(properties={"result_cache_enabled": False, "health_interval_s": 0.05}) as qs:
        assert qs.health is not None and qs.health.running()
        assert qs.session.health is qs.health
        qs.execute("select count(*) c from nation")
        wait_until(lambda: len(qs.health.snapshot()) >= 2, "two health samples")
    assert not qs.health.running() and qs.health not in live_monitors()


def test_query_server_warms_recurring_templates():
    session = make_session(health_monitor=False)
    with serving(session=session, warm_top_k=2, warm_interval_s=0.05) as server:
        before = counter("adaptive.warmed")
        q = "select count(*) c from nation"
        server.execute(q)
        server.execute(q)
        wait_until(lambda: counter("adaptive.warmed") > before, "adaptive.warmed")
        assert q in server._warmed
        assert all(sql.lstrip().lower().startswith(("select", "with"))
                   for sql in server._warmed)


# ---------------------------------------------------------------------------
# the property table
# ---------------------------------------------------------------------------


#: out-of-bound values per kind of check, refused by both packages
_BAD = {"positive": (0, -1), "non_negative": (-1,), "fraction": (0.0, 1.5, -0.25)}


def test_property_table_equals_reference():
    """Every port property: the reference's type and default, and the
    reference's refusals (message included) of out-of-bound values. The
    descriptions are the port's own (they name its kernels and modules);
    each is non-empty."""
    from presto_tpu.runtime.properties import SESSION_PROPERTIES as JP
    from presto_tpu.runtime.properties import validate_properties as jvalidate
    from presto_tpu_torch.runtime.properties import SESSION_PROPERTIES as PP
    from presto_tpu_torch.runtime.properties import validate_properties as pvalidate

    assert set(PP) <= set(JP)
    missing = sorted(set(JP) - set(PP))
    assert missing == [], missing
    checked = 0
    for name, p in PP.items():
        j = JP[name]
        assert p.py_type is j.py_type and p.default == j.default, name
        assert p.description.strip(), name
        assert (p.check is None) == (j.check is None), name
        if p.check is None:
            continue
        for bad in sum(_BAD.values(), ()):
            value = p.py_type(bad)
            jproblem = j.check(value)
            if jproblem is None:
                assert p.check(value) is None, (name, value)
                continue
            with pytest.raises(UserError) as pe:
                pvalidate({name: value})
            with pytest.raises(Exception) as je:
                jvalidate({name: value})
            assert str(pe.value) == str(je.value), (name, value)
            checked += 1
    assert checked >= 30


# ---------------------------------------------------------------------------
# phase 21 of chip_smoke.py on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_phase21_on_the_cpu():
    """Phase 21 (``chip_smoke.run_serving_queries``) runs its checks on
    the CPU at sf 0.01, lineitem in four splits (so the approximate
    subscription samples two)."""
    import chip_smoke

    out = chip_smoke.run_serving_queries(
        PConnector(sf=0.01, units_per_split=1 << 12, device="cpu"), device="cpu")
    assert out["batch"]["dispatched"] == 2 and out["batch"]["fallback.error"] == 0
    assert out["batch"]["topn"]["lanes"] == out["batch"]["agg"]["lanes"] == 8
    assert out["streams"]["stale_blocked"] == 0 and out["streams"]["epochs"] == 10
    assert out["streams"]["sampled_splits"] == [0, 2]
    assert out["leaf_fallback"]["counters"]["batch.fallback.leaf_route"] == 1
