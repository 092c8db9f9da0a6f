"""The port's continuous queries (``presto_tpu_torch/stream/
subscriptions.py``) over its ``QueryServer``, case for case after
``tests/test_subscriptions.py``, plus the delivered results epoch by epoch
against the reference server's.

- refreshes fire on an epoch advance and on an interval tick, and every
  delivered result meets the epoch floor taken when it fired
  (``subscription.stale_blocked`` stays 0);
- N same-template subscriptions woken by one append fuse at the batch
  gate (``batch.fallback.error`` stays 0);
- ``mode="approx"`` rides the sketch join and the sampled scan, flagged
  ``approximate``, and never shares a cache entry with the exact tier;
  a sampled scan keeps the reference's splits (same answer, same
  ``scan.splits_sampled_out``), and batched lanes sample like their
  serial runs (ROADMAP C21);
- the HTTP surface and the drain.

Every server shuts down in a ``finally``; every wait is bounded.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

import presto_tpu_torch.runtime.metrics as PM
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.lifecycle import QueryManager
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.server.frontend import HttpFrontend, QueryServer
from presto_tpu_torch.stream import StreamWriter
import torch_bridge  # noqa: F401  (pins one intra-op thread)

WAIT_S = 30.0


def counter(name: str) -> float:
    return PM.REGISTRY.snapshot().get(name, 0.0)


@contextlib.contextmanager
def serving(units_per_split=None, **kwargs):
    """(connector, session, server) over a memory catalog on the CPU."""
    conn = MemoryConnector(units_per_split=units_per_split, device="cpu")
    s = Session({"memory": conn}, properties={"batched_dispatch": True,
                                              "health_monitor": False}, device="cpu")
    server = QueryServer(session=s, **kwargs)
    try:
        yield conn, s, server
    finally:
        server.shutdown(drain_timeout_s=WAIT_S)


def ticks(n, lo=0) -> dict:
    k = np.arange(lo, lo + n, dtype=np.int64)
    return {"k": k, "v": (k * 3) % 100}


def count_of(res) -> int:
    return int(res.df.column("c")[0])


def test_initial_then_epoch_refresh_is_fresh():
    with serving() as (_conn, s, server):
        w = StreamWriter(s)
        w.append("ticks", ticks(10))
        sub = server.subscribe("select count(*) c, sum(v) s from ticks", "t0")
        first = sub.wait_for_seq(1, timeout_s=WAIT_S)
        assert first.trigger == "initial" and count_of(first) == 10
        assert first.epochs == {"ticks": 1}
        r = w.append("ticks", ticks(5, lo=10))
        got = sub.wait_for_epoch("ticks", r.epoch, timeout_s=WAIT_S)
        assert got.trigger == "epoch" and count_of(got) == r.total_rows
        assert got.epochs["ticks"] >= r.epoch
        assert counter("subscription.stale_blocked") == 0
        info = next(i for i in s.query_history if i.subscription_id == sub.id)
        assert info.tenant == "t0" and info.trace_token == f"sub:{sub.id}"


def test_every_delivered_result_meets_its_epoch_floor():
    with serving() as (_conn, s, server):
        w = StreamWriter(s)
        rows_at_epoch = {}
        r = w.append("ticks", ticks(20))
        rows_at_epoch[r.epoch] = r.total_rows
        sub = server.subscribe("select count(*) c from ticks", "t0")
        for i in range(5):
            r = w.append("ticks", ticks(7, lo=100 * (i + 1)))
            rows_at_epoch[r.epoch] = r.total_rows
        sub.wait_for_epoch("ticks", r.epoch, timeout_s=WAIT_S)
        for res in sub.results():
            floor = rows_at_epoch.get(res.epochs.get("ticks"))
            if floor is not None:
                assert count_of(res) >= floor
        assert counter("subscription.stale_blocked") == 0


def test_interval_tick_refresh_without_writes():
    with serving() as (_conn, s, server):
        StreamWriter(s).append("ticks", ticks(4))
        sub = server.subscribe("select max(v) m from ticks", "t0", interval_s=0.1)
        got = sub.wait_for_seq(3, timeout_s=WAIT_S)
        assert got.seq >= 3 and any(r.trigger == "interval" for r in sub.results())


def test_subscription_failure_paths_are_loud():
    with serving() as (_conn, s, server):
        StreamWriter(s).append("ticks", ticks(4))
        with pytest.raises(UserError, match="exact|approx"):
            server.subscribe("select 1", "t0", mode="wat")
        with pytest.raises(UserError, match="positive"):
            server.subscribe("select 1", "t0", interval_s=-1)
        with pytest.raises(UserError, match="placeholder"):
            server.subscribe("select count(*) from ticks where v < ?", "t0")
        sub = server.subscribe("select count(*) c from ticks", "t0")
        sub.wait_for_seq(1, timeout_s=WAIT_S)
        with pytest.raises(UserError, match="unknown subscription"):
            server.unsubscribe("sub_999")
    assert sub.state == "CANCELLED"
    with pytest.raises(UserError):
        sub.wait_for_seq(99, timeout_s=0.2)


def test_unsubscribe_deallocates_prepared_template():
    with serving() as (_conn, s, server):
        StreamWriter(s).append("ticks", ticks(4))
        sub = server.subscribe("select count(*) c from ticks", "t0")
        sub.wait_for_seq(1, timeout_s=WAIT_S)
        key = f"t0::{sub.id}"
        assert key in s._prepared
        server.unsubscribe(sub.id)
        assert key not in s._prepared and sub.state == "CANCELLED"


def test_drain_blocks_new_subscriptions():
    with serving() as (_conn, s, server):
        StreamWriter(s).append("ticks", ticks(4))
        sub = server.subscribe("select count(*) c from ticks", "t0")
        sub.wait_for_seq(1, timeout_s=WAIT_S)
        server.shutdown()
        assert sub.state == "CANCELLED"
        with pytest.raises(UserError, match="draining"):
            server.subscribe("select count(*) c from ticks", "t0")


def test_same_template_subscriptions_batch_through_gate(monkeypatch):
    """Four dashboards on one template, different literals: one append
    wakes all of them, the first refresh is held until the others queue
    at the gate, and the next leader fuses them into one batched
    dispatch; every dashboard sees the post-append rows."""
    with serving() as (_conn, s, server):
        w = StreamWriter(s)
        w.append("ticks", ticks(50))
        fmt = "select k, v from ticks where v < {} order by k limit 100"
        lits = (25, 50, 75, 101)
        subs = [server.subscribe(fmt.format(lit), f"tenant-{i}") for i, lit in enumerate(lits)]
        assert all(s._prepared[f"tenant-{i}::{sub.id}"].auto_slots
                   for i, sub in enumerate(subs))
        for sub in subs:
            sub.wait_for_seq(1, timeout_s=WAIT_S)
        gate = s.query_manager.batch_gate
        release, first = threading.Event(), threading.Event()
        orig = QueryManager.run_plan

        def gated(self, executor, plan, info, recorder):
            if not first.is_set():
                first.set()
                release.wait(WAIT_S)
            return orig(self, executor, plan, info, recorder)

        monkeypatch.setattr(QueryManager, "run_plan", gated)
        d0, q0 = counter("batch.dispatched"), counter("batch.queries")
        e0 = counter("batch.fallback.error")
        r = w.append("ticks", ticks(50, lo=50))
        assert first.wait(WAIT_S)
        deadline = time.monotonic() + WAIT_S
        while sum(gate.queue_depth(fp) for fp in list(gate._templates)) < len(subs) - 1:
            assert time.monotonic() < deadline, "the refreshes never met at the gate"
            time.sleep(0.005)
        release.set()
        got = [sub.wait_for_epoch("ticks", r.epoch, timeout_s=WAIT_S) for sub in subs]
        dd, qd = counter("batch.dispatched") - d0, counter("batch.queries") - q0
        assert dd >= 1 and qd / dd > 1.0 and counter("batch.fallback.error") == e0
        assert sum(res.batched for res in got) >= 2
        full = ticks(100)
        for res, lit in zip(got, lits):
            want = full["k"][full["v"] < lit][:100]
            assert res.df.column("k").tolist() == want.tolist()


def _wide_domain_tables(w: StreamWriter, seed=7, n=4000, nkeys=500):
    rng = np.random.default_rng(seed)
    ckeys = rng.integers(0, 1_000_000_000_000, nkeys).astype(np.int64)
    w.append("orders", {"okey": np.arange(n, dtype=np.int64),
                        "ckey": np.concatenate([rng.choice(ckeys, n - 1000),
                                                rng.integers(0, 1_000_000_000_000, 1000)
                                                ]).astype(np.int64)})
    w.append("cust", {"ckey": ckeys, "grp": rng.integers(0, 5, nkeys).astype(np.int64)})
    return ("select count(*) n from orders where ckey in "
            "(select ckey from cust where grp = 3)")


def test_approx_subscription_sketch_join_superset_flagged():
    with serving() as (_conn, s, server):
        sql = _wide_domain_tables(StreamWriter(s))
        exact = int(server.execute(sql, "t0").column("n")[0])
        sub = server.subscribe(sql, "t0", mode="approx")
        got = sub.wait_for_seq(1, timeout_s=WAIT_S)
        assert got.approximate and int(got.df.column("n")[0]) >= exact
    infos = [i for i in s.query_history if i.tenant == "t0"]
    assert infos and not infos[0].approximate


def test_approx_subscription_sampled_scan_flagged():
    with serving(units_per_split=64,
                 approx_properties={"approx_scan_fraction": 0.25}) as (_conn, s, server):
        StreamWriter(s).append("ticks", ticks(1000))
        sampled = counter("scan.splits_sampled_out")
        sub = server.subscribe("select count(*) c from ticks", "t0", mode="approx")
        got = sub.wait_for_seq(1, timeout_s=WAIT_S)
        assert got.approximate and 0 < count_of(got) < 1000
        # 16 splits of 64 rows (the last 40), a quarter kept: 12 out
        assert counter("scan.splits_sampled_out") == sampled + 12
        assert count_of(got) == 4 * 64
        assert int(server.execute("select count(*) c from ticks", "t0").column("c")[0]) == 1000


def test_exact_and_approx_subscriptions_never_share_cache():
    with serving(units_per_split=64,
                 approx_properties={"approx_scan_fraction": 0.25}) as (_conn, s, server):
        StreamWriter(s).append("ticks", ticks(1000))
        sql = "select count(*) c from ticks"
        exact_sub = server.subscribe(sql, "t0")
        approx_sub = server.subscribe(sql, "t0", mode="approx")
        e = exact_sub.wait_for_seq(1, timeout_s=WAIT_S)
        a = approx_sub.wait_for_seq(1, timeout_s=WAIT_S)
        assert count_of(e) == 1000 and not e.approximate
        assert count_of(a) < 1000 and a.approximate


def test_http_subscribe_poll_cancel_round_trip():
    with serving() as (_conn, s, server):
        w = StreamWriter(s)
        w.append("ticks", ticks(10))
        fe = HttpFrontend(server, port=0).start_background()
        base = f"http://127.0.0.1:{fe.port}"

        def post(path, body):
            req = urllib.request.Request(base + path, method="POST",
                                         data=json.dumps(body).encode(),
                                         headers={"X-Presto-Tenant": "dash"})
            try:
                with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        def poll_until(uri, cond):
            deadline = time.monotonic() + WAIT_S
            while True:
                with urllib.request.urlopen(base + uri, timeout=WAIT_S) as r:
                    page = json.loads(r.read())
                if cond(page):
                    return page
                assert time.monotonic() < deadline, page
                time.sleep(0.01)

        try:
            st, body = post("/v1/subscribe", {"sql": "select count(*) c from ticks"})
            assert st == 201 and body["tables"] == ["ticks"]
            sid, uri = body["id"], body["nextUri"]
            page = poll_until(uri, lambda p: p.get("seq", 0) >= 1)
            assert page["data"] == [[10]] and page["tenant"] == "dash"
            r = w.append("ticks", ticks(3, lo=10))
            page = poll_until(uri, lambda p: p.get("epochs", {}).get("ticks", 0) >= r.epoch)
            assert page["data"] == [[13]]
            st, body = post(f"/v1/subscription/{sid}/cancel", {})
            assert st == 200 and body == {"cancelled": sid}
            assert post("/v1/subscribe", {"notsql": 1})[0] == 400
            assert post("/v1/subscribe", {"sql": "select 1", "mode": "wat"})[0] == 400
        finally:
            fe.shutdown()


def test_deliveries_epoch_by_epoch_equal_reference():
    """The same appends through both packages' servers: the result each
    subscription delivers for each epoch (its rows and its epoch floor)
    is equal, and the ``subscription.*`` and ``stream.*`` moves too."""
    import presto_tpu.runtime.metrics as JM
    from presto_tpu.connectors.memory import MemoryConnector as JMemory
    from presto_tpu.runtime.session import Session as JSession
    from presto_tpu.server.frontend import QueryServer as JQueryServer
    from presto_tpu.stream import StreamWriter as JStreamWriter

    sql = "select count(*) c, sum(v) s, max(k) m from ticks where v < 60"
    batches = [ticks(30), ticks(7, lo=30), ticks(11, lo=37), ticks(5, lo=48)]
    js = JSession({"memory": JMemory()}, properties={"batched_dispatch": True,
                                                     "health_monitor": False})
    jserver = JQueryServer(session=js)
    delivered = {}
    try:
        for name, server, writer, wrap, reg in (
                ("port", None, None, lambda b: b, PM.REGISTRY),
                ("jax", jserver, JStreamWriter(js), pd.DataFrame, JM.REGISTRY)):
            with contextlib.ExitStack() as stack:
                if server is None:
                    _c, s, server = stack.enter_context(serving())
                    writer = StreamWriter(s)
                before = reg.snapshot()
                writer.append("ticks", wrap(batches[0]))
                sub = server.subscribe(sql, "t0")
                rows = [sub.wait_for_seq(1, timeout_s=WAIT_S)]
                for b in batches[1:]:
                    r = writer.append("ticks", wrap(b))
                    rows.append(sub.wait_for_epoch("ticks", r.epoch, timeout_s=WAIT_S))
                after = reg.snapshot()
                moves = {k: after.get(k, 0) - before.get(k, 0) for k in
                         ("subscription.created", "subscription.stale_blocked",
                          "subscription.refresh_failed", "stream.appends", "stream.rows",
                          "stream.tables_created")}
                out = []
                for res in rows:
                    frame = res.df.to_dict() if name == "port" else \
                        {c: res.df[c].to_numpy() for c in res.df.columns}
                    out.append((res.epochs["ticks"],
                                {c: np.asarray(v).tolist() for c, v in frame.items()}))
                delivered[name] = (out, moves)
    finally:
        jserver.shutdown()
    assert delivered["port"] == delivered["jax"]
    assert [e for e, _ in delivered["port"][0]] == [1, 2, 3, 4]


def test_batched_lanes_sample_like_their_serial_runs():
    """ROADMAP C21: under ``approx_scan_fraction`` < 1 the port's batched
    lanes read the splits their serial runs read (flagged approximate);
    the reference's batched scan reads every split."""
    from presto_tpu.connectors.memory import MemoryConnector as JMemory
    from presto_tpu.runtime.session import Session as JSession
    from presto_tpu.server.batcher import run_batched as jrun_batched
    from presto_tpu_torch.server.batcher import run_batched

    sql = "select count(*) c, sum(v) s from ticks where v < ?"
    props = {"approx_scan_fraction": 0.25, "result_cache_enabled": False}
    data = ticks(1000)
    pconn = MemoryConnector(units_per_split=64, device="cpu")
    pconn.create_table("ticks", data)
    ps = Session({"memory": pconn}, properties=props, device="cpu")
    h = ps.prepare(sql)
    lanes = run_batched(ps.catalog, h.plan, [h.bind([v]) for v in (30, 70)],
                        executor=ps.executor())
    for v, res in zip((30, 70), lanes):
        serial, info = ps.execute_prepared(h, [v])
        assert res.approximate and info.approximate
        for k in ("c", "s"):
            np.testing.assert_array_equal(res.column(k), serial.column(k))
        assert int(res.column("c")[0]) < int((data["v"] < v).sum())
    jconn = JMemory(units_per_split=64)
    jconn.create_table("ticks", pd.DataFrame(data))
    js = JSession({"memory": jconn}, properties=props)
    jh = js.prepare(sql)
    jlanes = jrun_batched(js.catalog, jh.plan, [jh.bind([v]) for v in (30, 70)])
    for v, frame in zip((30, 70), jlanes):
        assert int(frame["c"][0]) == int((data["v"] < v).sum())
        assert int(js.execute_prepared(jh, [v])[0]["c"][0]) < int(frame["c"][0])


def test_sampled_scan_equals_reference():
    """``approx_scan_fraction`` 0.25 over 16 splits: both packages keep
    the same 4 splits (the same answer, flagged approximate) and count
    the same ``scan.splits_sampled_out``; 1.0 scans everything."""
    import presto_tpu.runtime.metrics as JM
    from presto_tpu.connectors.memory import MemoryConnector as JMemory
    from presto_tpu.runtime.session import Session as JSession

    data = ticks(1000)
    sql = "select count(*) c, sum(v) s, min(k) lo, max(k) hi from ticks where v < 90"
    pconn = MemoryConnector(units_per_split=64, device="cpu")
    pconn.create_table("ticks", data)
    jconn = JMemory(units_per_split=64)
    jconn.create_table("ticks", pd.DataFrame(data))
    for fraction in (0.25, 1.0):
        props = {"approx_scan_fraction": fraction, "result_cache_enabled": False}
        ps = Session({"memory": pconn}, properties=props, device="cpu")
        js = JSession({"memory": jconn}, properties=props)
        pbefore, jbefore = PM.REGISTRY.snapshot(), JM.REGISTRY.snapshot()
        res, info = ps.execute(sql)
        frame, jinfo = js.execute(sql)
        pmoved = PM.REGISTRY.snapshot().get("scan.splits_sampled_out", 0) - \
            pbefore.get("scan.splits_sampled_out", 0)
        jmoved = JM.REGISTRY.snapshot().get("scan.splits_sampled_out", 0) - \
            jbefore.get("scan.splits_sampled_out", 0)
        assert pmoved == jmoved == (12 if fraction < 1 else 0)
        assert info.approximate == jinfo.approximate == (fraction < 1)
        for c in ("c", "s", "lo", "hi"):
            assert int(res.column(c)[0]) == int(frame[c][0]), (fraction, c)
