"""Continuous-query subscriptions over the serving layer.

Counterpart of ``presto_tpu/stream/subscriptions.py``. A
:class:`ContinuousQuery` is a standing statement: subscribed once
(``QueryServer.subscribe`` / ``POST /v1/subscribe``), prepared into a
plan template, then re-executed whenever a referenced table's version
epoch advances (streaming appends) or an interval tick elapses. Every
refresh flows through the server's admitted path: a fair slot per
tenant, in-flight accounting, and the ``TemplateBatchGate``, so N
same-template dashboards woken by one append fuse into one batched
dispatch.

The :class:`SubscriptionManager`'s single notifier thread only detects
due work (epoch deltas, ticks); each due refresh executes on its own
short-lived thread, so concurrent same-template refreshes meet at the
batch gate instead of serializing.

Freshness: the epoch snapshot is taken when the refresh fires, before
execution; the delivered :class:`SubscriptionResult` carries it. The plan
fingerprint folds live table versions, so the execution can neither
coalesce onto nor cache-hit a pre-append run, and delivery re-asserts
monotonicity (``subscription.stale_blocked``: always 0). Each delivery is
a freshness sample for ``session.slo``.

``mode="approx"`` subscriptions prepare against the server's sibling
approximate session (``approx_join`` on, optionally sampled scans), whose
results arrive flagged ``approximate``, never silently.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Mapping, Optional

from presto_tpu_torch.runtime.errors import InternalError, PrestoError, UserError
from presto_tpu_torch.runtime.metrics import REGISTRY


@dataclass(frozen=True)
class SubscriptionResult:
    """One delivered refresh. ``epochs`` is the per-table version
    snapshot taken at fire time — the rows reflect AT LEAST these
    versions (the freshness floor, not a ceiling: an append landing
    mid-execution may already be visible)."""

    df: object  # the refresh's QueryResult
    epochs: Mapping[str, int]
    seq: int
    trigger: str  # "initial" | "epoch" | "interval"
    approximate: bool
    batched: bool
    refresh_s: float


class ContinuousQuery:
    """The client-facing subscription surface: a bounded ring of
    delivered results plus wait/poll helpers. Delivery state is
    guarded by one condition variable; scheduling state (what is due,
    what is in flight) lives in the :class:`SubscriptionManager`."""

    def __init__(self, sub_id: str, sql: str, tenant: str, mode: str,
                 interval_s: Optional[float], tables: tuple,
                 keep: int = 8):
        self.id = sub_id
        self.sql = sql
        self.tenant = tenant
        self.mode = mode
        self.interval_s = interval_s
        #: tables the prepared plan scans (epoch-watched subset of
        #: these drives refreshes)
        self.tables = tuple(tables)
        self._cv = threading.Condition()
        self._results: "deque[SubscriptionResult]" = deque(maxlen=max(1, keep))
        self._seq = 0
        self._state = "ACTIVE"  # ACTIVE | CANCELLED | FAILED
        self._last_error: Optional[str] = None
        self._failures = 0  # consecutive refresh failures

    # ---- observation -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._cv:
            return self._state

    @property
    def seq(self) -> int:
        with self._cv:
            return self._seq

    @property
    def last_error(self) -> Optional[str]:
        with self._cv:
            return self._last_error

    def latest(self) -> Optional[SubscriptionResult]:
        with self._cv:
            return self._results[-1] if self._results else None

    def results(self) -> "list[SubscriptionResult]":
        with self._cv:
            return list(self._results)

    def wait_for_seq(self, seq: int,
                     timeout_s: float = 30.0) -> SubscriptionResult:
        """Block until a result with sequence >= ``seq`` is delivered;
        raises (typed) on timeout, cancellation, or failure."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._seq >= seq or self._state != "ACTIVE",
                timeout_s)
            for r in self._results:
                if r.seq >= seq:
                    return r
            raise UserError(
                f"subscription {self.id}: no result with seq>={seq} "
                f"(state={self._state}, seq={self._seq}, "
                f"last_error={self._last_error})")

    def wait_for_epoch(self, table: str, epoch: int,
                       timeout_s: float = 30.0) -> SubscriptionResult:
        """Block until a delivered result reflects ``table`` at version
        >= ``epoch`` (the freshness floor a writer's
        :class:`~presto_tpu_torch.stream.writer.AppendResult` hands out)."""
        def have():
            return (any(r.epochs.get(table, -1) >= epoch
                        for r in self._results)
                    or self._state != "ACTIVE")

        with self._cv:
            self._cv.wait_for(have, timeout_s)
            for r in self._results:
                if r.epochs.get(table, -1) >= epoch:
                    return r
            raise UserError(
                f"subscription {self.id}: no result at {table!r} epoch "
                f">={epoch} (state={self._state}, "
                f"last_error={self._last_error})")

    def page(self) -> dict:
        """The HTTP poll-page shape (``GET /v1/subscription/<id>``)."""
        with self._cv:
            p = {
                "id": self.id, "sql": self.sql, "tenant": self.tenant,
                "mode": self.mode, "state": self._state, "seq": self._seq,
                "tables": list(self.tables),
            }
            if self._last_error:
                p["error"] = self._last_error
            last = self._results[-1] if self._results else None
        if last is not None:
            from presto_tpu_torch.server.frontend import _df_payload

            p["epochs"] = dict(last.epochs)
            p["trigger"] = last.trigger
            p["approximate"] = last.approximate
            p["refreshS"] = round(last.refresh_s, 6)
            p.update(_df_payload(last.df))
        return p

    # ---- delivery (manager-side) ----------------------------------------
    def _deliver(self, df, epochs: Mapping[str, int], trigger: str,
                 approximate: bool, batched: bool,
                 refresh_s: float) -> SubscriptionResult:
        with self._cv:
            prev = self._results[-1] if self._results else None
            if prev is not None and any(
                    epochs.get(t, 0) < e for t, e in prev.epochs.items()):
                # the freshness contract's last line of defense: a
                # refresh must never deliver an OLDER view than one
                # already served (fires are serialized per sub, so
                # reaching here is an engine bug, not a race)
                REGISTRY.counter("subscription.stale_blocked").add()
                raise InternalError(
                    f"subscription {self.id}: stale delivery "
                    f"{dict(epochs)} after {dict(prev.epochs)}")
            self._seq += 1
            res = SubscriptionResult(
                df=df, epochs=dict(epochs), seq=self._seq, trigger=trigger,
                approximate=approximate, batched=batched,
                refresh_s=refresh_s)
            self._results.append(res)
            self._failures = 0
            self._cv.notify_all()
        return res

    def _fail(self, exc: BaseException, typed: bool,
              max_failures: int) -> bool:
        """Record a refresh failure; returns True when the
        subscription transitioned to FAILED (untyped breach, or too
        many consecutive typed failures)."""
        with self._cv:
            self._last_error = f"{type(exc).__name__}: {exc}"
            self._failures += 1
            if not typed or self._failures >= max_failures:
                self._state = "FAILED"
            self._cv.notify_all()
            return self._state == "FAILED"

    def _cancel(self) -> None:
        with self._cv:
            if self._state == "ACTIVE":
                self._state = "CANCELLED"
            self._cv.notify_all()


class SubscriptionManager:
    """Owns every subscription of one :class:`QueryServer`: epoch
    watching, interval ticks, refresh dispatch, lifecycle."""

    #: idle poll cadence of the notifier thread; a write to any hooked
    #: connector wakes it immediately (Event.set from the DDL
    #: listener), so this only bounds interval-tick resolution
    POLL_S = 0.05
    #: consecutive TYPED refresh failures before a subscription is
    #: marked FAILED instead of retrying on the next epoch/tick —
    #: transient chaos faults must not kill a dashboard, a persistent
    #: failure must not retry forever
    MAX_CONSECUTIVE_FAILURES = 20

    def __init__(self, server):
        self._server = server
        self._lock = threading.Lock()
        self._subs: "dict[str, ContinuousQuery]" = {}
        #: manager-owned scheduling state per subscription id:
        #: session/prepared-key, epoch sources, last-fired epochs,
        #: pending/inflight flags, next interval tick
        self._sched: "dict[str, dict]" = {}
        self._hooked: "set[int]" = set()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._ids = itertools.count(1)

    # ---- registration ----------------------------------------------------
    def subscribe(self, sql: str, tenant: str, mode: str = "exact",
                  interval_s: Optional[float] = None,
                  keep: int = 8) -> ContinuousQuery:
        if mode not in ("exact", "approx"):
            raise UserError(f"subscription mode must be exact|approx, "
                            f"got {mode!r}")
        if interval_s is not None and interval_s <= 0:
            raise UserError(f"interval_s must be positive, got {interval_s}")
        session = (self._server.approx_session() if mode == "approx"
                   else self._server.session)
        sub_id = f"sub_{next(self._ids)}"
        key = f"{tenant}::{sub_id}"
        handle = session.prepare(sql, key)
        if handle.n_user:
            session._prepared.pop(key, None)
            raise UserError(
                "subscription SQL must not contain ? placeholders "
                "(literals are auto-templated; there is no per-refresh "
                "binding source)")
        from presto_tpu_torch.cache.fingerprint import referenced_tables

        tables = tuple(t for _, t in referenced_tables(handle.plan))
        sources = self._epoch_sources(tables)
        sub = ContinuousQuery(sub_id, sql, tenant, mode, interval_s,
                              tables, keep=keep)
        with self._lock:
            self._subs[sub_id] = sub
            self._sched[sub_id] = {
                "session": session, "key": key, "sources": sources,
                "fired": {}, "pending": True, "inflight": False,
                "next_tick": (time.monotonic() + interval_s
                              if interval_s else None),
                # freshness baseline: creation counts as "delivered" so
                # lag measures refresh progress, not subscription age
                "delivered_mono": time.monotonic(),
            }
            for conn in sources.values():
                if id(conn) not in self._hooked:
                    # one listener per connector: any write wakes the
                    # notifier, which matches tables to subscriptions
                    conn.add_ddl_listener(self._on_write)
                    self._hooked.add(id(conn))
            if not self._running:
                self._running = True
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="presto-tpu-subscriptions")
                self._thread.start()
        REGISTRY.counter("subscription.created").add()
        self._wake.set()
        return sub

    def unsubscribe(self, sub_id: str) -> None:
        with self._lock:
            sub = self._subs.pop(sub_id, None)
            sched = self._sched.pop(sub_id, None)
        if sub is None:
            raise UserError(f"unknown subscription: {sub_id}")
        sub._cancel()
        if sched is not None:
            sched["session"]._prepared.pop(sched["key"], None)
        REGISTRY.counter("subscription.cancelled").add()

    def get(self, sub_id: str) -> ContinuousQuery:
        with self._lock:
            sub = self._subs.get(sub_id)
        if sub is None:
            raise UserError(f"unknown subscription: {sub_id}")
        return sub

    def snapshot(self) -> "list[dict]":
        with self._lock:
            subs = list(self._subs.values())
        return [s.page() for s in subs]

    def max_lag_s(self) -> float:
        """Worst delivery lag across ACTIVE subscriptions: seconds
        since the last delivery for any subscription with
        due-but-undelivered work (a pending or in-flight refresh).
        Idle subscriptions carry no lag — an unchanged table is not
        stale. 0.0 with no subscriptions. This is the freshness signal
        the health watchdog samples (runtime/health.py)."""
        now = time.monotonic()
        worst = 0.0
        with self._lock:
            for sid, sub in self._subs.items():
                sched = self._sched[sid]
                if sub.state != "ACTIVE":
                    continue
                if not (sched["pending"] or sched["inflight"]):
                    continue
                worst = max(worst, now - sched.get("delivered_mono", now))
        return worst

    def close(self) -> None:
        """Stop the notifier and cancel every subscription (the
        server's shutdown path). In-flight refreshes finish through
        the server's ordinary drain accounting."""
        with self._lock:
            self._running = False
            thread, self._thread = self._thread, None
            subs = list(self._subs.values())
            scheds = list(self._sched.values())
            self._subs.clear()
            self._sched.clear()
        self._wake.set()
        if thread is not None:
            thread.join(10)
        for sched in scheds:
            sched["session"]._prepared.pop(sched["key"], None)
        for sub in subs:
            sub._cancel()

    # ---- epoch watching --------------------------------------------------
    def _epoch_sources(self, tables) -> dict:
        """{table: connector} for every referenced table on a
        versioned (streamable) connector. Tables on static catalogs
        have no epochs — subscriptions over only those refresh on
        interval ticks alone."""
        out = {}
        for conn in self._server.session.catalog.connectors.values():
            if not hasattr(conn, "table_epoch"):
                continue
            for t in tables:
                if t in conn.tables():
                    out[t] = conn
        return out

    def _on_write(self, table: str) -> None:
        # runs inside the writer's DDL-listener fire: must be O(1) and
        # lock-free — the notifier thread does the table matching
        self._wake.set()

    # ---- the notifier loop -----------------------------------------------
    def _loop(self) -> None:
        while True:
            self._wake.wait(self.POLL_S)
            self._wake.clear()
            with self._lock:
                if not self._running:
                    return
                due = self._due_locked()
            # one thread per due refresh, started together: concurrent
            # same-template refreshes meet at the TemplateBatchGate and
            # fuse into one batched dispatch
            for sub, sched, epochs, trigger in due:
                threading.Thread(
                    target=self._fire, args=(sub, sched, epochs, trigger),
                    daemon=True, name=f"presto-tpu-{sub.id}",
                ).start()

    def _due_locked(self):
        now = time.monotonic()
        due = []
        for sid, sub in self._subs.items():
            sched = self._sched[sid]
            if sched["inflight"] or sub.state != "ACTIVE":
                continue
            epochs = {t: conn.table_epoch(t)
                      for t, conn in sched["sources"].items()}
            trigger = None
            if sched["pending"]:
                trigger = "initial" if not sched["fired"] else "epoch"
            elif any(epochs[t] > sched["fired"].get(t, -1) for t in epochs):
                trigger = "epoch"
            elif (sched["next_tick"] is not None
                  and now >= sched["next_tick"]):
                trigger = "interval"
            if trigger is None:
                continue
            sched["pending"] = False
            sched["inflight"] = True
            # the freshness floor: epochs AS OF this fire decision —
            # the delivered result must reflect at least these
            sched["fired"] = dict(epochs)
            if sched["next_tick"] is not None:
                sched["next_tick"] = now + float(sub.interval_s)
            due.append((sub, sched, epochs, trigger))
        return due

    # ---- refresh execution -----------------------------------------------
    def _fire(self, sub: ContinuousQuery, sched: dict,
              epochs: "dict[str, int]", trigger: str) -> None:
        from presto_tpu_torch.runtime.session import REQUEST_TRACE

        server = self._server
        #: links the refresh execution back to its subscription: the
        #: query runs with trace token ``sub:<id>`` and a stamped
        #: subscription_id (-> system.query_history), and writes its
        #: engine query id back for the post-hoc fire span below
        trace_ctx = {"token": f"sub:{sub.id}", "trace_id": "",
                     "subscription_id": sub.id, "force_trace": False}
        try:
            t0 = time.perf_counter()
            try:
                server._enter(sub.tenant)
            except UserError:
                # draining: the refresh is dropped, the subscription
                # stays ACTIVE (a restarted server re-fires it)
                REGISTRY.counter("subscription.drain_blocked").add()
                return
            try:
                try:
                    rt_token = REQUEST_TRACE.set(trace_ctx)
                    try:
                        df, info = server._execute_admitted(
                            lambda: sched["session"].execute_prepared(
                                sched["key"], []),
                            sub.tenant, timeout_s=server.submit_timeout_s)
                    finally:
                        REQUEST_TRACE.reset(rt_token)
                finally:
                    server._leave()
            except PrestoError as e:
                REGISTRY.counter("subscription.refresh_failed").add()
                failed = sub._fail(e, typed=True,
                                   max_failures=self.MAX_CONSECUTIVE_FAILURES)
                if not failed:
                    # the fire's epochs were NOT delivered: re-arm so
                    # the next pass retries (freshness over silence)
                    with self._lock:
                        if sub.id in self._sched:
                            sched["pending"] = True
                return
            except Exception as e:  # noqa: BLE001 — contract breach, recorded
                REGISTRY.counter("subscription.refresh_failed").add()
                sub._fail(e, typed=False,
                          max_failures=self.MAX_CONSECUTIVE_FAILURES)
                return
            dt = time.perf_counter() - t0
            sub._deliver(df=df, epochs=epochs, trigger=trigger,
                         approximate=bool(info.approximate),
                         batched=bool(info.batched), refresh_s=dt)
            with self._lock:
                if sub.id in self._sched:
                    sched["delivered_mono"] = time.monotonic()
            try:
                # child span on the refresh query's own recorder: the
                # fire (enter -> admitted -> delivered) wraps the
                # engine-side spans, so a trace export reads the
                # subscription wake as the parent of the execution
                if trace_ctx.get("query_id"):
                    tracer = sched["session"].traces.for_query(
                        trace_ctx["query_id"])
                    if tracer is not None:
                        tracer.add_complete(
                            "subscription:fire", "subscription", t0, dt,
                            {"subscriptionId": sub.id, "trigger": trigger,
                             "tenant": sub.tenant})
                slo = getattr(server.session, "slo", None)
                if slo is not None:
                    # the delivered refresh IS the freshness sample:
                    # fire-to-delivery wall time vs the objective
                    slo.observe_freshness(sub.tenant, dt)
            except Exception:  # noqa: BLE001 — observability-only path
                REGISTRY.counter("exec.trace_errors").add()
            REGISTRY.counter("subscription.fired").add()
            REGISTRY.counter(f"subscription.trigger.{trigger}").add()
            REGISTRY.histogram("subscription.refresh_s").add(dt)
        finally:
            with self._lock:
                sched["inflight"] = False
            # epochs may have advanced mid-refresh: re-check promptly
            self._wake.set()
