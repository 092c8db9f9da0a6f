"""Multi-client front-end over the Session/QueryManager substrate.

Counterpart of ``presto_tpu/server/frontend.py``: the coordinator's
statement protocol (``POST /v1/statement`` returning a poll URI, clients
following it to ``QUEUED -> RUNNING -> FINISHED`` with the rows in the
terminal page), ``PREPARE`` / ``EXECUTE`` over the session's prepared
statements, continuous-query subscriptions and a ``/metrics`` scrape.
Two surfaces over one core:

- :class:`QueryServer`: the in-process serving core (tenant identity,
  fairness slots, submit/poll bookkeeping, graceful drain). Tests drive
  it directly as the ``ServerClient``: no sockets, same code path.
- :class:`HttpFrontend`: a standard-library ``ThreadingHTTPServer``
  speaking HTTP/JSON on top. Tenant identity rides the
  ``X-Presto-Tenant`` header.

All tenants share one ``Session`` (so ``system.query_history``,
``system.tenants`` and the flight recorder see the whole serving
process) and therefore one memory pool; per-tenant isolation is the
scheduler's job, attribution is ``QueryInfo.tenant``'s. The server's
worker threads run on the session's device. A result page is built from
the port's ``QueryResult`` (:func:`_df_payload`) exactly as the JAX
package's pandas ``to_json(orient="values", date_format="iso")`` renders
it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import threading
import time
import uuid
from typing import Mapping, Optional

import numpy as np

from presto_tpu_torch.runtime.errors import (
    PrestoError,
    QueryCancelled,
    ServerOverloaded,
    UserError,
    error_code,
)
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.overload import OverloadController, shed_retry_after
from presto_tpu_torch.server.scheduler import FairScheduler, TenantSpec

_submit_seq = itertools.count(1)

_HEX = frozenset("0123456789abcdef")


def _json_float(v: float):
    """A DOUBLE as the result page's JSON carries it: the value pandas'
    JSON encoder writes (``double_precision`` 10). Past ``1e16 - 1`` or
    below 1e-15 it is ``%.10g``; otherwise the encoder's own fixed-point
    rounding to 10 decimals (in double arithmetic, a half rounding up
    when the last kept digit is odd or the fraction is 0), which differs
    from Python's correctly rounded ``%.10f`` on halves. NaN and
    infinities are null."""
    v = float(v)
    if not math.isfinite(v):
        return None
    neg, v = v < 0, abs(v)
    if v > 1e16 - 1 or (v != 0.0 and v < 1e-15):
        out = float("%.10g" % v)
    else:
        whole = int(v)
        tmp = (v - whole) * 1e10
        frac = int(tmp)
        diff = tmp - frac
        if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
            frac += 1
        if frac >= 10**10:
            frac, whole = 0, whole + 1
        out = float(f"{whole}.{frac:010d}")
    return -out if neg else out


def _json_value(v):
    """One decoded result value as the JSON result page carries it."""
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return _json_float(v)
    if isinstance(v, np.datetime64):
        if np.isnat(v):
            return None
        # ISO 8601 at millisecond precision, as pandas' date_format="iso"
        return np.datetime_as_string(v.astype("datetime64[ms]"), unit="ms")
    return str(v)


def _df_payload(res) -> dict:
    """A ``QueryResult`` -> the JSON result page ({columns, data}): the
    rows as the JAX package's ``df.to_json(orient="values",
    date_format="iso")`` writes its frame."""
    cols = [res.logical(n) for n in res.names]
    return {
        "columns": [str(c) for c in res.names],
        "data": [[_json_value(c[i]) for c in cols] for i in range(len(res))],
    }


def _on_device(device):
    """``torch.cuda.device(device)`` for a card, else nothing: a thread the
    server starts selects the session's card before it runs a query."""
    if getattr(device, "type", None) == "cuda":
        import torch

        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _parse_traceparent(header: Optional[str]) -> Optional[str]:
    """W3C ``traceparent`` -> its 32-hex trace-id, or None when the
    header is absent or malformed. A bad header degrades to a
    server-generated trace — it never rejects the statement (trace
    plumbing must not be able to 400 a query)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if (len(version) == 2 and set(version) <= _HEX
            and len(trace_id) == 32 and set(trace_id) <= _HEX
            and len(span_id) == 16 and set(span_id) <= _HEX
            and trace_id != "0" * 32):
        return trace_id
    return None


def _trace_context(token: Optional[str] = None,
                   traceparent_id: Optional[str] = None,
                   subscription_id: str = "",
                   force: bool = False) -> dict:
    """Build one REQUEST_TRACE context dict (runtime/session.py).

    Token precedence: an explicit ``X-Presto-Trace`` token, then the
    client traceparent's trace-id, then a fresh server-side id — a
    client that supplied EITHER header gets its identifier honored end
    to end. ``trace_id`` is what outgoing ``traceparent`` headers
    carry: the client's trace-id when one arrived, else the token
    itself when it happens to be 32-hex, else a new id."""
    tok = token or traceparent_id or uuid.uuid4().hex
    trace_id = traceparent_id
    if trace_id is None:
        low = tok.lower()
        trace_id = (low if len(low) == 32 and set(low) <= _HEX
                    else uuid.uuid4().hex)
    return {"token": tok, "trace_id": trace_id,
            "subscription_id": subscription_id,
            "force_trace": bool(force)}


class QueryServer:
    """The in-process serving core: tenant-scoped execution over one
    shared Session, gated by a :class:`FairScheduler`.

    ``connectors`` builds a fresh session on ``device`` (with
    ``batched_dispatch`` on: the serving layer exists to exploit load
    shape); passing an explicit ``session`` serves through it unchanged.
    Tests drive this class directly; the HTTP front-end adds only
    transport."""

    def __init__(self, connectors: Optional[Mapping[str, object]] = None,
                 *, session=None, tenants=None,
                 total_slots: Optional[int] = None,
                 properties: Optional[dict] = None,
                 approx_properties: Optional[dict] = None,
                 default_tenant: str = "default",
                 query_record_limit: int = 256,
                 submit_limit: int = 128,
                 submit_timeout_s: float = 300.0,
                 shed_queue_limit: Optional[int] = None,
                 shed_tenant_queue_limit: Optional[int] = None,
                 shed_drain_limit_s: Optional[float] = None,
                 warm_top_k: int = 0,
                 warm_interval_s: float = 1.0,
                 device="cuda"):
        from presto_tpu_torch.runtime.health import HealthMonitor, SloTracker
        from presto_tpu_torch.runtime.session import Session
        from presto_tpu_torch.stream.subscriptions import SubscriptionManager

        if session is None:
            props = {"batched_dispatch": True}
            props.update(properties or {})
            session = Session(dict(connectors or {}), properties=props, device=device)
        self.session = session
        self.default_tenant = default_tenant
        self.scheduler = FairScheduler(
            tenants, total_slots=total_slots, pool=session.pool(),
            global_queue_limit=shed_queue_limit,
            tenant_queue_limit=shed_tenant_queue_limit,
            shed_drain_limit_s=shed_drain_limit_s)
        #: the brown-out latch (overload rung 4): health breaches
        #: engage it, a breach-free cooldown disengages it, and
        #: eligible tenants' NEW traffic degrades per TenantSpec
        #: .brownout while it is engaged
        self.overload = OverloadController(
            cooldown_s=float(session.prop("brownout_cooldown_s")))
        #: the registry behind system.tenants (connectors/system.py)
        session.tenants = self.scheduler
        #: submit/poll records, RING-bounded: terminal records beyond
        #: the limit retire oldest-first (clients that still hold the
        #: id get "unknown query id" — the reference protocol's retired
        #: -query behavior). In-flight records are never evicted.
        self.query_record_limit = max(1, int(query_record_limit))
        #: backpressure on async submission: at most this many
        #: NON-terminal submitted queries (each owns one worker thread
        #: blocked in the fair scheduler) — beyond it, submit() rejects
        #: loudly instead of growing a thread per request
        self.submit_limit = max(1, int(submit_limit))
        #: fair-queue patience for ASYNC submissions: a worker thread
        #: must never block in the scheduler forever (a starved tenant
        #: flooding /v1/statement would otherwise pin threads and
        #: exhaust submit_limit for everyone); expiry surfaces as the
        #: typed admission-timeout failure on the poll page
        self.submit_timeout_s = submit_timeout_s
        self._queries: "dict[str, dict]" = {}
        self._qlock = threading.Lock()
        self._accepting = True
        self._inflight = 0
        self._drain_cv = threading.Condition()
        #: continuous-query subscriptions (presto_tpu_torch/stream/): the
        #: manager's notifier thread starts on first subscribe, never
        #: for a server that serves only ad-hoc statements
        self.subscriptions = SubscriptionManager(self)
        #: extra session properties for the APPROXIMATE sibling
        #: session (mode="approx" subscriptions) — e.g. a tiny
        #: join_build_budget_bytes to force the sketch path, or
        #: approx_scan_fraction for sampled scans
        self._approx_properties = dict(approx_properties or {})
        self._approx_session = None
        self._approx_lock = threading.Lock()
        #: per-tenant SLO burn-rate tracking (runtime/health.py):
        #: defaults come from the slo_* session properties, per-tenant
        #: objectives from TenantSpec.slo_latency_s/slo_freshness_s;
        #: run_plan observes latency, subscription delivery observes
        #: freshness — both through ``session.slo``
        session.slo = SloTracker(
            latency_objective_s=float(
                session.prop("slo_latency_objective_s")),
            freshness_objective_s=float(
                session.prop("slo_freshness_objective_s")),
            window=int(session.prop("slo_window")),
            overrides=self.scheduler.slo_overrides())
        #: the anomaly watchdog (runtime/health.py): samples serving
        #: vitals on its own thread, and on a breach arms the flight
        #: recorder against the worst in-flight query. Built LAST so
        #: every structure it samples (scheduler, subscriptions, slo)
        #: already exists; ``health_monitor=False`` serves without it
        self.health = None
        if session.prop("health_monitor"):
            self.health = HealthMonitor(
                session, scheduler=self.scheduler,
                subscriptions=self.subscriptions,
                interval_s=float(session.prop("health_interval_s")),
                ring=int(session.prop("health_ring")),
                baseline_window=int(
                    session.prop("health_baseline_window")),
                min_samples=int(session.prop("health_min_samples")),
                p99_factor=float(session.prop("health_p99_factor")),
                queue_limit=int(session.prop("health_queue_limit")),
                burn_limit=float(session.prop("health_burn_limit")),
                stale_lag_s=float(session.prop("health_stale_lag_s")),
                cooldown_s=float(session.prop("health_cooldown_s")),
                on_breach=self.overload.on_breach)
            self.health.start()
        #: the registry behind system.health (connectors/system.py)
        session.health = self.health
        #: template warming (plan/adaptive.py): adaptivity
        #: re-specializes recurring templates, and the first run of a
        #: re-specialized template builds its steps. With
        #: ``warm_top_k > 0`` a background thread re-executes the top-K
        #: SELECT templates by observed traffic once each, off the
        #: serving path, so steady traffic sees warm executable-cache
        #: hits.
        self._traffic: "dict[str, int]" = {}
        self._traffic_lock = threading.Lock()
        self._warmed: "set[str]" = set()
        self.warm_top_k = max(0, int(warm_top_k))
        self.warm_interval_s = max(0.05, float(warm_interval_s))
        self._warm_stop = threading.Event()
        self._warm_thread = None
        if self.warm_top_k > 0:
            self._warm_thread = threading.Thread(
                target=self._warm_loop, name="presto-warm", daemon=True)
            self._warm_thread.start()

    # ---- template warming ------------------------------------------------
    def _note_traffic(self, sql: str) -> None:
        """Count one arrival of ``sql`` toward warming priority.
        Traffic shape, not success, drives warming — a template that
        keeps arriving keeps deserving a warm cache."""
        if self.warm_top_k <= 0:
            return
        with self._traffic_lock:
            self._traffic[sql] = self._traffic.get(sql, 0) + 1

    def _warm_candidates(self) -> "list[str]":
        """Top-K recurring SELECT templates not yet warmed. Recurrence
        >= 2 mirrors the adaptivity corridor (plan-hints fire on runs
        >= 2): warming a one-shot statement buys nothing."""
        with self._traffic_lock:
            ranked = sorted(self._traffic.items(),
                            key=lambda kv: -kv[1])
        out = []
        for sql, count in ranked:
            if len(out) >= self.warm_top_k:
                break
            if count < 2 or sql in self._warmed:
                continue
            head = sql.lstrip().lower()
            if not (head.startswith("select") or head.startswith("with")):
                continue  # never re-execute DML/DDL in the background
            out.append(sql)
        return out

    def _warm_loop(self) -> None:
        """Daemon body: each interval, re-execute newly-hot templates
        once, paying any adaptivity-induced step build here instead of
        on a serving thread. Runs against the shared session (the same
        executable cache the serving path hits) but outside the fair
        scheduler: warming never takes a tenant's slot."""
        while not self._warm_stop.wait(self.warm_interval_s):
            for sql in self._warm_candidates():
                if self._warm_stop.is_set() or not self._accepting:
                    return
                self._warmed.add(sql)
                try:
                    with _on_device(self.session.device):
                        self.session.sql(sql)
                    REGISTRY.counter("adaptive.warmed").add()
                except Exception:  # noqa: BLE001 — warming is advisory
                    pass

    # ---- lifecycle accounting -------------------------------------------
    def _enter(self, tenant: str):
        with self._drain_cv:
            if not self._accepting:
                raise UserError("server is draining: not accepting queries")
            self._inflight += 1
        return tenant

    def _leave(self):
        with self._drain_cv:
            self._inflight -= 1
            self._drain_cv.notify_all()

    # ---- synchronous execution ------------------------------------------
    def _execute_admitted(self, fn, tenant: str,
                          timeout_s: Optional[float] = None,
                          on_start=None):
        """The ONE admission wrapper AFTER in-flight accounting: fair
        slot, tenant attribution, then ``fn()`` against the shared
        session. ``on_start`` fires once the slot is held (the
        QUEUED->RUNNING transition submit/poll reports — a query
        starved at the scheduler must poll as QUEUED, not RUNNING).
        Callers own ``_enter``/``_leave`` (submit() enters at accept
        time so a drain never drops an already-accepted query)."""
        from presto_tpu_torch.runtime.session import CURRENT_TENANT

        with self.scheduler.slot(tenant, timeout_s):
            if on_start is not None:
                on_start()
            token = CURRENT_TENANT.set(tenant)
            try:
                # a server thread runs on the session's device, not on
                # whatever card is current there
                with _on_device(self.session.device):
                    return fn()
            finally:
                CURRENT_TENANT.reset(token)

    def _brownout_mode(self, tenant: str) -> Optional[str]:
        """Routing verdict for one NEW submission: None (serve
        normally), "approx" (serve through the approx sibling
        session), or "shed" (refuse with ServerOverloaded). The
        ``brownout_force`` session property is the operator override —
        it pins the latch on regardless of health."""
        forced = bool(self.session.prop("brownout_force"))
        if forced != self.overload.forced:
            self.overload.force(forced)
        return self.overload.mode_for(self.scheduler.spec(tenant))

    def _route_session(self, tenant: str):
        """The session one NEW statement from ``tenant`` runs against,
        after the brown-out verdict. Raises ServerOverloaded for
        ``brownout="shed"`` tenants while the latch is engaged."""
        mode = self._brownout_mode(tenant)
        if mode == "shed":
            REGISTRY.counter("overload.shed").add()
            REGISTRY.counter("overload.shed_reason.brownout").add()
            raise ServerOverloaded(
                f"tenant {tenant!r} shed: brown-out engaged and the "
                f"tenant's brownout policy is 'shed'",
                retry_after_s=shed_retry_after(self.scheduler.queue_depth()))
        if mode == "approx":
            REGISTRY.counter("brownout.approx_routed").add()
            return self.approx_session(), True
        return self.session, False

    def execute(self, sql: str, tenant: Optional[str] = None,
                timeout_s: Optional[float] = None,
                deadline_s: Optional[float] = None):
        """Run one statement as ``tenant`` (fair slot + attribution);
        returns the ``QueryResult``. ``deadline_s`` bounds the WHOLE request
        — queue time included — and propagates into the query's
        cancel/deadline scope."""
        from presto_tpu_torch.runtime.lifecycle import REQUEST_DEADLINE

        tenant = tenant or self.default_tenant
        sess, _ = self._route_session(tenant)
        self._note_traffic(sql)
        self._enter(tenant)
        dl_token = (None if deadline_s is None else
                    REQUEST_DEADLINE.set(time.monotonic() + deadline_s))
        try:
            return self._execute_admitted(lambda: sess.sql(sql),
                                          tenant, timeout_s)
        finally:
            if dl_token is not None:
                REQUEST_DEADLINE.reset(dl_token)
            self._leave()

    def _prepared_key(self, tenant: str, name: str) -> str:
        """Per-tenant prepared-statement namespace: handles register
        in the shared session under ``tenant::name``, so one tenant
        can never overwrite, execute, or deallocate another's
        statement through the shared-session design."""
        return f"{tenant}::{name}"

    def prepare(self, sql: str, name: Optional[str] = None,
                tenant: Optional[str] = None):
        """PREPARE (no slot needed: planning only); returns the
        client-visible handle name (scoped to ``tenant``) to pass to
        :meth:`execute_prepared` / :meth:`deallocate`."""
        tenant = tenant or self.default_tenant
        if name is None:
            name = f"stmt_{next(_submit_seq)}"
        self.session.prepare(sql, self._prepared_key(tenant, name))
        return name

    def execute_prepared(self, name: str, params=(),
                         tenant: Optional[str] = None,
                         timeout_s: Optional[float] = None):
        tenant = tenant or self.default_tenant
        key = self._prepared_key(tenant, name)
        prep = self.session._prepared.get(key)
        if prep is not None:
            self._note_traffic(getattr(prep, "sql", "") or "")
        self._enter(tenant)
        try:
            return self._execute_admitted(
                lambda: self.session.execute_prepared(key,
                                                      list(params))[0],
                tenant, timeout_s)
        finally:
            self._leave()

    def deallocate(self, name: str, tenant: Optional[str] = None) -> None:
        from presto_tpu_torch.runtime.errors import UserError as _UE

        tenant = tenant or self.default_tenant
        key = self._prepared_key(tenant, name)
        if self.session._prepared.pop(key, None) is None:
            raise _UE(f"prepared statement not found: {name}")

    # ---- submit / poll (the /v1/statement shape) ------------------------
    def _retire_records_locked(self) -> None:
        """Evict oldest TERMINAL records beyond the ring bound (under
        ``_qlock``): a long-running server must not hold every result
        frame it ever produced."""
        over = len(self._queries) - self.query_record_limit
        if over <= 0:
            return
        for qid in [q for q, r in self._queries.items()
                    if r["state"] in ("FINISHED", "FAILED")][:over]:
            del self._queries[qid]

    def submit(self, sql: str, tenant: Optional[str] = None,
               trace: Optional[dict] = None,
               deadline_s: Optional[float] = None) -> str:
        """Asynchronous submission; returns a server query id to poll.
        In-flight accounting happens HERE (not on the worker thread):
        an accepted query is part of the drain set immediately, so a
        shutdown between the accept and the worker's first instruction
        still waits for it. Submission is bounded by ``submit_limit``
        pending queries — beyond it, reject loudly instead of growing
        one blocked thread per request.

        ``trace`` is a REQUEST_TRACE context dict (a client-supplied
        ``traceparent``/``X-Presto-Trace``, parsed by the HTTP layer);
        every submission gets one — a server-generated context when the
        client sent none — so the engine-side trace token always links
        back to the submission that caused it."""
        tenant = tenant or self.default_tenant
        with self._qlock:
            pending = sum(1 for r in self._queries.values()
                          if r["state"] in ("QUEUED", "RUNNING"))
        if pending >= self.submit_limit:
            REGISTRY.counter("server.submit_rejected").add()
            raise ServerOverloaded(
                f"server busy: {pending} submitted queries pending "
                f"(submit_limit={self.submit_limit})",
                retry_after_s=shed_retry_after(pending))
        # the scheduler's shed verdict, taken SYNCHRONOUSLY at accept
        # time: an over-ceiling submission must 429 on /v1/statement
        # itself, never spend a worker thread to fail on the poll page
        # — and a shed submission leaves no submit record behind
        self.scheduler.check_shed(tenant)
        sess, approximate = self._route_session(tenant)
        self._enter(tenant)  # raises while draining; worker leaves
        if trace is None:
            trace = _trace_context()
        trace["t0"] = time.perf_counter()
        qid = f"srv_{next(_submit_seq)}"
        rec = {"id": qid, "tenant": tenant, "sql": sql, "state": "QUEUED",
               "df": None, "error": None, "error_code": None,
               "submitted_at": time.time(), "done": threading.Event(),
               "trace": trace, "cancel_requested": False,
               "approximate": approximate,
               "deadline_mono": (None if deadline_s is None
                                 else time.monotonic() + deadline_s)}
        with self._qlock:
            self._queries[qid] = rec
            self._retire_records_locked()
        REGISTRY.counter("server.submitted").add()

        def on_start():
            # QUEUED until the fair slot is actually held: scheduler
            # starvation must be observable as QUEUED, not mislabeled
            # RUNNING; the stamp also bounds the frontend:submit span
            # (submit accept -> slot held = admission wait)
            trace["started_pc"] = time.perf_counter()
            if rec["cancel_requested"]:
                # cancelled while QUEUED: observe it at the slot
                # boundary — the slot releases on the way out and no
                # engine-side state was ever created
                raise QueryCancelled(
                    f"query {qid} cancelled while queued")
            rec["state"] = "RUNNING"

        def work():
            from presto_tpu_torch.runtime.lifecycle import REQUEST_DEADLINE
            from presto_tpu_torch.runtime.session import REQUEST_TRACE

            token = REQUEST_TRACE.set(trace)
            dl_token = (None if rec["deadline_mono"] is None else
                        REQUEST_DEADLINE.set(rec["deadline_mono"]))
            try:
                rec["df"] = self._execute_admitted(
                    lambda: sess.sql(sql), tenant,
                    timeout_s=self.submit_timeout_s,
                    on_start=on_start)
                rec["state"] = "FINISHED"
            except Exception as e:  # noqa: BLE001 — reported to the client
                rec["state"] = "FAILED"
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["error_code"] = (error_code(e)
                                     if isinstance(e, PrestoError)
                                     else "INTERNAL")
                if isinstance(e, ServerOverloaded):
                    rec["retry_after_s"] = e.retry_after_s
                REGISTRY.counter("server.failed").add()
            finally:
                if dl_token is not None:
                    REQUEST_DEADLINE.reset(dl_token)
                REQUEST_TRACE.reset(token)
                rec["done"].set()
                self._leave()

        t = threading.Thread(target=work, daemon=True,
                             name=f"presto-tpu-{qid}")
        rec["thread"] = t
        try:
            t.start()
        except BaseException:
            self._leave()  # thread never ran; balance the accounting
            raise
        return qid

    def poll(self, qid: str) -> dict:
        """Current state page for a submitted query (terminal pages
        carry results or the typed error). The first terminal poll
        stitches the frontend spans (submit wait, this poll) onto the
        query's own trace recorder — the end-to-end export then reads
        submit -> admission -> gate wait -> dispatch -> poll as one
        linked trace."""
        poll_t0 = time.perf_counter()
        with self._qlock:
            rec = self._queries.get(qid)
        if rec is None:
            raise UserError(f"unknown query id: {qid}")
        page = {"id": qid, "tenant": rec["tenant"], "state": rec["state"]}
        if rec.get("approximate"):
            # brown-out honesty: a query served through the approx
            # tier is flagged on every page, not just the result
            page["approximate"] = True
        if rec["state"] == "FINISHED":
            payload = rec.get("payload")
            if payload is None:
                # serialized once, on the first poll of the terminal
                # page: repeat polls must not re-pay O(rows) encoding
                payload = rec["payload"] = _df_payload(rec["df"])
            page.update(payload)
        elif rec["state"] == "FAILED":
            page["error"] = rec["error"]
            page["errorCode"] = rec["error_code"]
            if rec.get("retry_after_s") is not None:
                page["retryAfterS"] = rec["retry_after_s"]
        if rec["state"] in ("FINISHED", "FAILED"):
            self._stitch_frontend_spans(rec, poll_t0)
        return page

    def _stitch_frontend_spans(self, rec: dict, poll_t0: float) -> None:
        """Append the frontend-side spans to the query's trace recorder
        (once, on the first terminal poll). Post-hoc by design: the
        engine-side recorder exists only after the worker ran, and the
        submit wait is only known once the slot was held. Best-effort —
        trace plumbing must never fail a poll."""
        trace_ctx = rec.get("trace")
        if not trace_ctx or trace_ctx.get("frontend_spans_done"):
            return
        engine_qid = trace_ctx.get("query_id")
        if not engine_qid:  # worker never reached the session
            return
        try:
            tracer = self.session.traces.for_query(engine_qid)
        except Exception:  # noqa: BLE001 — observability-only path
            tracer = None
        if tracer is None:  # tracing off for this query
            return
        trace_ctx["frontend_spans_done"] = True
        try:
            t0 = trace_ctx["t0"]
            started = trace_ctx.get("started_pc", t0)
            tracer.add_complete(
                "frontend:submit", "frontend", t0,
                max(0.0, started - t0),
                {"queryId": rec["id"], "tenant": rec["tenant"],
                 "traceToken": trace_ctx["token"]})
            tracer.add_complete(
                "frontend:poll", "frontend", poll_t0,
                time.perf_counter() - poll_t0,
                {"queryId": rec["id"], "state": rec["state"]})
        except Exception:  # noqa: BLE001 — observability-only path
            REGISTRY.counter("exec.trace_errors").add()

    def trace_info(self, qid: str) -> dict:
        """Outgoing trace headers for a submitted query: the honored
        (or server-assigned) ``X-Presto-Trace`` token plus a W3C
        ``traceparent`` carrying the query's trace-id under a fresh
        server span-id — what the HTTP layer echoes on the 201 and on
        every poll page."""
        with self._qlock:
            rec = self._queries.get(qid)
        trace_ctx = (rec or {}).get("trace")
        if not trace_ctx:
            return {}
        span_id = uuid.uuid4().hex[:16]
        return {"X-Presto-Trace": trace_ctx["token"],
                "traceparent": f"00-{trace_ctx['trace_id']}-{span_id}-01"}

    def cancel(self, qid: str, reason: str = "cancelled by client") -> dict:
        """Cooperatively cancel a submitted query (the ``DELETE
        /v1/statement/<id>`` verb). RUNNING queries get their engine
        CancelScope flipped — the next checkpoint raises the typed
        ``QueryCancelled`` and releases every pool/host-spill
        reservation; QUEUED queries are marked and observed at the
        slot boundary (a waiter blocked in the fair queue drains at
        its next wake). Terminal queries are left untouched."""
        with self._qlock:
            rec = self._queries.get(qid)
        if rec is None:
            raise UserError(f"unknown query id: {qid}")
        if rec["state"] in ("FINISHED", "FAILED"):
            return {"id": qid, "state": rec["state"], "cancelled": False}
        REGISTRY.counter("server.cancel_requests").add()
        rec["cancel_requested"] = True
        flipped = False
        engine_qid = (rec.get("trace") or {}).get("query_id")
        if engine_qid:
            flipped = self.session.cancel(engine_qid, reason)
            if not flipped and self._approx_session is not None:
                flipped = self._approx_session.cancel(engine_qid, reason)
        # wake fair-queue waiters so a QUEUED cancel is observed at
        # the next scheduling pass instead of the admission timeout
        self.scheduler.kick()
        return {"id": qid, "state": rec["state"], "cancelled": True,
                "observed_running": flipped}

    def result(self, qid: str, timeout_s: Optional[float] = None):
        """Block until a submitted query finishes; returns its
        ``QueryResult`` (raises UserError with the captured failure on
        FAILED)."""
        with self._qlock:
            rec = self._queries.get(qid)
        if rec is None:
            raise UserError(f"unknown query id: {qid}")
        if not rec["done"].wait(timeout_s):
            raise UserError(f"query {qid} still running")
        if rec["state"] == "FAILED":
            raise UserError(f"query {qid} failed: {rec['error']}")
        return rec["df"]

    # ---- continuous queries (presto_tpu_torch/stream/) ------------------
    def approx_session(self):
        """The APPROXIMATE sibling session (built lazily): same
        connectors and memory pool as the main session, but with
        ``approx_join`` on (Bloom-sketch semi joins) plus any
        ``approx_properties`` overrides. Its plan fingerprints fold
        the approx knobs, so exact and approximate executions never
        share cached results — and its own catalog hooks the shared
        memory connector's DDL listeners, so appends invalidate both
        sessions' caches scoped per table."""
        with self._approx_lock:
            if self._approx_session is None:
                from presto_tpu_torch.runtime.session import Session

                conns = {n: c for n, c in
                         self.session.catalog.connectors.items()
                         if n != "system"}
                props = {"batched_dispatch": True, "approx_join": True}
                props.update(self._approx_properties)
                self._approx_session = Session(
                    conns, memory_pool=self.session.pool(),
                    properties=props, device=self.session.device)
            return self._approx_session

    def subscribe(self, sql: str, tenant: Optional[str] = None,
                  mode: str = "exact",
                  interval_s: Optional[float] = None, keep: int = 8):
        """Register a continuous query: ``sql`` is prepared into a
        plan template and re-executed (through the fair scheduler and
        the batch gate) whenever a referenced table's version epoch
        advances, or every ``interval_s`` seconds. Returns the
        :class:`~presto_tpu_torch.stream.subscriptions.ContinuousQuery`
        handle; ``mode="approx"`` serves the dashboard tier through
        the approx sibling session, flagged ``approximate``."""
        with self._drain_cv:
            if not self._accepting:
                raise UserError("server is draining: not accepting "
                                "subscriptions")
        return self.subscriptions.subscribe(
            sql, tenant or self.default_tenant, mode=mode,
            interval_s=interval_s, keep=keep)

    def unsubscribe(self, sub_id: str) -> None:
        self.subscriptions.unsubscribe(sub_id)

    def subscription_page(self, sub_id: str) -> dict:
        return self.subscriptions.get(sub_id).page()

    # ---- observability / shutdown ---------------------------------------
    def metrics_text(self) -> str:
        return self.session.export_metrics()

    def tenants_snapshot(self) -> "list[dict]":
        return self.scheduler.snapshot()

    def shutdown(self, drain_timeout_s: float = 30.0,
                 flight_path: Optional[str] = None) -> dict:
        """Graceful drain: stop accepting, wait for in-flight queries,
        then report pool state (reservations release on every terminal
        state, so a clean drain leaves the pool empty) and optionally
        flush the flight-recorder ring to ``flight_path``. Continuous
        queries cancel FIRST — their in-flight refreshes hold ordinary
        in-flight accounting, so the drain wait below covers them. The
        health watchdog stops before anything it samples is torn
        down."""
        deadline = time.monotonic() + drain_timeout_s
        self._warm_stop.set()
        if self._warm_thread is not None:
            self._warm_thread.join(timeout=drain_timeout_s)
        if self.health is not None:
            self.health.close()
        self.subscriptions.close()
        with self._drain_cv:
            self._accepting = False
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drain_cv.wait(remaining)
            drained_clients = self._inflight == 0
        pool = self.session.pool()
        if flight_path is not None:
            try:
                self.session.export_flight_record(flight_path)
            except Exception:  # noqa: BLE001 — a drain must not fail
                REGISTRY.counter("flight.capture_errors").add()
        # detach the scheduler's pool listener: the process-global pool
        # must not keep a retired server's scheduler alive
        self.scheduler.close()
        REGISTRY.counter("server.shutdowns").add()
        return {
            "drained": drained_clients,
            "inflight": self._inflight,
            "pool_reserved_bytes": pool.snapshot()["reserved_bytes"],
            "flight_records": len(self.session.flight),
        }


#: the no-sockets client surface tests use; it IS the server core: one
#: name per role, one implementation
ServerClient = QueryServer


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------


class HttpFrontend:
    """stdlib HTTP/JSON transport over a :class:`QueryServer`.

    Routes::

        POST /v1/statement           body = SQL text; 200 -> {id, state,
                                     nextUri}; tenant via X-Presto-Tenant;
                                     a client ``traceparent`` (W3C) or
                                     ``X-Presto-Trace`` token is honored
                                     end to end and echoed back on the
                                     response headers; an
                                     ``X-Presto-Deadline`` header (epoch
                                     seconds, or relative seconds)
                                     propagates into the query's cancel/
                                     deadline scope; a shed submission
                                     gets 429 + ``Retry-After``
        DELETE /v1/statement/<id>    cooperative cancel; 200 -> {id,
                                     state, cancelled}
        GET  /v1/statement/<id>      poll page (FINISHED pages carry
                                     {columns, data}); echoes the trace
                                     headers of the submission
        POST /v1/prepared            JSON {action: prepare|execute|
                                     deallocate, name, sql?, params?}
        POST /v1/subscribe           JSON {sql, mode?, intervalS?};
                                     201 -> {id, tables, mode,
                                     nextUri} (continuous query)
        GET  /v1/subscription/<id>   latest delivered page (epochs,
                                     seq, approximate, columns, data)
        POST /v1/subscription/<id>/cancel
        GET  /metrics                OpenMetrics text exposition
        GET  /v1/tenants             scheduler snapshot JSON

    ``port=0`` binds an ephemeral port (tests); ``.port`` reports it.
    """

    def __init__(self, server: QueryServer, host: str = "127.0.0.1",
                 port: int = 8080):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        qserver = server

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, payload, ctype="application/json",
                      headers=None):
                body = (payload if isinstance(payload, bytes)
                        else json.dumps(payload, default=str).encode())
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _tenant(self) -> str:
                return (self.headers.get("X-Presto-Tenant")
                        or self.headers.get("X-Presto-User")
                        or qserver.default_tenant)

            def _trace_ctx(self):
                """REQUEST_TRACE context from the client's trace
                headers, or None when it sent none. A client that
                supplied either header opted into tracing — the query
                runs with a recorder even when the session-wide
                ``trace_enabled`` property is off."""
                token = self.headers.get("X-Presto-Trace")
                tp_id = _parse_traceparent(self.headers.get("traceparent"))
                if token is None and tp_id is None:
                    return None
                return _trace_context(token=token, traceparent_id=tp_id,
                                      force=True)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n)

            def _deadline_s(self):
                """``X-Presto-Deadline`` -> relative seconds remaining,
                or None. Values past 1e9 are absolute unix-epoch
                deadlines (the cross-service propagation shape); small
                values are relative budgets. Malformed or already-
                expired deadlines are the CLIENT's fault: UserError ->
                400, never a silent drop of a semantic header."""
                hdr = self.headers.get("X-Presto-Deadline")
                if hdr is None:
                    return None
                try:
                    v = float(hdr)
                except ValueError:
                    raise UserError(
                        f"X-Presto-Deadline: cannot parse {hdr!r} as "
                        "seconds") from None
                remaining = v - time.time() if v > 1e9 else v
                if remaining <= 0:
                    raise UserError(
                        f"X-Presto-Deadline already expired "
                        f"({remaining:.3f}s remaining)")
                return remaining

            def _overloaded(self, e: "ServerOverloaded"):
                """429 + Retry-After (integer seconds, ceil'd so a
                sub-second hint never rounds to 'retry now')."""
                after = max(1, int(e.retry_after_s + 0.999))
                self._send(429, {"error": str(e),
                                 "errorCode": e.error_code,
                                 "retryAfterS": e.retry_after_s},
                           headers={"Retry-After": str(after)})

            def do_GET(self):
                try:
                    if self.path == "/metrics":
                        self._send(200, qserver.metrics_text().encode(),
                                   ctype=("application/openmetrics-text; "
                                          "version=1.0.0"))
                        return
                    if self.path == "/v1/tenants":
                        self._send(200, qserver.tenants_snapshot())
                        return
                    if self.path.startswith("/v1/statement/"):
                        qid = self.path.rsplit("/", 1)[1]
                        page = qserver.poll(qid)
                        self._send(200, page,
                                   headers=qserver.trace_info(qid))
                        return
                    if self.path.startswith("/v1/subscription/"):
                        sid = self.path.rsplit("/", 1)[1]
                        self._send(200, qserver.subscription_page(sid))
                        return
                    self._send(404, {"error": f"no route {self.path}"})
                except ServerOverloaded as e:
                    self._overloaded(e)
                except UserError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — HTTP boundary
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def do_DELETE(self):
                try:
                    if self.path.startswith("/v1/statement/"):
                        qid = self.path.rsplit("/", 1)[1]
                        self._send(200, qserver.cancel(qid))
                        return
                    self._send(404, {"error": f"no route {self.path}"})
                except UserError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — HTTP boundary
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                try:
                    if self.path == "/v1/statement":
                        sql = self._body().decode("utf-8")
                        qid = qserver.submit(sql, self._tenant(),
                                             trace=self._trace_ctx(),
                                             deadline_s=self._deadline_s())
                        self._send(201, {
                            "id": qid, "state": "QUEUED",
                            "nextUri": f"/v1/statement/{qid}",
                        }, headers=qserver.trace_info(qid))
                        return
                    if self.path == "/v1/prepared":
                        try:
                            req = json.loads(self._body().decode("utf-8"))
                            action = req.get("action")
                            if action in ("prepare", "execute",
                                          "deallocate"):
                                req["name"]  # required for all actions
                            if action == "prepare":
                                req["sql"]
                        except (ValueError, KeyError) as e:
                            # malformed CLIENT input is a 400, not a
                            # 500 (json.JSONDecodeError is ValueError)
                            self._send(400, {"error": "bad request: "
                                             f"{type(e).__name__}: {e}"})
                            return
                        if action == "prepare":
                            name = qserver.prepare(req["sql"],
                                                   req.get("name"),
                                                   self._tenant())
                            self._send(201, {"prepared": name})
                            return
                        if action == "execute":
                            df = qserver.execute_prepared(
                                req["name"], req.get("params", ()),
                                self._tenant())
                            self._send(200, _df_payload(df))
                            return
                        if action == "deallocate":
                            qserver.deallocate(req["name"],
                                               self._tenant())
                            self._send(200, {"deallocated": req["name"]})
                            return
                        self._send(400, {"error": "action must be "
                                         "prepare|execute|deallocate"})
                        return
                    if self.path == "/v1/subscribe":
                        try:
                            req = json.loads(self._body().decode("utf-8"))
                            sql = req["sql"]
                        except (ValueError, KeyError) as e:
                            self._send(400, {"error": "bad request: "
                                             f"{type(e).__name__}: {e}"})
                            return
                        sub = qserver.subscribe(
                            sql, self._tenant(),
                            mode=req.get("mode", "exact"),
                            interval_s=req.get("intervalS"))
                        self._send(201, {
                            "id": sub.id, "mode": sub.mode,
                            "tables": list(sub.tables),
                            "nextUri": f"/v1/subscription/{sub.id}",
                        })
                        return
                    if (self.path.startswith("/v1/subscription/")
                            and self.path.endswith("/cancel")):
                        sid = self.path.split("/")[3]
                        qserver.unsubscribe(sid)
                        self._send(200, {"cancelled": sid})
                        return
                    self._send(404, {"error": f"no route {self.path}"})
                except ServerOverloaded as e:
                    self._overloaded(e)
                except UserError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — HTTP boundary
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self.server = server
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        REGISTRY.counter("server.started").add()
        self.httpd.serve_forever()

    def start_background(self) -> "HttpFrontend":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="presto-tpu-http")
        self._thread.start()
        return self

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
