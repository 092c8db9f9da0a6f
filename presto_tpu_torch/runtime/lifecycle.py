"""Query lifecycle: admission, deadlines, cancellation, fragment retries
and the OOM ladder.

Counterpart of ``presto_tpu/runtime/lifecycle.py``:

- **Deadline** (``query_max_run_time``): there is no watchdog that can
  stop a launched kernel, so the deadline is checked at the host-side
  boundaries: every fragment dispatch (:func:`run_fragment`), every
  driver-loop push and finish (``exec/pipeline.py``), every scan split
  and every spill transfer slot. Each check is also the query's cancel
  checkpoint (``runtime/overload.CancelScope``).
- **Admission** (``query_max_memory_bytes``): the plan's peak estimated
  node materialization (:func:`peak_estimate_bytes`) is compared with the
  limit before launch, then reserved from the session's memory pool
  (FIFO queue, ``admission_queue_timeout_s``) and released on every
  terminal state.
- **Fragment retry** (``retry_count`` / ``retry_backoff_s``): a dispatch
  failing with a retryable error re-runs its subtree after exponential
  backoff (never sleeping past the deadline). A backend out-of-memory
  (``errors.is_backend_oom``: the CUDA caching allocator's
  ``torch.OutOfMemoryError``) maps to ``DeviceOutOfMemory`` here.
- **OOM ladder** (``oom_ladder_max``): a ``DeviceOutOfMemory`` re-plans
  the query one rung down (``exec/ladder.OomLadderMixin``: hybrid with a
  shrunk resident set, more buckets, smaller probe chunks) and re-runs it
  on the same device. Before a re-run the failed attempt's exception and
  frames are dropped and the CUDA caching allocator's free blocks are
  returned (``torch.cuda.empty_cache``): the traceback of a real OOM
  holds the failed run's tensors, and the next rung must not OOM again
  on memory nobody uses. Only a ``DeviceOutOfMemory`` walks the ladder.

The active :class:`QueryContext` travels in a ``ContextVar``: the driver
loop and the executor see it without a parameter through every operator.
A thread does not inherit it, so the checks run on the query's own
thread (the prefetch worker of ``exec/pipeline.prefetch_iter`` only
loads).

Every run ends at one choke point (``QueryManager.run_plan``'s finally):
its metric delta is attributed, the SLO tracker attached as
``session.slo`` observes its latency, and the flight recorder captures a
post-mortem when it failed, degraded, retried or overran
(``runtime/flight.py``). Concurrent identical queries coalesce onto one
execution (:class:`InflightCoalescer`).

The serving tier's pieces live here too: the template batch gate
(``QueryManager.batch_gate``, ``server/batcher.TemplateBatchGate``), a
batch leader's admission scale (:meth:`QueryManager.admit` reserves the
plan's peak once per fused lane, clamped so that batching never fails a
query the serial path admits) and the request deadline a server sets
(:data:`REQUEST_DEADLINE`, the tighter of it and ``query_max_run_time``
wins). Not ported yet: the distributed -> local degradation (it comes
with the distributed joins, ROADMAP A10c).
"""

from __future__ import annotations

import gc
import threading
import time
import traceback
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from presto_tpu_torch.runtime.devices import timed_dispatch
from presto_tpu_torch.runtime.errors import (
    DeviceOutOfMemory,
    ExceededTimeLimit,
    ResourceExhausted,
    is_backend_oom,
    is_retryable,
)
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.overload import CancelScope, RetryBudget
from presto_tpu_torch.runtime.trace import current as trace_current
from presto_tpu_torch.runtime.trace import span as trace_span

#: cap on one exponential-backoff sleep
MAX_BACKOFF_S = 5.0

_CURRENT: ContextVar[Optional["QueryContext"]] = ContextVar(
    "presto_tpu_torch_query_context", default=None)

#: a request's absolute ``time.monotonic()`` deadline, set by the serving
#: front-end around a request (``X-Presto-Deadline``, ``deadline_s``)
REQUEST_DEADLINE: ContextVar[Optional[float]] = ContextVar(
    "presto_tpu_torch_request_deadline", default=None)


@dataclass(frozen=True)
class RetryPolicy:
    count: int = 0
    backoff_s: float = 0.01


class QueryContext:
    """Per-query lifecycle state visible at every execution boundary."""

    def __init__(self, deadline_s: float | None = None, retry: RetryPolicy = RetryPolicy(),
                 on_retry: Callable[[str, BaseException], None] | None = None,
                 cancel_scope: "CancelScope | None" = None,
                 retry_budget: "RetryBudget | None" = None):
        self.deadline = None if deadline_s is None else time.monotonic() + deadline_s
        self.deadline_s = deadline_s
        self.retry = retry
        self.on_retry = on_retry
        self.fragment_retries = 0
        #: every deadline checkpoint doubles as a cancel checkpoint
        self.cancel_scope = cancel_scope
        #: the session's retry token bucket (None in bare contexts)
        self.retry_budget = retry_budget

    def check_deadline(self, where: str = "driver") -> None:
        if self.cancel_scope is not None:
            self.cancel_scope.check(where)
        if self.deadline is not None and time.monotonic() > self.deadline:
            REGISTRY.counter("query.deadline_exceeded").add()
            raise ExceededTimeLimit(
                f"query exceeded query_max_run_time={self.deadline_s}s (checked at {where})")

    def record_retry(self, site: str, exc: BaseException) -> None:
        self.fragment_retries += 1
        REGISTRY.counter("fragment.retried").add()
        if self.on_retry is not None:
            self.on_retry(site, exc)


def current_context() -> QueryContext | None:
    return _CURRENT.get()


def check_deadline(where: str = "driver") -> None:
    """Boundary hook: enforce the active query's deadline and cancel
    scope, if any."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.check_deadline(where)


def _map_backend_oom(e: BaseException, where: str):
    """The typed ``DeviceOutOfMemory`` for a backend out-of-memory raised
    at a dispatch boundary, or None when ``e`` is not one."""
    if not is_backend_oom(e):
        return None
    REGISTRY.counter("query.backend_oom").add()
    return DeviceOutOfMemory(f"backend out of memory at {where}: {type(e).__name__}: {e}")


def run_fragment(label: str, fn: Callable[[], object]):
    """Execute one fragment dispatch under the active lifecycle: the
    deadline is checked at entry and between attempts, and retryable
    failures re-run with exponential backoff up to ``retry.count`` times.
    An exception that exhausted its retries here is tagged
    (``_presto_retries_exhausted``), so an ancestor dispatch re-raises it
    instead of multiplying the retries by the plan depth. A backend OOM
    maps to ``DeviceOutOfMemory``: not retried here, recoverable by the
    query's OOM ladder."""
    ctx = _CURRENT.get()
    if ctx is None:
        with trace_span(label, "fragment"):
            try:
                return timed_dispatch(fn)
            except Exception as e:
                oom = _map_backend_oom(e, label)
                if oom is not None:
                    raise oom from e
                raise
    ctx.check_deadline(label)
    attempts = max(0, ctx.retry.count)
    dispatch_h = REGISTRY.histogram("fragment.dispatch_s")
    budget = ctx.retry_budget
    for attempt in range(attempts + 1):
        try:
            with trace_span(label, "fragment", {"attempt": attempt} if attempt else None), \
                    dispatch_h.time():
                result = timed_dispatch(fn)
            if attempt > 0 and budget is not None:
                budget.record_success()
            return result
        except Exception as e:
            if attempt > 0 and budget is not None:
                budget.record_failure()
            oom = _map_backend_oom(e, label)
            if oom is not None:
                raise oom from e
            exhausted = getattr(e, "_presto_retries_exhausted", False)
            if not is_retryable(e) or exhausted or attempt == attempts:
                if is_retryable(e):
                    e._presto_retries_exhausted = True
                raise
            if budget is not None and not budget.try_spend(label):
                # the breaker is open: fail fast with the original error
                e._presto_retries_exhausted = True
                raise
            ctx.record_retry(label, e)
            sleep_s = min(ctx.retry.backoff_s * (2 ** attempt), MAX_BACKOFF_S)
            if ctx.deadline is not None:
                # never sleep past the deadline
                sleep_s = min(sleep_s, max(0.0, ctx.deadline - time.monotonic()))
            with trace_span(f"backoff:{label}", "retry",
                            {"attempt": attempt, "error": type(e).__name__}):
                time.sleep(sleep_s)
            ctx.check_deadline(label)
    raise AssertionError("unreachable")  # pragma: no cover


def peak_estimate_bytes(plan, catalog) -> tuple[int, str]:
    """Max stats-estimated materialized bytes over all plan nodes (the
    admission operand) and the offending node's type name."""
    from presto_tpu_torch.runtime.memory import estimate_node_bytes

    worst, worst_node = 0, "?"

    def walk(node):
        nonlocal worst, worst_node
        try:
            est = estimate_node_bytes(node, catalog)
        except Exception:  # noqa: BLE001 -- stats gaps never block a query
            est = 0
        if est > worst:
            worst, worst_node = est, type(node).__name__
        for c in node.children:
            walk(c)

    walk(plan)
    return worst, worst_node


def _drop_failed_run(exc: BaseException) -> None:
    """Clear the frames of ``exc`` and of the exceptions it chains: the
    traceback of a real device OOM references the failed attempt's
    tensors (locals of its frames, suspended stream generators)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
            exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _reclaim_device(executor) -> None:
    """Collect the failed attempt's cycles and hand the caching
    allocator's free blocks back before the next rung runs."""
    gc.collect()
    dev = getattr(executor, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.empty_cache()


class _InflightEntry:
    """One in-flight execution other submissions can coalesce onto."""

    __slots__ = ("event", "result", "ok", "waiters")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.ok = False
        self.waiters = 0


class InflightCoalescer:
    """Concurrent identical queries (one binding fingerprint) coalesce
    onto one execution: followers wait for the leader's result instead
    of racing duplicate device work. Concurrent same-template queries
    with different literals serialize behind one template slot.

    The Session gates entry as result-cache admission is gated
    (deterministic plans, no fault injector, no stats recorder), so a
    follower's answer is what its own run would have given. A leader
    publishes in a ``finally``: a failed leader wakes its followers with
    nothing, and each runs itself. Every follower gets its own copy."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict[str, _InflightEntry] = {}
        #: template fingerprint -> [lock, refcount]
        self._tlocks: dict[str, list] = {}

    def lead_or_wait(self, key: str, timeout_s: float | None = None):
        """``(True, entry)`` for the leader (which must ``publish`` the
        entry in a finally), or ``(False, result_or_None)`` for a
        follower: the leader's result, or None when the leader failed or
        the wait timed out (the caller then runs itself)."""
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                entry = _InflightEntry()
                self._inflight[key] = entry
                return True, entry
            entry.waiters += 1
        try:
            served = entry.event.wait(timeout_s)
        finally:
            with self._lock:
                entry.waiters -= 1
        if served and entry.ok:
            return False, entry.result.copy()
        return False, None

    def publish(self, key: str, entry: _InflightEntry, result) -> None:
        """Finish an in-flight execution: keep a copy of the result (None
        on failure) and wake every waiter. The key is retired first, so a
        late arrival leads a fresh execution; with no waiter registered by
        then, nobody reads the result and it is not copied."""
        with self._lock:
            self._inflight.pop(key, None)
            waiting = entry.waiters
        if result is not None and waiting:
            entry.result = result.copy()
            entry.ok = True
        entry.event.set()

    def waiters(self, key: str) -> int:
        """Current follower count of an in-flight key."""
        with self._lock:
            entry = self._inflight.get(key)
            return 0 if entry is None else entry.waiters

    @contextmanager
    def template_slot(self, template_key: str):
        """Serialize the executions of one plan template; slots are
        refcounted, so the map holds only in-flight templates."""
        with self._lock:
            slot = self._tlocks.get(template_key)
            if slot is None:
                slot = self._tlocks[template_key] = [threading.Lock(), 0]
            slot[1] += 1
        if not slot[0].acquire(blocking=False):
            REGISTRY.counter("prepare.template_queued").add()
            slot[0].acquire()
        try:
            yield
        finally:
            slot[0].release()
            with self._lock:
                slot[1] -= 1
                if slot[1] == 0:
                    self._tlocks.pop(template_key, None)


class QueryManager:
    """One session's query lifecycle mechanics: admission, the deadline
    and cancel scope, fragment retries, the OOM ladder and the in-flight
    coalescer. The Session keeps the client surface and the QUEUED /
    RUNNING / FINISHED state machine."""

    def __init__(self, session):
        self.session = session
        #: concurrent identical queries coalesce here
        self.coalescer = InflightCoalescer()
        #: concurrent same-template different-literal queries meet here
        #: and fuse into one batched dispatch under ``batched_dispatch``
        from presto_tpu_torch.server.batcher import TemplateBatchGate

        self.batch_gate = TemplateBatchGate()
        self._inflight_lock = threading.Lock()
        #: live executions, query_id -> {info, executor, plan, tracer,
        #: cancel}: the health watchdog's view of what runs now
        self._inflight_queries: dict = {}
        #: query_id -> CancelScope for the whole tracked execution
        self._scopes: dict = {}
        #: the session's retry token bucket, built at first use
        self._retry_budget: RetryBudget | None = None

    def retry_budget(self) -> RetryBudget:
        """The session's shared :class:`RetryBudget`: fragment retries and
        OOM-ladder rungs draw from one bucket."""
        with self._inflight_lock:
            if self._retry_budget is None:
                self._retry_budget = RetryBudget(
                    capacity=self.session.prop("retry_budget_tokens"),
                    refill_per_s=self.session.prop("retry_budget_refill_per_s"),
                    probe_cooldown_s=self.session.prop("retry_breaker_cooldown_s"))
            return self._retry_budget

    def open_scope(self, query_id: str) -> CancelScope:
        """Register the query's CancelScope for the whole tracked
        execution (paired with :meth:`close_scope` in a finally)."""
        scope = CancelScope(query_id)
        with self._inflight_lock:
            self._scopes[query_id] = scope
        return scope

    def close_scope(self, query_id: str) -> None:
        with self._inflight_lock:
            self._scopes.pop(query_id, None)

    def scope_of(self, query_id: str) -> "CancelScope | None":
        with self._inflight_lock:
            return self._scopes.get(query_id)

    def cancel(self, query_id: str, reason: str = "cancelled") -> bool:
        """Flip a live query's :class:`CancelScope`; its next checkpoint
        raises ``QueryCancelled``. False when the query is not in flight
        or was already cancelled."""
        with self._inflight_lock:
            scope = self._scopes.get(query_id)
            if scope is None:
                entry = self._inflight_queries.get(query_id)
                scope = None if entry is None else entry.get("cancel")
        if scope is None:
            return False
        return scope.cancel(reason)

    # -- admission ------------------------------------------------------
    def admission_limit(self) -> int:
        limit = self.session.prop("query_max_memory_bytes")
        if limit is not None:
            return int(limit)
        from presto_tpu_torch.runtime.memory import DEFAULT_POOL_HEADROOM, executor_budget_bytes

        return executor_budget_bytes(self.session.device) * DEFAULT_POOL_HEADROOM

    def admit(self, plan, info, pool, scale: int = 1) -> int:
        """Reject (``ResourceExhausted``) before launch when the plan's
        peak estimate exceeds the per-query limit; else reserve that peak
        from the pool, queuing FIFO (``admission_queue_timeout_s``, capped
        by the deadline) while other queries hold it. A batch leader runs
        ``scale`` fused lanes and reserves the peak once per lane, the
        scale clamped so that it never fails a query the serial path
        would admit; returns the granted scale."""
        limit = self.admission_limit()
        peak, node = peak_estimate_bytes(plan, self.session.catalog)
        scale = max(1, int(scale))
        if scale > 1 and peak > 0:
            scale = min(scale, max(1, limit // peak), max(1, pool.capacity_bytes // peak))
        if peak > limit:
            REGISTRY.counter("query.admission_rejected").add()
            raise ResourceExhausted(
                f"admission control: {node} is estimated to materialize {peak} bytes, "
                f"over the limit of {limit} bytes ({pool.describe()}; set the "
                "query_max_memory_bytes session property to raise it)")
        timeout_s = self.session.prop("admission_queue_timeout_s")
        deadline_s = self.session.prop("query_max_run_time")
        if deadline_s is not None:
            # the run-time deadline starts after admission: cap the wait
            timeout_s = deadline_s if timeout_s is None else min(timeout_s, deadline_s)
        t0 = time.monotonic()
        try:
            queued_s = pool.reserve(info.query_id, peak * scale, timeout_s=timeout_s,
                                    detail=f"peak estimate {peak} bytes at {node}"
                                    + (f" x{scale} batch lanes" if scale > 1 else ""),
                                    tenant=info.tenant or None)
        except ResourceExhausted:
            info.memory_queued_s = time.monotonic() - t0
            raise
        info.memory_reserved_bytes = peak * scale
        info.memory_queued_s = queued_s
        return scale

    # -- execution scope ------------------------------------------------
    def _context(self, info, scope: "CancelScope | None" = None) -> QueryContext:
        events = self.session.events
        deadline_s = self.session.prop("query_max_run_time")
        request_deadline = REQUEST_DEADLINE.get()
        if request_deadline is not None:
            # the serving layer's request deadline: the tighter one wins
            remaining = max(0.0, request_deadline - time.monotonic())
            deadline_s = remaining if deadline_s is None else min(deadline_s, remaining)
        ctx = QueryContext(
            deadline_s=deadline_s,
            retry=RetryPolicy(count=self.session.prop("retry_count"),
                              backoff_s=self.session.prop("retry_backoff_s")),
            cancel_scope=scope, retry_budget=self.retry_budget())

        def on_retry(site: str, exc: BaseException):
            info.fragment_retries = ctx.fragment_retries
            info.retry_events.append({"site": site, "error": type(exc).__name__})
            events.fragment_retried(info)

        ctx.on_retry = on_retry
        return ctx

    def run_plan(self, executor, plan, info, recorder):
        """Run a plan under the full lifecycle: admission against the
        session's memory pool, the deadline and cancel scope, fragment
        retries (at the executor's dispatch boundaries) and the OOM
        ladder. The pool reservation is released on every terminal
        state. A ``QueryMetricsDelta`` rides the context for the whole
        admission and execution, so every registry move of the run is
        also this query's (``info.metrics``, ``join_strategy``,
        ``filter_selectivity``, ``oom_rung``)."""
        from presto_tpu_torch.runtime.metrics import QueryMetricsDelta, install_delta, uninstall_delta

        pool = self.session.pool()
        delta = QueryMetricsDelta()
        delta_token = install_delta(delta)
        scope = self.scope_of(info.query_id) or CancelScope(info.query_id)
        with self._inflight_lock:
            self._inflight_queries[info.query_id] = {
                "info": info, "executor": executor, "plan": plan,
                "tracer": trace_current(), "cancel": scope}
        err = None
        try:
            return self._run_admitted(executor, plan, info, recorder, pool, scope)
        except BaseException as e:
            err = e
            raise
        finally:
            with self._inflight_lock:
                self._inflight_queries.pop(info.query_id, None)
            uninstall_delta(delta_token)
            info.attribute_metrics(delta.snapshot())
            self._stamp_device_peak(info)
            self._observe_slo(info, err)
            self._maybe_flight_record(executor, plan, info, err)

    def inflight_snapshot(self) -> "list[dict]":
        """Shallow copies of the live execution entries."""
        with self._inflight_lock:
            return [dict(e) for e in self._inflight_queries.values()]

    def _stamp_device_peak(self, info) -> None:
        """Record the allocator's watermark on the finished query
        (``device_telemetry``; 0 without a card)."""
        if not self.session.prop("device_telemetry"):
            return
        try:
            from presto_tpu_torch.runtime.devices import peak_bytes

            info.device_peak_bytes = peak_bytes()
        except Exception:  # noqa: BLE001 -- telemetry never fails a query
            pass

    def _observe_slo(self, info, err) -> None:
        """Feed the tenant SLO tracker attached as ``session.slo`` (a
        plain session has none). A failure counts as a latency breach."""
        slo = getattr(self.session, "slo", None)
        if slo is None:
            return
        try:
            latency = float("inf") if err is not None else info.execution_s
            slo.observe_latency(info.tenant or "default", latency)
        except Exception:  # noqa: BLE001 -- observability never fails a query
            pass

    def _maybe_flight_record(self, executor, plan, info, err) -> None:
        """Capture a post-mortem when the run failed, degraded (an OOM
        rung), retried a fragment or overran its deadline; a success only
        under ``flight_record_successes``. Best-effort."""
        try:
            triggers = []
            if err is not None:
                triggers.append("failed")
                if isinstance(err, ExceededTimeLimit):
                    triggers.append("deadline")
            if info.oom_retries > 0 or info.degraded:
                triggers.append("degraded")
            if info.fragment_retries > 0:
                triggers.append("retried")
            if not triggers:
                if not self.session.prop("flight_record_successes"):
                    return
                triggers.append("requested")
            self.session.flight.capture(info, plan, self.session, executor=executor, err=err,
                                        triggers=triggers)
        except Exception:  # noqa: BLE001 -- see docstring
            REGISTRY.counter("flight.capture_errors").add()

    def _run_admitted(self, executor, plan, info, recorder, pool, scope=None):
        try:
            with trace_span("admission", "lifecycle"):
                asked = getattr(executor, "admission_scale", 1)
                granted = self.admit(plan, info, pool, scale=asked)
                if granted != asked:
                    # a clamped batch leader dispatches only the lanes
                    # its reservation covers; the rest re-queue at the
                    # gate (server/batcher.BatchRunner.run)
                    executor.admission_scale_granted = granted
        finally:
            # admission (pool queue wait included) is QUEUED time: the
            # RUNNING transition is re-stamped on success and failure
            info.started_at = time.time()
            info.started_mono = time.monotonic()
        try:
            ctx = self._context(info, scope)
            token = _CURRENT.set(ctx)
            try:
                with REGISTRY.histogram("query.execution_s").time():
                    return self._run_with_oom_ladder(executor, plan, info, recorder, ctx)
            finally:
                info.fragment_retries = ctx.fragment_retries
                _CURRENT.reset(token)
        finally:
            pool.release(info.query_id)

    def _run_with_oom_ladder(self, executor, plan, info, recorder, ctx):
        """The OOM recovery loop: a ``DeviceOutOfMemory`` steps the
        executor one rung down its ladder and re-runs the plan on the
        same device, up to ``oom_ladder_max`` rungs (and while the retry
        budget grants them). Each rung shrinks per-step residency, so a
        wrong estimate costs time, never the answer. Any other failure
        propagates (the distributed -> local degradation comes with the
        distributed joins, ROADMAP A10c)."""
        ladder_max = self.session.prop("oom_ladder_max")
        budget = ctx.retry_budget
        rung = 0
        while True:
            try:
                if rung > 0:
                    # inside the try: an injected OOM at this checkpoint
                    # consumes a rung like any step OOM
                    ctx.check_deadline("oom_ladder")
                result = executor.run(plan)
                if rung > 0 and budget is not None:
                    budget.record_success()
                info.approximate = bool(getattr(executor, "used_approx", False))
                self._note_planned_spills(executor, info)
                return result
            except DeviceOutOfMemory as e:
                if rung > 0 and budget is not None:
                    budget.record_failure()
                degrade = getattr(executor, "degrade_for_oom", None)
                if rung >= ladder_max or degrade is None or not degrade():
                    raise
                if budget is not None and not budget.try_spend("oom_ladder"):
                    raise
                rung += 1
                info.oom_retries += 1
                info.rung_history.append({"kind": "ladder", "rung": info.oom_retries,
                                          "error": str(e)[:200]})
                with trace_span("oom_degrade", "lifecycle", {"rung": rung, "error": str(e)[:120]}):
                    REGISTRY.counter("query.oom_degraded").add()
                    self.session.events.query_degraded(info)
                    if recorder is not None:
                        # the OOMed attempt's stats must not leak into
                        # the re-run's
                        recorder.nodes.clear()
                _drop_failed_run(e)
            # the failed attempt is unreachable now (``e`` is unbound)
            _reclaim_device(executor)

    @staticmethod
    def _note_planned_spills(executor, info) -> None:
        """Append the run's planned out-of-core decisions to the rung
        history as ``kind: "planned_hybrid"`` / ``"planned_grouped"``,
        apart from the ladder's ``kind: "ladder"`` entries."""
        for ev in getattr(executor, "spill_events", ()) or ():
            if ev.get("mode") in ("hybrid", "grouped"):
                info.rung_history.append({"kind": f"planned_{ev['mode']}", **ev})
