"""Engine flight recorder: always-on failure post-mortems.

Counterpart of ``presto_tpu/runtime/flight.py``. A :class:`FlightRecord`
is one query's post-mortem, captured at ``QueryManager.run_plan``'s
choke point (``runtime/lifecycle.py``) when the query fails, degrades
(an OOM rung), retries a fragment or overruns its deadline, and on
success too under the ``flight_record_successes`` session property. It
holds:

- the plan rendered with the hints the run used;
- the query's span trace (``TraceRecorder.to_span_dicts``, copied);
- the query's metric delta (``QueryInfo.metrics``);
- the OOM rung history and the fragment retry events;
- the run's spill and adaptive events;
- the memory pool's state at the end.

Capture copies host state only: it never touches the device or takes a
pool reservation, and a failed capture counts ``flight.capture_errors``
instead of failing the query. The ring is per session and bounded
(``flight_recorder_limit``); ``system.flight_recorder`` lists it and
``Session.export_flight_record`` writes it as JSON.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from presto_tpu_torch.runtime.metrics import REGISTRY

#: default ring bound
DEFAULT_LIMIT = 64


def _json_safe(v):
    """Span args / summaries may carry numpy or device scalars; the
    export contract is plain JSON, so coerce loudly-typed values and
    repr() anything exotic rather than fail the dump."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    import numpy as np
    import torch

    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        return v.item()
    return repr(v)


@dataclass
class FlightRecord:
    """One query's post-mortem (see module docstring)."""

    query_id: str
    sql: str
    #: terminal state at capture ("FAILED" | "FINISHED")
    state: str
    #: why this record exists: subset of
    #: {"failed", "degraded", "retried", "deadline", "requested"}
    triggers: tuple
    captured_at: float
    error: Optional[str] = None
    error_code: Optional[str] = None
    retryable: Optional[bool] = None
    #: final OOM-ladder rung + the per-rung error history
    oom_rung: int = 0
    rung_history: list = field(default_factory=list)
    #: fragment retry events ({"site", "error"}) in occurrence order
    retry_events: list = field(default_factory=list)
    fragment_retries: int = 0
    degraded_to_local: bool = False
    deadline_s: Optional[float] = None
    execution_s: float = 0.0
    #: EXPLAIN-with-hints render of the executed plan
    plan_render: str = ""
    #: flattened span trace (start_s relative to the first span)
    spans: list = field(default_factory=list)
    dropped_spans: int = 0
    #: the query's attributed metric delta (QueryInfo.metrics)
    metrics: dict = field(default_factory=dict)
    #: exchange-skew summaries + hot partition ids of the LAST run
    exchange_skew: list = field(default_factory=list)
    hot_partitions: list = field(default_factory=list)
    #: executed out-of-core spill decisions of the LAST run (mode,
    #: partitions, resident/streamed counts, host bytes — ladder.py's
    #: ``_note_spill`` summaries)
    spill: list = field(default_factory=list)
    #: applied adaptive-execution decisions of the LAST run (salt /
    #: join_flip / bucket / route — ladder.py's ``_note_adaptive``
    #: events): a post-mortem of a history-steered plan must show what
    #: adaptivity changed
    adaptive: list = field(default_factory=list)
    #: memory pool state at terminal time (reservation released —
    #: recording a post-mortem never holds pool capacity)
    pool: dict = field(default_factory=dict)
    #: whether tracing was on for this query — distinguishes "traced
    #: nothing" (enabled, zero spans) from "tracing off" (empty spans
    #: carry no signal)
    trace_enabled: bool = False

    def to_dict(self) -> dict:
        return {
            "queryId": self.query_id,
            "sql": self.sql,
            "state": self.state,
            "triggers": list(self.triggers),
            "capturedAt": self.captured_at,
            "error": self.error,
            "errorCode": self.error_code,
            "retryable": self.retryable,
            "oomRung": self.oom_rung,
            "rungHistory": _json_safe(self.rung_history),
            "retryEvents": _json_safe(self.retry_events),
            "fragmentRetries": self.fragment_retries,
            "degradedToLocal": self.degraded_to_local,
            "deadlineS": self.deadline_s,
            "executionS": round(self.execution_s, 6),
            "planRender": self.plan_render,
            "spans": _json_safe(self.spans),
            "droppedSpans": self.dropped_spans,
            "metrics": _json_safe(
                {k: self.metrics[k] for k in sorted(self.metrics)}),
            "exchangeSkew": _json_safe(self.exchange_skew),
            "hotPartitions": _json_safe(self.hot_partitions),
            "spill": _json_safe(self.spill),
            "adaptive": _json_safe(self.adaptive),
            "pool": _json_safe(self.pool),
            "traceEnabled": self.trace_enabled,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def _flatten_spans(tracer) -> "tuple[list, int]":
    """TraceRecorder -> JSON-ready span dicts. The record must own its
    copy (live Span.args stay mutable until export), so every args
    dict is coerced+copied here."""
    if tracer is None:
        return [], 0
    out = [
        {**d, "args": _json_safe(d["args"])}
        for d in tracer.to_span_dicts()
    ]
    return out, tracer.dropped


class FlightRecorder:
    """Bounded per-session ring of :class:`FlightRecord` post-mortems.

    Thread-safe: concurrent queries on one session capture from their
    own driver threads. Capture allocates host memory only — the ring
    bound (``flight_recorder_limit``) is the retention contract."""

    def __init__(self, limit: int = DEFAULT_LIMIT):
        self._ring: "deque[FlightRecord]" = deque(maxlen=limit)
        self._lock = threading.Lock()

    def resize(self, limit: int) -> None:
        """Apply a changed ``flight_recorder_limit`` immediately (the
        query_history_limit take-effect rule): oldest records drop NOW."""
        with self._lock:
            self._ring = deque(self._ring, maxlen=limit)

    # ---- capture ---------------------------------------------------------
    def capture(self, info, plan, session, executor=None,
                err=None, triggers=("requested",),
                tracer=None) -> FlightRecord:
        """Build and retain one post-mortem. Called from run_plan's
        finally (runtime/lifecycle.py) with the metric delta already
        attributed onto ``info``; ``err`` is the in-flight exception on
        the failure path (info.error is stamped later, upstream).
        ``tracer`` overrides the context-local recorder — the health
        watchdog captures a query from OUTSIDE its driver thread, where
        ``trace.current()`` would read the watchdog's (empty) context."""
        from presto_tpu_torch.runtime import trace
        from presto_tpu_torch.runtime.errors import error_code as _code
        from presto_tpu_torch.runtime.errors import is_retryable

        render = ""
        try:
            from presto_tpu_torch.plan.nodes import plan_tree_str

            render = plan_tree_str(
                plan, catalog=session.catalog,
                approx_join=bool(session.prop("approx_join")),
                plan_hints=getattr(executor, "plan_hints", None) or None,
                agg_bypass=bool(session.prop("partial_agg_bypass")),
                join_build_budget=getattr(executor, "join_build_budget",
                                          None),
            )
        except Exception:  # noqa: BLE001 — a render bug must not eat
            render = "<plan render failed>"  # the rest of the record
        if tracer is None:
            tracer = trace.current()
        spans, dropped = _flatten_spans(tracer)
        pool = {}
        try:
            p = session.pool()
            pool = dict(p.snapshot())
            pool["pool"] = p.name
        except Exception:  # noqa: BLE001
            pool = {}
        rec = FlightRecord(
            query_id=info.query_id,
            sql=info.sql,
            state="FAILED" if err is not None else "FINISHED",
            triggers=tuple(triggers),
            captured_at=time.time(),
            error=None if err is None else f"{type(err).__name__}: {err}",
            error_code=None if err is None else _code(err),
            # from the in-flight exception, NOT info.retryable: capture
            # runs during unwinding, before the session's except stamps
            # the info (error/error_code take the same route)
            retryable=None if err is None else bool(is_retryable(err)),
            oom_rung=int(info.oom_retries),
            rung_history=list(info.rung_history),
            retry_events=list(info.retry_events),
            fragment_retries=int(info.fragment_retries),
            degraded_to_local=bool(info.degraded),
            deadline_s=session.prop("query_max_run_time"),
            execution_s=info.execution_s,
            plan_render=render,
            spans=spans,
            dropped_spans=dropped,
            metrics=dict(info.metrics),
            exchange_skew=list(
                getattr(executor, "exchange_skew", ()) or ()),
            hot_partitions=list(
                getattr(executor, "hot_partitions", ()) or ()),
            spill=list(getattr(executor, "spill_events", ()) or ()),
            adaptive=list(getattr(executor, "adaptive_events", ()) or ()),
            pool=pool,
            trace_enabled=tracer is not None,
        )
        with self._lock:
            self._ring.append(rec)
        REGISTRY.counter("flight.captured").add()
        for t in rec.triggers:
            REGISTRY.counter(f"flight.trigger.{t}").add()
        return rec

    # ---- read ------------------------------------------------------------
    def records(self) -> "list[FlightRecord]":
        with self._lock:
            return list(self._ring)

    def for_query(self, query_id: str) -> Optional[FlightRecord]:
        with self._lock:
            for rec in reversed(self._ring):
                if rec.query_id == query_id:
                    return rec
        return None

    def latest(self) -> Optional[FlightRecord]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def to_json(self, query_id: Optional[str] = None) -> str:
        """JSON export: one record (by query id) or the whole ring,
        newest last: the ``Session.export_flight_record`` payload."""
        if query_id is not None:
            rec = self.for_query(query_id)
            if rec is None:
                from presto_tpu_torch.runtime.errors import UserError

                raise UserError(
                    f"no flight record for query {query_id!r} "
                    "(nothing captured, or evicted from the ring)"
                )
            return rec.to_json()
        return json.dumps([r.to_dict() for r in self.records()])

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
