"""Structured query tracing: nested spans, exportable as Chrome trace JSON.

Counterpart of ``presto_tpu/runtime/trace.py``, whole. A
:class:`TraceRecorder` collects one query's span tree (query -> plan
node -> operator step, plus driver and join-filter spans), and the
session's ring of recent recorders (:class:`TraceStore`) backs
``Session.export_trace`` (Chrome ``trace_event`` JSON, loadable in
Perfetto / chrome://tracing).

- **Cheap when off, cheap when on.** The recorder rides a ContextVar;
  with none installed, :func:`span` costs one ContextVar read and
  returns a shared no-op context manager. With one installed, a span is
  two ``perf_counter`` reads and one list append: recording is
  per-query and single-writer (the query's thread; the scan prefetch
  worker runs with the recorder cleared), so there are no locks on the
  hot path.
- **Host-observed times.** A span around an operator step measures the
  host's time in it: CUDA launches are asynchronous, so the device work
  lands in the span that later waits on it. With ``profile_annotations``
  each span also opens a ``torch.profiler.record_function`` named
  ``<span>#<trace_token>``, so a torch profiler trace on the card shows
  each span as a user annotation over the kernels it launched.
- **Bounded.** Spans per query cap at ``max_spans`` (overflow counts
  into the ``trace.spans_dropped`` metric, never errors); the
  per-session :class:`TraceStore` is a fixed-size ring.

A span's ``args`` hold Python values only, never tensors.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import nullcontext
from contextvars import ContextVar
from typing import Any, Optional

from presto_tpu_torch.runtime.metrics import REGISTRY

#: span categories (the ``cat`` field of exported events)
CATEGORIES = (
    "query",      # the root span of one tracked query
    "fragment",   # a lifecycle fragment dispatch (run_fragment attempt)
    "node",       # one plan node's execution (inclusive of children)
    "step",       # one operator step dispatch
    "exchange",   # a collective exchange (bytes/partitions/rounds in args)
    "cache",      # exec/result/stats cache lookups
    "retry",      # a fragment-retry backoff window
    "lifecycle",  # admission / degradation
    "driver",     # the local driver push loop
    "stats",      # estimate snapshot / plan-stats history recording
    "frontend",   # HTTP serving-tier spans (submit / poll round-trips)
    "subscription",  # a continuous-query refresh fire (child of its sub)
)

_TRACE: ContextVar[Optional["TraceRecorder"]] = ContextVar(
    "presto_tpu_torch_trace", default=None
)

#: shared reusable no-op context manager (``nullcontext`` keeps no
#: per-use state); its ``__enter__`` returns None, so callers that
#: annotate span args must guard ``if sp is not None``
_NOOP = nullcontext()


class Span:
    """One recorded span. ``args`` is live-mutable until export —
    callers may attach results (bytes moved, hit/miss) after the
    timed region closes."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "t0", "t1", "args")

    def __init__(self, span_id: int, parent_id: int, name: str, cat: str):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.t0 = 0.0
        self.t1 = 0.0
        self.args: dict[str, Any] = {}


class _SpanCtx:
    __slots__ = ("rec", "span", "_ann")

    def __init__(self, rec: "TraceRecorder", span: Span):
        self.rec = rec
        self.span = span
        self._ann = None

    def __enter__(self) -> Span:
        rec = self.rec
        rec._stack.append(self.span.span_id)
        if rec.annotate:
            self._ann = _annotation(self.span.name, rec.trace_token)
            if self._ann is not None:
                self._ann.__enter__()
        self.span.t0 = time.perf_counter()
        return self.span

    def __exit__(self, *exc):
        self.span.t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self.rec._stack.pop()
        return False


def _annotation(name: str, token: Optional[str]):
    """A ``torch.profiler.record_function`` carrying the trace token, or
    None when the profiler is unavailable (annotation is best-effort)."""
    try:
        from torch.profiler import record_function
    except Exception:  # pragma: no cover - a torch without the profiler
        return None
    return record_function(f"{name}#{token}" if token else name)


class TraceRecorder:
    """One query's span tree. Single-writer (the query's thread owns the
    query synchronously); reads happen after the query finishes."""

    __slots__ = (
        "query_id", "trace_token", "max_spans", "annotate",
        "spans", "dropped", "created_wall", "_stack", "_seq",
    )

    def __init__(self, query_id: str, trace_token: Optional[str] = None,
                 max_spans: int = 8192, annotate: bool = False):
        self.query_id = query_id
        self.trace_token = trace_token
        self.max_spans = max_spans
        self.annotate = annotate
        self.spans: list[Span] = []
        self.dropped = 0
        self.created_wall = time.time()
        self._stack: list[int] = []  # open span ids (parents)
        self._seq = 0

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: str = "step",
             args: Optional[dict] = None):
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            REGISTRY.counter("trace.spans_dropped").add()
            return _NOOP
        parent = self._stack[-1] if self._stack else -1
        s = Span(self._seq, parent, name, cat)
        self._seq += 1
        if args:
            s.args.update(args)
        self.spans.append(s)
        return _SpanCtx(self, s)

    def add_complete(self, name: str, cat: str, t0: float, dur_s: float,
                     args: Optional[dict] = None) -> Optional[Span]:
        """Record an already-timed span (explicit perf_counter start +
        duration) under the currently open span."""
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            REGISTRY.counter("trace.spans_dropped").add()
            return None
        parent = self._stack[-1] if self._stack else -1
        s = Span(self._seq, parent, name, cat)
        self._seq += 1
        s.t0 = t0
        s.t1 = t0 + dur_s
        if args:
            s.args.update(args)
        self.spans.append(s)
        return s

    # -- introspection -----------------------------------------------------
    @property
    def t0(self) -> float:
        return self.spans[0].t0 if self.spans else 0.0

    def to_span_dicts(self) -> list[dict]:
        """The span tree as plain dicts with query-relative timestamps
        (args shared by reference — callers that persist them, like
        the flight recorder, must deep-copy/coerce). The flattening
        the ``system.trace_spans`` scan and post-mortem capture share."""
        t0 = self.t0
        return [
            {
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "name": s.name,
                "cat": s.cat,
                "start_s": round(max(s.t0 - t0, 0.0), 6),
                "duration_s": round(max(s.t1 - s.t0, 0.0), 6),
                "args": s.args,
            }
            for s in self.spans
        ]

    def spans_by_cat(self, cat: str) -> list[Span]:
        return [s for s in self.spans if s.cat == cat]

    def children_of(self, span_id: int) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    # -- export ------------------------------------------------------------
    def to_events(self, pid: int) -> list[dict]:
        """Chrome trace_event entries for this query (one pid per
        query; ts in microseconds on the process perf_counter epoch)."""
        events: list[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"query {self.query_id}"},
            },
            {
                "name": "process_labels", "ph": "M", "pid": pid, "tid": 0,
                "args": {"labels": f"trace_token={self.trace_token}"},
            },
        ]
        for s in self.spans:
            args = {"span_id": s.span_id, "parent_id": s.parent_id}
            args.update(s.args)
            if self.trace_token is not None:
                args["trace_token"] = self.trace_token
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "pid": pid,
                "tid": 0,
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
                "args": args,
            })
        return events


# ---------------------------------------------------------------------------
# Module-level recording surface (the instrumentation points' API)
# ---------------------------------------------------------------------------


def install(rec: Optional[TraceRecorder]):
    """Install ``rec`` as the active recorder; returns the reset token
    (nested queries from event listeners get their own recorder and
    restore the outer one on exit)."""
    return _TRACE.set(rec)


def uninstall(token) -> None:
    _TRACE.reset(token)


def current() -> Optional[TraceRecorder]:
    return _TRACE.get()


def span(name: str, cat: str = "step", args: Optional[dict] = None):
    """The one instrumentation hook: a context manager timing a span
    under the active recorder, or a shared no-op when tracing is off.
    ``with span(...) as sp:`` — ``sp`` is the live Span (mutate
    ``sp.args`` freely) or None on the no-op path."""
    rec = _TRACE.get()
    if rec is None:
        return _NOOP
    return rec.span(name, cat, args)


def add_complete(name: str, cat: str, t0: float, dur_s: float,
                 args: Optional[dict] = None) -> None:
    rec = _TRACE.get()
    if rec is not None:
        rec.add_complete(name, cat, t0, dur_s, args)


# ---------------------------------------------------------------------------
# Byte accounting helpers (observability-side batch sizing; capacity
# arithmetic only — never a device sync)
# ---------------------------------------------------------------------------


def batch_row_bytes(batch) -> int:
    """Per-row device bytes of a Batch: column payload widths + the
    validity and live masks (1 byte each as moved on the wire — bools
    ride as uint8 through the collectives)."""
    total = 1  # live mask
    for c in batch.columns.values():
        width = 1
        for d in c.data.shape[1:]:
            width *= int(d)
        total += width * c.data.element_size() + 1  # + valid mask
    return total


def batch_device_bytes(batch) -> int:
    """Capacity-based device residency of a Batch (live rows and
    padding both occupy HBM)."""
    return batch_row_bytes(batch) * int(batch.capacity)


# ---------------------------------------------------------------------------
# Per-session trace retention + Chrome export
# ---------------------------------------------------------------------------

#: recorders retained per session (spans are memory-heavy relative to
#: QueryInfo, so this ring is deliberately smaller than query history)
TRACE_RING = 64


class TraceStore:
    """Ring buffer of the session's most recent TraceRecorders."""

    def __init__(self, maxlen: int = TRACE_RING):
        self._ring: deque[TraceRecorder] = deque(maxlen=maxlen)

    def add(self, rec: TraceRecorder) -> None:
        self._ring.append(rec)

    def recorders(self) -> list[TraceRecorder]:
        return list(self._ring)

    def latest(self) -> Optional[TraceRecorder]:
        return self._ring[-1] if self._ring else None

    def for_query(self, query_id: str) -> Optional[TraceRecorder]:
        for rec in reversed(self._ring):
            if rec.query_id == query_id:
                return rec
        return None

    def __len__(self) -> int:
        return len(self._ring)


def to_chrome_trace(recorders: list[TraceRecorder]) -> dict:
    """The Chrome ``trace_event`` JSON object for a set of recorders
    (one pid per query, ts on the shared perf_counter epoch)."""
    events: list[dict] = []
    tokens = []
    for pid, rec in enumerate(recorders, start=1):
        events.extend(rec.to_events(pid))
        if rec.trace_token is not None:
            tokens.append(rec.trace_token)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "engine": "presto_tpu_torch",
            "trace_tokens": sorted(set(tokens)),
            "queries": [rec.query_id for rec in recorders],
        },
    }


def export_chrome_trace(path: str, recorders: list[TraceRecorder]) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(recorders), f)
    return path
