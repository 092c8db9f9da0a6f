"""Query event pipeline.

Counterpart of ``presto_tpu/runtime/events.py``, whole: the session
fans ``query_created`` / ``query_completed`` / ``query_failed`` out to
registered :class:`EventListener` objects, which receive the same
``QueryInfo`` the session tracks. Listener failures never fail the
query: they are logged, swallowed and counted
(``events.listener_errors``). :class:`QueryHistoryBuffer` is the
built-in listener behind ``Session.history``. ``query_cached``,
``fragment_retried`` and ``query_degraded`` are dispatched by the result
cache and the lifecycle, which the port does not have yet.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Protocol

from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.stats import QueryInfo

log = logging.getLogger("presto_tpu_torch.events")


class EventListener(Protocol):
    """Listeners implement any subset of these (missing methods are
    skipped); all receive the tracker's live QueryInfo."""

    def query_created(self, info: QueryInfo) -> None: ...

    def query_completed(self, info: QueryInfo) -> None: ...

    def query_failed(self, info: QueryInfo) -> None: ...

    def query_cached(self, info: QueryInfo) -> None: ...

    def fragment_retried(self, info: QueryInfo) -> None: ...

    def query_degraded(self, info: QueryInfo) -> None: ...


class EventDispatcher:
    def __init__(self, listeners=()):
        self.listeners = list(listeners)

    def add(self, listener: EventListener):
        self.listeners.append(listener)

    def _fire(self, method: str, info: QueryInfo):
        for l in self.listeners:
            fn = getattr(l, method, None)
            if fn is None:
                continue
            try:
                fn(info)
            except Exception:  # listener bugs never fail queries
                REGISTRY.counter("events.listener_errors").add()
                log.exception("event listener %r failed in %s", l, method)

    def query_created(self, info: QueryInfo):
        self._fire("query_created", info)

    def query_completed(self, info: QueryInfo):
        self._fire("query_completed", info)

    def query_failed(self, info: QueryInfo):
        """Fired on the FAILED transition, before query_completed
        (which fires for every terminal state, like the reference's
        QueryCompletedEvent carrying the failure info)."""
        self._fire("query_failed", info)

    def query_cached(self, info: QueryInfo):
        """Fired when a query is answered from the result cache
        (``info.cache_hit`` is already True); query_completed still
        follows, like every terminal state."""
        self._fire("query_cached", info)

    def fragment_retried(self, info: QueryInfo):
        """Fired on each fragment retry; ``info.fragment_retries`` has
        already been incremented when listeners see it."""
        self._fire("fragment_retried", info)

    def query_degraded(self, info: QueryInfo):
        """Fired each time the OOM recovery ladder steps a rung down
        (``info.oom_retries`` already reflects the new rung) — the
        runtime-OOM analog of fragment_retried."""
        self._fire("query_degraded", info)


class QueryHistoryBuffer:
    """Ring buffer of recently completed QueryInfos: the built-in
    EventListener behind ``Session.history`` (the JAX package's
    ``system.query_history`` table reads it). ``query_completed`` fires
    for every terminal state, so FAILED queries appear too."""

    def __init__(self, maxlen: int = 256):
        self._ring: deque[QueryInfo] = deque(maxlen=maxlen)

    def resize(self, maxlen: int) -> None:
        """Apply a changed ``query_history_limit`` (deque maxlen is
        immutable, so rebuild keeping the newest entries)."""
        if maxlen != self._ring.maxlen:
            self._ring = deque(self._ring, maxlen=maxlen)

    def query_completed(self, info: QueryInfo) -> None:
        self._ring.append(info)

    def infos(self) -> "list[QueryInfo]":
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)
