"""Overload control: cancellation, retry budgets, shedding, brown-out.

Counterpart of ``presto_tpu/runtime/overload.py``, whole. The port's
query lifecycle (``runtime/lifecycle.py``) uses :class:`CancelScope`
(every deadline checkpoint is a cancel checkpoint, and the
``step.cancel_checkpoint`` fault site) and :class:`RetryBudget` (fragment
retries and OOM-ladder rungs draw from one per-session token bucket with
a circuit breaker). :func:`shed_retry_after`, :class:`CostEwma` and
:class:`OverloadController` are the mechanisms of load shedding and
brown-out, which a serving tier drives; the port has no server yet, so
only their unit contracts run.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from presto_tpu_torch.runtime.errors import (
    DeviceOutOfMemory,
    QueryCancelled,
    is_backend_oom,
)
from presto_tpu_torch.runtime.faults import fault_point
from presto_tpu_torch.runtime.metrics import REGISTRY


class CancelScope:
    """One query's cooperative-cancellation flag.

    ``cancel(reason)`` is safe from any thread and idempotent (the
    first reason wins); ``check(where)`` is called by the query's OWN
    thread at choke points and raises the typed ``QueryCancelled``
    once flipped. There is no preemption (a launched kernel runs to
    completion), so "within one checkpoint" is the cancellation
    latency contract, same as every other lifecycle control here.
    """

    __slots__ = ("_event", "_reason", "_observed", "query_id")

    def __init__(self, query_id: str = ""):
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._observed = False
        self.query_id = query_id

    def cancel(self, reason: str = "cancelled") -> bool:
        """Flip the scope; returns True on the first flip only."""
        if self._event.is_set():
            return False
        self._reason = reason
        self._event.set()
        REGISTRY.counter("cancel.requested").add()
        return True

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def check(self, where: str) -> None:
        """Cooperative checkpoint: a no-op until cancelled, then a
        typed raise. Doubles as the ``step.cancel_checkpoint`` fault
        site so chaos can storm the checkpoint itself. Checkpoints
        run OUTSIDE the fragment boundary (gate waits, driver loop),
        so a backend-shaped injection (an ``oom`` fault armed at the
        ``step`` prefix) is mapped to the typed ``DeviceOutOfMemory``
        HERE — the correct-or-typed contract holds at every site."""
        try:
            fault_point("step.cancel_checkpoint")
        except Exception as e:
            if not is_backend_oom(e):
                raise
            REGISTRY.counter("query.backend_oom").add()
            raise DeviceOutOfMemory(
                f"backend out of memory at cancel checkpoint {where!r}: "
                f"{type(e).__name__}: {e}"
            ) from e
        if self._event.is_set():
            if not self._observed:
                self._observed = True
                REGISTRY.counter("cancel.observed").add()
            raise QueryCancelled(
                f"query {self.query_id or '?'} cancelled at {where!r}"
                f" ({self._reason or 'cancelled'})"
            )


def shed_retry_after(queued: int, *, base_s: float = 0.1,
                     cap_s: float = 30.0) -> float:
    """Retry-After hint for a shed: strictly monotone in queue depth
    (each queued query adds drain time), capped so a melted server
    never tells a client to go away for minutes."""
    return min(cap_s, base_s * (1.0 + max(0, queued)))


class CostEwma:
    """Exponentially-weighted moving average of per-query cost
    (seconds of slot occupancy) — the admission controller's estimate
    of how long one more queued query takes to drain. Thread-safe;
    starts at ``initial`` so an idle server never sheds its first
    query on a cold estimate."""

    def __init__(self, alpha: float = 0.2, initial: float = 0.0):
        self._alpha = float(alpha)
        self._value = float(initial)
        self._samples = 0
        self._lock = threading.Lock()

    def update(self, cost_s: float) -> float:
        with self._lock:
            if self._samples == 0:
                self._value = float(cost_s)
            else:
                self._value += self._alpha * (float(cost_s) - self._value)
            self._samples += 1
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples


class RetryBudget:
    """Per-session token bucket over ALL retry-shaped work (fragment
    retries, OOM-ladder rungs) with a circuit breaker on top.

    Independent faults sip from the bucket and the time-based refill
    keeps pace. Correlated failures — a storm where every fragment
    fails the same way — drain it; then the breaker OPENS and every
    subsequent ``try_spend`` is denied instantly (fail-fast instead of
    a retry storm that multiplies offered load). After
    ``probe_cooldown_s`` the breaker goes HALF-OPEN: exactly one
    caller gets a probe token; its ``record_success`` closes the
    breaker and refills the bucket, its ``record_failure`` re-opens
    and the cooldown restarts.
    """

    def __init__(self, capacity: float = 16.0, refill_per_s: float = 2.0,
                 probe_cooldown_s: float = 1.0):
        self.capacity = max(1.0, float(capacity))
        self.refill_per_s = max(0.0, float(refill_per_s))
        self.probe_cooldown_s = max(0.0, float(probe_cooldown_s))
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._state = "closed"  # closed | open | half-open
        self._opened_at = 0.0
        self._probing = False
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        if self.refill_per_s > 0.0 and now > self._last:
            self._tokens = min(self.capacity,
                               self._tokens
                               + (now - self._last) * self.refill_per_s)
        self._last = now

    def try_spend(self, label: str = "") -> bool:
        """May this retry proceed? Denials are terminal for the caller
        (fail fast with the ORIGINAL error); they are counted under
        ``overload.retry_budget_exhausted``."""
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            if self._state == "open":
                if now - self._opened_at >= self.probe_cooldown_s:
                    self._state = "half-open"
                else:
                    REGISTRY.counter("overload.retry_budget_exhausted").add()
                    return False
            if self._state == "half-open":
                if self._probing:
                    REGISTRY.counter("overload.retry_budget_exhausted").add()
                    return False
                self._probing = True
                REGISTRY.counter("overload.breaker_probe").add()
                return True
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self._state = "open"
            self._opened_at = now
            REGISTRY.counter("overload.breaker_open").add()
            REGISTRY.counter("overload.retry_budget_exhausted").add()
            return False

    def record_success(self) -> None:
        """A spent retry succeeded: a half-open probe's success closes
        the breaker and refills the bucket (the storm has passed)."""
        with self._lock:
            if self._state == "half-open" and self._probing:
                self._state = "closed"
                self._probing = False
                self._tokens = self.capacity
                REGISTRY.counter("overload.breaker_rearm").add()

    def record_failure(self) -> None:
        """A spent retry failed: a half-open probe's failure re-opens
        the breaker and the cooldown restarts."""
        with self._lock:
            if self._state == "half-open" and self._probing:
                self._state = "open"
                self._probing = False
                self._opened_at = time.monotonic()

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "tokens": round(self._tokens, 3),
                    "capacity": self.capacity}


class OverloadController:
    """The brown-out latch: health breaches flip it, a breach-free
    cooldown flips it back, and an operator can force either way.

    The serving tier consults :meth:`mode_for` per NEW submission —
    in-flight queries are never re-routed (results must match the tier
    they were admitted to) — and routes ``brownout="approx"`` tenants
    through the approx session (flagged via ``QueryInfo.approximate``)
    or sheds ``brownout="shed"`` tenants with ``ServerOverloaded``.
    Tenants with no brown-out policy are untouched: degradation is
    opt-in per the fairness contract.
    """

    def __init__(self, cooldown_s: float = 5.0):
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._lock = threading.Lock()
        self._engaged = False
        self._forced = False
        self._last_breach = 0.0
        self._engagements = 0
        self._last_event: Optional[dict] = None

    def on_breach(self, event: Optional[dict] = None) -> None:
        """HealthMonitor ``on_breach`` callback: engage (or extend)
        the brown-out."""
        with self._lock:
            self._last_breach = time.monotonic()
            self._last_event = dict(event) if event else None
            if not self._engaged:
                self._engaged = True
                self._engagements += 1
                REGISTRY.counter("brownout.engaged").add()

    def force(self, on: bool) -> None:
        """Operator override (``brownout_force`` session property or a
        direct call): ``True`` engages and pins the brown-out past any
        cooldown; ``False`` releases the pin and disengages now."""
        with self._lock:
            if on:
                self._forced = True
                if not self._engaged:
                    self._engaged = True
                    self._engagements += 1
                    REGISTRY.counter("brownout.engaged").add()
            else:
                self._forced = False
                if self._engaged:
                    self._engaged = False
                    REGISTRY.counter("brownout.recovered").add()

    def _maybe_recover_locked(self, now: float) -> None:
        if (self._engaged and not self._forced
                and now - self._last_breach >= self.cooldown_s):
            self._engaged = False
            REGISTRY.counter("brownout.recovered").add()

    @property
    def engaged(self) -> bool:
        with self._lock:
            self._maybe_recover_locked(time.monotonic())
            return self._engaged

    def mode_for(self, spec) -> Optional[str]:
        """Routing verdict for one NEW submission under ``spec``:
        ``None`` (serve normally), ``"approx"`` (route to the approx
        tier), or ``"shed"`` (refuse with ServerOverloaded). Checks
        recovery first so a quiet server disengages lazily without a
        background thread."""
        with self._lock:
            self._maybe_recover_locked(time.monotonic())
            if not self._engaged:
                return None
        return getattr(spec, "brownout", None)

    @property
    def forced(self) -> bool:
        with self._lock:
            return self._forced

    @property
    def engagements(self) -> int:
        with self._lock:
            return self._engagements

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_recover_locked(time.monotonic())
            return {"engaged": self._engaged, "forced": self._forced,
                    "engagements": self._engagements,
                    "cooldown_s": self.cooldown_s,
                    "last_event": self._last_event}
