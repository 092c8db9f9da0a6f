"""Fairness-aware multi-tenant admission: the layer between the serving
front-end and the memory pool's strict FIFO.

Counterpart of ``presto_tpu/server/scheduler.py``. ``MemoryPool.reserve``
is strict FIFO on purpose (head-of-line keeps big queries from starving),
which is wrong between tenants: one aggressor flooding cheap queries
would starve an interactive tenant's occasional query. Every query first
takes a weighted-fair concurrency slot here, then admits through the
pool as before.

- Each tenant carries a virtual time; every enqueued waiter advances it
  by ``1 / weight`` and carries its virtual finish stamp, and the lowest
  stamp among quota-eligible waiters runs next, so a lighter tenant's
  next query overtakes a flooding tenant's backlog.
- Quotas are hard gates: a tenant at ``max_concurrent`` running queries,
  or holding ``max_bytes`` of live tenant-tagged pool reservations
  (``runtime/memory.py``), is skipped whatever its stamp. There is no
  mid-flight kill: a launched kernel runs to completion, so preemption
  happens at admission boundaries.
- ``total_slots`` bounds overall concurrency (None leaves it to the
  pool).
- Load shedding: over a queue ceiling (per tenant, or global for tenants
  that already queue) or the cost-EWMA drain estimate, ``acquire`` and
  ``check_shed`` raise the retryable ``ServerOverloaded`` with a
  retry-after hint before any queue state exists.
- Unknown tenants auto-register with ``default_spec`` up to
  ``max_tenants``; past it they share the ``__overflow__`` lane.

Counters: ``tenant.admitted`` / ``tenant.queued`` /
``tenant.over_quota_blocked`` / ``tenant.queue_timeouts`` (each also
suffixed ``.<tenant>``), histogram ``tenant.queued_s``; ``snapshot`` backs
``system.tenants`` when a server attaches the scheduler to its session.
"""

from __future__ import annotations

import itertools
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterable, Mapping, Optional

from presto_tpu_torch.runtime.errors import ResourceExhausted, ServerOverloaded
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.overload import CostEwma, shed_retry_after

_NAME_RE = re.compile(r"[^A-Za-z0-9_]")


def _metric_name(tenant: str) -> str:
    """Tenant name sanitized for OpenMetrics suffixes."""
    return _NAME_RE.sub("_", tenant) or "_"


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's fairness contract: scheduling ``weight`` (share of
    contended slots), ``max_concurrent`` running queries, and
    ``max_bytes`` of live memory-pool reservations (both ``None`` =
    unlimited)."""

    name: str
    weight: float = 1.0
    max_concurrent: Optional[int] = None
    max_bytes: Optional[int] = None
    #: per-tenant SLO objectives consumed by ``runtime/health.py``'s
    #: SloTracker; ``None`` falls through to the session-wide
    #: ``slo_latency_objective_s`` / ``slo_freshness_objective_s``
    slo_latency_s: Optional[float] = None
    slo_freshness_s: Optional[float] = None
    #: brown-out policy (runtime/overload.OverloadController): while a
    #: health breach has the brown-out engaged, this tenant's NEW
    #: traffic is routed to the approx tier (``"approx"``, flagged via
    #: QueryInfo.approximate) or refused with ServerOverloaded
    #: (``"shed"``); ``None`` (the default) opts out of degradation
    brownout: Optional[str] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        for f in ("slo_latency_s", "slo_freshness_s"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"tenant {self.name!r}: {f} must be > 0")
        if self.brownout not in (None, "approx", "shed"):
            raise ValueError(
                f"tenant {self.name!r}: brownout must be approx|shed|None, "
                f"got {self.brownout!r}")


class _TenantState:
    __slots__ = ("running", "peak_running", "admitted", "over_quota_blocked",
                 "queue_timeouts", "vtime")

    def __init__(self):
        self.running = 0
        self.peak_running = 0
        self.admitted = 0
        self.over_quota_blocked = 0
        self.queue_timeouts = 0
        self.vtime = 0.0


class _Waiter:
    __slots__ = ("stamp", "seq", "tenant", "counted_block")

    def __init__(self, stamp: float, seq: int, tenant: str):
        self.stamp = stamp
        self.seq = seq
        self.tenant = tenant
        self.counted_block = False

    @property
    def order(self):
        return (self.stamp, self.seq)


class FairScheduler:
    """Weighted-fair, quota-gated concurrency slots for named tenants.

    Unknown tenants auto-register with ``default_spec`` (weight 1, no
    quotas unless overridden) — a serving front-end must not 500 a new
    client, it must schedule it fairly.
    """

    def __init__(self, tenants: "Iterable[TenantSpec] | Mapping | None" = None,
                 total_slots: Optional[int] = None,
                 default_spec: Optional[TenantSpec] = None,
                 pool=None, max_tenants: int = 256,
                 global_queue_limit: Optional[int] = None,
                 tenant_queue_limit: Optional[int] = None,
                 shed_drain_limit_s: Optional[float] = None):
        self._cv = threading.Condition()
        #: load-shedding ceilings (overload rung 1; None = disabled).
        #: Over-ceiling acquires fail FAST with the retryable
        #: ServerOverloaded (HTTP 429 upstream) BEFORE a waiter is
        #: enqueued or vtime is burned — a shed leaves no ghost state.
        self.global_queue_limit = global_queue_limit
        self.tenant_queue_limit = tenant_queue_limit
        #: EWMA-cost admission: shed when the estimated backlog drain
        #: time ``(queued+1) * ewma_cost / slots`` exceeds this
        self.shed_drain_limit_s = shed_drain_limit_s
        #: per-query slot-occupancy EWMA (updated by ``slot()``) — the
        #: drain-time estimator; also exported via snapshot rows
        self.cost_ewma = CostEwma()
        self._specs: dict[str, TenantSpec] = {}
        self._states: dict[str, _TenantState] = {}
        self._waiters: list[_Waiter] = []
        self._vclock = 0.0
        self._seq = itertools.count()
        self._running_total = 0
        self.total_slots = total_slots
        self.default_spec = default_spec or TenantSpec("default")
        #: cap on auto-registered tenant names: the tenant header is
        #: client-controlled, and each name permanently allocates
        #: state, a system.tenants row, and per-tenant counters — past
        #: the cap, walk-ins pool into one shared "__overflow__" lane
        #: (still fairly scheduled, bounded cardinality, counted)
        self.max_tenants = max(1, int(max_tenants))
        #: optional MemoryPool whose tenant-tagged reservations back the
        #: byte quotas (runtime/memory.py); its release listeners kick
        #: this scheduler so byte-blocked waiters re-check promptly
        #: (detached again by close() — a listener on the process-global
        #: pool must not pin a dead scheduler forever)
        self._pool = pool
        self._pool_listener = None
        if pool is not None and hasattr(pool, "add_release_listener"):
            self._pool_listener = lambda *_: self.kick()
            pool.add_release_listener(self._pool_listener)
        if isinstance(tenants, Mapping):
            tenants = tenants.values()
        for spec in tenants or ():
            self.register(spec)

    # ---- registry --------------------------------------------------------
    def register(self, spec: TenantSpec) -> None:
        with self._cv:
            self._specs[spec.name] = spec
            self._states.setdefault(spec.name, _TenantState())

    def spec(self, tenant: str) -> TenantSpec:
        with self._cv:
            return self._spec_locked(tenant)

    def _resolve_locked(self, tenant: str) -> str:
        """Effective tenant name: unknown tenants auto-register with
        the default spec until ``max_tenants``; beyond it they pool
        into the shared ``__overflow__`` lane (the header is
        client-controlled — unbounded names must not grow state or
        metric cardinality forever)."""
        if tenant in self._specs:
            return tenant
        if len(self._specs) >= self.max_tenants:
            REGISTRY.counter("tenant.overflow").add()
            tenant = "__overflow__"
            if tenant in self._specs:
                return tenant
        s = TenantSpec(tenant, self.default_spec.weight,
                       self.default_spec.max_concurrent,
                       self.default_spec.max_bytes,
                       self.default_spec.slo_latency_s,
                       self.default_spec.slo_freshness_s,
                       self.default_spec.brownout)
        self._specs[tenant] = s
        self._states.setdefault(tenant, _TenantState())
        return tenant

    def _spec_locked(self, tenant: str) -> TenantSpec:
        return self._specs[self._resolve_locked(tenant)]

    # ---- quota / fairness predicates ------------------------------------
    def _tenant_bytes(self, tenant: str) -> int:
        if self._pool is None:
            return 0
        try:
            return self._pool.tenant_reserved_bytes(tenant)
        except Exception:  # noqa: BLE001 — quotas degrade open, not closed
            return 0

    def _under_quota(self, tenant: str) -> bool:
        spec = self._spec_locked(tenant)
        st = self._states[tenant]
        if spec.max_concurrent is not None and st.running >= spec.max_concurrent:
            return False
        if spec.max_bytes is not None and self._tenant_bytes(tenant) >= spec.max_bytes:
            return False
        return True

    def _blocker_of(self, w: _Waiter) -> Optional[str]:
        """Why ``w`` cannot be admitted right now: its own tenant is
        over quota ("quota"), the global slot pool is full ("slots"),
        or an eligible waiter with an earlier virtual finish time is
        ahead ("turn"). None = admissible. Quota verdicts are memoized
        per tenant within one call: byte quotas read the pool under
        ITS lock, and a deep queue must not pay one cross-lock probe
        per earlier waiter."""
        quota_memo: dict[str, bool] = {}

        def under(name: str) -> bool:
            v = quota_memo.get(name)
            if v is None:
                v = quota_memo[name] = self._under_quota(name)
            return v

        if not under(w.tenant):
            return "quota"
        if self.total_slots is not None and self._running_total >= self.total_slots:
            return "slots"
        for o in self._waiters:
            if o is not w and o.order < w.order and under(o.tenant):
                return "turn"
        return None

    # ---- load shedding ---------------------------------------------------
    def _check_shed_locked(self, tenant: str, mname: str) -> None:
        """Overload rung 1, decided BEFORE any queue state exists for
        this submission: raise the retryable ``ServerOverloaded`` when
        a queue ceiling or the EWMA drain estimate says accepting it
        would grow the backlog past what the engine can drain. The
        Retry-After hint is monotone in queue depth. Fairness note:
        the GLOBAL ceiling only sheds tenants that already hold queue
        share — a light tenant with no backlog always gets one spot in
        line, so an aggressor's storm can never shed it first."""
        queued_total = len(self._waiters)
        queued_tenant = sum(1 for w in self._waiters if w.tenant == tenant)
        why = None
        if (self.tenant_queue_limit is not None
                and queued_tenant >= self.tenant_queue_limit):
            why = "queue_tenant"
        elif (self.global_queue_limit is not None
                and queued_total >= self.global_queue_limit
                and queued_tenant > 0):
            why = "queue_global"
        elif (self.shed_drain_limit_s is not None
                and self.cost_ewma.samples > 0
                and queued_tenant > 0):
            slots = self.total_slots or max(1, self._running_total)
            drain_s = (queued_total + 1) * self.cost_ewma.value / slots
            if drain_s > self.shed_drain_limit_s:
                why = "cost"
        if why is None:
            return
        retry_after = shed_retry_after(queued_total)
        REGISTRY.counter("overload.shed").add()
        REGISTRY.counter(f"overload.shed_reason.{why}").add()
        REGISTRY.counter(f"overload.shed_tenant.{mname}").add()
        raise ServerOverloaded(
            f"tenant {tenant!r} shed at admission ({why}): "
            f"{queued_tenant} queued for this tenant, {queued_total} "
            f"queued globally, {self._running_total} running "
            f"(ewma cost {self.cost_ewma.value:.3f}s; retry after "
            f"{retry_after:.2f}s)",
            retry_after_s=retry_after,
        )

    def check_shed(self, tenant: str) -> None:
        """Synchronous shed verdict for ``tenant`` (the front-end's
        accept-time gate): raises ``ServerOverloaded`` exactly as
        ``acquire`` would, without enqueuing anything."""
        with self._cv:
            tenant = self._resolve_locked(tenant)
            self._check_shed_locked(tenant, _metric_name(tenant))

    # ---- acquire / release ----------------------------------------------
    def acquire(self, tenant: str, timeout_s: Optional[float] = None) -> str:
        """Block until ``tenant`` may start one query; returns the
        tenant name as the release token. Raises ``ResourceExhausted``
        after ``timeout_s`` in the queue."""
        t0 = time.monotonic()
        deadline = None if timeout_s is None else t0 + timeout_s
        with self._cv:
            # resolve once: past max_tenants, walk-ins share the
            # overflow lane, and ALL accounting below (state, vtime,
            # metric suffixes, the release token) uses the resolved
            # name so it stays bounded
            tenant = self._resolve_locked(tenant)
            mname = _metric_name(tenant)
            spec = self._specs[tenant]
            st = self._states[tenant]
            self._check_shed_locked(tenant, mname)
            stamp = max(st.vtime, self._vclock) + 1.0 / spec.weight
            # advance the tenant's virtual time at ENQUEUE, not
            # admission: a burst of N waiters from one tenant must
            # carry stamps v+1, v+2, ..., v+N — stamping them all v+1
            # would let the backlog admit shoulder-to-shoulder and
            # defeat exactly the overtake property the weights exist
            # for (a timed-out waiter's stamp stays spent: a tenant
            # that queues work it abandons still paid for the place it
            # held in line)
            st.vtime = stamp
            w = _Waiter(stamp, next(self._seq), tenant)
            self._waiters.append(w)
            waited = False
            try:
                while True:
                    blocker = self._blocker_of(w)
                    if blocker is None:
                        break
                    if blocker == "quota" and not w.counted_block:
                        w.counted_block = True
                        st.over_quota_blocked += 1
                        REGISTRY.counter("tenant.over_quota_blocked").add()
                        REGISTRY.counter(
                            f"tenant.over_quota_blocked.{mname}").add()
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        st.queue_timeouts += 1
                        REGISTRY.counter("tenant.queue_timeouts").add()
                        REGISTRY.counter(
                            f"tenant.queue_timeouts.{mname}").add()
                        raise ResourceExhausted(
                            f"tenant {tenant!r} admission timeout: waited "
                            f"{timeout_s}s for a fair slot "
                            f"(blocked on {blocker}; {self.describe()})"
                        )
                    waited = True
                    self._cv.wait(remaining)
            finally:
                self._waiters.remove(w)
                # whoever was behind this waiter may be admissible now
                # (including after a timeout or an async interrupt)
                self._cv.notify_all()
            st.running += 1
            st.peak_running = max(st.peak_running, st.running)
            st.admitted += 1
            self._vclock = max(self._vclock, w.stamp)
            self._running_total += 1
        queued_s = time.monotonic() - t0
        REGISTRY.counter("tenant.admitted").add()
        REGISTRY.counter(f"tenant.admitted.{mname}").add()
        if waited:
            REGISTRY.counter("tenant.queued").add()
            REGISTRY.counter(f"tenant.queued.{mname}").add()
            REGISTRY.histogram("tenant.queued_s").add(queued_s)
        return tenant

    def release(self, token: str) -> None:
        with self._cv:
            st = self._states.get(token)
            if st is not None and st.running > 0:
                st.running -= 1
                self._running_total -= 1
            self._cv.notify_all()

    @contextmanager
    def slot(self, tenant: str, timeout_s: Optional[float] = None):
        token = self.acquire(tenant, timeout_s)
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.release(token)
            # slot occupancy feeds the EWMA drain estimator (failed
            # queries included: they occupied the slot all the same)
            self.cost_ewma.update(time.monotonic() - t0)

    def kick(self) -> None:
        """Re-check blocked waiters (wired to memory-pool releases so
        byte-quota blocks clear as soon as reservations drop)."""
        with self._cv:
            self._cv.notify_all()

    def close(self) -> None:
        """Detach from the pool (idempotent): unregister the release
        listener so a retired scheduler is collectable and pool
        releases stop paying for it."""
        if (self._pool is not None and self._pool_listener is not None
                and hasattr(self._pool, "remove_release_listener")):
            self._pool.remove_release_listener(self._pool_listener)
        self._pool_listener = None

    # ---- observability ---------------------------------------------------
    def queue_depth(self) -> int:
        """Waiters currently queued for a slot — the admission-queue
        growth signal the health watchdog samples."""
        with self._cv:
            return len(self._waiters)

    def slo_overrides(self) -> "dict[str, tuple]":
        """Per-tenant SLO objective overrides for the SloTracker:
        ``{tenant: (latency_s | None, freshness_s | None)}`` for every
        registered tenant that declares at least one objective."""
        with self._cv:
            return {name: (spec.slo_latency_s, spec.slo_freshness_s)
                    for name, spec in self._specs.items()
                    if spec.slo_latency_s is not None
                    or spec.slo_freshness_s is not None}

    def describe(self) -> str:
        with self._cv:
            return (f"{self._running_total} running, "
                    f"{len(self._waiters)} queued across "
                    f"{len(self._specs)} tenants")

    def snapshot(self) -> "list[dict]":
        """One row per registered tenant (the ``system.tenants``
        backing store), internally consistent under one lock."""
        with self._cv:
            queued = {}
            for w in self._waiters:
                queued[w.tenant] = queued.get(w.tenant, 0) + 1
            rows = []
            for name, spec in sorted(self._specs.items()):
                st = self._states[name]
                rows.append({
                    "tenant": name,
                    "weight": spec.weight,
                    "max_concurrent": (-1 if spec.max_concurrent is None
                                       else spec.max_concurrent),
                    "max_bytes": (-1 if spec.max_bytes is None
                                  else spec.max_bytes),
                    "running": st.running,
                    "peak_running": st.peak_running,
                    "queued": queued.get(name, 0),
                    "admitted": st.admitted,
                    "over_quota_blocked": st.over_quota_blocked,
                    "queue_timeouts": st.queue_timeouts,
                    "reserved_bytes": self._tenant_bytes(name),
                    "vtime": st.vtime,
                })
            return rows
