"""Serving-tier health: tenant SLOs and the anomaly watchdog.

Counterpart of ``presto_tpu/runtime/health.py``:

- ``SloTracker``: per-tenant latency and freshness objectives with
  rolling-window burn rates (the breach fraction over the window).
  ``QueryManager._observe_slo`` records each executed query's latency
  into the tracker attached as ``session.slo`` (a failure is a breach).
  ``system.slo`` lists it; counters ``slo.good`` / ``slo.breach`` (and
  per tenant and kind).
- ``HealthMonitor``: a background watchdog sampling qps, p50 / p99,
  admission-queue depth, pool occupancy, executable-cache hit rate,
  subscription freshness lag and SLO burn into a bounded ring
  (``system.health``), each sample held against a trailing baseline. A
  breach (p99 regression, queue growth, SLO burn, stale lag) fires
  ``health.breach`` and a flight-recorder capture of the worst in-flight
  query; a latch and a cooldown make one sustained incident one breach.
  ``sample()`` is the whole cadence step, public so tests drive it
  without the thread. The scheduler and the subscriptions are None until
  the server is ported.

Every monitor registers in a module-level weak set
(``live_monitors()``), so a test can assert that no watchdog thread
outlives it: a test that starts one closes it.
"""

from __future__ import annotations

import re
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional

from presto_tpu_torch.runtime.metrics import REGISTRY

_NAME_RE = re.compile(r"[^A-Za-z0-9_]")

#: reasons a sample can breach, in report-priority order
BREACH_REASONS = ("p99", "queue", "burn", "stale")


def _metric_name(name: str) -> str:
    return _NAME_RE.sub("_", name) or "_"


def _pctl(values: "list[float]", q: float) -> float:
    """Nearest-rank percentile of an unsorted list (0.0 when empty)."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


# ---------------------------------------------------------------------------
# tenant SLOs
# ---------------------------------------------------------------------------

class _SloState:
    __slots__ = ("latency_objective_s", "freshness_objective_s",
                 "latency_window", "freshness_window",
                 "latency_good", "latency_breach",
                 "freshness_good", "freshness_breach")

    def __init__(self, latency_objective_s, freshness_objective_s, window):
        self.latency_objective_s = latency_objective_s
        self.freshness_objective_s = freshness_objective_s
        self.latency_window = deque(maxlen=window)
        self.freshness_window = deque(maxlen=window)
        self.latency_good = 0
        self.latency_breach = 0
        self.freshness_good = 0
        self.freshness_breach = 0


class SloTracker:
    """Per-tenant service objectives with rolling burn rates.

    ``burn rate`` is the breach fraction over the rolling window
    (0.0 = every observation met its objective, 1.0 = none did) —
    the multiplier an error-budget alert would page on.
    """

    def __init__(self, latency_objective_s: float = 1.0,
                 freshness_objective_s: float = 10.0,
                 window: int = 256,
                 overrides: "Optional[dict]" = None):
        self._lock = threading.Lock()
        self.latency_objective_s = float(latency_objective_s)
        self.freshness_objective_s = float(freshness_objective_s)
        self.window = max(1, int(window))
        #: tenant -> (latency_objective_s | None, freshness_objective_s
        #: | None); None falls through to the tracker-wide default
        self._overrides = dict(overrides or {})
        self._tenants: "dict[str, _SloState]" = {}

    def _state_locked(self, tenant: str) -> _SloState:
        st = self._tenants.get(tenant)
        if st is None:
            lat, fresh = self._overrides.get(tenant, (None, None))
            st = self._tenants[tenant] = _SloState(
                self.latency_objective_s if lat is None else float(lat),
                self.freshness_objective_s if fresh is None else float(fresh),
                self.window)
        return st

    def observe_latency(self, tenant: str, seconds: float) -> None:
        tenant = tenant or "default"
        with self._lock:
            st = self._state_locked(tenant)
            good = seconds <= st.latency_objective_s
            st.latency_window.append(good)
            if good:
                st.latency_good += 1
            else:
                st.latency_breach += 1
        kind = "good" if good else "breach"
        REGISTRY.counter(f"slo.{kind}").add()
        REGISTRY.counter(f"slo.latency_{kind}.{_metric_name(tenant)}").add()

    def observe_freshness(self, tenant: str, lag_s: float) -> None:
        tenant = tenant or "default"
        with self._lock:
            st = self._state_locked(tenant)
            good = lag_s <= st.freshness_objective_s
            st.freshness_window.append(good)
            if good:
                st.freshness_good += 1
            else:
                st.freshness_breach += 1
        kind = "good" if good else "breach"
        REGISTRY.counter(f"slo.{kind}").add()
        REGISTRY.counter(f"slo.freshness_{kind}.{_metric_name(tenant)}").add()

    @staticmethod
    def _burn(window: deque) -> float:
        if not window:
            return 0.0
        return 1.0 - (sum(1 for g in window if g) / len(window))

    def burn_rate(self, tenant: Optional[str] = None) -> float:
        """Worst rolling breach fraction across latency+freshness for
        ``tenant`` (or across all tenants when ``None``)."""
        with self._lock:
            states = ([self._tenants[tenant]]
                      if tenant in self._tenants
                      else list(self._tenants.values())
                      if tenant is None else [])
            worst = 0.0
            for st in states:
                worst = max(worst, self._burn(st.latency_window),
                            self._burn(st.freshness_window))
            return worst

    def snapshot(self) -> "list[dict]":
        """One row per tenant (the ``system.slo`` backing store)."""
        with self._lock:
            rows = []
            for name in sorted(self._tenants):
                st = self._tenants[name]
                rows.append({
                    "tenant": name,
                    "latency_objective_s": st.latency_objective_s,
                    "freshness_objective_s": st.freshness_objective_s,
                    "latency_good": st.latency_good,
                    "latency_breach": st.latency_breach,
                    "freshness_good": st.freshness_good,
                    "freshness_breach": st.freshness_breach,
                    "latency_burn_rate": self._burn(st.latency_window),
                    "freshness_burn_rate": self._burn(st.freshness_window),
                })
            return rows

    def gauges(self) -> dict:
        out = {}
        for row in self.snapshot():
            t = _metric_name(row["tenant"])
            out[f"slo.latency_burn_rate.{t}"] = row["latency_burn_rate"]
            out[f"slo.freshness_burn_rate.{t}"] = row["freshness_burn_rate"]
        return out


# ---------------------------------------------------------------------------
# anomaly watchdog
# ---------------------------------------------------------------------------

#: every constructed monitor, weakly held — ``live_monitors()`` is the
#: thread-leak guard of the tests
_MONITORS: "weakref.WeakSet" = weakref.WeakSet()


def live_monitors() -> "list[HealthMonitor]":
    """Monitors whose watchdog thread is still running (tests assert
    this is empty after each test)."""
    return [m for m in list(_MONITORS) if m.running()]


class HealthMonitor:
    """Background anomaly watchdog over one session's serving state.

    ``sample()`` is the whole cadence step — collect one snapshot,
    ring-buffer it, compare against the trailing baseline, fire on
    breach — and is public so tests (and the tier-1 gate) can drive
    detection deterministically without the thread.

    Breach semantics: a latch arms on a clean sample and a breach
    disarms it, so one sustained incident produces exactly one
    ``health_breach`` (plus a cooldown guarding re-arm flapping).
    On breach the worst in-flight query (longest elapsed, from the
    lifecycle's in-flight registry) is captured into the flight
    recorder under the ``health_breach`` trigger with its own live
    tracer — the slow query's post-mortem, not the watchdog's.
    """

    def __init__(self, session, scheduler=None, subscriptions=None,
                 interval_s: float = 0.25, ring: int = 128,
                 baseline_window: int = 8, min_samples: int = 3,
                 p99_factor: float = 3.0, queue_limit: int = 64,
                 burn_limit: float = 0.5, stale_lag_s: float = 30.0,
                 cooldown_s: float = 5.0,
                 on_breach: "Optional[Callable[[dict], None]]" = None):
        self.session = session
        self.scheduler = scheduler
        self.subscriptions = subscriptions
        self.interval_s = max(0.01, float(interval_s))
        self.baseline_window = max(1, int(baseline_window))
        self.min_samples = max(1, int(min_samples))
        self.p99_factor = float(p99_factor)
        self.queue_limit = int(queue_limit)
        self.burn_limit = float(burn_limit)
        self.stale_lag_s = float(stale_lag_s)
        self.cooldown_s = float(cooldown_s)
        self.on_breach = on_breach
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=max(4, int(ring)))
        self._breaches: "deque[dict]" = deque(maxlen=32)
        self._armed = True
        self._last_breach_mono: Optional[float] = None
        self._last_query_count = 0.0
        self._last_sample_mono: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _MONITORS.add(self)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "HealthMonitor":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="presto-tpu-torch-health", daemon=True)
                self._thread.start()
        return self

    def close(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
        with self._lock:
            self._thread = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                REGISTRY.counter("health.sample_errors").add()

    # ---- collection ------------------------------------------------------
    def _collect(self) -> dict:
        now = time.monotonic()
        snap = REGISTRY.snapshot()
        completed = float(snap.get("query.execution_s.count", 0.0))
        dt = (None if self._last_sample_mono is None
              else max(1e-9, now - self._last_sample_mono))
        qps = 0.0 if dt is None else max(
            0.0, completed - self._last_query_count) / dt
        self._last_query_count = completed
        self._last_sample_mono = now

        laten = [i.execution_s for i in self.session.history.infos()[-64:]
                 if i.execution_s > 0]
        pool = self.session.pool().snapshot()
        cap = pool.get("capacity_bytes") or 0
        occ = (pool.get("reserved_bytes", 0) / cap) if cap else 0.0
        hits = float(snap.get("exec_cache.hit", 0.0))
        misses = float(snap.get("exec_cache.miss", 0.0))
        hit_rate = hits / (hits + misses) if (hits + misses) else 0.0
        depth = 0
        if self.scheduler is not None:
            try:
                depth = int(self.scheduler.queue_depth())
            except Exception:  # noqa: BLE001
                depth = 0
        lag = 0.0
        if self.subscriptions is not None:
            try:
                lag = float(self.subscriptions.max_lag_s())
            except Exception:  # noqa: BLE001
                lag = 0.0
        slo = getattr(self.session, "slo", None)
        burn = slo.burn_rate() if slo is not None else 0.0
        return {
            "ts": time.time(),
            "qps": qps,
            "p50_s": _pctl(laten, 0.50),
            "p99_s": _pctl(laten, 0.99),
            "queue_depth": depth,
            "pool_occupancy": occ,
            "cache_hit_rate": hit_rate,
            "freshness_lag_s": lag,
            "slo_burn": burn,
            "breach": 0,
            "reason": "",
        }

    # ---- detection -------------------------------------------------------
    def _baseline_p99_locked(self) -> "tuple[float, int]":
        """Median p99 over the trailing ``baseline_window`` ring
        entries that actually observed latencies (>0), plus how many
        such entries back it."""
        recent = [r["p99_s"] for r in list(self._ring)[-self.baseline_window:]
                  if r["p99_s"] > 0]
        if not recent:
            return 0.0, 0
        return _pctl(recent, 0.5), len(recent)

    def _reasons(self, cur: dict, baseline_p99: float, support: int) -> list:
        reasons = []
        if (support >= self.min_samples and baseline_p99 > 0
                and cur["p99_s"] > self.p99_factor * baseline_p99):
            reasons.append("p99")
        if cur["queue_depth"] > self.queue_limit:
            reasons.append("queue")
        if cur["slo_burn"] > self.burn_limit:
            reasons.append("burn")
        if cur["freshness_lag_s"] > self.stale_lag_s:
            reasons.append("stale")
        return reasons

    def sample(self) -> dict:
        """One watchdog cadence step; returns the recorded snapshot."""
        cur = self._collect()
        with self._lock:
            baseline_p99, support = self._baseline_p99_locked()
            reasons = self._reasons(cur, baseline_p99, support)
            fire = False
            now = time.monotonic()
            if reasons:
                cooled = (self._last_breach_mono is None
                          or now - self._last_breach_mono >= self.cooldown_s)
                if self._armed and cooled:
                    fire = True
                    self._armed = False
                    self._last_breach_mono = now
                    cur["breach"] = 1
                    cur["reason"] = ",".join(reasons)
            else:
                # a clean sample re-arms the latch: the NEXT incident
                # is a new breach, the same one never double-fires
                self._armed = True
            self._ring.append(cur)
            if fire:
                event = dict(cur)
                event["baseline_p99_s"] = baseline_p99
                self._breaches.append(event)
        if fire:
            REGISTRY.counter("health.breach").add()
            for r in reasons:
                REGISTRY.counter(f"health.breach.{r}").add()
            self._capture_worst_inflight(event)
            if self.on_breach is not None:
                try:
                    self.on_breach(event)
                except Exception:  # noqa: BLE001
                    REGISTRY.counter("health.sample_errors").add()
        return cur

    def _capture_worst_inflight(self, event: dict) -> None:
        """Flight-record the longest-running in-flight query under the
        ``health_breach`` trigger — the post-mortem a slow-but-green
        incident would otherwise never leave."""
        manager = getattr(self.session, "query_manager", None)
        inflight = manager.inflight_snapshot() if manager is not None else []
        if not inflight:
            REGISTRY.counter("health.breach_no_inflight").add()
            return
        worst = max(inflight, key=lambda e: e["info"].elapsed_s)
        event["query_id"] = worst["info"].query_id
        try:
            self.session.flight.capture(
                worst["info"], worst["plan"], self.session,
                executor=worst["executor"], err=None,
                triggers=("health_breach",), tracer=worst["tracer"])
        except Exception:  # noqa: BLE001 — capture is best-effort
            REGISTRY.counter("flight.capture_errors").add()

    # ---- observability ---------------------------------------------------
    def snapshot(self) -> "list[dict]":
        """Ring contents, oldest first (the ``system.health`` backing
        store)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def breaches(self) -> "list[dict]":
        with self._lock:
            return [dict(b) for b in self._breaches]

    def gauges(self) -> dict:
        with self._lock:
            last = self._ring[-1] if self._ring else None
            n_breach = len(self._breaches)
        out = {"health.ring_depth": float(len(self._ring)),
               "health.breaches": float(n_breach)}
        if last is not None:
            out["health.qps"] = last["qps"]
            out["health.p99_s"] = last["p99_s"]
            out["health.queue_depth"] = float(last["queue_depth"])
            out["health.freshness_lag_s"] = last["freshness_lag_s"]
            out["health.slo_burn"] = last["slo_burn"]
        return out
