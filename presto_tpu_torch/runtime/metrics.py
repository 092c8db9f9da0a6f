"""Process-wide metrics registry.

Counterpart of ``presto_tpu/runtime/metrics.py``, whole: a flat
registry of named counters (``CounterStat``), timers (``TimeStat``) and
fixed-bucket histograms (``HistogramStat``, p50/p95/p99 in snapshots),
snapshot-able as a dict and exportable as OpenMetrics/Prometheus text
(:func:`to_openmetrics`, surfaced by ``Session.export_metrics``). The
family names, bucket bounds and ``METRIC_HELP`` are the JAX package's,
so the exposition of equal registries is byte-identical.

Every value is a Python number added on the host: a call site never
adds a tensor (a ``.item()`` per batch would be a device sync per
batch).

Thread safety: event listeners and prefetch workers may bump stats off
the query's thread, so every ``add`` is atomic under a per-stat lock
(the registry lock only guards map creation).

Per-query attribution: :class:`QueryMetricsDelta` rides a
``ContextVar`` around each query's run, and every stat ``add`` ALSO
lands in the collector of the context it ran under, so concurrent
queries on separate threads never bleed into each other's
deltas. Adds from threads outside any query context (the scan prefetch
worker runs its loads with the delta cleared, as the JAX package's
worker sees none) update only the global stat; attribution is
observed on the query's own thread by design.
"""

from __future__ import annotations

import bisect
import threading
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Optional


_DELTA: ContextVar[Optional["QueryMetricsDelta"]] = ContextVar(
    "presto_tpu_torch_metrics_delta", default=None
)


class QueryMetricsDelta:
    """A query-scoped view of every stat moved while this collector was
    installed (``install_delta``/``uninstall_delta``). Counters land
    under their plain name; timers under ``name.count``/``name.total_s``;
    histograms under ``name.count``/``name.total`` — the same key shapes
    ``MetricsRegistry.snapshot`` uses, so delta dicts and snapshot
    diffs read identically. Locked: event listeners may add from a
    thread that inherited the query's context."""

    __slots__ = ("_vals", "_lock")

    def __init__(self):
        self._vals: dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, name: str, v: float) -> None:
        with self._lock:
            self._vals[name] = self._vals.get(name, 0.0) + v

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._vals)


def install_delta(collector: Optional[QueryMetricsDelta]):
    """Install ``collector`` as the context's delta sink; returns the
    reset token (nested queries from event listeners install their own
    and restore the outer one on exit)."""
    return _DELTA.set(collector)


def uninstall_delta(token) -> None:
    _DELTA.reset(token)


def current_delta() -> Optional[QueryMetricsDelta]:
    return _DELTA.get()


@dataclass
class CounterStat:
    name: str
    total: float = 0.0
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, v: float = 1.0):
        with self._lock:
            self.total += v
        d = _DELTA.get()
        if d is not None:
            d.add(self.name, v)


@dataclass
class TimeStat:
    """Wall-time accumulator with count/total/min/max (the digest role
    of Airlift's TimeStat, without decaying percentiles)."""

    name: str
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, seconds: float):
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.min_s = min(self.min_s, seconds)
            self.max_s = max(self.max_s, seconds)
        d = _DELTA.get()
        if d is not None:
            d.add(self.name + ".count", 1.0)
            d.add(self.name + ".total_s", seconds)

    def time(self):
        return _Timer(self)


#: default histogram bucket upper bounds: geometric, 10us..100s in
#: quarter-decade steps (wall times of everything from a span append to
#: a cold distributed compile land inside; the last bucket is +inf)
DEFAULT_BOUNDS = tuple(10.0 ** (-5 + i * 0.25) for i in range(29))

#: ratio-shaped bounds for fraction metrics (selectivities, hit rates):
#: values live on [0, 1], where the latency buckets would dump
#: everything below 1.0 into two cells and destroy the percentiles
SELECTIVITY_BOUNDS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)

#: ratio-shaped bounds for the exchange-skew histogram: max/mean
#: delivered rows per destination lives on [1, mesh size] (1 =
#: balanced, P = one hot partition owns everything) — latency buckets
#: would crush the whole range into two cells
SKEW_BOUNDS = (1.0, 1.1, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0,
               16.0, 32.0)

#: per-metric bucket shapes — THE place a histogram's boundary choice
#: lives. ``MetricsRegistry.histogram(name)`` resolves bounds here, so
#: every call site of a named metric agrees by construction (bounds are
#: fixed at first creation; a second caller passing different explicit
#: bounds would silently get the first shape). Latency-shaped
#: DEFAULT_BOUNDS is the fallback for everything unlisted.
HISTOGRAM_BOUNDS: dict[str, tuple] = {
    "join.filter_selectivity": SELECTIVITY_BOUNDS,
    "exchange.skew": SKEW_BOUNDS,
    "spill.resident_fraction": SELECTIVITY_BOUNDS,
}


class HistogramStat:
    """Fixed-bucket histogram with percentile snapshots.

    Values land in the first bucket whose upper bound is >= v (the last
    bucket is unbounded). Percentiles report the matched bucket's upper
    bound — a conservative (never under-reporting) estimate; the exact
    observed max is tracked separately.
    """

    __slots__ = ("name", "bounds", "counts", "count", "total", "max",
                 "_lock")

    def __init__(self, name: str, bounds: tuple = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def add(self, v: float):
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += v
            if v > self.max:
                self.max = v
        d = _DELTA.get()
        if d is not None:
            d.add(self.name + ".count", 1.0)
            d.add(self.name + ".total", v)

    def time(self):
        return _Timer(self)

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0 when
        empty; the exact max for the overflow bucket)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def snapshot_into(self, out: dict) -> None:
        out[self.name + ".count"] = float(self.count)
        out[self.name + ".total"] = self.total
        if self.count:
            out[self.name + ".p50"] = self.quantile(0.50)
            out[self.name + ".p95"] = self.quantile(0.95)
            out[self.name + ".p99"] = self.quantile(0.99)
            out[self.name + ".max"] = self.max


class _Timer:
    def __init__(self, stat):
        self.stat = stat

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stat.add(time.perf_counter() - self.t0)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, CounterStat] = {}
        self.timers: dict[str, TimeStat] = {}
        self.histograms: dict[str, HistogramStat] = {}

    def counter(self, name: str) -> CounterStat:
        with self._lock:
            if name not in self.counters:
                self.counters[name] = CounterStat(name)
            return self.counters[name]

    def timer(self, name: str) -> TimeStat:
        with self._lock:
            if name not in self.timers:
                self.timers[name] = TimeStat(name)
            return self.timers[name]

    def histogram(self, name: str,
                  bounds: Optional[tuple] = None) -> HistogramStat:
        """``bounds=None`` resolves the metric's registered shape from
        ``HISTOGRAM_BOUNDS`` (latency-shaped default) — call sites of a
        named metric need not, and should not, repeat its boundaries."""
        with self._lock:
            if name not in self.histograms:
                if bounds is None:
                    bounds = HISTOGRAM_BOUNDS.get(name, DEFAULT_BOUNDS)
                self.histograms[name] = HistogramStat(name, bounds)
            return self.histograms[name]

    def reset(self) -> None:
        """Drop every stat (test isolation; live handles from before a
        reset keep counting into detached objects, so re-fetch by name
        after resetting)."""
        with self._lock:
            self.counters.clear()
            self.timers.clear()
            self.histograms.clear()

    def snapshot(self) -> dict:
        out: dict[str, float] = {}
        for c in self.counters.values():
            out[c.name] = c.total
        for t in self.timers.values():
            out[t.name + ".count"] = float(t.count)
            out[t.name + ".total_s"] = t.total_s
            if t.count:
                out[t.name + ".min_s"] = t.min_s
                out[t.name + ".max_s"] = t.max_s
        for h in self.histograms.values():
            h.snapshot_into(out)
        return out


#: the process registry (reference: the JMX MBean server)
REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# OpenMetrics / Prometheus text exposition
# ---------------------------------------------------------------------------

#: metric-name prefix in the exposition (the reference's JMX beans map
#: to a prometheus-jmx namespace the same way)
EXPOSITION_PREFIX = "presto_tpu_"


def _metric_name(name: str) -> str:
    """Engine metric name -> exposition family name: dots and dashes
    become underscores (the only characters our names use outside
    ``[a-zA-Z0-9_]``)."""
    return EXPOSITION_PREFIX + name.replace(".", "_").replace("-", "_")


def _fmt(v: float) -> str:
    """Canonical sample value: integral floats print as integers
    (OpenMetrics allows either; stable text diffs nicely)."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


#: ``# HELP`` text per exposition family (post-prefix engine names).
#: EVERY literal family the engine fires has an entry — enforced by
#: tests/test_health.py's completeness check, which greps the source
#: for literal ``REGISTRY.counter/timer/histogram("...")`` names.
#: Dynamically-suffixed families (f-string names: per-tenant, per-
#: trigger, per-reason, per-device) stay HELP-less (OpenMetrics
#: allows it) — their prefix documents them here via the base family.
METRIC_HELP: dict[str, str] = {
    # ---- aggregation strategy picks
    "agg.strategy.bypass": (
        "aggregations answered straight from incremental table stats "
        "(no scan dispatched)"),
    "agg.strategy.fused": "aggregations fused into the scan kernel",
    "agg.strategy.partial": (
        "aggregations executed partial-per-fragment then merged"),
    "agg.strategy.single": (
        "aggregations executed single-stage on gathered rows"),
    # ---- cross-query batched dispatch (server/batcher.py)
    "batch.dispatched": "vmapped cross-query batch dispatches",
    "batch.fallback": (
        "batch members served by per-query fallback instead of the "
        "vmapped program (reasons: batch.fallback.*)"),
    "batch.fallback.distributed": (
        "batch fallbacks because the template planned distributed"),
    "batch.fallback.error": (
        "batch fallbacks because the vmapped dispatch raised"),
    "batch.gate_timeout": (
        "batch-gate waits that timed out and ran solo"),
    "batch.queries": "queries that entered the template batch gate",
    "batch.served": (
        "queries served a result from a cross-query batched dispatch"),
    "batch.size": "lanes per dispatched cross-query batch",
    "batch.trimmed": (
        "batch members trimmed because the gate filled past the "
        "vmap width"),
    # ---- caches
    "cache.result_lookup_s": "result-cache lookup latency",
    "exec_cache.evicted": "compiled-executable cache evictions",
    "exec_cache.hit": "compiled-executable cache hits",
    "exec_cache.miss": "compiled-executable cache misses",
    "exec_cache.uncacheable": (
        "executables not cached (non-hashable or oversized keys)"),
    "result_cache.evicted": "result-cache evictions",
    "result_cache.hit": "result-cache hits (no execution dispatched)",
    "result_cache.invalidated": (
        "result-cache entries dropped by DDL/version invalidation"),
    "result_cache.miss": "result-cache misses",
    "result_cache.populated": "result-cache entries populated",
    "result_cache.skipped": (
        "result-cache lookups skipped (volatile scans or caching off)"),
    "result_cache.uncacheable": (
        "results not cached (oversized or non-deterministic)"),
    "stats_cache.hit": "incremental table-stats cache hits",
    "stats_cache.miss": "incremental table-stats cache misses",
    "joinkeys.minmax_memo_hits": (
        "join-key min/max pruning memo hits (plan_stats-backed)"),
    # ---- events / listeners
    "events.listener_errors": (
        "query-event listener callbacks that raised (isolated; the "
        "query is unaffected)"),
    # ---- exchange
    "exchange.bytes": "bytes moved through partitioned exchanges",
    "exchange.dispatch_s": "partitioned-exchange dispatch latency",
    "exchange.dispatches": "partitioned-exchange dispatches",
    "exchange.rounds": "exchange rounds executed",
    "exchange.skew": (
        "max/mean delivered-rows-per-destination ratio of each "
        "partitioned exchange (1 = balanced)"),
    "exchange.quota_overflow": (
        "exchanges whose receive capacity overflowed (the hot "
        "partition id rides the trace span and flight record)"),
    # ---- executor routes
    "exec.leaf_fused_route": (
        "leaf fragments routed through the fused scan kernel"),
    "exec.leaf_route_fallback": (
        "leaf fused-route bailouts to the general path (reasons: "
        "exec.leaf_route_fallback.*)"),
    "exec.pallas_join_route": "joins routed through the Pallas kernel",
    "exec.q1_fused_route": (
        "aggregation queries routed through the fused Q1-shape kernel"),
    "exec.q1_route_fallback": (
        "Q1-shape route bailouts to the general aggregation path"),
    "exec.traces": "actual jit traces executed (the no-retrace probe)",
    "exec.trace_errors": (
        "best-effort trace/observability plumbing failures (the "
        "query is unaffected)"),
    # ---- flight recorder
    "flight.captured": "flight-recorder post-mortems captured",
    "flight.capture_errors": (
        "flight-recorder captures that failed (capture is best-effort; "
        "the query is unaffected)"),
    # ---- fragments / lifecycle
    "fragment.dispatch_s": "per-fragment dispatch latency",
    "fragment.retried": "fragment dispatches retried after failure",
    "query.admission_rejected": (
        "queries rejected at memory-pool admission"),
    "query.backend_oom": "backend out-of-memory errors observed",
    "query.completed": "queries reaching a terminal state",
    "query.deadline_exceeded": (
        "queries killed by query_max_run_time"),
    "query.degraded_to_local": (
        "distributed plans degraded to local execution"),
    "query.execution_s": "query execution latency (admitted -> done)",
    "query.failed": "queries reaching FAILED",
    "query.oom_degraded": (
        "queries that finished only after OOM-ladder degradation"),
    "query.retried": "whole-query retries",
    "query.started": "queries admitted to execution",
    # ---- health watchdog / SLOs (runtime/health.py)
    "health.breach": (
        "health-watchdog breaches fired (each arms the flight "
        "recorder; reasons: health.breach.*)"),
    "health.breach_no_inflight": (
        "health breaches with no in-flight query to capture"),
    "health.sample_errors": (
        "health-watchdog sampling passes that raised (isolated)"),
    "slo.good": "SLO observations within objective (all tenants)",
    "slo.breach": "SLO observations over objective (all tenants)",
    # ---- join strategy
    "join.filter_rows_in": (
        "probe rows entering join-pushdown filters"),
    "join.filter_rows_pruned": (
        "probe rows pruned by join-pushdown filters"),
    "join.filter_selectivity": (
        "observed selectivity of join-pushdown filters"),
    "join.pallas_fallback": (
        "Pallas join routes that fell back to the general kernel"),
    # ---- memory pool
    "memory.queue_timeouts": (
        "pool admissions that timed out waiting for capacity"),
    "memory.queued": "pool admissions that had to queue",
    "memory.queued_s": "time spent queued for pool capacity",
    "memory.rejected": "pool reservations rejected outright",
    "memory.released": "pool reservations released",
    "memory.reserved": "pool reservations granted",
    # ---- adaptive execution (plan/adaptive.py)
    "adaptive.salted": (
        "repartition joins rewritten with skew salting (hot "
        "destination split across S salted partitions, matching "
        "build rows replicated)"),
    "adaptive.join_flip": (
        "join builds re-sized from recorded actuals (grouped vs "
        "in-memory re-decided from history, not the static estimate)"),
    "adaptive.bucket_override": (
        "grouped aggregations re-sized from recorded actuals "
        "(bucket counts from history, not the static estimate)"),
    "adaptive.route_disabled": (
        "fused (Pallas) join routes disabled because the "
        "fingerprint's route fell back at runtime (lying stats)"),
    "adaptive.compile_budget_refused": (
        "adaptive re-specializations refused because predicted "
        "compile cost exceeded predicted win at the observed "
        "recurrence rate"),
    "adaptive.stand_down": (
        "adaptive decision passes suppressed under an active fault "
        "injector or success-capture recorder (baseline plans only)"),
    "adaptive.warmed": (
        "top-K templates background-warmed by the serving layer so "
        "adaptivity never injects a cold compile into steady state"),
    # ---- plan stats
    "plan_stats.evicted": "plan-stats fingerprints evicted",
    "plan_stats.invalidated": (
        "plan-stats fingerprints dropped by DDL/version invalidation"),
    "plan_stats.record_errors": (
        "plan-stats recording failures (isolated)"),
    "plan_stats.recorded": "plan-stats runs recorded",
    "plan_stats.imported": (
        "plan-stats entries imported from a previous run's export "
        "(Session.import_plan_stats — adaptivity warm restart)"),
    "plan_stats.import_stale": (
        "imported plan-stats entries skipped because their recorded "
        "table versions no longer match the catalog"),
    # ---- prepared statements / templates
    "prepare.coalesced": (
        "executions coalesced onto an identical in-flight run"),
    "prepare.slot_ineligible": (
        "literals not auto-templated into binding slots (reasons: "
        "prepare.slot_ineligible.*)"),
    "prepare.slots_bound": "template binding slots bound per execution",
    "prepare.template_hit": (
        "executions whose plan template was already compiled-warm"),
    "prepare.template_queued": (
        "executions that waited at the template batch gate"),
    # ---- scan
    "scan.splits_sampled_out": (
        "table-scan splits skipped by approx-mode sampled scans "
        "(approx_scan_fraction < 1; results flagged approximate)"),
    # ---- serving front-end
    "server.failed": "submitted statements reaching FAILED",
    "server.shutdowns": "server shutdown/drain sequences run",
    "server.started": "HTTP front-ends started",
    "server.submit_rejected": (
        "statement submissions rejected by the submit_limit "
        "backpressure bound"),
    "server.submitted": "statements accepted via submit()",
    "tenant.admitted": "fair-scheduler slot admissions (all tenants)",
    "tenant.over_quota_blocked": (
        "admissions blocked on a tenant byte/concurrency quota"),
    "tenant.overflow": (
        "walk-in tenant names pooled into the __overflow__ lane "
        "(max_tenants cardinality bound)"),
    "tenant.queue_timeouts": "fair-queue waits that timed out",
    "tenant.queued": "admissions that had to queue (all tenants)",
    "tenant.queued_s": "time spent queued in the fair scheduler",
    # ---- trace
    "trace.spans_dropped": (
        "spans dropped by per-query recorder ring bounds"),
    # ---- live gauges (exported via Session.export_metrics)
    "memory_pool_reserved_bytes": (
        "bytes currently reserved from the session's memory pool"),
    "memory_pool_capacity_bytes": "capacity of the session's memory pool",
    "memory_pool_occupancy": (
        "reserved/capacity fraction of the session's memory pool"),
    "exec_cache_entries": (
        "entries in the process-wide compiled-executable cache "
        "(ledger: system.exec_cache)"),
    "flight_recorder_depth": (
        "post-mortem records currently retained in the session's "
        "flight-recorder ring"),
    "health.ring_depth": "samples in the health watchdog's vitals ring",
    "health.breaches": "breach events retained by the health watchdog",
    "health.qps": "last-sampled completed-queries-per-second",
    "health.p99_s": "last-sampled p99 execution latency",
    "health.queue_depth": "last-sampled admission-queue depth",
    "health.freshness_lag_s": (
        "last-sampled worst subscription delivery lag"),
    "health.slo_burn": "last-sampled worst tenant SLO burn rate",
    "spill.planned_hybrid": (
        "joins/aggregations planned as hybrid spill (hot partitions "
        "device-resident, cold ones streamed from host)"),
    "spill.planned_grouped": (
        "joins/aggregations planned as fully-grouped spill (no "
        "resident partitions)"),
    "spill.partitions_resident": (
        "build partitions kept device-resident by hybrid spill plans"),
    "spill.partitions_streamed": (
        "build partitions streamed host->device by spill plans"),
    "spill.resident_fraction": (
        "resident/total partition fraction of each hybrid spill plan"),
    "spill.partition_overflow": (
        "cold spill partitions recursively re-partitioned because "
        "they exceeded the per-unit byte budget"),
    "spill.transfer_bytes": (
        "host->device bytes moved by the spill transfer pipeline"),
    "spill.host_rejected": (
        "host-spill reservations refused by spill_host_budget_bytes "
        "(typed SPILL_BUDGET_EXCEEDED failures)"),
    "stream.appends": (
        "micro-batch appends landed on streaming tables (each bumps "
        "the table's version epoch)"),
    "stream.rows": "rows ingested by micro-batch appends",
    "stream.dict_rebuilds": (
        "VARCHAR dictionary merges forced by appends introducing "
        "unseen values (old codes remapped in place)"),
    "stream.append_s": (
        "append latency: encode + incremental stats merge + publish"),
    "stream.tables_created": "streaming tables created",
    "subscription.fired": (
        "continuous-query refreshes delivered (initial, epoch-driven, "
        "and interval ticks — see subscription.trigger.*)"),
    "subscription.refresh_failed": (
        "continuous-query refreshes that failed (typed failures "
        "re-arm the fire; untyped ones fail the subscription)"),
    "subscription.stale_blocked": (
        "refresh results DROPPED because the executing session read a "
        "table version older than the fire-time epoch floor"),
    "subscription.drain_blocked": (
        "refreshes dropped because the server was draining "
        "(subscriptions stay active for a restarted server)"),
    "subscription.refresh_s": (
        "continuous-query refresh latency: fire decision -> result "
        "delivered to the subscription's ring"),
    "subscription.created": "continuous queries registered",
    "subscription.cancelled": "continuous queries cancelled",
    # ---- overload control (runtime/overload.py) ----
    "overload.shed": (
        "submissions refused at admission with the retryable "
        "SERVER_OVERLOADED (queue ceilings, EWMA drain estimate, or "
        "brown-out shed policy; per-cause split in overload."
        "shed_reason.*, per-tenant in overload.shed_tenant.*)"),
    "overload.shed_reason.brownout": (
        "submissions shed because the brown-out latch was engaged and "
        "the tenant's brownout policy is 'shed'"),
    "overload.retry_budget_exhausted": (
        "retries denied by the per-session retry token bucket / open "
        "circuit breaker (the caller fails fast with its original "
        "error instead of retrying)"),
    "overload.breaker_open": (
        "retry circuit breaker OPEN transitions (the token bucket "
        "drained — correlated failures outpaced the refill)"),
    "overload.breaker_probe": (
        "half-open probe retries granted after the breaker cooldown "
        "(exactly one in-flight probe at a time)"),
    "overload.breaker_rearm": (
        "breaker CLOSED transitions: a half-open probe succeeded, the "
        "token bucket refilled"),
    "cancel.requested": (
        "CancelScope flips (DELETE /v1/statement, Session.cancel, or "
        "the overload controller) — first flip per query only"),
    "cancel.observed": (
        "cancelled queries that reached a cooperative checkpoint and "
        "raised the typed QUERY_CANCELLED (first observation per "
        "query)"),
    "server.cancel_requests": (
        "cancel requests accepted by the serving layer for non-"
        "terminal submitted queries"),
    "brownout.engaged": (
        "brown-out latch engagements (health breach or operator "
        "force): eligible tenants' NEW traffic degrades per their "
        "TenantSpec.brownout policy"),
    "brownout.recovered": (
        "brown-out latch releases after a breach-free cooldown (or "
        "the operator clearing brownout_force)"),
    "brownout.approx_routed": (
        "submissions routed to the approximate tier by an engaged "
        "brown-out (flagged approximate on every poll page)"),
}


def _help_line(lines: list, engine_name: str, family: str) -> None:
    text = METRIC_HELP.get(engine_name)
    if text:
        lines.append(f"# HELP {family} {text}")


def to_openmetrics(registry: MetricsRegistry = None,
                   gauges: Optional[dict] = None) -> str:
    """The registry as OpenMetrics/Prometheus text exposition.

    - counters -> ``# TYPE f counter`` with one ``f_total`` sample;
    - timers -> ``# TYPE f_seconds summary`` (``_count``/``_sum``) plus
      ``f_seconds_min``/``_max`` gauges (TimeStat keeps no quantiles);
    - histograms -> ``# TYPE f summary`` with ``quantile`` labels
      (p50/p95/p99 — bucket upper bounds, conservative) plus
      ``_count``/``_sum`` and an ``f_max`` gauge;
    - ``gauges`` (name -> live value, e.g. memory-pool occupancy or
      cache entry counts — state a monotone counter cannot express)
      -> ``# TYPE f gauge`` with one sample each.

    Known families also carry a ``# HELP`` line (:data:`METRIC_HELP`).
    Families are emitted in sorted name order and the text ends with
    ``# EOF`` (the OpenMetrics terminator), so the output is both
    scrape-able and deterministic for golden tests.
    """
    reg = REGISTRY if registry is None else registry
    lines: list[str] = []
    for c in sorted(reg.counters.values(), key=lambda s: s.name):
        f = _metric_name(c.name)
        _help_line(lines, c.name, f)
        lines.append(f"# TYPE {f} counter")
        lines.append(f"{f}_total {_fmt(c.total)}")
    for t in sorted(reg.timers.values(), key=lambda s: s.name):
        f = _metric_name(t.name) + "_seconds"
        _help_line(lines, t.name, f)
        lines.append(f"# TYPE {f} summary")
        lines.append(f"{f}_count {_fmt(t.count)}")
        lines.append(f"{f}_sum {_fmt(t.total_s)}")
        if t.count:
            lines.append(f"# TYPE {f}_min gauge")
            lines.append(f"{f}_min {_fmt(t.min_s)}")
            lines.append(f"# TYPE {f}_max gauge")
            lines.append(f"{f}_max {_fmt(t.max_s)}")
    for h in sorted(reg.histograms.values(), key=lambda s: s.name):
        f = _metric_name(h.name)
        _help_line(lines, h.name, f)
        lines.append(f"# TYPE {f} summary")
        for q in (0.5, 0.95, 0.99):
            lines.append(f'{f}{{quantile="{q}"}} {_fmt(h.quantile(q))}')
        lines.append(f"{f}_count {_fmt(h.count)}")
        lines.append(f"{f}_sum {_fmt(h.total)}")
        if h.count:
            lines.append(f"# TYPE {f}_max gauge")
            lines.append(f"{f}_max {_fmt(h.max)}")
    for name in sorted(gauges or ()):
        f = _metric_name(name)
        _help_line(lines, name, f)
        lines.append(f"# TYPE {f} gauge")
        lines.append(f"{f} {_fmt(gauges[name])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
