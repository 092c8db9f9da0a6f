"""Session properties (the subset the ported slices read).

Counterpart of ``presto_tpu/runtime/properties.py``: typed, validated
per-session overrides of engine defaults, with the JAX package's names,
types and defaults. Unknown names are errors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from presto_tpu_torch.runtime.errors import UserError


@dataclass(frozen=True)
class PropertyDef:
    name: str
    py_type: type
    default: Any
    description: str
    #: extra constraint beyond the type (returns a problem string or None)
    check: Optional[Callable[[Any], Optional[str]]] = None

    def coerce(self, value):
        """Coerce a user-supplied value (possibly a SQL literal string,
        as ``SET SESSION`` passes it) to the property's type, as the JAX
        package does, then apply ``check``."""
        if value is None:
            return None
        try:
            if self.py_type is bool:
                if isinstance(value, bool):
                    v = value
                elif isinstance(value, str):
                    s = value.strip().lower()
                    if s in ("true", "1", "on", "yes"):
                        v = True
                    elif s in ("false", "0", "off", "no"):
                        v = False
                    else:
                        raise UserError(s)
                else:
                    v = bool(value)
            else:
                v = self.py_type(value)
        except (TypeError, ValueError):
            raise UserError(f"session property {self.name}: cannot interpret "
                            f"{value!r} as {self.py_type.__name__}") from None
        if self.check is not None:
            problem = self.check(v)
            if problem:
                raise UserError(f"session property {self.name}: {problem}")
        return v


def _positive(v):
    return None if v > 0 else f"must be positive, got {v}"


def _non_negative(v):
    return None if v >= 0 else f"must be >= 0, got {v}"


SESSION_PROPERTIES: dict[str, PropertyDef] = {
    d.name: d
    for d in [
        PropertyDef(
            "broadcast_join_row_limit", int, 1 << 21,
            "Join build sides with at most this many rows (a sound stats "
            "bound) take the broadcast distribution on a mesh session; the "
            "fragmenter (plan/fragmenter.py) and EXPLAIN (TYPE DISTRIBUTED) "
            "read it. 0 disables broadcast joins.",
            _non_negative),
        PropertyDef(
            "gather_row_limit", int, 1 << 22,
            "Guard on the distributed executor's replicate-everything "
            "fallbacks (the replicated sort, TopN and Limit): replicating "
            "more rows than this to every shard fails fast "
            "(exec/distributed.py).",
            _positive),
        PropertyDef(
            "join_build_budget_bytes", int, None,
            "Capacity planner: estimated join build sides (and keyed "
            "aggregation states) above this byte budget run out of core, "
            "planned hybrid or grouped with host-RAM offload "
            "(exec/spill.py). Default: a quarter of the device budget "
            "(runtime/memory.device_budget_bytes).",
            _positive),
        PropertyDef(
            "spill_host_budget_bytes", int, None,
            "Host-RAM byte budget for spilled partitions "
            "(exec/grouped.HostSpill): hybrid and grouped execution "
            "reserve their host-side partition bytes against it and fail "
            "loud (SPILL_BUDGET_EXCEEDED) instead of growing host memory "
            "silently. Default: the process-wide host-spill budget (16x "
            "the device budget).",
            _positive),
        PropertyDef(
            "direct_group_limit", int, 4096,
            "Grouped aggregation addresses its state directly when the "
            "product of the key dictionaries' domains is at most this; "
            "larger domains take the bounded sort strategy "
            "(exec/local_planner.pick_group_strategy).",
            _positive),
        PropertyDef(
            "partial_agg_bypass", bool, True,
            "Adaptive aggregation: when the estimated (or plan-stats "
            "observed) group count nears the input row count, skip the "
            "per-batch partial folds and aggregate the concatenated rows "
            "in one pass (agg_strategy=bypass). Integer and decimal "
            "results are identical; DOUBLE sums agree to rounding. Off "
            "keeps keyed aggregations at agg_strategy=partial."),
        PropertyDef(
            "plan_templates", bool, True,
            "Plan-template parameterization: eligible literals are "
            "lifted out of the plan into typed runtime slots "
            "(plan/templates.py), so queries differing only in constants "
            "share one plan template. Bit-identical results on or off. "
            "Literals that prove kernel admission (leaf-route spec "
            "bounds, LIMIT shapes) stay baked, counted under "
            "prepare.slot_ineligible.*."),
        PropertyDef(
            "batched_dispatch", bool, False,
            "Cross-query batched dispatch (server/batcher.py): "
            "concurrent same-template different-literal queries meet at "
            "the template batch gate, and one leader scans the table once "
            "and replays the template's operator steps once per binding "
            "over the shared scanned batches (N results from one scan) "
            "instead of N serialized runs. Results are bit-identical to "
            "serial execution and the result cache stays keyed per "
            "binding. Templates outside the pure scan/filter/project/"
            "global-agg/sort/topN whitelist fall back to the serialized "
            "template slot, counted under batch.fallback.*. Off by "
            "default for embedded sessions; the serving layer "
            "(presto_tpu_torch.server) turns it on."),
        PropertyDef(
            "batch_max_size", int, 8,
            "Most bindings one cross-query batched dispatch may fuse.",
            _positive),
        PropertyDef(
            "tenant", str, None,
            "Default tenant identity stamped on this session's "
            "QueryInfo records (system.query_history attribution). The "
            "serving front-end overrides it per request via the "
            "request-scoped tenant context."),
        PropertyDef(
            "collect_node_stats", bool, False,
            "Record per-plan-node wall time and output rows on every "
            "query (the EXPLAIN ANALYZE recorder, always on)."),
        PropertyDef(
            "query_retries", int, 0,
            "Transparent query-level retries on execution failure: the "
            "engine's whole failure-recovery posture (there is no "
            "mid-query recovery; a failed attempt is re-run from the "
            "top, counted under query.retried).",
            _non_negative),
        PropertyDef(
            "query_max_run_time", float, None,
            "Per-query wall-clock deadline in seconds, checked at every "
            "fragment dispatch, driver-loop push and finish, scan split "
            "and spill transfer slot (a launched kernel runs to "
            "completion; the check fires before the next step). Expiry "
            "raises ExceededTimeLimit (error_code EXCEEDED_TIME_LIMIT). "
            "None: no deadline.",
            _positive),
        PropertyDef(
            "query_max_memory_bytes", int, None,
            "Admission-control limit: a query whose peak estimated node "
            "materialization (runtime/memory.estimate_node_bytes) exceeds "
            "it is rejected with ResourceExhausted before launch. None: "
            "64x the device budget.",
            _positive),
        PropertyDef(
            "memory_pool_bytes", int, None,
            "Capacity of the memory pool the session admits through. "
            "None: the process-wide pool (64x the device budget), shared "
            "by every session of the process; set, the session gets a "
            "private pool of that size.",
            _positive),
        PropertyDef(
            "admission_queue_timeout_s", float, 30.0,
            "How long a query may wait in the memory pool's FIFO "
            "admission queue for its reservation before failing with "
            "ResourceExhausted. 0 restores reject-or-nothing.",
            _non_negative),
        PropertyDef(
            "oom_ladder_max", int, 4,
            "Rungs of the runtime OOM ladder: a backend out-of-memory at "
            "a dispatch re-plans the query out of core with more buckets "
            "and smaller probe chunks and re-runs it on the same device, "
            "up to this many times before the DeviceOutOfMemory surfaces. "
            "0 disables runtime OOM recovery.",
            _non_negative),
        PropertyDef(
            "retry_count", int, 0,
            "Fragment-level retries of RETRYABLE failures (injected "
            "faults, transient device loss): a failing fragment dispatch "
            "re-runs its subtree up to this many extra times with "
            "exponential backoff. Deterministic failures are never "
            "retried. 0 disables fragment retry.",
            _non_negative),
        PropertyDef(
            "retry_backoff_s", float, 0.01,
            "Base of the exponential fragment-retry backoff: attempt k "
            "sleeps retry_backoff_s * 2^k seconds (capped at 5 s, and "
            "never past the deadline).",
            _non_negative),
        PropertyDef(
            "degrade_to_local", bool, True,
            "Graceful degradation: a distributed query that fails with "
            "a retryable error after its fragment retries are exhausted "
            "re-plans onto the single-device local pipeline as a last "
            "resort (QueryInfo.degraded marks it)."),
        PropertyDef(
            "result_cache_enabled", bool, True,
            "Serve a repeated identical query from the session's "
            "versioned result cache (cache/result_cache.py: keyed by plan "
            "fingerprint and the referenced tables' catalog versions). "
            "Volatile plans (system tables, nondeterministic functions), "
            "fault-injected runs and failed queries never populate or "
            "hit."),
        PropertyDef(
            "result_cache_max_bytes", int, 256 << 20,
            "Byte budget of the session's result cache "
            "(QueryResult.nbytes); eviction is LRU-first, and a result "
            "larger than the whole budget is not stored.",
            _positive),
        PropertyDef(
            "exec_cache_max_entries", int, 256,
            "Entry bound of the process-wide executable cache "
            "(cache/exec_cache.py: operator step callables keyed by "
            "step-config fingerprint); LRU eviction. Setting it resizes "
            "the cache for every session; unset leaves the process bound "
            "as it is.",
            _positive),
        PropertyDef(
            "trace_enabled", bool, True,
            "Record a structured span trace (query -> plan node -> "
            "operator step, plus driver and join-filter spans) for every "
            "query. Traces are retained in a per-session ring, exportable "
            "as Chrome trace JSON via Session.export_trace(path)."),
        PropertyDef(
            "trace_max_spans", int, 8192,
            "Span cap per traced query; spans beyond it are dropped "
            "(counted in the trace.spans_dropped metric), never an "
            "error.",
            _positive),
        PropertyDef(
            "query_history_limit", int, 256,
            "Entries retained in the session's query-history ring "
            "(Session.history, fed by the built-in query_completed "
            "listener).",
            _positive),
        PropertyDef(
            "flight_recorder_limit", int, 64,
            "Post-mortem records retained in the session's flight-"
            "recorder ring (runtime/flight.py, system.flight_recorder). "
            "A record is captured whenever a query fails, degrades down "
            "the OOM ladder, retries a fragment or exceeds its deadline; "
            "Session.export_flight_record writes them as JSON.",
            _positive),
        PropertyDef(
            "flight_record_successes", bool, False,
            "Also capture a flight record for every successful query; "
            "adaptive decisions stand down meanwhile, so the captured "
            "runs show the baseline plan."),
        PropertyDef(
            "plan_stats_limit", int, 512,
            "Plan fingerprints retained in the session's estimate-vs-"
            "actual history (cache/plan_stats.py, system.plan_stats; LRU "
            "by fingerprint, invalidated on DDL).",
            _positive),
        PropertyDef(
            "adaptive_execution", bool, True,
            "Let plan-stats history steer recurring plans "
            "(plan/adaptive.py): history-corrected join and aggregate "
            "sizing and the fused-route disable after a runtime "
            "fallback, compile-budget gated against the executable "
            "cache's ledger and logged to system.adaptive. Off = "
            "telemetry only."),
        PropertyDef(
            "adaptive_salt_max", int, 8,
            "Upper bound on the skew-salt partition count "
            "(plan/adaptive.salt_factor).",
            _positive),
        PropertyDef(
            "profile_annotations", bool, False,
            "Wrap every trace span in a torch.profiler.record_function "
            "named '<span>#<trace_token>', so a torch profiler trace "
            "of the card shows each span as a user annotation over the "
            "kernels it launched."),
        PropertyDef(
            "profile_dir", str, None,
            "When set, every query runs under torch.profiler (CPU and "
            "CUDA activities) and writes one Chrome trace, named by its "
            "query id, into this directory: the device-side timeline "
            "beside EXPLAIN ANALYZE's host-side operator stats."),
        PropertyDef(
            "narrow_storage", bool, None,
            "Stats-driven narrow physical column storage: scans "
            "materialize int8/int16/int32 device columns wherever "
            "connector value bounds permit, which arms the fused leaf "
            "route (exec/leaf_route.py). Process-wide, mirrors the "
            "PRESTO_TPU_NARROW environment variable; default: on. Off "
            "takes the generic operators with canonical storage; "
            "results are bit-identical either way."),
        PropertyDef(
            "runtime_join_filters", bool, True,
            "Runtime join filters (sideways information passing): an "
            "inner or semi join's build side pushes its key (min, max) "
            "and a Bloom bitmask into the probe-side scan, which clears "
            "the live bit of rows that cannot join "
            "(plan/joinfilters.py). Results are identical either way; "
            "join.filter_rows_in / join.filter_rows_pruned count the "
            "scanned and pruned rows."),
        PropertyDef(
            "pallas_join", bool, True,
            "Prefer the fused lookup-table probe kernels for equi-joins "
            "on narrow stats-bounded keys (ops/cuda_join.py). Ineligible "
            "joins fall back to the dense or sorted probes with a "
            "join.pallas_fallback counter; results are identical."),
        PropertyDef(
            "approx_join", bool, False,
            "APPROXIMATE semi joins: when the exact fused table cannot "
            "fit, probe a two-hash Bloom sketch instead (ops/cuda_join.py "
            "sketch_probe) — false positives possible (extra rows at "
            "roughly (1-exp(-2n/m))^2 for n build keys in m=2^19 bits), "
            "never false negatives, never row loss (anti joins are "
            "excluded by construction). Changes results: "
            "QueryResult.approximate says when a run probed the sketch."),
        PropertyDef(
            "approx_scan_fraction", float, 1.0,
            "APPROXIMATE scans: execute only this deterministic "
            "fraction of each table's splits (evenly strided, so the "
            "sample is stable per split layout). 1.0 scans everything; "
            "below 1.0 the query is flagged QueryInfo.approximate (the "
            "dashboard tier of presto_tpu_torch/stream/ subscriptions). "
            "Changes results: the plan fingerprint folds this property, "
            "so sampled and exact runs never share cached results.",
            lambda v: None if 0.0 < v <= 1.0 else f"must be in (0, 1], got {v}"),
        PropertyDef(
            "pallas_strings", bool, None,
            "The route of LIKE and the prefix test on byte columns: "
            "the CUDA string kernels (ops/cuda_strings.py) on a CUDA "
            "session, their plain PyTorch versions on a CPU one. Kept "
            "for the property table: the device picks the route, so "
            "unset or the device's own route is accepted, and false on "
            "a CUDA session or true on a CPU one is refused "
            "(NotSupported). Per session."),
        PropertyDef(
            "device_telemetry", bool, True,
            "Stamp QueryInfo.device_peak_bytes with the CUDA caching "
            "allocator's peak watermark (runtime/devices.py) at query "
            "completion; 0 without a card."),
        PropertyDef(
            "slo_latency_objective_s", float, 1.0,
            "Default per-tenant latency objective (seconds): a query "
            "finishing slower counts against the tenant's SLO burn rate "
            "(system.slo). Per-tenant overrides ride "
            "TenantSpec.slo_latency_s.",
            _positive),
        PropertyDef(
            "slo_freshness_objective_s", float, 10.0,
            "Default per-tenant subscription freshness objective "
            "(seconds): a continuous-query refresh delivering staler than "
            "this counts against the tenant's freshness burn rate. "
            "Per-tenant overrides ride TenantSpec.slo_freshness_s.",
            _positive),
        PropertyDef(
            "slo_window", int, 256,
            "Rolling observation window (per tenant, per objective kind) "
            "over which SLO burn rates are computed.",
            _positive),
        PropertyDef(
            "health_monitor", bool, True,
            "Arm the serving-tier anomaly watchdog (runtime/health.py) "
            "when a QueryServer starts: a background thread samples "
            "qps/p99/queue/pool/cache/freshness into system.health and "
            "fires health_breach events (plus a flight-recorder capture "
            "of the worst in-flight query) on regressions."),
        PropertyDef(
            "health_interval_s", float, 0.25,
            "Watchdog sampling cadence (seconds).",
            _positive),
        PropertyDef(
            "health_ring", int, 128,
            "Bounded ring of health snapshots retained (the "
            "system.health table depth).",
            _positive),
        PropertyDef(
            "health_baseline_window", int, 8,
            "Trailing samples forming the watchdog's baseline (median "
            "p99 over this window is the regression reference).",
            _positive),
        PropertyDef(
            "health_min_samples", int, 3,
            "Baseline samples (with observed latencies) required before "
            "the p99 regression detector may fire: a cold start must not "
            "breach on its first slow query.",
            _positive),
        PropertyDef(
            "health_p99_factor", float, 3.0,
            "Breach when the current p99 exceeds this multiple of the "
            "trailing-baseline p99.",
            _positive),
        PropertyDef(
            "health_queue_limit", int, 64,
            "Breach when the admission queue holds more waiters than "
            "this.",
            _positive),
        PropertyDef(
            "health_burn_limit", float, 0.5,
            "Breach when any tenant's rolling SLO burn rate (breach "
            "fraction) exceeds this.",
            _positive),
        PropertyDef(
            "health_stale_lag_s", float, 30.0,
            "Breach when the worst subscription freshness lag exceeds "
            "this many seconds.",
            _positive),
        PropertyDef(
            "health_cooldown_s", float, 5.0,
            "Minimum seconds between health_breach firings (with the "
            "clean-sample re-arm latch, one sustained incident fires "
            "once, not once per sample).",
            _non_negative),
        PropertyDef(
            "retry_budget_tokens", float, 16.0,
            "Capacity of the per-session retry token bucket "
            "(runtime/overload.RetryBudget): fragment retries and "
            "OOM-ladder rungs each spend one token; a drained bucket "
            "opens the circuit breaker and failures fail fast.",
            _positive),
        PropertyDef(
            "retry_budget_refill_per_s", float, 2.0,
            "Retry tokens refilled per second. 0 disables refill (tokens "
            "only return through the half-open probe's success).",
            _non_negative),
        PropertyDef(
            "retry_breaker_cooldown_s", float, 1.0,
            "Seconds an open retry circuit breaker waits before going "
            "half-open and granting exactly one probe retry.",
            _non_negative),
        PropertyDef(
            "brownout_cooldown_s", float, 5.0,
            "Breach-free seconds after which an engaged brown-out "
            "(runtime/overload.OverloadController) disengages and "
            "eligible tenants' traffic returns to the exact tier.",
            _non_negative),
        PropertyDef(
            "brownout_force", bool, False,
            "Operator override: pin the brown-out latch on (eligible "
            "tenants degrade per TenantSpec.brownout regardless of "
            "health). Setting it back to false disengages immediately."),
    ]
}


def validate_properties(props: dict) -> dict:
    """Coerce + validate a property mapping; unknown names are errors."""
    out = {}
    for name, value in props.items():
        d = SESSION_PROPERTIES.get(name)
        if d is None:
            known = ", ".join(sorted(SESSION_PROPERTIES))
            raise UserError(f"unknown session property {name!r} (known: {known})")
        out[name] = d.coerce(value)
    return out


def effective(props: dict, name: str):
    """Value of a property under the session overrides."""
    return props.get(name, SESSION_PROPERTIES[name].default)
