"""System tables: live engine state as SQL.

Counterpart of ``presto_tpu/connectors/system.py``: the 14 tables of the
``system`` catalog, backed by the session's query history, plan-stats
history, adaptive decision ring, flight recorder, memory pool, trace
ring, SLO tracker and health monitor, and by the process's metrics
registry, executable cache and devices. The data is materialized at scan
time, on the session's device. ``runtime_nodes`` lists the CUDA devices
(their index and name), or the CPU when the session runs there;
``tenants`` stays empty until a server attaches its scheduler.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from presto_tpu_torch.batch import Batch, Dictionary
from presto_tpu_torch.spi import Split, batch_capacity
from presto_tpu_torch.types import BIGINT, DOUBLE, DataType, fixed_bytes, varchar

_QUERY_STATES = ["FAILED", "FINISHED", "QUEUED", "RUNNING"]
STATE_DICT = Dictionary(_QUERY_STATES)

SCHEMAS: dict[str, dict[str, DataType]] = {
    "runtime_queries": {
        "query_id": fixed_bytes(24),
        "state": varchar(),
        "query": fixed_bytes(256),
        "elapsed_s": DOUBLE,
        "output_rows": BIGINT,
    },
    "runtime_metrics": {
        "name": fixed_bytes(64),
        "value": DOUBLE,
    },
    "runtime_nodes": {
        "node_id": fixed_bytes(32),
        "platform": fixed_bytes(16),
    },
    # post-hoc query history (the session's ring buffer, fed by the
    # built-in query_completed listener) with the phase breakdown
    "query_history": {
        "query_id": fixed_bytes(24),
        "state": varchar(),
        "query": fixed_bytes(256),
        "trace_token": fixed_bytes(32),
        "queued_s": DOUBLE,
        "planning_s": DOUBLE,
        "execution_s": DOUBLE,
        "elapsed_s": DOUBLE,
        "output_rows": BIGINT,
        "fragment_retries": BIGINT,
        "cache_hit": BIGINT,
        # this query's plan TEMPLATE (literal slots in place of values)
        # was already warm in the session — the compiled executable was
        # reused regardless of the literal binding (plan/templates.py)
        "template_hit": BIGINT,
        # coalesced onto a concurrent identical in-flight execution
        "coalesced": BIGINT,
        # rode a cross-query batched dispatch (the server's batcher)
        "batched": BIGINT,
        # lanes in the batched dispatch this query rode (0 unbatched)
        "batch_size": BIGINT,
        # the continuous query that fired this execution ("" for ad-hoc
        # statements) — joins refresh history back to system
        # subscriptions by id
        "subscription_id": fixed_bytes(32),
        # serving-layer tenant attribution ("" outside the front-end).
        # 48 bytes of UTF-8; names longer than that DO truncate in the
        # system tables (the scheduler and metric suffixes keep full
        # names) — keep tenant identifiers short
        "tenant": fixed_bytes(48),
        "approximate": BIGINT,
        "degraded": BIGINT,
        "oom_retries": BIGINT,
        "memory_queued_s": DOUBLE,
        "error_code": fixed_bytes(32),
        # per-query metric-delta attribution (QueryInfo.attribute_metrics):
        # before these, strategy/selectivity/rung were only recoverable
        # from process-GLOBAL counters, useless under concurrency
        "oom_rung": BIGINT,
        "join_strategy": fixed_bytes(32),
        "filter_selectivity": DOUBLE,
    },
    # estimate-vs-actual history per plan fingerprint and node
    # (cache/plan_stats.py; rows carry the LATEST completed run of each
    # retained fingerprint, version-invalidated on DDL)
    "plan_stats": {
        "fingerprint": fixed_bytes(64),
        "query_id": fixed_bytes(24),
        "node_id": BIGINT,
        "node_type": fixed_bytes(24),
        "est_rows": BIGINT,
        "actual_rows": BIGINT,
        "selectivity": DOUBLE,
        "strategy": fixed_bytes(16),
        "misest": DOUBLE,
        # observed exchange-partition skew (max/mean delivered rows
        # across destinations) of the node's exchanges; 0 = none seen
        "skew": DOUBLE,
        "runs": BIGINT,
    },
    # adaptive-execution decision log (plan/adaptive.py): one row per
    # applied OR refused decision of this session's feedback
    # controller — salted repartitions, history-corrected sizing,
    # disabled fused routes, compile-budget refusals
    "adaptive": {
        "query_id": fixed_bytes(24),
        "fingerprint": fixed_bytes(64),
        "node_id": BIGINT,
        # decision kind: salt | join_flip | bucket | route
        "kind": fixed_bytes(16),
        # what the decision did (e.g. "repartition=salted(4)")
        "action": fixed_bytes(64),
        # why it fired (telemetry trigger, e.g. "skew 6.8x hot=7")
        "trigger": fixed_bytes(96),
        "salt": BIGINT,
        "hot_partition": BIGINT,
        "est_bytes": BIGINT,
        # 1 = applied; 0 = refused by the compile-budget gate
        "applied": BIGINT,
        "created_at": DOUBLE,
    },
    # flight-recorder post-mortems (runtime/flight.py): one row per
    # retained record; the full evidence (plan render, spans, metric
    # delta) exports as JSON via Session.export_flight_record
    "flight_recorder": {
        "query_id": fixed_bytes(24),
        "state": varchar(),
        "query": fixed_bytes(256),
        "triggers": fixed_bytes(48),
        "error_code": fixed_bytes(32),
        "oom_rung": BIGINT,
        "rungs": BIGINT,
        # rung-history totals: ``rungs`` counts LADDER entries only
        # (runtime-OOM re-plans); ``rungs_total`` also counts the
        # planned_hybrid/planned_grouped out-of-core decisions, and
        # ``first_rung_error`` is the error that started the ladder
        "rungs_total": BIGINT,
        "first_rung_error": fixed_bytes(64),
        "fragment_retries": BIGINT,
        "degraded": BIGINT,
        "spans": BIGINT,
        # whether a TraceRecorder was live at capture: distinguishes
        # "traced, zero spans" from "tracing off" (flight.py)
        "trace_enabled": BIGINT,
        "metric_deltas": BIGINT,
        "hot_partitions": fixed_bytes(48),
        "execution_s": DOUBLE,
        "captured_at": DOUBLE,
        "pool_reserved_bytes": BIGINT,
    },
    # compile-cost ledger of the process-wide executable cache
    # (cache/exec_cache.py): per-entry provenance, reuse, and the
    # measured trace+compile amortization (compile_s_saved)
    "exec_cache": {
        "kind": fixed_bytes(24),
        # longest kind tag (18) + ':' + 64-hex sha256 = 83; sized so
        # the fingerprint tail never truncates away entry identity
        "key": fixed_bytes(96),
        "hits": BIGINT,
        "calls": BIGINT,
        "cold_call_s": DOUBLE,
        "warm_call_s": DOUBLE,
        "compile_s_saved": DOUBLE,
        "age_s": DOUBLE,
        "idle_s": DOUBLE,
    },
    # serving-layer tenant registry (server/scheduler.FairScheduler,
    # attached by a fronting QueryServer): one row per tenant with its
    # fairness contract and live scheduling state; empty outside the
    # serving layer
    "tenants": {
        "tenant": fixed_bytes(48),
        "weight": DOUBLE,
        "max_concurrent": BIGINT,  # -1 = unlimited
        "max_bytes": BIGINT,       # -1 = unlimited
        "running": BIGINT,
        "peak_running": BIGINT,
        "queued": BIGINT,
        "admitted": BIGINT,
        "over_quota_blocked": BIGINT,
        "queue_timeouts": BIGINT,
        "reserved_bytes": BIGINT,
        "vtime": DOUBLE,
    },
    # live state of the memory pool this session admits through
    # (runtime/memory.MemoryPool): one row, materialized at scan time
    "memory_pool": {
        "pool": fixed_bytes(16),
        "capacity_bytes": BIGINT,
        "reserved_bytes": BIGINT,
        "free_bytes": BIGINT,
        "active_queries": BIGINT,
        "queued_queries": BIGINT,
    },
    # live per-device telemetry (runtime/devices.py): the CUDA caching
    # allocator's watermarks plus the process dispatch wall-clock
    # ledger; a CPU row of zeros without a card
    "device_stats": {
        "device_id": fixed_bytes(16),
        "platform": fixed_bytes(16),
        "bytes_in_use": BIGINT,
        "peak_bytes": BIGINT,
        "bytes_limit": BIGINT,
        "dispatch_wall_s": DOUBLE,
        "dispatches": BIGINT,
    },
    # per-tenant SLO objectives and rolling burn rates
    # (runtime/health.py SloTracker, attached by a fronting
    # QueryServer); empty outside the serving layer
    "slo": {
        "tenant": fixed_bytes(48),
        "latency_objective_s": DOUBLE,
        "freshness_objective_s": DOUBLE,
        "latency_good": BIGINT,
        "latency_breach": BIGINT,
        "freshness_good": BIGINT,
        "freshness_breach": BIGINT,
        "latency_burn_rate": DOUBLE,
        "freshness_burn_rate": DOUBLE,
    },
    # the health watchdog's vital-sign ring (runtime/health.py
    # HealthMonitor), oldest first; breach rows carry reason codes
    # ("p99,queue" etc.) and arm the flight recorder
    "health": {
        "ts": DOUBLE,
        "qps": DOUBLE,
        "p50_s": DOUBLE,
        "p99_s": DOUBLE,
        "queue_depth": BIGINT,
        "pool_occupancy": DOUBLE,
        "cache_hit_rate": DOUBLE,
        "freshness_lag_s": DOUBLE,
        "slo_burn": DOUBLE,
        "breach": BIGINT,
        # comma-joined reason codes; 24 bytes fits the full worst case
        # ("p99,queue,burn,stale")
        "reason": fixed_bytes(24),
    },
    # flattened span traces of recent queries (runtime/trace.py);
    # start_s is relative to the query's first span
    "trace_spans": {
        "query_id": fixed_bytes(24),
        "span_id": BIGINT,
        "parent_id": BIGINT,
        "name": fixed_bytes(48),
        "category": fixed_bytes(12),
        "start_s": DOUBLE,
        "duration_s": DOUBLE,
        "plan_node_id": BIGINT,
        "trace_token": fixed_bytes(32),
    },
}


def _bytes_col(strings: Sequence[str], width: int) -> np.ndarray:
    out = np.zeros((len(strings), width), np.uint8)
    for i, s in enumerate(strings):
        b = s.encode("utf-8", "replace")[:width]
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


class SystemConnector:
    """Registered automatically by every Session under catalog name
    'system'."""

    name = "system"

    #: system tables reflect live engine state — results are never
    #: reusable, so the result cache skips any plan that scans them
    #: (cache/fingerprint.plan_is_deterministic)
    volatile = True

    def __init__(self, session):
        self._session = session

    # ---- metadata -------------------------------------------------------
    def tables(self) -> Sequence[str]:
        return list(SCHEMAS)

    def schema(self, table: str) -> Mapping[str, DataType]:
        return SCHEMAS[table]

    def dictionaries(self, table: str) -> Mapping[str, Dictionary]:
        if table in ("runtime_queries", "query_history",
                     "flight_recorder"):
            return {"state": STATE_DICT}
        return {}

    def row_count(self, table: str) -> int:
        return len(self._rows(table)[0]) if self._rows(table) else 0

    def unique_keys(self, table: str):
        return ()

    # ---- data -----------------------------------------------------------
    def _rows(self, table: str):
        if table == "runtime_queries":
            infos = list(self._session.query_history)
            return (
                [i.query_id for i in infos],
                [i.state for i in infos],
                [" ".join(i.sql.split()) for i in infos],
                [i.elapsed_s for i in infos],
                [i.output_rows for i in infos],
            )
        if table == "runtime_metrics":
            from presto_tpu_torch.runtime.metrics import REGISTRY

            snap = REGISTRY.snapshot()
            names = sorted(snap)
            return names, [snap[n] for n in names]
        if table == "query_history":
            infos = self._session.history.infos()
            return (
                [i.query_id for i in infos],
                [i.state for i in infos],
                [" ".join(i.sql.split()) for i in infos],
                [i.trace_token or "" for i in infos],
                [i.queued_s for i in infos],
                [i.planning_s for i in infos],
                [i.execution_s for i in infos],
                [i.elapsed_s for i in infos],
                [i.output_rows for i in infos],
                [i.fragment_retries for i in infos],
                [int(i.cache_hit) for i in infos],
                [int(i.template_hit) for i in infos],
                [int(i.coalesced) for i in infos],
                [int(i.batched) for i in infos],
                [i.batch_size for i in infos],
                [i.subscription_id for i in infos],
                [i.tenant for i in infos],
                [int(i.approximate) for i in infos],
                [int(i.degraded) for i in infos],
                [i.oom_retries for i in infos],
                [i.memory_queued_s for i in infos],
                [i.error_code or "" for i in infos],
                [i.oom_rung for i in infos],
                [i.join_strategy for i in infos],
                [i.filter_selectivity for i in infos],
            )
        if table == "plan_stats":
            entries = self._session.plan_stats.entries(
                self._session.catalog)
            (fps, qids, nids, ntypes, ests, acts, sels, strats, mis,
             skews, runs) = ([], [], [], [], [], [], [], [], [], [], [])
            for e in entries:
                for r in e.records:
                    fps.append(e.fingerprint)
                    qids.append(e.query_id)
                    nids.append(r["node_id"])
                    ntypes.append(r["node_type"])
                    ests.append(r["est_rows"])
                    acts.append(r["actual_rows"])
                    sels.append(r["selectivity"])
                    strats.append(r["strategy"])
                    mis.append(r["misest"])
                    skews.append(r.get("skew", 0.0))
                    runs.append(e.runs)
            return (fps, qids, nids, ntypes, ests, acts, sels, strats,
                    mis, skews, runs)
        if table == "adaptive":
            evs = self._session.adaptive.rows()
            return (
                [str(e.get("query_id", "")) for e in evs],
                [str(e.get("fingerprint", "")) for e in evs],
                [int(e.get("node_id", -1)) for e in evs],
                [str(e.get("kind", "")) for e in evs],
                [str(e.get("action", "")) for e in evs],
                [str(e.get("trigger", "")) for e in evs],
                [int(e.get("salt", 0)) for e in evs],
                [int(e.get("hot_partition", -1)) for e in evs],
                [int(e.get("est_bytes", -1)) for e in evs],
                [int(bool(e.get("applied", True))) for e in evs],
                [float(e.get("created_at", 0.0)) for e in evs],
            )
        if table == "flight_recorder":
            recs = self._session.flight.records()

            def ladder(r):
                # pre-spill-tier entries carry no "kind": treat as ladder
                return [e for e in r.rung_history
                        if e.get("kind", "ladder") == "ladder"]

            return (
                [r.query_id for r in recs],
                [r.state for r in recs],
                [" ".join(r.sql.split()) for r in recs],
                [",".join(r.triggers) for r in recs],
                [r.error_code or "" for r in recs],
                [r.oom_rung for r in recs],
                [len(ladder(r)) for r in recs],
                [len(r.rung_history) for r in recs],
                [(ladder(r)[0].get("error", "") if ladder(r) else "")
                 for r in recs],
                [r.fragment_retries for r in recs],
                [int(r.degraded_to_local) for r in recs],
                [len(r.spans) for r in recs],
                [int(r.trace_enabled) for r in recs],
                [len(r.metrics) for r in recs],
                [",".join(str(p) for p in r.hot_partitions)
                 for r in recs],
                [r.execution_s for r in recs],
                [r.captured_at for r in recs],
                [int(r.pool.get("reserved_bytes", 0)) for r in recs],
            )
        if table == "exec_cache":
            from presto_tpu_torch.cache.exec_cache import EXEC_CACHE

            rows = EXEC_CACHE.stats_rows()
            return (
                [r["kind"] for r in rows],
                [r["key"] for r in rows],
                [r["hits"] for r in rows],
                [r["calls"] for r in rows],
                [r["cold_call_s"] for r in rows],
                [r["warm_call_s"] for r in rows],
                [r["compile_s_saved"] for r in rows],
                [r["age_s"] for r in rows],
                [r["idle_s"] for r in rows],
            )
        if table == "tenants":
            sched = getattr(self._session, "tenants", None)
            rows = sched.snapshot() if sched is not None else []
            keys = ("tenant", "weight", "max_concurrent", "max_bytes",
                    "running", "peak_running", "queued", "admitted",
                    "over_quota_blocked", "queue_timeouts",
                    "reserved_bytes", "vtime")
            return tuple([r[k] for r in rows] for k in keys)
        if table == "memory_pool":
            pool = self._session.pool()
            snap = pool.snapshot()  # one lock: internally consistent
            return (
                [pool.name],
                [snap["capacity_bytes"]],
                [snap["reserved_bytes"]],
                [snap["free_bytes"]],
                [snap["active_queries"]],
                [snap["queued_queries"]],
            )
        if table == "trace_spans":
            qids, sids, pids_, names_, cats, starts, durs, nids, toks = (
                [], [], [], [], [], [], [], [], []
            )
            for rec in self._session.traces.recorders():
                # the ONE span-flattening projection, shared with the
                # flight recorder (TraceRecorder.to_span_dicts)
                for d in rec.to_span_dicts():
                    qids.append(rec.query_id)
                    sids.append(d["span_id"])
                    pids_.append(d["parent_id"])
                    names_.append(d["name"])
                    cats.append(d["cat"])
                    starts.append(d["start_s"])
                    durs.append(d["duration_s"])
                    nids.append(int(d["args"].get("plan_node_id", -1)))
                    toks.append(rec.trace_token or "")
            return (qids, sids, pids_, names_, cats, starts, durs, nids,
                    toks)
        if table == "runtime_nodes":
            import torch

            dev = self._session.device
            if dev.type != "cuda":
                return ["cpu"], ["cpu"]
            n = torch.cuda.device_count()
            return ([f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(n)],
                    ["gpu"] * n)
        if table == "device_stats":
            from presto_tpu_torch.runtime.devices import sample_devices

            devs = sample_devices()
            keys = ("device_id", "platform", "bytes_in_use",
                    "peak_bytes", "bytes_limit", "dispatch_wall_s",
                    "dispatches")
            return tuple([d[k] for d in devs] for k in keys)
        if table == "slo":
            slo = getattr(self._session, "slo", None)
            rows = slo.snapshot() if slo is not None else []
            keys = ("tenant", "latency_objective_s",
                    "freshness_objective_s", "latency_good",
                    "latency_breach", "freshness_good",
                    "freshness_breach", "latency_burn_rate",
                    "freshness_burn_rate")
            return tuple([r[k] for r in rows] for k in keys)
        if table == "health":
            mon = getattr(self._session, "health", None)
            rows = mon.snapshot() if mon is not None else []
            keys = ("ts", "qps", "p50_s", "p99_s", "queue_depth",
                    "pool_occupancy", "cache_hit_rate",
                    "freshness_lag_s", "slo_burn", "breach", "reason")
            return tuple([r[k] for r in rows] for k in keys)
        raise KeyError(table)

    def scan_numpy(self, split: Split, columns=None) -> Mapping[str, np.ndarray]:
        table = split.table
        rows = self._rows(table)
        arrays: dict[str, np.ndarray] = {}
        if table == "runtime_queries":
            qid, state, sql, elapsed, outrows = rows
            arrays = {
                "query_id": _bytes_col(qid, 24),
                "state": STATE_DICT.encode(state).astype(np.int32),
                "query": _bytes_col(sql, 256),
                "elapsed_s": np.asarray(elapsed, np.float64),
                "output_rows": np.asarray(outrows, np.int64),
            }
        elif table == "runtime_metrics":
            names, values = rows
            arrays = {
                "name": _bytes_col(names, 64),
                "value": np.asarray(values, np.float64),
            }
        elif table == "runtime_nodes":
            ids, platforms = rows
            arrays = {
                "node_id": _bytes_col(ids, 32),
                "platform": _bytes_col(platforms, 16),
            }
        elif table == "query_history":
            (qid, state, sql, tok, queued, planning, execution, elapsed,
             outrows, retries, hits, tmpl, coal, batched, bsize, subid,
             tenant, approx,
             degraded, oomr, memq, ecode, rung, jstrat, fsel) = rows
            arrays = {
                "query_id": _bytes_col(qid, 24),
                "state": STATE_DICT.encode(state).astype(np.int32),
                "query": _bytes_col(sql, 256),
                "trace_token": _bytes_col(tok, 32),
                "queued_s": np.asarray(queued, np.float64),
                "planning_s": np.asarray(planning, np.float64),
                "execution_s": np.asarray(execution, np.float64),
                "elapsed_s": np.asarray(elapsed, np.float64),
                "output_rows": np.asarray(outrows, np.int64),
                "fragment_retries": np.asarray(retries, np.int64),
                "cache_hit": np.asarray(hits, np.int64),
                "template_hit": np.asarray(tmpl, np.int64),
                "coalesced": np.asarray(coal, np.int64),
                "batched": np.asarray(batched, np.int64),
                "batch_size": np.asarray(bsize, np.int64),
                "subscription_id": _bytes_col(subid, 32),
                "tenant": _bytes_col(tenant, 48),
                "approximate": np.asarray(approx, np.int64),
                "degraded": np.asarray(degraded, np.int64),
                "oom_retries": np.asarray(oomr, np.int64),
                "memory_queued_s": np.asarray(memq, np.float64),
                "error_code": _bytes_col(ecode, 32),
                "oom_rung": np.asarray(rung, np.int64),
                "join_strategy": _bytes_col(jstrat, 32),
                "filter_selectivity": np.asarray(fsel, np.float64),
            }
        elif table == "plan_stats":
            (fps, qids, nids, ntypes, ests, acts, sels, strats, mis,
             skews, runs) = rows
            arrays = {
                "fingerprint": _bytes_col(fps, 64),
                "query_id": _bytes_col(qids, 24),
                "node_id": np.asarray(nids, np.int64),
                "node_type": _bytes_col(ntypes, 24),
                "est_rows": np.asarray(ests, np.int64),
                "actual_rows": np.asarray(acts, np.int64),
                "selectivity": np.asarray(sels, np.float64),
                "strategy": _bytes_col(strats, 16),
                "misest": np.asarray(mis, np.float64),
                "skew": np.asarray(skews, np.float64),
                "runs": np.asarray(runs, np.int64),
            }
        elif table == "adaptive":
            (qid, fps, nids, kinds, actions, trigs, salts, hots, ebytes,
             applied, created) = rows
            arrays = {
                "query_id": _bytes_col(qid, 24),
                "fingerprint": _bytes_col(fps, 64),
                "node_id": np.asarray(nids, np.int64),
                "kind": _bytes_col(kinds, 16),
                "action": _bytes_col(actions, 64),
                "trigger": _bytes_col(trigs, 96),
                "salt": np.asarray(salts, np.int64),
                "hot_partition": np.asarray(hots, np.int64),
                "est_bytes": np.asarray(ebytes, np.int64),
                "applied": np.asarray(applied, np.int64),
                "created_at": np.asarray(created, np.float64),
            }
        elif table == "flight_recorder":
            (qid, state, sql, trig, ecode, rung, rungs, rungs_total,
             first_err, retries, degr,
             spans, tron, mdeltas, hot, execs, cap, poolb) = rows
            arrays = {
                "query_id": _bytes_col(qid, 24),
                "state": STATE_DICT.encode(state).astype(np.int32),
                "query": _bytes_col(sql, 256),
                "triggers": _bytes_col(trig, 48),
                "error_code": _bytes_col(ecode, 32),
                "oom_rung": np.asarray(rung, np.int64),
                "rungs": np.asarray(rungs, np.int64),
                "rungs_total": np.asarray(rungs_total, np.int64),
                "first_rung_error": _bytes_col(first_err, 64),
                "fragment_retries": np.asarray(retries, np.int64),
                "degraded": np.asarray(degr, np.int64),
                "spans": np.asarray(spans, np.int64),
                "trace_enabled": np.asarray(tron, np.int64),
                "metric_deltas": np.asarray(mdeltas, np.int64),
                "hot_partitions": _bytes_col(hot, 48),
                "execution_s": np.asarray(execs, np.float64),
                "captured_at": np.asarray(cap, np.float64),
                "pool_reserved_bytes": np.asarray(poolb, np.int64),
            }
        elif table == "exec_cache":
            (kind, key, hits, calls, cold, warm, saved, age,
             idle) = rows
            arrays = {
                "kind": _bytes_col(kind, 24),
                "key": _bytes_col(key, 96),
                "hits": np.asarray(hits, np.int64),
                "calls": np.asarray(calls, np.int64),
                "cold_call_s": np.asarray(cold, np.float64),
                "warm_call_s": np.asarray(warm, np.float64),
                "compile_s_saved": np.asarray(saved, np.float64),
                "age_s": np.asarray(age, np.float64),
                "idle_s": np.asarray(idle, np.float64),
            }
        elif table == "tenants":
            (tname, weight, maxc, maxb, running, peak, queued, admitted,
             blocked, timeouts, resv, vtime) = rows
            arrays = {
                "tenant": _bytes_col(tname, 48),
                "weight": np.asarray(weight, np.float64),
                "max_concurrent": np.asarray(maxc, np.int64),
                "max_bytes": np.asarray(maxb, np.int64),
                "running": np.asarray(running, np.int64),
                "peak_running": np.asarray(peak, np.int64),
                "queued": np.asarray(queued, np.int64),
                "admitted": np.asarray(admitted, np.int64),
                "over_quota_blocked": np.asarray(blocked, np.int64),
                "queue_timeouts": np.asarray(timeouts, np.int64),
                "reserved_bytes": np.asarray(resv, np.int64),
                "vtime": np.asarray(vtime, np.float64),
            }
        elif table == "memory_pool":
            name, cap, reserved, free, active, queued = rows
            arrays = {
                "pool": _bytes_col(name, 16),
                "capacity_bytes": np.asarray(cap, np.int64),
                "reserved_bytes": np.asarray(reserved, np.int64),
                "free_bytes": np.asarray(free, np.int64),
                "active_queries": np.asarray(active, np.int64),
                "queued_queries": np.asarray(queued, np.int64),
            }
        elif table == "device_stats":
            did, plat, inuse, peak, limit, wall, disp = rows
            arrays = {
                "device_id": _bytes_col(did, 16),
                "platform": _bytes_col(plat, 16),
                "bytes_in_use": np.asarray(inuse, np.int64),
                "peak_bytes": np.asarray(peak, np.int64),
                "bytes_limit": np.asarray(limit, np.int64),
                "dispatch_wall_s": np.asarray(wall, np.float64),
                "dispatches": np.asarray(disp, np.int64),
            }
        elif table == "slo":
            (tname, lobj, fobj, lgood, lbreach, fgood, fbreach, lburn,
             fburn) = rows
            arrays = {
                "tenant": _bytes_col(tname, 48),
                "latency_objective_s": np.asarray(lobj, np.float64),
                "freshness_objective_s": np.asarray(fobj, np.float64),
                "latency_good": np.asarray(lgood, np.int64),
                "latency_breach": np.asarray(lbreach, np.int64),
                "freshness_good": np.asarray(fgood, np.int64),
                "freshness_breach": np.asarray(fbreach, np.int64),
                "latency_burn_rate": np.asarray(lburn, np.float64),
                "freshness_burn_rate": np.asarray(fburn, np.float64),
            }
        elif table == "health":
            (ts, qps, p50, p99, depth, occ, hitr, lag, burn, breach,
             reason) = rows
            arrays = {
                "ts": np.asarray(ts, np.float64),
                "qps": np.asarray(qps, np.float64),
                "p50_s": np.asarray(p50, np.float64),
                "p99_s": np.asarray(p99, np.float64),
                "queue_depth": np.asarray(depth, np.int64),
                "pool_occupancy": np.asarray(occ, np.float64),
                "cache_hit_rate": np.asarray(hitr, np.float64),
                "freshness_lag_s": np.asarray(lag, np.float64),
                "slo_burn": np.asarray(burn, np.float64),
                "breach": np.asarray(breach, np.int64),
                "reason": _bytes_col(reason, 24),
            }
        elif table == "trace_spans":
            (qid, sid, pid, name, cat, start, dur, nid, tok) = rows
            arrays = {
                "query_id": _bytes_col(qid, 24),
                "span_id": np.asarray(sid, np.int64),
                "parent_id": np.asarray(pid, np.int64),
                "name": _bytes_col(name, 48),
                "category": _bytes_col(cat, 12),
                "start_s": np.asarray(start, np.float64),
                "duration_s": np.asarray(dur, np.float64),
                "plan_node_id": np.asarray(nid, np.int64),
                "trace_token": _bytes_col(tok, 32),
            }
        arrays = {c: v[split.lo : split.hi] for c, v in arrays.items()}
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def splits(self, table: str, target_splits: int = 0) -> Sequence[Split]:
        n = self.row_count(table)
        return [Split(table, 0, 0, n, max(n, 1))]

    def scan(self, split: Split, columns=None, capacity=None) -> Batch:
        arrays = dict(self.scan_numpy(split, columns))
        n = len(next(iter(arrays.values()))) if arrays else 0
        cap = capacity or batch_capacity(max(n, 1))
        types = {c: SCHEMAS[split.table][c] for c in arrays}
        dicts = {
            c: d for c, d in self.dictionaries(split.table).items() if c in arrays
        }
        return Batch.from_numpy(arrays, types, capacity=cap, dictionaries=dicts,
                                device=self._session.device)
