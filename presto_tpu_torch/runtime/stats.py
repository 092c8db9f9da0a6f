"""Per-query execution statistics: EXPLAIN ANALYZE and ``QueryInfo``.

Counterpart of ``presto_tpu/runtime/stats.py``. Stats attach to plan
nodes: the executor has one dispatch point per node, and under a
``StatsRecorder`` it materializes each node's output stream there, so a
node's wall time is inclusive of its children and of its device work.

Node identity: stats key on stable per-query plan-node ids assigned by
:class:`NodeIds` (pre-order over the plan), never on a raw ``id(node)``:
``NodeIds`` pins a strong reference to every node it names, so an id can
never be reused while the map lives.

The distributed executor's end-of-run flush attaches each exchange's
skew to the node that drove it (:meth:`StatsRecorder.record_skew`), and
``render_analyzed_plan`` renders a tracer's ``exchange`` and ``cache``
span roll-ups after the node rows.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional


class NodeIds:
    """Stable per-query plan-node ids."""

    __slots__ = ("_ids", "_pinned", "_next")

    def __init__(self):
        self._ids: dict[int, int] = {}
        #: strong refs: an id(node) key stays unique for our lifetime
        self._pinned: list = []
        self._next = 0

    def assign(self, plan) -> None:
        """Pre-order id assignment over a plan tree (idempotent per node)."""
        self.of(plan)
        for c in plan.children:
            self.assign(c)

    def of(self, node) -> int:
        key = id(node)
        nid = self._ids.get(key)
        if nid is None:
            nid = self._next
            self._next += 1
            self._ids[key] = nid
            self._pinned.append(node)
        return nid

    def get(self, node) -> Optional[int]:
        return self._ids.get(id(node))


#: symmetric misestimate factor at which EXPLAIN ANALYZE flags a node
MISEST_FACTOR = 4.0


def misestimate_ratio(est_rows: int, actual_rows: int) -> float:
    """Symmetric est-vs-actual factor ``max(actual/est, est/actual)``
    (0.0 when either side is unknown; ``actual == 0`` reports the
    estimate itself)."""
    if est_rows is None or est_rows <= 0 or actual_rows < 0:
        return 0.0
    if actual_rows == 0:
        return float(est_rows)
    return max(actual_rows / est_rows, est_rows / actual_rows)


@dataclass
class NodeEstimate:
    """Plan-time snapshot of what the planner predicted for one node,
    frozen before execution."""

    node_id: int
    node_type: str
    #: bounds.estimate_rows
    est_rows: int
    #: bounds.upper_bound_rows (None: unprovable)
    upper_bound_rows: Optional[int] = None
    #: True when the sound bound is exact (no predicate below)
    exact: bool = False
    #: the planned join or aggregation strategy ("" for other nodes)
    strategy: str = ""
    #: physical per-row output bytes the planner assumed
    row_bytes: int = -1

    def to_dict(self):
        return {
            "nodeId": self.node_id,
            "node": self.node_type,
            "est_rows": self.est_rows,
            "upper_bound_rows": self.upper_bound_rows,
            "exact": self.exact,
            "strategy": self.strategy,
            "row_bytes": self.row_bytes,
        }


@dataclass
class NodeStats:
    """Actuals for one plan node."""

    node_type: str
    detail: str = ""
    node_id: int = -1
    wall_s: float = 0.0
    input_rows: int = -1  # -1: not measured
    output_rows: int = -1  # -1: not measured
    output_bytes: int = -1  # live-row payload bytes of the node's output
    device_bytes: int = -1  # device-buffer (capacity) bytes observed
    invocations: int = 0
    #: plan-time predicted rows (copied from NodeEstimate at finalize)
    est_rows: int = -1
    #: planner-chosen join or aggregation strategy ("" else)
    strategy: str = ""
    #: the worst max/mean delivered-row ratio of the exchanges this
    #: node drove (mesh runs; 0.0: no partitioned exchange)
    skew: float = 0.0
    exchange_rows: int = 0
    hot_partition: int = -1
    #: a planned fused route fell back at runtime (the OOM ladder's record)
    route_fallback: bool = False
    #: executed out-of-core mode ("" = resident)
    spill_mode: str = ""
    spill_partitions: int = 0
    spill_resident: int = 0
    spill_host_bytes: int = 0

    @property
    def misest(self) -> float:
        """Symmetric est-vs-actual factor (0.0 when unmeasured)."""
        if self.est_rows < 0 or self.output_rows < 0:
            return 0.0
        return misestimate_ratio(self.est_rows, self.output_rows)

    def to_dict(self):
        return {
            "node": self.node_type,
            "detail": self.detail,
            "nodeId": self.node_id,
            "wall_s": round(self.wall_s, 6),
            "input_rows": self.input_rows,
            "output_rows": self.output_rows,
            "output_bytes": self.output_bytes,
            "device_bytes": self.device_bytes,
            "invocations": self.invocations,
            "est_rows": self.est_rows,
            "strategy": self.strategy,
            "misest": round(self.misest, 3),
            "skew": round(self.skew, 3),
            "exchange_rows": self.exchange_rows,
            "hot_partition": self.hot_partition,
            "route_fallback": self.route_fallback,
            "spill_mode": self.spill_mode,
            "spill_partitions": self.spill_partitions,
            "spill_resident": self.spill_resident,
            "spill_host_bytes": self.spill_host_bytes,
        }


class StatsRecorder:
    """Collects NodeStats keyed by stable per-query node id."""

    def __init__(self, measure_rows: bool = True):
        self.ids = NodeIds()
        self.nodes: dict[int, NodeStats] = {}
        #: plan-time estimate snapshot, same node-id key space
        self.estimates: dict[int, NodeEstimate] = {}
        self.measure_rows = measure_rows

    def attach_plan(self, plan) -> None:
        """Pre-assign deterministic pre-order ids for a plan about to run."""
        self.ids.assign(plan)

    def attach_estimates(self, plan, catalog, approx_join: bool = False,
                         join_build_budget: int | None = None,
                         plan_hints: dict | None = None,
                         agg_bypass: bool = True) -> None:
        """Snapshot the planner's per-node predictions before execution:
        estimated rows, the sound upper bound and its exactness, the
        planned join strategy or aggregation strategy, and the physical
        row width. A per-node stats gap degrades that node's snapshot,
        never the query."""
        from presto_tpu_torch.exec.leaf_route import agg_strategy_for
        from presto_tpu_torch.exec.local_planner import planned_join_strategy
        from presto_tpu_torch.plan import nodes as N
        from presto_tpu_torch.plan.bounds import estimate_record
        from presto_tpu_torch.runtime.memory import node_row_bytes

        def walk(node):
            nid = self.ids.of(node)
            est, ub, exact = 1, None, False
            try:
                rec = estimate_record(node, catalog)
                est, ub, exact = rec["est_rows"], rec["upper_bound_rows"], rec["exact"]
            except Exception:  # noqa: BLE001 -- stats gaps never block
                pass
            strategy = ""
            if isinstance(node, (N.Join, N.SemiJoin)):
                try:
                    strategy = planned_join_strategy(
                        node, catalog, join_build_budget=join_build_budget,
                        approx_join=approx_join)
                except Exception:  # noqa: BLE001
                    strategy = ""
            elif isinstance(node, N.Aggregate):
                try:
                    # recorder runs skip the leaf route (true per-node
                    # actuals), so record the strategy this run uses
                    strategy = agg_strategy_for(node, catalog, hints=plan_hints,
                                                bypass_enabled=agg_bypass,
                                                fused_enabled=False)
                except Exception:  # noqa: BLE001
                    strategy = ""
            try:
                rb = node_row_bytes(node, catalog)
            except Exception:  # noqa: BLE001
                rb = -1
            self.estimates[nid] = NodeEstimate(nid, type(node).__name__, int(est), ub,
                                               bool(exact), strategy, rb)
            for c in node.children:
                walk(c)

        walk(plan)

    def node_id(self, node) -> int:
        return self.ids.of(node)

    def record(self, node, wall_s: float, output_rows: int = -1,
               output_bytes: int = -1, device_bytes: int = -1):
        key = self.ids.of(node)
        st = self.nodes.get(key)
        if st is None:
            st = NodeStats(type(node).__name__, node_id=key)
            self.nodes[key] = st
        st.wall_s += wall_s
        st.invocations += 1
        # rows and bytes accumulate across invocations, like wall_s: a
        # node dispatched more than once reports its total
        if output_rows >= 0:
            st.output_rows = output_rows if st.output_rows < 0 else st.output_rows + output_rows
        if output_bytes >= 0:
            st.output_bytes = (output_bytes if st.output_bytes < 0
                               else st.output_bytes + output_bytes)
        if device_bytes >= 0:
            st.device_bytes = max(st.device_bytes, device_bytes)

    def record_skew(self, node, ratio: float, rows: int = 0,
                    hot: Optional[int] = None) -> None:
        """Attach an exchange-skew observation to the node that drove the
        exchange (the distributed executor's end-of-run flush): the WORST
        ratio wins, and ``hot`` names that exchange's hottest destination
        (it rides the plan-stats history)."""
        key = self.ids.of(node)
        st = self.nodes.get(key)
        if st is None:
            st = NodeStats(type(node).__name__, node_id=key)
            self.nodes[key] = st
        if float(ratio) >= st.skew and hot is not None:
            st.hot_partition = int(hot)
        st.skew = max(st.skew, float(ratio))
        st.exchange_rows += int(rows)

    def record_route_fallback(self, node) -> None:
        """Mark a node whose planner-chosen fused route fell back at run
        time (its build's advisory stats were violated); the plan-stats
        history carries it to the adaptive controller."""
        key = self.ids.of(node)
        st = self.nodes.get(key)
        if st is None:
            st = NodeStats(type(node).__name__, node_id=key)
            self.nodes[key] = st
        st.route_fallback = True

    def record_spill(self, node, mode: str, partitions: int, resident: int,
                     host_bytes: int) -> None:
        """Record an executed out-of-core decision on ``node``'s stats
        (the spill tier's strategy points): the mode that ran, how many
        partitions stayed resident and the peak host bytes its spill
        stores held."""
        key = self.ids.of(node)
        st = self.nodes.get(key)
        if st is None:
            st = NodeStats(type(node).__name__, node_id=key)
            self.nodes[key] = st
        st.spill_mode = mode
        st.spill_partitions = int(partitions)
        st.spill_resident = int(resident)
        st.spill_host_bytes = max(st.spill_host_bytes, int(host_bytes))

    def stats_for(self, node) -> Optional[NodeStats]:
        nid = self.ids.get(node)
        return None if nid is None else self.nodes.get(nid)

    def estimate_for(self, node) -> Optional[NodeEstimate]:
        nid = self.ids.get(node)
        return None if nid is None else self.estimates.get(nid)

    def finalize(self, plan) -> None:
        """Derive each node's input_rows from its children's measured
        output_rows, and copy each executed node's plan-time estimate
        and strategy onto its NodeStats."""

        def walk(node):
            st = self.stats_for(node)
            if st is not None and node.children:
                total, known = 0, False
                for c in node.children:
                    cst = self.stats_for(c)
                    if cst is not None and cst.output_rows >= 0:
                        total += cst.output_rows
                        known = True
                if known:
                    st.input_rows = total
            for c in node.children:
                walk(c)

        walk(plan)
        for nid, est in self.estimates.items():
            st = self.nodes.get(nid)
            if st is not None:
                st.est_rows = est.est_rows
                st.strategy = est.strategy

    def estimate_vs_actual(self) -> list:
        """Per-node (node_id, node_type, est, actual, selectivity,
        strategy, misest, ...) records, the rows a plan-stats history
        keeps under the query's plan fingerprint."""
        out = []
        for nid in sorted(self.estimates):
            est = self.estimates[nid]
            st = self.nodes.get(nid)
            actual = -1 if st is None else st.output_rows
            sel = -1.0
            if st is not None and st.input_rows > 0 and st.output_rows >= 0:
                sel = st.output_rows / st.input_rows
            out.append({
                "node_id": nid,
                "node_type": est.node_type,
                "est_rows": est.est_rows,
                "actual_rows": actual,
                "selectivity": sel,
                "strategy": est.strategy,
                "misest": misestimate_ratio(est.est_rows, actual),
                "skew": 0.0 if st is None else round(st.skew, 3),
                "hot_partition": -1 if st is None else st.hot_partition,
                "spill_mode": "" if st is None else st.spill_mode,
                "wall_s": 0.0 if st is None else round(st.wall_s, 6),
                "route_fallback": False if st is None else bool(st.route_fallback),
            })
        return out


@dataclass
class QueryInfo:
    """One executed query's record. Wall-clock fields are for display;
    durations come from the monotonic mirrors (``*_mono``). A local run
    sets ``query_id``, ``sql``, ``state``, the timestamps,
    ``planning_s``, ``error`` / ``error_code`` / ``retryable``,
    ``approximate``, ``output_rows`` and ``node_stats``; the lifecycle,
    pool, cache, coalescing and batching fields keep their defaults."""

    query_id: str
    sql: str
    state: str  # QUEUED -> RUNNING -> FINISHED | FAILED
    created_at: float
    trace_token: Optional[str] = None
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    created_mono: Optional[float] = None
    started_mono: Optional[float] = None
    finished_mono: Optional[float] = None
    #: host time spent in parse/analyze/prune before tracking started
    planning_s: float = 0.0
    error: Optional[str] = None
    error_code: Optional[str] = None
    retryable: Optional[bool] = None
    fragment_retries: int = 0
    degraded: bool = False
    oom_retries: int = 0
    rung_history: list = field(default_factory=list)
    retry_events: list = field(default_factory=list)
    memory_queued_s: float = 0.0
    memory_reserved_bytes: int = 0
    cache_hit: bool = False
    template_hit: bool = False
    coalesced: bool = False
    batched: bool = False
    tenant: str = ""
    #: True when the run probed an approximate join sketch
    approximate: bool = False
    output_rows: int = -1
    node_stats: list = field(default_factory=list)  # list[NodeStats.to_dict()]
    #: per-query metric deltas (runtime/metrics.QueryMetricsDelta
    #: snapshot of the run): every counter, timer and histogram the query
    #: moved, attributed to THIS query even under concurrency; moves after
    #: the run (``query.completed``, ``query.failed``) under ``post_run.``
    metrics: dict = field(default_factory=dict)
    #: strategies of the joins this run executed (comma-joined
    #: ``join.strategy.*`` delta names, e.g. "dense,pallas"; "")
    join_strategy: str = ""
    #: mean runtime-join-filter selectivity observed (fraction of probe
    #: scan rows KEPT; -1.0 when no filter fired)
    filter_selectivity: float = -1.0
    oom_rung: int = 0
    device_peak_bytes: int = 0
    subscription_id: str = ""
    batch_size: int = 0

    def attribute_metrics(self, deltas: dict) -> None:
        """Fold a per-query metric-delta snapshot into this record: the
        raw deltas land in ``metrics`` (zero-valued entries dropped), and
        the derived columns (executed join strategies, mean filter
        selectivity, final OOM rung) are computed here, so every consumer
        reads one attribution."""
        self.metrics = {k: v for k, v in deltas.items() if v}
        prefix = "join.strategy."
        self.join_strategy = ",".join(sorted(
            k[len(prefix):] for k, v in deltas.items() if k.startswith(prefix) and v > 0))
        n = deltas.get("join.filter_selectivity.count", 0.0)
        self.filter_selectivity = (deltas.get("join.filter_selectivity.total", 0.0) / n
                                   if n else -1.0)
        self.oom_rung = int(deltas.get("query.oom_degraded", 0))

    @property
    def queued_s(self) -> float:
        """QUEUED -> RUNNING (monotonic; 0 while still queued)."""
        if self.created_mono is None or self.started_mono is None:
            return 0.0
        return max(0.0, self.started_mono - self.created_mono)

    @property
    def execution_s(self) -> float:
        """RUNNING -> terminal (monotonic; live queries read 'so far')."""
        if self.started_mono is None:
            return 0.0
        end = self.finished_mono if self.finished_mono is not None else time.monotonic()
        return max(0.0, end - self.started_mono)

    @property
    def elapsed_s(self) -> float:
        if self.started_mono is not None:
            return self.execution_s
        if self.started_at is None:
            return 0.0
        end = self.finished_at if self.finished_at is not None else time.time()
        return end - self.started_at

    def to_json(self) -> str:
        return json.dumps({
            "queryId": self.query_id,
            "sql": self.sql,
            "state": self.state,
            "traceToken": self.trace_token,
            "createdAt": self.created_at,
            "startedAt": self.started_at,
            "finishedAt": self.finished_at,
            "elapsedS": round(self.elapsed_s, 6),
            "queuedS": round(self.queued_s, 6),
            "planningS": round(self.planning_s, 6),
            "executionS": round(self.execution_s, 6),
            "error": self.error,
            "errorCode": self.error_code,
            "retryable": self.retryable,
            "fragmentRetries": self.fragment_retries,
            "degraded": self.degraded,
            "oomRetries": self.oom_retries,
            "rungHistory": self.rung_history,
            "retryEvents": self.retry_events,
            "memoryQueuedS": round(self.memory_queued_s, 6),
            "memoryReservedBytes": self.memory_reserved_bytes,
            "cacheHit": self.cache_hit,
            "templateHit": self.template_hit,
            "coalesced": self.coalesced,
            "batched": self.batched,
            "tenant": self.tenant,
            "approximate": self.approximate,
            "outputRows": self.output_rows,
            "nodeStats": self.node_stats,
            "metrics": {k: self.metrics[k] for k in sorted(self.metrics)},
            "joinStrategy": self.join_strategy,
            "filterSelectivity": round(self.filter_selectivity, 6),
            "oomRung": self.oom_rung,
            "devicePeakBytes": self.device_peak_bytes,
            "subscriptionId": self.subscription_id,
            "batchSize": self.batch_size,
        })


def _fmt_bytes(n: int) -> str:
    if n < 0:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"  # pragma: no cover


def render_analyzed_plan(plan, recorder: StatsRecorder, tracer=None) -> str:
    """EXPLAIN ANALYZE rendering: the plan tree annotated with actuals,
    the planner's row estimate against what happened (``est E->A (Nx)``,
    flagged ``MISEST`` past :data:`MISEST_FACTOR`) and the planned
    strategy, followed by a tracer's exchange and cache span roll-ups
    when one is given."""
    lines = []

    def est_part(node, st) -> str:
        est = recorder.estimate_for(node)
        if est is None:
            return ""
        actual = -1 if st is None else st.output_rows
        if actual < 0:
            return f", est {est.est_rows:,}->?"
        ratio = misestimate_ratio(est.est_rows, actual)
        flag = " MISEST" if ratio >= MISEST_FACTOR else ""
        return f", est {est.est_rows:,}->{actual:,} ({ratio:.1f}x{flag})"

    def walk(node, indent):
        pad = "  " * indent
        name = type(node).__name__
        st = recorder.stats_for(node)
        est = recorder.estimate_for(node)
        strat = f"  strategy={est.strategy}" if est is not None and est.strategy else ""
        if st is not None:
            rows = "?" if st.output_rows < 0 else f"{st.output_rows:,}"
            in_rows = "?" if st.input_rows < 0 else f"{st.input_rows:,}"
            skew = f", skew {st.skew:.1f}x" if st.skew > 0 else ""
            spill = ""
            if st.spill_mode:
                spill = (f", spill {st.spill_mode}"
                         f"({st.spill_resident}/{st.spill_partitions} "
                         f"resident, host {_fmt_bytes(st.spill_host_bytes)})")
            lines.append(
                f"{pad}{name}  [wall {st.wall_s * 1e3:.1f}ms, "
                f"rows {in_rows}->{rows}"
                f"{est_part(node, st)}, "
                f"bytes {_fmt_bytes(st.output_bytes)}, "
                f"calls {st.invocations}{skew}{spill}]" + strat
            )
        else:
            lines.append(f"{pad}{name}  [not executed{est_part(node, st)}]" + strat)
        for c in node.children:
            walk(c, indent + 1)

    walk(plan, 0)
    if tracer is not None:
        ex = tracer.spans_by_cat("exchange")
        if ex:
            total = sum(int(s.args.get("bytes", 0)) for s in ex)
            rounds = sum(int(s.args.get("rounds", 0)) for s in ex)
            wall = sum(max(s.t1 - s.t0, 0.0) for s in ex)
            lines.append(f"exchanges: {len(ex)} dispatches, {_fmt_bytes(total)} "
                         f"moved, {rounds} rounds, wall {wall * 1e3:.1f}ms")
        for s in tracer.spans_by_cat("cache"):
            extra = ", ".join(f"{k}={v}" for k, v in sorted(s.args.items()))
            lines.append(f"cache: {s.name} {max(s.t1 - s.t0, 0.0) * 1e3:.2f}ms"
                         + (f" ({extra})" if extra else ""))
    return "\n".join(lines) + "\n"
