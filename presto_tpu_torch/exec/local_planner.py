"""Local execution: logical plan -> operator pipelines -> batches.

Counterpart of ``presto_tpu/exec/local_planner.py`` for the resident
tier: scans stream one device batch per split, filters and projections
map over the stream, joins build in device memory, and aggregations
fold into device-resident state. The physical decisions are the JAX
package's, made from the same stats:

- the fused leaf route first (``exec/leaf_route.py``): a scan -> filter
  -> aggregate fragment over stats-bounded columns runs as one fused
  kernel step per scan batch, falling back (counted) on a runtime
  ``value_overflow``; keyless aggregates otherwise take
  ``GlobalAggregationOperator``;
- grouping strategy: direct addressing when every key is a small
  dictionary domain (product <= the ``direct_group_limit`` session
  property, default ``DIRECT_LIMIT``), else the bounded sort strategy
  sized from the estimated rows, with the partial-aggregation bypass
  (``exec/leaf_route.bypass_partial_agg``, the ``partial_agg_bypass``
  property) when groups approach rows;
- join probe: the fused lookup-table kernels (``ops/cuda_join``) when
  the build key's stats domain fits their tables, else a dense
  direct-address table when the domain is tight, else the sorted
  search probe (``planned_join_strategy`` renders the plan's choice);
  semi and anti joins (``_exec_semijoin``) take the same rungs with the
  membership probes, and under ``approx_join`` a semi join whose exact
  table does not fit probes the Bloom sketch (the run is then flagged
  ``used_approx``, which ``QueryResult.approximate`` reports);
- a join whose build keys may repeat takes the expansion probe, its
  output capacity sized lazily from the first probe batch and doubled on
  ``CapacityOverflow`` (``_retrying_expand_probe``); a FULL OUTER join
  probes with LEFT semantics, accumulating matched-build flags, and then
  emits the never-matched build rows (``_exec_full_join``); the analyzer
  turns a RIGHT join into a LEFT join with its sides swapped;
- join keys normalize to one int64 (``exec/joinkeys.py``); a hash key's
  verify pairs go to the probe, which checks candidates by value;
- runtime join filters (``runtime_join_filters``, on by default): an
  inner or semi join eligible by ``plan/joinfilters.filter_edge_for``
  registers a ``JoinFilterSlot`` on its probe scan before the probe side
  executes; the slot starts at the build key's declared stats interval
  and takes the finished build's (min, max) and Bloom words, and the
  scan clears the live bit of each row outside them
  (``join.filter_rows_in`` / ``join.filter_rows_pruned``, read back once
  per query);
- capacities retry and double on ``CapacityOverflow``;
- a Union concatenates its child streams lazily, re-encoding a VARCHAR
  column whose children carry different dictionaries into their merge;
  a Limit keeps the first rows in stream order (split order); a SELECT
  without FROM reads one row of no columns (``Values``);
- scalar subqueries: ``BindScalars`` runs each ``ScalarValue``'s subplan
  first and reads its one value on the host (``_eval_scalar``), and every
  operator below sees its expressions with the ``Unbound`` slots bound
  to literals (``bind_scalars``) through the ``scalars`` dict each
  ``_exec_*`` receives;
- a plan template's literal slots (``expr.Param``) read the bound
  device scalars in ``params``, installed as the ambient
  ``expr.param_scope`` for the whole run;
- under a ``StatsRecorder`` (``recorder``: EXPLAIN ANALYZE,
  ``Session.execute``) each node's output stream is materialized at its
  dispatch and its wall, live rows and bytes recorded, and the leaf
  route is skipped so every node's actuals are true;
- every node's dispatch runs in a ``node:<Type>`` trace span (with its
  stable ``plan_node_id``) through the lifecycle's ``run_fragment``
  (``fragment:<Type>``: the deadline and cancel check, retries of a
  retryable failure, a backend OOM mapped to ``DeviceOutOfMemory``), the
  sink's drain in ``node:Output`` / ``fragment:Output``, each runtime
  filter application in ``join_filter``; scans check the deadline at
  each split, on the query's thread; the JAX package's fault points sit
  at its sites (``scan`` per split, ``aggregation`` and ``step.agg`` per
  aggregate, ``step.join_build`` per resident build,
  ``step.grouped_join`` per spilled join);
- out of core (``exec/spill.py``, ``exec/grouped.py``): a join, semi or
  anti join whose build estimate (``runtime/memory.estimate_node_bytes``)
  exceeds ``join_build_budget``, or a keyed aggregation whose estimated
  state does, runs planned hybrid or grouped: both sides hash-bucketed to
  budget-accounted host RAM, the resident buckets joined (or aggregated)
  as one pass and the cold units streamed back through the two-slot
  transfer pipeline, each unit probed by the plain sorted or dense probe
  at one shared capacity; the spill stores live until the run's drain
  ends;
- the OOM ladder (``exec/ladder.OomLadderMixin``): at rung > 0 every
  join re-plans out of core with more buckets, and the fused leaf route,
  the partial-aggregation bypass and the runtime join filters are off.

Plan-stats history steers a recurring plan: ``plan_hints`` feed the
aggregation bypass and the spill tier's hot partition, and the adaptive
controller's decisions (``adaptive``: ``join_flip`` and ``bucket`` size
a build or an aggregation from actuals, ``route`` turns a lying fused
route off) are applied at the strategy points and noted in
``adaptive_events``. Operator steps come from the executable cache
(``cache/exec_cache.py``), join-key bounds from the stats cache.

Sampled scans (``scan_sample_fraction`` < 1, the ``approx_scan_fraction``
property): a table scan keeps an evenly strided subset of its splits, the
run is flagged ``used_approx`` and ``scan.splits_sampled_out`` counts the
splits left out. A plan node without an executor here raises
``NotSupported``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, QueryResult
from presto_tpu_torch.cache import stats_cache
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.exec import leaf_route
from presto_tpu_torch.exec.joinkeys import declared_key_interval, join_key_exprs
from presto_tpu_torch.exec.grouped import HostSpill, bucket_batches, bucket_ids_for, spill_stream
from presto_tpu_torch.exec.joins import (
    BuildOutput,
    JoinBuildOperator,
    LookupJoinOperator,
    full_init_flags,
    full_tail,
)
from presto_tpu_torch.exec.ladder import OomLadderMixin
from presto_tpu_torch.exec.operators import (
    AggSpec,
    CapacityOverflow,
    DirectStrategy,
    FilterProjectOperator,
    GlobalAggregationOperator,
    HashAggregationOperator,
    LimitOperator,
    NullGroupKeys,
    OrderByOperator,
    SortKey,
    SortStrategy,
    TopNOperator,
    align_batch_dicts,
    concat_batches,
    union_target_dicts,
    valid_of,
    window_operator_from_node,
)
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline, prefetch_iter
from presto_tpu_torch.exec.spill import expand_units, fit_resident, plan_spill, transfer_iter
from presto_tpu_torch.expr import InputRef, bind_scalars, evaluate, param_scope
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops.hashing import bloom_test, partition_ids
from presto_tpu_torch.ops.groupby import ValueBitsOverflow
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.bounds import agg_value_bits, estimate_rows, key_dictionary
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.plan.joinfilters import filter_edge_for
from presto_tpu_torch.runtime.errors import InternalError, NotSupported, UserError
from presto_tpu_torch.runtime.faults import fault_point
from presto_tpu_torch.runtime.lifecycle import check_deadline, run_fragment
from presto_tpu_torch.runtime.memory import (
    HostSpillBudget,
    device_budget_bytes,
    estimate_node_bytes,
    executor_budget_bytes,
    global_host_spill_budget,
    node_row_bytes,
)
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.stats import NodeIds
from presto_tpu_torch.runtime.trace import batch_device_bytes, batch_row_bytes
from presto_tpu_torch.runtime.trace import add_complete
from presto_tpu_torch.runtime.trace import current as current_trace
from presto_tpu_torch.runtime.trace import span as trace_span
from presto_tpu_torch.spi import batch_capacity
from presto_tpu_torch.types import TypeKind

DIRECT_LIMIT = 4096
MAX_GROUP_CAP = 1 << 20
MAX_RETRIES = 6

#: payload column kinds the fused probe's int32 value tables carry
_PALLAS_PAYLOAD_KINDS = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DATE,
                         TypeKind.DECIMAL, TypeKind.VARCHAR, TypeKind.BOOLEAN)


class JoinFilterSlot:
    """One runtime join filter: a join's build side -> its probe scan.

    Registered on the probe scan before the probe side executes, it
    starts at the build key's DECLARED stats interval, so the scan prunes
    before (or without) the build's products, and tightens to the build's
    exact (min, max) and Bloom words when the build finishes. The scan
    reads the slot per batch. The pruning counts accumulate as device
    scalars and are read back once per query."""

    __slots__ = ("col", "declared", "minmax", "bloom", "stat_in", "stat_pruned")

    def __init__(self, col: str, declared):
        self.col = col
        self.declared = declared
        self.minmax = None  # (0-d min, 0-d max) over the live build keys
        self.bloom = None  # the Bloom words
        self.stat_in = None
        self.stat_pruned = None

    def bounds(self):
        """(min, max), or None while nothing is known (no declared
        interval, build not finished)."""
        return self.minmax if self.minmax is not None else self.declared


def live_count(batch: Batch) -> int:
    """Host-side live-row count."""
    return int(batch.count())


def pick_group_strategy(keys, pax, dict_len, est_rows: int,
                        direct_limit: int = DIRECT_LIMIT):
    """Direct addressing for small dictionary-key domains, bounded
    merge-by-sort otherwise. ``dict_len``: name -> dictionary domain size
    (None when unknown); ``est_rows`` sizes the sort strategy's group
    capacity, backed by overflow-retry doubling."""
    if not pax and keys:
        domains = []
        for _, e in keys:
            d = (dict_len(e.name)
                 if isinstance(e, InputRef) and e.dtype.kind is TypeKind.VARCHAR else None)
            if d is None:
                break
            domains.append(d)
        else:
            if domains and int(np.prod(domains)) <= direct_limit:
                strides = []
                acc = 1
                for d in reversed(domains):
                    strides.append(acc)
                    acc *= d
                strides.reverse()
                return DirectStrategy(tuple(0 for _ in domains), tuple(strides),
                                      int(np.prod(domains)))
    return SortStrategy(min(batch_capacity(max(est_rows, 16)), MAX_GROUP_CAP))


def build_key_interval(node, catalog):
    """The stats interval of a join's single build key: the dense and
    fused-probe decisions both derive from it, in EXPLAIN and in
    execution. A packed multi-key build has none and takes the sorted
    probe, as in the JAX package."""
    if len(node.right_keys) != 1:
        return None
    return declared_key_interval(node.right, node.right_keys[0], catalog)


def default_join_build_budget(device=None) -> int:
    """The build budget when ``join_build_budget_bytes`` is unset: a
    quarter of ``device``'s budget (the default device's when None;
    ``runtime/memory.py``)."""
    return (device_budget_bytes() if device is None else executor_budget_bytes(device)) // 4


def planned_spill(node, catalog, join_build_budget: int | None = None):
    """The planned out-of-core shape of a join's build at rung 0
    (``exec/spill.plan_spill`` over its estimate and the budget)."""
    budget = default_join_build_budget() if join_build_budget is None else join_build_budget
    return plan_spill(estimate_node_bytes(node.right, catalog), budget)


def planned_join_strategy(node, catalog, join_build_budget: int | None = None,
                          approx_join: bool = False) -> str:
    """The probe strategy the executor will pick for this join or semi
    join, from stats alone, the JAX package's rule: hybrid or grouped
    (the build's estimate exceeds ``join_build_budget``; a FULL join
    stays in memory) > pallas (fused lookup-table probe) > sketch(approx)
    (under ``approx_join``, a non-negated semi join whose exact table
    does not fit) > dense (direct-address table) > unique (sorted probe)
    > expand. Advisory like every stats decision: a runtime
    ineligibility degrades one rung, counted."""
    semi = isinstance(node, N.SemiJoin)
    if semi or node.kind != "full":
        decision = planned_spill(node, catalog, join_build_budget)
        if decision.mode != "resident":
            return decision.mode
    iv = build_key_interval(node, catalog)
    unique = True if semi else node.unique
    if iv is not None and cuda_join.interval_ok(iv[0], iv[1]):
        domain = iv[1] - iv[0] + 1
        outs = () if semi else node.output_right
        if not outs and (semi or (unique and node.kind == "inner")) \
                and cuda_join.exists_words(domain):
            return "pallas"
        if outs and unique and node.kind in ("inner", "left") \
                and len(outs) <= cuda_join.MAX_VALUES \
                and cuda_join.payload_rows(domain, len(outs)):
            return "pallas"
    if approx_join and semi and not node.negated:
        return "sketch(approx)"
    if iv is not None and unique and not semi and 0 < iv[1] - iv[0] + 1 <= (1 << 31) - 1:
        return "dense"
    if unique:
        return "dense" if iv is not None else "unique"
    return "expand"


def _probe_capacity(lspill, nbuckets: int, probe_chunk: int, extra=()) -> int:
    """The shared capacity of a spilled join's probe chunks: bounded by
    the rows a chunk can carry (``probe_chunk`` caps accumulation, the
    largest bucket caps the data, a single oversized spill chunk passes
    whole). ``extra``: the streamed units' own stores (a recursive split
    moves rows out of ``lspill``), which the capacity covers too."""
    max_bucket = max((lspill.bucket_rows(b) for b in range(nbuckets)), default=0)
    max_chunk = lspill.max_chunk_rows()
    for sp in extra:
        if sp is None or sp is lspill:
            continue
        max_bucket = max(max_bucket, max((sp.bucket_rows(b) for b in range(sp.nbuckets)),
                                         default=0))
        max_chunk = max(max_chunk, sp.max_chunk_rows())
    return batch_capacity(max(min(probe_chunk, max_bucket), max_chunk, 16), minimum=16)


def _join_filter_step(name: str):
    """The runtime join filter's step over column ``name``: (new live
    mask, live rows in, rows pruned), the counts left on the device. A
    NULL key cannot join, so it is pruned too."""

    def step(b: Batch, mn, mx, words):
        col = b[name]
        k = col.data.to(torch.int64)
        keep = (k >= mn) & (k <= mx) & valid_of(col.valid, b.live)
        if words is not None:
            keep = keep & bloom_test(words, col.data)
        live = b.live & keep
        return live, b.live.sum(), (b.live & ~live).sum()

    return step


class LocalExecutor(OomLadderMixin):
    #: the template batch gate may hand this executor's plans to the
    #: batched dispatcher (``server/batcher.py``)
    supports_batched_dispatch = True

    def __init__(self, catalog: Catalog, pallas_join_enabled: bool = True,
                 approx_join: bool = False, runtime_join_filters: bool = True,
                 device="cuda", join_build_budget: int | None = None,
                 spill_host_budget: int | None = None, scan_sample_fraction: float = 1.0,
                 direct_group_limit: int = DIRECT_LIMIT, agg_bypass: bool = True):
        self.catalog = catalog
        #: the largest dictionary-key domain product the direct
        #: aggregation strategy addresses (``direct_group_limit``)
        self.direct_group_limit = direct_group_limit
        #: the adaptive partial-aggregation bypass may fire (the
        #: ``partial_agg_bypass`` session property)
        self.agg_bypass = agg_bypass
        #: APPROXIMATE sampled scans: below 1.0 each table scan keeps an
        #: evenly strided subset of its splits and the run is flagged
        #: ``used_approx``
        self.scan_sample_fraction = float(scan_sample_fraction or 1.0)
        #: push join build-key bounds and Bloom words into probe scans
        self.runtime_join_filters = runtime_join_filters
        #: id(probe scan node) -> [JoinFilterSlot]
        self._scan_filters: dict[int, list[JoinFilterSlot]] = {}
        #: the query's runtime join-key min/max readbacks, by content
        self._minmax_memo: dict = {}
        #: prefer the fused lookup-table probe where stats permit
        self.pallas_join_enabled = pallas_join_enabled
        #: semi joins whose exact table does not fit may probe the Bloom
        #: sketch (approximate: false positives, never false negatives)
        self.approx_join = approx_join
        #: set when this run published a sketch a semi join probes: its
        #: result may carry false-positive rows, and says so
        self.used_approx = False
        #: where an empty aggregation state lives
        self.device = resolve_device(device)
        #: the plan template's literal-slot values (device scalars,
        #: ``plan/templates.device_params``), set by the Session
        self.params: tuple = ()
        #: optional StatsRecorder for the current query (set by the
        #: Session; powers QueryInfo node stats and EXPLAIN ANALYZE)
        self.recorder = None
        #: plan-stats history of this plan's fingerprint ({id(plan node):
        #: record}, runs >= 2 only; set by the Session)
        self.plan_hints: dict = {}
        #: the query's adaptive decisions, set by the Session
        #: (``plan/adaptive.py``: {id(node) -> {kind -> decision}})
        self.adaptive: dict = {}
        #: the current run's applied adaptive decisions (``_note_adaptive``)
        self.adaptive_events: list = []
        #: stable plan-node ids for trace spans when no recorder is set
        self._trace_ids = None
        #: estimated build sides (and aggregation states) above this many
        #: bytes run out of core (``exec/spill.py``)
        self.join_build_budget = (default_join_build_budget(self.device)
                                  if join_build_budget is None else join_build_budget)
        #: the OOM ladder's rung (``exec/ladder.py``; the lifecycle bumps
        #: it through ``degrade_for_oom`` and re-runs the plan)
        self.oom_rung = 0
        #: host-RAM bytes the spill stores may hold (None: the process-wide
        #: budget, ``runtime/memory.global_host_spill_budget``)
        self.spill_host_budget = spill_host_budget
        self._host_budget = None
        #: the current run's executed spill decisions (``_note_spill``)
        self.spill_events: list = []
        #: live HostSpill stores of the current run, released when its
        #: drain ends: streams are replayable (a fragment retry re-drains),
        #: so the host partitions outlive each stream
        self._spill_stores: list = []

    # ------------------------------------------------------------------
    def run(self, plan: N.PlanNode) -> QueryResult:
        """Execute to a ``QueryResult`` (names + host arrays)."""
        if not isinstance(plan, N.Output):
            raise InternalError("top-level plan must be an Output node")
        # per run: the OOM ladder re-enters run() on the same executor
        self.used_approx = False
        self.spill_events = []
        self.adaptive_events = []
        batches, names = self.run_batches(plan)
        return QueryResult(names, [b for b in batches if live_count(b) > 0],
                           approximate=self.used_approx)

    def run_batches(self, plan: N.Output):
        # a scalar subquery's subplan (an Output) runs here too, with
        # scalars of its own
        if self.recorder is not None:
            self.recorder.attach_plan(plan)
        self._minmax_memo.clear()
        scalars: dict = {}
        rename = dict(zip(plan.sources, plan.names))
        # the host spill lives as long as this drain; a nested run (a
        # scalar subquery) releases only its own stores
        mark = len(self._spill_stores)
        try:
            with param_scope(self.params):
                batches = self._exec(plan.child, scalars)

                # the sink's drain is a fragment boundary too: in a plan
                # without a pipeline breaker the lazy scan work happens
                # here, and a retry re-drains the replayable stream
                def drain():
                    return [b.select(list(plan.sources)).rename(rename) for b in batches]

                with trace_span("node:Output", "node", {"plan_node_id": self._nid(plan)}):
                    out = run_fragment("fragment:Output", drain)
        finally:
            for sp in self._spill_stores[mark:]:
                sp.release()
            del self._spill_stores[mark:]
        # every scan of the run has drained: one readback of the filters'
        # pruning counts
        self._flush_filter_stats()
        return out, list(plan.names)

    def _host_spill_budget(self) -> HostSpillBudget:
        """A private budget when ``spill_host_budget_bytes`` set one, else
        the process-wide one."""
        if self._host_budget is None:
            self._host_budget = (
                HostSpillBudget(self.spill_host_budget, name="session-spill")
                if self.spill_host_budget is not None else global_host_spill_budget())
        return self._host_budget

    def _host_spill(self, nbuckets: int, tag: str = "spill"):
        """A budget-accounted HostSpill on this executor's device,
        released when the current run's drain ends."""
        spill = HostSpill(nbuckets, budget=self._host_spill_budget(), tag=tag,
                          device=self.device)
        self._spill_stores.append(spill)
        return spill

    def _exec(self, node: N.PlanNode, scalars: dict) -> BatchStream:
        """Execute a node to a replayable lazy BatchStream; ``scalars``
        holds the values of the scalar subqueries bound above it."""
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            raise NotSupported(f"executing a {type(node).__name__} node is not ported yet")
        # the lifecycle boundary around the dispatch; a lazy node's work
        # runs in its stream, so a failure there surfaces at the draining
        # ancestor's dispatch, which retries by re-running its subtree
        rec = self.recorder
        name = f"node:{type(node).__name__}"
        label = f"fragment:{type(node).__name__}"
        args = {"plan_node_id": self._nid(node)}
        if rec is None:
            with trace_span(name, "node", args):
                return run_fragment(label, lambda: m(node, scalars))
        t0 = time.perf_counter()
        with trace_span(name, "node", args) as sp:
            out = run_fragment(label, lambda: m(node, scalars))
            rows, nbytes, dev_bytes = -1, -1, -1
            if rec.measure_rows and isinstance(out, BatchStream):
                # materialize here, so the wall includes this node's work
                batches = out.materialize()
                rows, nbytes, dev_bytes = 0, 0, 0
                for b in batches:
                    lc = live_count(b)
                    rows += lc
                    nbytes += lc * batch_row_bytes(b)
                    dev_bytes += batch_device_bytes(b)
                out = BatchStream.of(batches)
        wall = time.perf_counter() - t0  # inclusive of children
        if sp is not None and rows >= 0:
            sp.args["rows"] = rows
        rec.record(node, wall, rows, output_bytes=nbytes, device_bytes=dev_bytes)
        return out

    def _nid(self, node) -> int:
        """Stable per-query plan-node id (``runtime/stats.NodeIds``)."""
        if self.recorder is not None:
            return self.recorder.node_id(node)
        if self._trace_ids is None:
            self._trace_ids = NodeIds()
        return self._trace_ids.of(node)

    # ---- leaves ----------------------------------------------------------
    def sampled_splits(self, splits: list) -> list:
        """The splits a scan reads: all of them, or under
        ``scan_sample_fraction`` < 1 an evenly strided subset,
        deterministic per split layout (repeated refreshes of one
        subscription sample alike). A sampled run is flagged
        ``used_approx``: a sampled result is never presented as exact."""
        f = self.scan_sample_fraction
        if f >= 1.0 or len(splits) <= 1:
            return splits
        n_all = len(splits)
        keep = max(1, int(round(n_all * f)))
        if keep >= n_all:
            return splits
        step = n_all / keep
        self.used_approx = True
        REGISTRY.counter("scan.splits_sampled_out").add(n_all - keep)
        return [splits[min(int(i * step), n_all - 1)] for i in range(keep)]

    def _exec_tablescan(self, node: N.TableScan, scalars) -> BatchStream:
        """Streaming scan: one device batch per split, yielded lazily;
        the next split generates on a worker thread meanwhile."""
        conn = self.catalog.connector(node.connector)
        src_cols = [s for _, s in node.columns]
        rename = {s: n for n, s in node.columns}
        op = (FilterProjectOperator(bind_scalars(node.predicate, scalars), None)
              if node.predicate is not None else None)
        splits = self.sampled_splits(list(conn.splits(node.table)))
        cap = batch_capacity(max(s.row_hint for s in splits))
        fslots = self._scan_filters.get(id(node), ())

        def load(split):
            fault_point("scan")
            b = conn.scan(split, src_cols, cap).rename(rename)
            if op is None or current_trace() is not None:
                # on the consumer's thread: the predicate's span opens here
                return (b if op is None else op.process(b)[0]), None
            t0 = time.perf_counter()
            return op.apply(b), (t0, time.perf_counter() - t0)

        def make():
            # a predicate that ran on the prefetch worker (no recorder
            # there) gets its step span here, where the JAX package opens
            # it; the filters apply as each batch is handed on, so each
            # reads its slot's state at that moment
            for b, timed in prefetch_iter(load, splits):
                # on the query's thread, where its context (deadline,
                # cancel scope, metric delta) is installed
                check_deadline("scan")
                if timed is not None:
                    add_complete("step:filter_project", "step", *timed)
                for slot in fslots:
                    b = self._apply_join_filter(slot, b)
                yield b

        return BatchStream(make)

    # ---- streaming transforms -------------------------------------------
    def _exec_filter(self, node: N.Filter, scalars) -> BatchStream:
        child = self._exec(node.child, scalars)
        op = FilterProjectOperator(bind_scalars(node.predicate, scalars), None)
        return child.map(lambda b: op.process(b)[0])

    def _exec_project(self, node: N.Project, scalars) -> BatchStream:
        child = self._exec(node.child, scalars)
        op = FilterProjectOperator(None, {n: bind_scalars(e, scalars) for n, e in node.exprs})
        return child.map(lambda b: op.process(b)[0])

    # ---- aggregation ----------------------------------------------------
    def _exec_aggregate(self, node: N.Aggregate, scalars):
        # the fused leaf route (exec/leaf_route.py): a scan -> filter ->
        # partial-agg fragment over stats-bounded NULL-free columns runs
        # as ONE fused step per scan batch (the Q1 kernel for TPC-H Q1,
        # the leaf-aggregation kernel otherwise); a runtime
        # value_overflow falls back to the generic route below, counted.
        # Skipped under a stats recorder (EXPLAIN ANALYZE needs true
        # per-node actuals) and on OOM-ladder rungs > 0 (a degraded re-run
        # takes the generic tiers)
        if self.recorder is None and self.oom_rung == 0:
            route, reason = leaf_route.match_leaf_fragment(node, self.catalog)
            if route is not None:
                routed = leaf_route.execute_leaf_route(route, self, node, scalars)
                if routed is not None:
                    REGISTRY.counter("agg.strategy.fused").add()
                    return BatchStream.of(routed)
            elif reason is not None:
                leaf_route.count_fallback(reason)

        child = self._exec(node.child, scalars)
        fault_point("aggregation")
        keys = [(n, bind_scalars(e, scalars)) for n, e in node.keys]
        pax = [(n, bind_scalars(e, scalars)) for n, e in node.passengers]
        # stats-derived |value| bounds; a violated bound trips
        # value_overflow and retries at 63 bits
        aggs = [AggSpec(a.kind, bind_scalars(a.input, scalars) if a.input is not None else None,
                        a.name, a.dtype, value_bits=b)
                for a, b in zip(node.aggs, agg_value_bits(node, self.catalog))]
        if not keys and not pax:
            REGISTRY.counter("agg.strategy.single").add()
            op = GlobalAggregationOperator(aggs, device=self.device)
            return BatchStream.of(Pipeline(child, [op]).run())
        if keys:
            # planned out-of-core aggregation: an estimated group state
            # over the budget partitions the input by key hash into host
            # buckets and aggregates bucket by bucket (a group lives in
            # one bucket). The estimate alone triggers it: a ladder rung
            # re-runs a fitting aggregation on the normal path
            agg_est = estimate_node_bytes(node, self.catalog)
            # history-corrected sizing (plan/adaptive.py): recorded
            # actuals size the grouped tier for a recurring fingerprint
            bdec = self._adaptive_decision(node, "bucket")
            if bdec is not None and bdec.est_bytes >= 0:
                agg_est = bdec.est_bytes
                self._note_adaptive(node, bdec, action=f"agg est_bytes={agg_est} from actuals")
            if agg_est > self.join_build_budget:
                decision = self._spill_decision(node, agg_est)
                hybrid = self._exec_hybrid_agg(node, child, keys, aggs, pax, decision)
                if hybrid is not None:
                    REGISTRY.counter(f"agg.strategy.{decision.mode}").add()
                    return hybrid
        strategy = self._pick_group_strategy(keys, pax, node)
        if isinstance(strategy, SortStrategy) and self._use_agg_bypass(node):
            # group cardinality ~ input cardinality: per-batch partial
            # folds reduce nothing, so aggregate the concatenated rows in
            # ONE pass with the group capacity sized by the true row count
            # (not on a ladder rung: one pass is what a degraded re-run
            # must not do)
            REGISTRY.counter("agg.strategy.bypass").add()
            batches = child.materialize()
            rows = sum(live_count(b) for b in batches)
            if batches:
                child = BatchStream.of([concat_batches(batches)])
            strategy = SortStrategy(min(batch_capacity(max(rows, 16)), MAX_GROUP_CAP))
        else:
            REGISTRY.counter("agg.strategy.partial").add()
        fault_point("step.agg")
        for _attempt in range(MAX_RETRIES):
            op = HashAggregationOperator(keys, aggs, strategy, passengers=pax,
                                         device=self.device)
            try:
                return BatchStream.of(Pipeline(child, [op]).run())
            except ValueBitsOverflow:
                aggs = [dataclasses.replace(a, value_bits=63) for a in aggs]
            except NullGroupKeys:
                # the packed direct domain has no NULL slot
                strategy = self._pick_group_strategy(keys, pax, node, force_sort=True)
            except CapacityOverflow as e:
                if e.op != "HashAggregation" or not isinstance(strategy, SortStrategy):
                    raise
                strategy = SortStrategy(strategy.max_groups * 2)
        raise CapacityOverflow("Aggregate", strategy.max_groups)

    def _use_agg_bypass(self, node: N.Aggregate) -> bool:
        """The adaptive partial-aggregation bypass for one keyed sort-
        strategy aggregation: the NDV estimate, corrected by plan-stats
        history (``leaf_route.bypass_partial_agg``), unless the session
        turned ``partial_agg_bypass`` off. Never on a ladder rung: one
        pass is what a degraded re-run must not do."""
        if not self.agg_bypass or self.oom_rung > 0:
            return False
        return leaf_route.bypass_partial_agg(node, self.catalog, hints=self.plan_hints)

    def _exec_hybrid_agg(self, node: N.Aggregate, child, keys, aggs, pax, decision):
        """Out-of-core keyed aggregation: partition the input rows by the
        hash of the whole key tuple into host buckets (every group lives
        in one bucket, so the per-bucket aggregations are disjoint and
        concatenate exactly), aggregate the resident buckets in one pass,
        then stream the cold units through the two-slot transfer
        pipeline. None when the keys cannot be hash-partitioned (BYTES
        keys): the caller takes the single-state path."""
        if any(e.dtype.kind is TypeKind.BYTES for _, e in keys):
            return None
        key_exprs = [e for _, e in keys]

        def bids(batch, modulus):
            cols = []
            for e in key_exprs:
                v = evaluate(e, batch)
                if v.data.dim() != 1:
                    raise NotImplementedError("non-scalar aggregation key in hybrid spill")
                # a NULL key hashes as 0; the per-bucket sort strategy
                # still groups NULL apart from a genuine 0
                ok = batch.live & valid_of(v.valid, batch.live)
                cols.append(torch.where(ok, v.data.to(torch.int64), 0))
            return partition_ids(cols, modulus).cpu().numpy()

        nbuckets = decision.nbuckets
        aspill = self._host_spill(nbuckets, "agg")
        for b in child:
            aspill.append(b, bids(b, nbuckets))
        row_bytes = max(node_row_bytes(node.child, self.catalog), 1)
        resident, resident_bytes = fit_resident(decision, aspill.bucket_rows, row_bytes)
        cold = [b for b in range(nbuckets) if b not in set(resident)]
        unit_budget = max(decision.budget - resident_bytes, decision.budget // 2, 1)
        units = expand_units(aspill, None, cold, unit_budget, row_bytes, build_ids=bids,
                             make_spill=lambda: self._host_spill(1, "agg-split"))
        self._note_spill(node, decision, resident=resident, streamed=len(units),
                         host_bytes=aspill.total_bytes())
        chunk_rows = self._oom_probe_chunk(1 << 18)
        chunk_cap = _probe_capacity(aspill, nbuckets, chunk_rows, extra=[u.build for u in units])
        state = {"aggs": list(aggs)}

        def agg_pass(batches, rows):
            """One bucket pass with the usual overflow retries (groups <=
            rows sizes the sort strategy)."""
            strategy = SortStrategy(min(batch_capacity(max(rows, 16)), MAX_GROUP_CAP))
            src = BatchStream.of(list(batches))
            for _ in range(MAX_RETRIES):
                op = HashAggregationOperator(keys, state["aggs"], strategy, passengers=pax,
                                             device=self.device)
                try:
                    return Pipeline(src, [op]).run()
                except ValueBitsOverflow:
                    state["aggs"] = [dataclasses.replace(a, value_bits=63)
                                     for a in state["aggs"]]
                except CapacityOverflow as e:
                    if e.op != "HashAggregation":
                        raise
                    strategy = SortStrategy(strategy.max_groups * 2)
            raise CapacityOverflow("Aggregate", strategy.max_groups)

        def load_unit(u):
            out = list(bucket_batches(u.build, u.bucket, chunk_rows, chunk_cap))
            rows = u.build.bucket_rows(u.bucket)
            if rows:
                REGISTRY.counter("spill.transfer_bytes").add(rows * row_bytes)
            return out

        def make():
            fault_point("step.agg")
            res_rows = sum(aspill.bucket_rows(b) for b in resident)
            if res_rows:
                res_chunks = [pb for b in resident
                              for pb in bucket_batches(aspill, b, chunk_rows, chunk_cap)]
                yield from agg_pass(res_chunks, res_rows)
            for u, batches in transfer_iter(load_unit, units, label="spill:transfer"):
                unit_out = []
                with trace_span("spill:unit", "step", {"residue": u.residue,
                                                       "modulus": u.modulus}):
                    rows = u.build.bucket_rows(u.bucket)
                    if rows:
                        unit_out = agg_pass(batches, rows)
                yield from unit_out

        return BatchStream(make)

    def _pick_group_strategy(self, keys, pax, node: N.Aggregate, force_sort: bool = False):
        def dict_len(name: str):
            d = key_dictionary(node.child, name, self.catalog)
            return len(d) if d is not None else None

        return pick_group_strategy(
            keys, pax, dict_len, estimate_rows(node.child, self.catalog),
            direct_limit=0 if force_sort else self.direct_group_limit)

    # ---- joins ----------------------------------------------------------
    @staticmethod
    def _dense_domain(iv, right_batches):
        """(key_min, domain) when the stats interval is tight enough for
        a dense direct-address table: at most max(2^20, 16 x build rows)
        slots, and below 2^31. None keeps the sorted build."""
        if iv is None:
            return None
        domain = iv[1] - iv[0] + 1
        rows = sum(live_count(b) for b in right_batches)
        if 0 < domain <= min(max(1 << 20, 16 * rows), (1 << 31) - 1):
            return (iv[0], int(domain))
        return None

    def _pallas_spec(self, iv, outs: tuple, rfields, unique: bool, kind: str):
        """The fused-probe configuration for a join whose build-key stats
        interval is ``iv``, or None when no table fits. Exact modes
        first; the sketch (approximate) mode only under ``approx_join``,
        only for semi joins, and only when no exact table fits."""
        if not self.pallas_join_enabled:
            return None
        if iv is not None and cuda_join.interval_ok(int(iv[0]), int(iv[1])):
            lo, hi = int(iv[0]), int(iv[1])
            domain = hi - lo + 1
            if outs:
                kinds_ok = all(rfields.get(c) is not None
                               and rfields[c].kind in _PALLAS_PAYLOAD_KINDS for c in outs)
                if (unique and kind in ("inner", "left") and kinds_ok
                        and len(outs) <= cuda_join.MAX_VALUES
                        and cuda_join.payload_rows(domain, len(outs))):
                    return cuda_join.PallasJoinSpec("payload", lo, hi, payload=tuple(outs))
            elif ((kind in ("semi", "anti") or (unique and kind == "inner"))
                    and cuda_join.exists_words(domain)):
                return cuda_join.PallasJoinSpec("exists", lo, hi)
        if self.approx_join and kind == "semi" and not outs:
            return cuda_join.PallasJoinSpec("sketch", nbits=cuda_join.SKETCH_BITS)
        return None

    @staticmethod
    def _key_upper_bound(iv):
        """The packed build's bound: a non-negative stats max, else None."""
        if iv is None or iv[0] < 0:
            return None
        return int(iv[1])

    # ---- runtime join filters -------------------------------------------
    def _register_join_filter(self, node):
        """Register the probe-scan filter slot of an INNER or SEMI join
        before its probe side executes (eligibility is
        ``joinfilters.filter_edge_for``, which EXPLAIN renders). The slot
        starts at the build key's declared stats interval. None on an OOM
        ladder rung > 0 (the degraded re-run takes no filters)."""
        if not (self.runtime_join_filters and self.oom_rung == 0):
            return None
        tgt = filter_edge_for(node)
        if tgt is None:
            return None
        scan, col = tgt
        slots = self._scan_filters.setdefault(id(scan), [])
        for s in slots:
            if s.col == col:
                return s
        slot = JoinFilterSlot(col, declared_key_interval(node.right, node.right_keys[0],
                                                         self.catalog))
        slots.append(slot)
        return slot

    def _filter_bits(self, node_right) -> int:
        """Bloom size: about 4 bits per estimated build row, a power of
        two in [2^13, 2^23]."""
        est = estimate_rows(node_right, self.catalog)
        nbits = 1 << 13
        while nbits < 4 * est and nbits < (1 << 23):
            nbits <<= 1
        return nbits

    def _fill_join_filter(self, slot, build, node_right, rkey):
        """Publish the finished build's products into the slot and feed
        the exact min/max into the cross-query stats cache (a later
        query's key packing reuses the readback)."""
        if slot is None or build.filter_minmax is None:
            return
        slot.minmax = build.filter_minmax
        slot.bloom = build.filter_bloom
        ck = stats_cache.minmax_key(self.catalog, node_right, rkey)
        if ck is not None and stats_cache.peek(ck) is None:
            mn, mx = int(slot.minmax[0]), int(slot.minmax[1])
            if mn <= mx:  # an empty build's sentinel interval would
                # poison key packing
                stats_cache.cached_minmax(ck, lambda: (mn, mx))

    def _flipped_estimate(self, node, est: int) -> int:
        """The build's byte estimate, replaced by the adaptive
        controller's history-corrected one when it decided a
        ``join_flip`` for this node."""
        fdec = self._adaptive_decision(node, "join_flip")
        if fdec is not None and fdec.est_bytes >= 0:
            est = fdec.est_bytes
            self._note_adaptive(node, fdec, action=f"build est_bytes={est} from actuals")
        return est

    def _route_disabled(self, node) -> bool:
        """The adaptive controller disabled this join's fused route."""
        rdec = self._adaptive_decision(node, "route")
        if rdec is not None:
            self._note_adaptive(node, rdec, action="pallas route disabled")
        return rdec is not None

    @staticmethod
    def _apply_join_filter(slot: JoinFilterSlot, b: Batch) -> Batch:
        """AND the filter (range, then Bloom membership) into the scan
        batch's live mask; a NULL key cannot join, so it is pruned too.
        The counts stay on the device until the query's readback."""
        bounds = slot.bounds()
        if bounds is None or slot.col not in b:
            return b
        if b[slot.col].data.dim() != 1:
            return b
        name = slot.col
        step = EXEC_CACHE.get_or_build(EXEC_CACHE.key_of("join_filter", name,
                                                         slot.bloom is not None),
                                       lambda: _join_filter_step(name))
        with trace_span("join_filter", "join", {"column": name}):
            live, n_in, pruned = step(b, bounds[0], bounds[1], slot.bloom)
        b = b.with_live(live)
        slot.stat_in = n_in if slot.stat_in is None else slot.stat_in + n_in
        slot.stat_pruned = pruned if slot.stat_pruned is None else slot.stat_pruned + pruned
        return b

    def _flush_filter_stats(self):
        """The once-per-query readback of the filters' pruning counts
        into ``join.filter_rows_in`` / ``join.filter_rows_pruned`` and a
        ``join.filter_selectivity`` observation per slot that saw rows;
        the accumulators restart."""
        for slots in self._scan_filters.values():
            for slot in slots:
                if slot.stat_in is None:
                    continue
                n_in, pruned = int(slot.stat_in), int(slot.stat_pruned)
                slot.stat_in = slot.stat_pruned = None
                REGISTRY.counter("join.filter_rows_in").add(n_in)
                REGISTRY.counter("join.filter_rows_pruned").add(pruned)
                if n_in:
                    REGISTRY.histogram("join.filter_selectivity").add(1.0 - pruned / n_in)

    def _join_keys(self, node, left: BatchStream, right, scalars):
        """(probe key, build key, verify pairs): one integer key per
        side, multi-key pairs packed or mixed (``exec/joinkeys.py``).
        Only a multi-key pair without stats-derived pack widths pays the
        runtime min/max: a replay of each side and a readback."""

        def runtime_minmax(side: int, key):
            mn, mx = 0, 0
            for b in (left if side == 0 else right):
                v = evaluate(key, b)
                live = b.live & valid_of(v.valid, b.live)
                if bool(live.any()):
                    data = v.data.to(torch.int64)[live]
                    mn, mx = min(mn, int(data.min())), max(mx, int(data.max()))
            return mn, mx

        def runtime_dict(side: int, key):
            batches = left if side == 0 else right
            b = batches.peek() if isinstance(batches, BatchStream) else (
                batches[0] if batches else None)
            if b is None or key.name not in b:
                return None
            return b[key.name].dictionary

        return join_key_exprs([bind_scalars(k, scalars) for k in node.left_keys],
                              [bind_scalars(k, scalars) for k in node.right_keys],
                              catalog=self.catalog, lnode=node.left, rnode=node.right,
                              runtime_minmax=runtime_minmax, runtime_dict=runtime_dict,
                              minmax_memo=self._minmax_memo)

    def _exec_join(self, node: N.Join, scalars):
        # the JAX package's order: the filter slot, the probe subtree, the
        # build subtree, the spill decision, the build, the keys, the
        # filter's products
        fslot = self._register_join_filter(node)
        left = self._exec(node.left, scalars)
        right_stream = self._exec(node.right, scalars)
        # out of core: a build whose estimate exceeds the budget (or any
        # build on a ladder rung) runs hybrid or grouped; a FULL join
        # stays in memory (the grouped tier has no unmatched-build tail)
        est = estimate_node_bytes(node.right, self.catalog)
        est = self._flipped_estimate(node, est)
        spill = est > self.join_build_budget
        decision = self._spill_decision(node, est)
        if decision.mode != "resident" and node.kind != "full":
            lkey, rkey, verify = self._join_keys(node, left, right_stream, scalars)
            if verify and spill:
                raise NotImplementedError("wide string keys in grouped (spilled) joins")
            if not verify:
                REGISTRY.counter(f"join.strategy.{decision.mode}").add()
                return self._exec_grouped_join(node, left, right_stream, lkey, rkey, decision)
            # a ladder-forced spill cannot verify wide string keys; the
            # estimate says the build fits, so it stays in memory
        # the build side is materialized (the lookup source concatenates
        # it); the probe side streams batch by batch
        right = right_stream.materialize()
        fault_point("step.join_build")
        lkey, rkey, verify = self._join_keys(node, left, right, scalars)
        if verify and not node.unique and node.kind != "inner":
            raise NotImplementedError("wide string keys on non-unique OUTER joins "
                                      "(verification cannot re-synthesize the "
                                      "null-extended row)")
        # the dense and fused sides serve unique builds only; hash-verified
        # keys and FULL joins never take the fused route
        iv = build_key_interval(node, self.catalog) if node.unique else None
        # a fingerprint whose fused route fell back at run time stops
        # re-attempting it (plan/adaptive.py)
        route_off = self._route_disabled(node)
        spec = (None if verify or node.kind == "full" or route_off else
                self._pallas_spec(iv, tuple(node.output_right),
                                  {f.name: f.dtype for f in node.right.fields},
                                  node.unique, node.kind))
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec,
                                  key_max=self._key_upper_bound(iv) if node.unique else None,
                                  filter_bits=self._filter_bits(node.right) if fslot else 0)
        Pipeline(BatchStream.of(right), [build]).run()
        if spec is not None and build.pallas is None:
            self._note_route_fallback(node)
        self._fill_join_filter(fslot, build, node.right, rkey)
        outs = [BuildOutput(n, n) for n in node.output_right]
        if node.kind == "full":
            return self._exec_full_join(node, left, build, lkey, outs, right, verify)
        if node.unique:
            op = LookupJoinOperator(build, lkey, outs, node.kind, verify=verify)
            return left.map(lambda b: op.process(b)[0])
        return left.map(self._retrying_expand_probe(build, lkey, outs, node.kind, right,
                                                    lambda op, b: op.process(b)[0],
                                                    verify=verify))

    def _spill_both_sides(self, node, left, right_stream, lkey, rkey, decision,
                          build_row_bytes: int, tag: str):
        """Hash-spill both sides of a join or semi join to budget-accounted
        host stores, clamp the planned resident set to the actual bucket
        sizes, and expand the cold buckets into streamed units (split
        while oversized). Returns ``(rspill, lspill, resident, units)``
        and records the executed decision."""
        nbuckets = decision.nbuckets
        rspill = spill_stream(right_stream, rkey, nbuckets,
                              spill=self._host_spill(nbuckets, f"{tag}-build"))
        lspill = spill_stream(left, lkey, nbuckets,
                              spill=self._host_spill(nbuckets, f"{tag}-probe"))
        resident, resident_bytes = fit_resident(decision, rspill.bucket_rows, build_row_bytes)
        res_set = set(resident)
        cold = [b for b in range(nbuckets) if b not in res_set]
        # a streamed unit's build must fit beside the resident set; never
        # below half the budget, so the split depth is bounded by skew
        unit_budget = max(decision.budget - resident_bytes, decision.budget // 2, 1)
        units = expand_units(rspill, lspill, cold, unit_budget, build_row_bytes,
                             build_ids=lambda b, m: bucket_ids_for(b, rkey, m),
                             probe_ids=lambda b, m: bucket_ids_for(b, lkey, m),
                             make_spill=lambda: self._host_spill(1, f"{tag}-split"))
        self._note_spill(node, decision, resident=resident, streamed=len(units),
                         host_bytes=rspill.total_bytes() + lspill.total_bytes())
        return rspill, lspill, resident, units

    def _exec_grouped_join(self, node: N.Join, left, right_stream, lkey, rkey, decision):
        """Out-of-core (hybrid or grouped) join: both sides hash-spill to
        host RAM; the resident build buckets are joined first as one
        combined build (key-equal rows share a bucket, so merging disjoint
        buckets adds no false match), then the cold units stream
        host->device through the two-slot transfer pipeline, each joined
        by the normal probe. Every build (resident and unit) pads to one
        shared capacity and every probe chunk to another; the build
        operator is re-finished per pass and the probe operators are
        shared across passes (one per output capacity), so the strategy
        counters count as the JAX package's do."""
        row_bytes_r = max(node_row_bytes(node.right, self.catalog), 1)
        # probe chunks sized so a chunk stays well under the budget
        probe_chunk = self._oom_probe_chunk(max(
            1 << 14,
            self.join_build_budget // max(node_row_bytes(node.left, self.catalog), 1) // 4))
        rspill, lspill, resident, units = self._spill_both_sides(
            node, left, right_stream, lkey, rkey, decision, row_bytes_r, "join")
        nbuckets = decision.nbuckets
        outs = [BuildOutput(n, n) for n in node.output_right]
        rfields = {f.name: f for f in node.right.fields}
        resident_rows = sum(rspill.bucket_rows(b) for b in resident)
        unit_build_rows = max((u.build.bucket_rows(u.bucket) for u in units), default=0)
        build_cap = batch_capacity(max(resident_rows, unit_build_rows, 16), minimum=16)
        probe_cap = _probe_capacity(lspill, nbuckets, probe_chunk,
                                    extra=[u.probe for u in units])
        build = JoinBuildOperator(rkey, capacity=build_cap)
        probe_ops: dict[tuple, LookupJoinOperator] = {}

        def probe_op(cap: int | None) -> LookupJoinOperator:
            key = ("u",) if cap is None else ("e", cap)
            if key not in probe_ops:
                probe_ops[key] = LookupJoinOperator(build, lkey, outs, node.kind,
                                                    unique=cap is None, out_capacity=cap)
            return probe_ops[key]

        def null_build_cols(b: Batch) -> Batch:
            cols = dict(b.columns)
            for bo in outs:
                cols[bo.name] = self._null_column(rfields[bo.source].dtype, b.capacity)
            return Batch(cols, b.live)

        state = {"cap": batch_capacity(max(build_cap, probe_cap, 1024))}

        def probe_all(probe_chunks):
            for pb in probe_chunks:
                if node.unique:
                    yield probe_op(None).process(pb)[0]
                    continue
                for _ in range(MAX_RETRIES):
                    try:
                        out = probe_op(state["cap"]).process(pb)[0]
                        break
                    except CapacityOverflow:
                        state["cap"] *= 2
                else:
                    raise CapacityOverflow("GroupedJoin", state["cap"])
                yield out

        def load_unit(u):
            b = u.build.bucket_batch(u.bucket, capacity=build_cap)
            if b is not None:
                REGISTRY.counter("spill.transfer_bytes").add(
                    u.build.bucket_rows(u.bucket) * row_bytes_r)
            return b

        def make():
            fault_point("step.grouped_join")
            # pass 1: the device-resident buckets, as one combined build
            res_batches = [bb for b in resident
                           if (bb := rspill.bucket_batch(b, capacity=build_cap)) is not None]
            res_probes = (pb for b in resident
                          for pb in bucket_batches(lspill, b, probe_chunk, probe_cap))
            if res_batches:
                build.batches = res_batches
                build.build_side = None
                build.finish()
                yield from probe_all(res_probes)
            elif node.kind == "left":
                for pb in res_probes:
                    yield null_build_cols(pb)
            # pass 2: the cold units through the two-slot pipeline; a
            # unit's output materializes inside its span, which closes
            # before the yield
            for u, build_batch in transfer_iter(load_unit, units, label="spill:transfer"):
                unit_out = []
                with trace_span("spill:unit", "step", {"residue": u.residue,
                                                       "modulus": u.modulus}):
                    probe_chunks = bucket_batches(u.probe, u.bucket, probe_chunk, probe_cap)
                    if build_batch is None:
                        if node.kind == "left":
                            unit_out = [null_build_cols(pb) for pb in probe_chunks]
                    else:
                        build.batches = [build_batch]
                        build.build_side = None
                        build.finish()
                        unit_out = list(probe_all(probe_chunks))
                yield from unit_out

        return BatchStream(make)

    def _null_column(self, dtype, cap: int) -> Column:
        """An all-NULL column of ``cap`` rows (zero data, invalid
        everywhere) on this executor's device."""
        shape, dt = (((cap, dtype.width), torch.uint8) if dtype.kind is TypeKind.BYTES
                     else ((cap,), dtype.torch_dtype))
        return Column(torch.zeros(shape, dtype=dt, device=self.device),
                      torch.zeros(cap, dtype=torch.bool, device=self.device), dtype)

    def _retrying_expand_probe(self, build, lkey, outs, kind: str, right, call, verify=()):
        """The expansion probe of one batch, retried at a doubled output
        capacity on ``CapacityOverflow``: probing is stateless per batch,
        so only the batch that overflowed probes again, and the raised
        capacity stays for later batches. The first capacity comes from
        the first probe batch, ``batch_capacity(max(its capacity, build
        rows, 1024))``; at most ``MAX_RETRIES`` capacities a batch. One
        operator per capacity (each counts its strategy once), as in the
        JAX package. ``call(op, batch, *args)`` probes (a FULL join's
        flags pass through ``args``)."""
        right_rows = sum(live_count(b) for b in right)
        state = {"cap": None, "ops": {}}

        def probe(b: Batch, *args):
            if state["cap"] is None:
                state["cap"] = batch_capacity(max(b.capacity, right_rows, 1024))
            for _ in range(MAX_RETRIES):
                c = state["cap"]
                op = state["ops"].get(c)
                if op is None:
                    op = LookupJoinOperator(build, lkey, outs, kind, unique=False,
                                            out_capacity=c, verify=verify)
                    state["ops"][c] = op
                try:
                    return call(op, b, *args)
                except CapacityOverflow:
                    state["cap"] = c * 2
            raise CapacityOverflow("Join", state["cap"])

        return probe

    def _exec_full_join(self, node: N.Join, left, build, lkey, outs, right, verify):
        """FULL OUTER: probe with LEFT semantics while accumulating the
        matched-build flags, then emit the never-matched build rows with
        NULL probe columns as a tail batch. The flags live in the stream,
        so a replay restarts them; an expansion retry probes again from
        the flags before the failed attempt."""
        if node.unique:
            uop = LookupJoinOperator(build, lkey, outs, "full", verify=verify)

            def probe_once(b, flags):
                return uop.process_full(b, flags)
        else:
            if verify:
                raise NotImplementedError("wide string join keys require a unique build side")
            probe_once = self._retrying_expand_probe(
                build, lkey, outs, "full", right, lambda op, b, flags: op.process_full(b, flags))

        def it():
            flags = full_init_flags(build)
            schema = None
            for b in left:
                out, flags = probe_once(b, flags)
                schema = b
                yield out
            if schema is None:
                schema = self._schema_batch(node.left)
            yield full_tail(build, outs, flags, schema)

        return BatchStream(it)

    def _schema_batch(self, plan: N.PlanNode) -> Batch:
        """A one-row, all-dead batch of a plan node's fields: the probe
        schema of a FULL join's tail when the probe stream yields no
        batch (every value is NULL, so no dictionary is needed)."""
        dev = self.device
        cols = {}
        for f in plan.fields:
            shape, dt = (((1, f.dtype.width), torch.uint8) if f.dtype.kind is TypeKind.BYTES
                         else ((1,), f.dtype.torch_dtype))
            cols[f.name] = Column(torch.zeros(shape, dtype=dt, device=dev),
                                  torch.zeros(1, dtype=torch.bool, device=dev), f.dtype)
        return Batch(cols, torch.zeros(1, dtype=torch.bool, device=dev))

    def _exec_semijoin(self, node: N.SemiJoin, scalars):
        """Semi (``IN`` / ``EXISTS``) or anti (negated) join. Out of core
        when the build's estimate exceeds the budget (or on a ladder
        rung); resident otherwise: the membership probes prefer the
        fused exists bitmask (duplicate-safe), then the dense table when
        stats allow, else the sorted keys; under ``approx_join`` a semi
        join whose exact table does not fit probes the Bloom sketch. A
        semi join registers a runtime filter like an inner join."""
        fslot = self._register_join_filter(node)
        left = self._exec(node.left, scalars)
        right_stream = self._exec(node.right, scalars)
        jt = "anti" if node.negated else "semi"
        est = self._flipped_estimate(node, estimate_node_bytes(node.right, self.catalog))
        decision = self._spill_decision(node, est)
        if decision.mode != "resident":
            # a probe key's existence is decided inside its own hash
            # bucket, so bucketing is exact for semi and anti alike
            lkey, rkey, verify = self._join_keys(node, left, right_stream, scalars)
            if verify:
                raise NotImplementedError("wide string semi-join keys")
            REGISTRY.counter(f"join.strategy.{decision.mode}").add()
            return self._exec_grouped_semijoin(node, left, right_stream, lkey, rkey,
                                               decision, jt)
        right = right_stream.materialize()
        fault_point("step.join_build")
        lkey, rkey, verify = self._join_keys(node, left, right, scalars)
        if verify:
            # an existence probe has no build row to verify against; a
            # hash collision could flip membership
            raise NotImplementedError("wide string semi-join keys")
        iv = build_key_interval(node, self.catalog)
        spec = None if self._route_disabled(node) else self._pallas_spec(iv, (), {}, True, jt)
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec,
                                  filter_bits=self._filter_bits(node.right) if fslot else 0)
        Pipeline(BatchStream.of(right), [build]).run()
        if spec is not None and build.pallas is None:
            self._note_route_fallback(node)
        self._fill_join_filter(fslot, build, node.right, rkey)
        if spec is not None and spec.mode == "sketch" and build.pallas_side is not None:
            # the sketch was published: eligible probe batches ride it,
            # so the result may carry false-positive rows — flagged
            # (conservatively: a batch that falls back to the exact probe
            # does not clear the flag), as the JAX package flags it
            self.used_approx = True
        op = LookupJoinOperator(build, lkey, (), jt)
        return left.map(lambda b: op.process(b)[0])

    def _exec_grouped_semijoin(self, node: N.SemiJoin, left, right_stream, lkey, rkey,
                               decision, jt: str):
        """Out-of-core semi or anti join, shaped as the grouped join: the
        combined resident pass first, then the cold units through the
        two-slot pipeline. An absent build unit passes every anti probe
        row and drops every semi row: the probe rows routed there can
        only match build rows routed there."""
        row_bytes_r = max(node_row_bytes(node.right, self.catalog), 1)
        probe_chunk = self._oom_probe_chunk(1 << 18)
        rspill, lspill, resident, units = self._spill_both_sides(
            node, left, right_stream, lkey, rkey, decision, row_bytes_r, "semi")
        nbuckets = decision.nbuckets
        resident_rows = sum(rspill.bucket_rows(b) for b in resident)
        unit_build_rows = max((u.build.bucket_rows(u.bucket) for u in units), default=0)
        build_cap = batch_capacity(max(resident_rows, unit_build_rows, 16), minimum=16)
        probe_cap = _probe_capacity(lspill, nbuckets, probe_chunk,
                                    extra=[u.probe for u in units])
        build = JoinBuildOperator(rkey, capacity=build_cap)
        op = LookupJoinOperator(build, lkey, (), jt)

        def load_unit(u):
            b = u.build.bucket_batch(u.bucket, capacity=build_cap)
            if b is not None:
                REGISTRY.counter("spill.transfer_bytes").add(
                    u.build.bucket_rows(u.bucket) * row_bytes_r)
            return b

        def make():
            fault_point("step.grouped_join")
            res_batches = [bb for b in resident
                           if (bb := rspill.bucket_batch(b, capacity=build_cap)) is not None]
            res_probes = (pb for b in resident
                          for pb in bucket_batches(lspill, b, probe_chunk, probe_cap))
            if res_batches:
                build.batches = res_batches
                build.build_side = None
                build.finish()
                for pb in res_probes:
                    yield op.process(pb)[0]
            elif jt == "anti":  # nothing to exclude: all pass
                yield from res_probes
            for u, build_batch in transfer_iter(load_unit, units, label="spill:transfer"):
                unit_out = []
                with trace_span("spill:unit", "step", {"residue": u.residue,
                                                       "modulus": u.modulus}):
                    probe_chunks = bucket_batches(u.probe, u.bucket, probe_chunk, probe_cap)
                    if build_batch is None:
                        if jt == "anti":
                            unit_out = list(probe_chunks)
                    else:
                        build.batches = [build_batch]
                        build.build_side = None
                        build.finish()
                        unit_out = [op.process(pb)[0] for pb in probe_chunks]
                yield from unit_out

        return BatchStream(make)

    # ---- ordering ---------------------------------------------------------
    @staticmethod
    def _bound_keys(keys, scalars) -> list[SortKey]:
        return [SortKey(bind_scalars(k.expr, scalars), k.descending, k.nulls_first)
                for k in keys]

    def _exec_sort(self, node: N.Sort, scalars):
        child = self._exec(node.child, scalars)
        op = OrderByOperator(self._bound_keys(node.keys, scalars))
        return BatchStream.of(Pipeline(child, [op]).run())

    def _exec_topn(self, node: N.TopN, scalars):
        child = self._exec(node.child, scalars)
        op = TopNOperator(self._bound_keys(node.keys, scalars), node.count)
        return BatchStream.of(Pipeline(child, [op]).run())

    def _exec_limit(self, node: N.Limit, scalars):
        child = self._exec(node.child, scalars)
        return BatchStream.of(Pipeline(child, [LimitOperator(node.count)]).run())

    # ---- window functions ------------------------------------------------
    def _exec_window(self, node: N.Window, scalars):
        """Drain the child, then one batch in the window's sort order."""
        child = self._exec(node.child, scalars)
        op = window_operator_from_node(node, scalars)
        return BatchStream.of(Pipeline(child, [op]).run())

    # ---- FROM-less SELECT and set operations ------------------------------
    def _exec_values(self, node: N.Values, scalars) -> BatchStream:
        """One live row, no columns, on the session's device."""
        return BatchStream.of([Batch({}, torch.ones(1, dtype=torch.bool, device=self.device))])

    def _exec_union(self, node: N.Union, scalars):
        """UNION ALL: the lazy concatenation of the child streams, replayed
        child by child. Each batch keeps its own capacity and stays a
        batch of its own (a scalar subquery's one-row check sees each
        term apart, as in the JAX package). A VARCHAR column whose
        children carry different dictionaries re-encodes into their
        merged dictionary (codes compare within one dictionary only)."""
        children = [self._exec(c, scalars) for c in node.inputs]
        names = node.field_names()
        targets = union_target_dicts(names, [cs.peek() for cs in children])
        mapping_cache: dict = {}

        def make():
            for cs in children:
                for b in cs:
                    yield align_batch_dicts(b.select(names), targets, mapping_cache)

        return BatchStream(make)

    # ---- scalar subqueries ----------------------------------------------
    def _exec_bindscalars(self, node: N.BindScalars, scalars):
        for sv in node.scalars:
            scalars[sv.name] = self._eval_scalar(sv)
        return self._exec(node.child, scalars)

    def _eval_scalar(self, sv: N.ScalarValue):
        """Run the subplan (an Output: the analyzer plans every scalar
        subquery as a query) and read its one value on the host: one
        device-to-host sync per scalar and query, as in the JAX package,
        since the value becomes a literal of the plan above. No live row
        gives NULL; more than one raises."""
        batches, names = self.run_batches(sv.child)
        for b in batches:
            n = live_count(b)
            if n == 0:
                continue
            if n > 1:
                raise UserError("scalar subquery returned more than one row")
            col = b[names[0]]
            idx = int(torch.nonzero(b.live)[0, 0])
            if col.valid is not None and not bool(col.valid[idx]):
                return None
            raw = col.data[idx].item()
            return col.dtype.from_physical(raw) if col.dtype.kind is TypeKind.DECIMAL else raw
        return None
