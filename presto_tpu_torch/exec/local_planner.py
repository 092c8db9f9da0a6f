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
  dictionary domain (product <= ``DIRECT_LIMIT``), else the
  bounded sort strategy sized from the estimated rows, with the
  partial-aggregation bypass (``exec/leaf_route.bypass_partial_agg``)
  when groups approach rows;
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
  stable ``plan_node_id``), the sink's drain in ``node:Output``, each
  runtime filter application in ``join_filter``; the JAX package's fault
  points sit at its sites (``scan`` per split, ``aggregation`` and
  ``step.agg`` per aggregate, ``step.join_build`` per resident build).

Not ported: the spill and grouped tiers, the OOM ladder, the lifecycle's
fragments and deadlines, adaptive history, and the result and executable
caches. Every join and aggregate runs resident; a plan node without an
executor here raises ``NotSupported``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, QueryResult
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.exec import leaf_route
from presto_tpu_torch.exec.joinkeys import declared_key_interval, join_key_exprs
from presto_tpu_torch.exec.joins import (
    BuildOutput,
    JoinBuildOperator,
    LookupJoinOperator,
    full_init_flags,
    full_tail,
)
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
from presto_tpu_torch.expr import InputRef, bind_scalars, evaluate, param_scope
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops.hashing import bloom_test
from presto_tpu_torch.ops.groupby import ValueBitsOverflow
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.bounds import agg_value_bits, estimate_rows, key_dictionary
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.plan.joinfilters import filter_edge_for
from presto_tpu_torch.runtime.errors import InternalError, NotSupported, UserError
from presto_tpu_torch.runtime.faults import fault_point
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


def planned_join_strategy(node, catalog, approx_join: bool = False) -> str:
    """The probe strategy the executor will pick for this join or semi
    join, from stats alone — the JAX package's rule without its
    out-of-core modes: pallas (fused lookup-table probe) > sketch(approx)
    (under ``approx_join``, a non-negated semi join whose exact table
    does not fit) > dense (direct-address table) > unique (sorted probe)
    > expand. Advisory like every stats decision: a runtime
    ineligibility degrades one rung, counted."""
    semi = isinstance(node, N.SemiJoin)
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


class LocalExecutor:
    def __init__(self, catalog: Catalog, pallas_join_enabled: bool = True,
                 approx_join: bool = False, runtime_join_filters: bool = True,
                 device="cuda"):
        self.catalog = catalog
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
        #: stable plan-node ids for trace spans when no recorder is set
        self._trace_ids = None

    # ------------------------------------------------------------------
    def run(self, plan: N.PlanNode) -> QueryResult:
        """Execute to a ``QueryResult`` (names + host arrays)."""
        if not isinstance(plan, N.Output):
            raise InternalError("top-level plan must be an Output node")
        self.used_approx = False
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
        with param_scope(self.params):
            batches = self._exec(plan.child, scalars)
            # the sink's drain: in a plan without a pipeline breaker the
            # lazy scan work happens here
            with trace_span("node:Output", "node", {"plan_node_id": self._nid(plan)}):
                out = [b.select(list(plan.sources)).rename(rename) for b in batches]
        # every scan of the run has drained: one readback of the filters'
        # pruning counts
        self._flush_filter_stats()
        return out, list(plan.names)

    def _exec(self, node: N.PlanNode, scalars: dict) -> BatchStream:
        """Execute a node to a replayable lazy BatchStream; ``scalars``
        holds the values of the scalar subqueries bound above it."""
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            raise NotSupported(f"executing a {type(node).__name__} node is not ported yet")
        rec = self.recorder
        name = f"node:{type(node).__name__}"
        args = {"plan_node_id": self._nid(node)}
        if rec is None:
            with trace_span(name, "node", args):
                return m(node, scalars)
        t0 = time.perf_counter()
        with trace_span(name, "node", args) as sp:
            out = m(node, scalars)
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
    def _exec_tablescan(self, node: N.TableScan, scalars) -> BatchStream:
        """Streaming scan: one device batch per split, yielded lazily;
        the next split generates on a worker thread meanwhile."""
        conn = self.catalog.connector(node.connector)
        src_cols = [s for _, s in node.columns]
        rename = {s: n for n, s in node.columns}
        op = (FilterProjectOperator(bind_scalars(node.predicate, scalars), None)
              if node.predicate is not None else None)
        splits = list(conn.splits(node.table))
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
        # Skipped under a stats recorder: EXPLAIN ANALYZE needs true
        # per-node actuals
        if self.recorder is None:
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
        strategy = self._pick_group_strategy(keys, pax, node)
        if (isinstance(strategy, SortStrategy)
                and leaf_route.bypass_partial_agg(node, self.catalog)):
            # group cardinality ~ input cardinality: per-batch partial
            # folds reduce nothing, so aggregate the concatenated rows in
            # ONE pass with the group capacity sized by the true row count
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

    def _pick_group_strategy(self, keys, pax, node: N.Aggregate, force_sort: bool = False):
        def dict_len(name: str):
            d = key_dictionary(node.child, name, self.catalog)
            return len(d) if d is not None else None

        return pick_group_strategy(
            keys, pax, dict_len, estimate_rows(node.child, self.catalog),
            direct_limit=0 if force_sort else DIRECT_LIMIT)

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
        starts at the build key's declared stats interval."""
        if not self.runtime_join_filters:
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

    @staticmethod
    def _fill_join_filter(slot, build):
        """Publish the finished build's products into the slot."""
        if slot is None or build.filter_minmax is None:
            return
        slot.minmax = build.filter_minmax
        slot.bloom = build.filter_bloom

    @staticmethod
    def _apply_join_filter(slot: JoinFilterSlot, b: Batch) -> Batch:
        """AND the filter (range, then Bloom membership) into the scan
        batch's live mask; a NULL key cannot join, so it is pruned too.
        The counts stay on the device until the query's readback."""
        bounds = slot.bounds()
        if bounds is None or slot.col not in b:
            return b
        col = b[slot.col]
        if col.data.dim() != 1:
            return b
        with trace_span("join_filter", "join", {"column": slot.col}):
            k = col.data.to(torch.int64)
            keep = (k >= bounds[0]) & (k <= bounds[1]) & valid_of(col.valid, b.live)
            if slot.bloom is not None:
                keep = keep & bloom_test(slot.bloom, col.data)
            live = b.live & keep
            n_in = b.live.sum()
            pruned = (b.live & ~live).sum()
        slot.stat_in = n_in if slot.stat_in is None else slot.stat_in + n_in
        slot.stat_pruned = pruned if slot.stat_pruned is None else slot.stat_pruned + pruned
        return b.with_live(live)

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
        # build subtree, the keys, the build, the filter's products
        fslot = self._register_join_filter(node)
        left = self._exec(node.left, scalars)
        # the build side is materialized (the lookup source concatenates
        # it); the probe side streams batch by batch
        right = self._exec(node.right, scalars).materialize()
        fault_point("step.join_build")
        lkey, rkey, verify = self._join_keys(node, left, right, scalars)
        if verify and not node.unique and node.kind != "inner":
            raise NotSupported("wide string keys on non-unique OUTER joins (verification "
                               "cannot re-synthesize the null-extended row)")
        # the dense and fused sides serve unique builds only; hash-verified
        # keys and FULL joins never take the fused route
        iv = build_key_interval(node, self.catalog) if node.unique else None
        spec = (None if verify or node.kind == "full" else
                self._pallas_spec(iv, tuple(node.output_right),
                                  {f.name: f.dtype for f in node.right.fields},
                                  node.unique, node.kind))
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec,
                                  key_max=self._key_upper_bound(iv) if node.unique else None,
                                  filter_bits=self._filter_bits(node.right) if fslot else 0)
        Pipeline(BatchStream.of(right), [build]).run()
        self._fill_join_filter(fslot, build)
        outs = [BuildOutput(n, n) for n in node.output_right]
        if node.kind == "full":
            return self._exec_full_join(node, left, build, lkey, outs, right, verify)
        if node.unique:
            op = LookupJoinOperator(build, lkey, outs, node.kind, verify=verify)
            return left.map(lambda b: op.process(b)[0])
        return left.map(self._retrying_expand_probe(build, lkey, outs, node.kind, right,
                                                    lambda op, b: op.process(b)[0],
                                                    verify=verify))

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
                raise NotSupported("wide string join keys require a unique build side")
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
        """Semi (``IN`` / ``EXISTS``) or anti (negated) join, resident:
        the membership probes prefer the fused exists bitmask
        (duplicate-safe), then the dense table when stats allow, else
        the sorted keys; under ``approx_join`` a semi join whose exact
        table does not fit probes the Bloom sketch. A semi join registers
        a runtime filter like an inner join."""
        fslot = self._register_join_filter(node)
        left = self._exec(node.left, scalars)
        right = self._exec(node.right, scalars).materialize()
        jt = "anti" if node.negated else "semi"
        fault_point("step.join_build")
        lkey, rkey, verify = self._join_keys(node, left, right, scalars)
        if verify:
            # an existence probe has no build row to verify against; a
            # hash collision could flip membership
            raise NotSupported("wide string semi-join keys")
        iv = build_key_interval(node, self.catalog)
        spec = self._pallas_spec(iv, (), {}, True, jt)
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec,
                                  filter_bits=self._filter_bits(node.right) if fslot else 0)
        Pipeline(BatchStream.of(right), [build]).run()
        self._fill_join_filter(fslot, build)
        if spec is not None and spec.mode == "sketch" and build.pallas_side is not None:
            # the sketch was published: eligible probe batches ride it,
            # so the result may carry false-positive rows — flagged
            # (conservatively: a batch that falls back to the exact probe
            # does not clear the flag), as the JAX package flags it
            self.used_approx = True
        op = LookupJoinOperator(build, lkey, (), jt)
        return left.map(lambda b: op.process(b)[0])

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
