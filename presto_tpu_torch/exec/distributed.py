"""Distributed execution: logical plan -> per-shard steps over a mesh.

Counterpart of ``presto_tpu/exec/distributed.py`` (Presto's coordinator
and worker tier: ``AddExchanges``, ``PlanFragmenter``, the partial/final
aggregation split and the exchange operators), for scans, filters,
projections, aggregations, UNION ALL, sorts, TopN, Limit and scalar
subqueries. The JAX package compiles each fragment into a ``shard_map``
step with its collectives inside; here one Python controller drives the
same steps shard by shard (``parallel/mesh.py``'s layout: a row-sharded
batch is one tensor per column, shard-major) and the exchanges between
them (``parallel/exchange.py``):

- a grouped aggregation runs PARTIAL per shard, the multi-round
  exchange on the hash of its keys, then FINAL per shard;
- the fused leaf route runs its kernel step once per shard and
  all-reduces the [groups] states (``exec/leaf_route.py``);
- a global aggregation and a small direct-addressed one fold each shard
  into one state (the JAX package lets XLA insert that reduction);
- an ORDER BY range-partitions on its first key from a pooled sample,
  then sorts per shard; TopN and Limit keep each shard's first rows
  before the final pass over the gathered survivors;
- filters and projections run per shard, elementwise.

Every shard's rows are the JAX package's device's rows, in its order:
the scan's splits go round-robin (``splits[i::n]``) into shards padded
to ``cap_dev``, the exchange ranks rows stably and receives them
sender-major, so an unordered result comes out in the JAX package's row
order. Joins, semi joins and windows on a mesh are refused with
``NotSupported`` (ROADMAP C26); a local session runs them.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, QueryResult
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
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
    _key_parts,
    _phys_dtype,
    align_batch_dicts,
    union_target_dicts,
    valid_of,
)
from presto_tpu_torch.exec.local_planner import (
    DIRECT_LIMIT,
    default_join_build_budget,
    live_count,
    pick_group_strategy,
)
from presto_tpu_torch.exec.pipeline import Pipeline
from presto_tpu_torch.expr import bind_scalars, evaluate, param_scope
from presto_tpu_torch.ops.compact import compact_indices
from presto_tpu_torch.ops.groupby import ValueBitsOverflow, gather_padded, group_ids_sort, segment_agg
from presto_tpu_torch.ops.hashing import bucket_ids, partition_ids
from presto_tpu_torch.ops.sort import sort_indices
from presto_tpu_torch.parallel.exchange import (
    a2a_wire_bytes,
    exchange_multiround,
    gather_wire_bytes,
    record_exchange,
    skew_ratio,
)
from presto_tpu_torch.parallel.mesh import join_shards, shard_view, shards_of, worker_axes
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.runtime.errors import InternalError, NotSupported, UserError
from presto_tpu_torch.runtime.faults import fault_point
from presto_tpu_torch.runtime.lifecycle import check_deadline, run_fragment
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.trace import batch_device_bytes, batch_row_bytes
from presto_tpu_torch.runtime.trace import span as trace_span
from presto_tpu_torch.spi import batch_capacity, split_valids
from presto_tpu_torch.types import BIGINT, TypeKind, check_narrow_range

MAX_RETRIES = 6


@dataclass
class DistBatch:
    """One global batch and its distribution over the workers."""

    batch: Batch
    sharded: bool  # rows sharded over the workers vs fully replicated


def _null_safe(v, live):
    """(data zeroed under NULL, validity as a tensor) of a key ``Val``:
    NULL keys group together, and the validity sorts and hashes beside
    the data so the NULL group stays apart from real zeros."""
    valid = valid_of(v.valid, live)
    mask = valid[:, None] if v.data.dim() > 1 else valid
    return torch.where(mask, v.data, torch.zeros_like(v.data)), valid


def _gather(batch: Batch, idx: torch.Tensor, out_live=None) -> Batch:
    """Rows ``idx`` of ``batch`` (an index past the capacity gives a dead,
    zero row); a NULL-free column keeps the shared-live identity."""
    live = gather_padded(batch.live, idx, False)
    if out_live is not None:
        live = live & out_live
    cols = {}
    for n, c in batch.columns.items():
        if c.valid is None or c.valid is batch.live:
            valid = None if c.valid is None else live
        else:
            valid = gather_padded(c.valid, idx, False)
        cols[n] = Column(gather_padded(c.data, idx, 0), valid, c.dtype, c.dictionary)
    return Batch(cols, live)


def _pad_rows(b: Batch, cap: int) -> Batch:
    """Grow a batch's row capacity with dead rows (a row-sharded batch's
    capacity is a multiple of the mesh size)."""
    if cap == b.capacity:
        return b
    extra = cap - b.capacity

    def pad(a, fill=0):
        return torch.cat([a, torch.full((extra,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                        device=a.device)])

    live = pad(b.live, False)
    cols = {}
    for n, c in b.columns.items():
        if c.valid is None or c.valid is b.live:
            valid = None if c.valid is None else live
        else:
            valid = pad(c.valid, False)
        cols[n] = Column(pad(c.data), valid, c.dtype, c.dictionary)
    return Batch(cols, live)


def _compact_local(b: Batch, out_cap: int) -> Batch:
    """Gather one shard's live rows into a smaller capacity (the caller
    guarantees live rows <= ``out_cap``)."""
    idx, _, _ = compact_indices(b.live, out_cap)
    return _gather(b, idx)


def _compact_step(mesh, out_cap: int):
    """Per-shard compaction of a row-sharded batch to ``out_cap`` rows a
    shard, shared through the executable cache."""

    def step(b: Batch) -> Batch:
        return join_shards([_compact_local(s, out_cap) for s in shards_of(b, mesh)], mesh)

    return step


class DistributedExecutor(OomLadderMixin):
    """Single-controller distributed executor over a worker mesh.

    Mirrors ``LocalExecutor``'s plan dispatch; each node reuses the local
    operator over the global batch or runs a per-shard step with the
    exchange in the middle."""

    #: cross-query batched dispatch stays off on this tier: a mesh
    #: session falls back to the serialized template slot, counted under
    #: ``batch.fallback.distributed``
    supports_batched_dispatch = False

    def __init__(self, catalog: Catalog, mesh, broadcast_limit: int = 1 << 21,
                 gather_limit: int = 1 << 22, direct_group_limit: int | None = None,
                 join_build_budget: int | None = None, spill_host_budget: int | None = None):
        from presto_tpu_torch.cache.fingerprint import _mesh_shape

        self.catalog = catalog
        #: the plan template's literal-slot values (device scalars), the
        #: ambient ``expr.param_scope`` of the whole run
        self.params: tuple = ()
        #: the query's runtime join-key min/max readbacks, by content
        self._minmax_memo: dict = {}
        self.mesh = mesh
        self.nworkers = int(mesh.size)
        #: where replicated batches, states and results live
        self.device = mesh.devices[0]
        #: estimated aggregation states over this many bytes run grouped
        #: (bucket by bucket over the whole mesh)
        if join_build_budget is None:
            join_build_budget = default_join_build_budget(self.device)
        self.join_build_budget = join_build_budget
        self._mesh_fp = _mesh_shape(mesh)
        #: the mesh's worker axes (("workers",), or ("dcn", "ici"))
        self.axes = worker_axes(mesh)
        self.broadcast_limit = broadcast_limit
        self.direct_group_limit = DIRECT_LIMIT if direct_group_limit is None \
            else direct_group_limit
        #: row guard on the replicate-everything fallbacks (sort, TopN,
        #: Limit): gathering N rows to every shard multiplies memory by
        #: the mesh size, so a large input fails fast
        self.gather_limit = gather_limit
        #: optional StatsRecorder for the current query (set by the Session)
        self.recorder = None
        self._trace_ids = None
        #: plan-stats history hints and the ``partial_agg_bypass`` switch
        self.plan_hints: dict = {}
        self.agg_bypass = True
        self.oom_rung = 0
        #: per-exchange (site, node, per-destination rows, row bytes),
        #: read back once at the end of the run
        self._skew_accum: list = []
        #: the last run's flushed per-exchange summaries and the
        #: destinations that tripped a receive overflow (the flight
        #: recorder copies both)
        self.exchange_skew: list = []
        self.hot_partitions: list = []
        self.spill_host_budget = spill_host_budget
        self._host_budget = None
        self.spill_events: list = []
        #: the query's adaptive decisions (set by the Session) and the
        #: applied ones of the last run
        self.adaptive: dict = {}
        self.adaptive_events: list = []

    # ------------------------------------------------------------------
    def run(self, plan: N.PlanNode) -> QueryResult:
        if not isinstance(plan, N.Output):
            raise InternalError("top-level plan must be an Output node")
        from presto_tpu_torch.plan.fragmenter import fragment_plan

        self.fragment_info = fragment_plan(plan, self.catalog, self.broadcast_limit,
                                           self.join_build_budget)
        if self.recorder is not None:
            self.recorder.attach_plan(plan)
        self._minmax_memo.clear()
        # per run: an OOM-ladder rung re-enters run()
        self._skew_accum.clear()
        self.hot_partitions = []
        self.spill_events = []
        self.adaptive_events = []
        scalars: dict[str, Any] = {}
        try:
            with param_scope(self.params), \
                    trace_span("node:Output", "node", {"plan_node_id": self._nid(plan)}):
                d = self._exec(plan.child, scalars)
                b = self._replicate(d).batch
                b = b.select(list(plan.sources)).rename(dict(zip(plan.sources, plan.names)))
                return QueryResult(list(plan.names), [b] if live_count(b) else [])
        finally:
            # failed runs flush too: a post-mortem's most useful line is
            # which partition was hot when it died
            self._flush_exchange_skew()

    # ------------------------------------------------------------------
    def _exec(self, node: N.PlanNode, scalars: dict) -> DistBatch:
        """Per-node dispatch, the fragment boundary: the lifecycle's
        deadline and cancel check and retries (``run_fragment``)."""
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            raise NotSupported(f"no distributed executor for {type(node).__name__}")
        label = f"fragment:{type(node).__name__}"
        rec = self.recorder
        nid = self._nid(node)
        if rec is None:
            with trace_span(f"node:{type(node).__name__}", "node", {"plan_node_id": nid}):
                return run_fragment(label, lambda: m(node, scalars))
        t0 = time.perf_counter()
        with trace_span(f"node:{type(node).__name__}", "node", {"plan_node_id": nid}) as sp:
            out = run_fragment(label, lambda: m(node, scalars))
        wall = time.perf_counter() - t0  # inclusive of children
        rows, nbytes, dev_bytes = -1, -1, -1
        if rec.measure_rows and isinstance(out, DistBatch):
            rows = live_count(out.batch)
            nbytes = rows * batch_row_bytes(out.batch)
            dev_bytes = batch_device_bytes(out.batch)
            if sp is not None:
                sp.args["rows"] = rows
        rec.record(node, wall, rows, output_bytes=nbytes, device_bytes=dev_bytes)
        return out

    def _nid(self, node) -> int:
        """Stable per-query plan-node id (``runtime/stats.NodeIds``)."""
        if self.recorder is not None:
            return self.recorder.node_id(node)
        if self._trace_ids is None:
            from presto_tpu_torch.runtime.stats import NodeIds

            self._trace_ids = NodeIds()
        return self._trace_ids.of(node)

    def _shard_map(self, fn, b: Batch) -> Batch:
        """``fn`` over every shard of a row-sharded batch, each on its own
        device, joined back in shard order."""
        return join_shards([fn(s) for s in shards_of(b, self.mesh)], self.mesh)

    def _replicate(self, d: DistBatch, guard: str | None = None,
                   rows_hint: int | None = None) -> DistBatch:
        """Row-sharded -> replicated: the gather exchange (the shards in
        shard order). ``guard`` names the replicate-everything fallback
        asking (sort, TopN, Limit): it enforces ``gather_limit`` and first
        compacts a mostly-dead batch shard by shard, so the gather moves
        live rows, not padding."""
        if not d.sharded:
            return d
        fault_point("exchange.gather")
        b = d.batch
        if guard is not None:
            rows = rows_hint if rows_hint is not None else live_count(b)
            if rows > self.gather_limit:
                raise CapacityOverflow(
                    f"{guard}: replicating {rows} rows to every device "
                    f"exceeds gather_limit={self.gather_limit}; raise the "
                    "limit or restructure the query (partition-parallel "
                    f"{guard} not yet implemented)",
                    self.gather_limit,
                )
            cap2 = batch_capacity(max(rows, 16), minimum=16)
            if self.nworkers * cap2 < b.capacity:
                step = EXEC_CACHE.get_or_build(
                    EXEC_CACHE.key_of("dist_compact", cap2, self._mesh_fp),
                    lambda: _compact_step(self.mesh, cap2))
                b = step(b)
        t0 = time.perf_counter()
        # the shards already sit in shard order: the gathered batch is
        # the global one
        record_exchange("gather" if guard is None else f"gather:{guard}",
                        gather_wire_bytes(batch_row_bytes(b), b.capacity, self.nworkers),
                        self.nworkers, time.perf_counter() - t0)
        return DistBatch(b, sharded=False)

    # ---- exchange-skew telemetry -----------------------------------------
    def _note_exchange_skew(self, site: str, node, dest, row_bytes: int):
        """Bank one exchange's per-destination histogram for the end-of-
        run flush (never a readback here: this is the dispatch path)."""
        self._skew_accum.append((site, node, dest, int(row_bytes)))

    def _hot_partition(self, dest) -> int:
        """The hottest destination of an overflowed exchange, recorded
        for post-mortems and metrics."""
        counts = np.asarray(dest.cpu() if isinstance(dest, torch.Tensor) else dest)
        hot = int(np.argmax(counts)) if counts.size else -1
        self.hot_partitions.append(hot)
        return hot

    def _flush_exchange_skew(self):
        """The once-per-run readback of the per-destination histograms:
        the ``exchange.skew`` histogram and per-site row counters,
        ``NodeStats.skew`` on the recorder, and the ``exchange_skew``
        summary the flight recorder captures."""
        summaries = []
        for site, node, dest, row_bytes in self._skew_accum:
            try:
                counts = np.asarray(dest.cpu() if isinstance(dest, torch.Tensor) else dest)
            except Exception:  # noqa: BLE001 — telemetry never raises
                continue
            rows = int(counts.sum())
            if rows <= 0:
                continue
            ratio = skew_ratio(counts)
            REGISTRY.counter(f"exchange.rows.{site}").add(rows)
            REGISTRY.histogram("exchange.skew").add(ratio)
            summaries.append({"site": site, "rows": rows, "bytes": rows * row_bytes,
                              "skew": round(ratio, 3),
                              "hot_partition": int(np.argmax(counts))})
            if node is not None and self.recorder is not None:
                self.recorder.record_skew(node, ratio, rows, hot=int(np.argmax(counts)))
        self._skew_accum.clear()
        self.exchange_skew = summaries

    # ---- leaves ----------------------------------------------------------
    def _exec_tablescan(self, node: N.TableScan, scalars) -> DistBatch:
        """Data-parallel scan: splits round-robin onto shards, each shard
        generated into one padded host buffer and copied to its rows of
        the global batch, so the host holds one shard at a time."""
        fault_point("scan")
        conn = self.catalog.connector(node.connector)
        src_cols = [s for _, s in node.columns]
        splits = list(conn.splits(node.table))
        n = self.nworkers
        assign = [splits[i::n] for i in range(n)]
        cap_dev = batch_capacity(max(max(sum(s.row_hint for s in sp) for sp in assign), 1),
                                 minimum=128)
        if hasattr(conn, "physical_schema"):
            types = conn.physical_schema(node.table, src_cols)
        else:
            types = {c: conn.schema(node.table)[c] for c in src_cols}
        dicts = {c: d for c, d in conn.dictionaries(node.table).items() if c in types}
        dev = self.device
        total = n * cap_dev

        def empty(c):
            t = types[c]
            tail = (t.width,) if t.kind is TypeKind.BYTES else ()
            return torch.zeros((total,) + tail, dtype=t.torch_dtype, device=dev)

        data = {c: empty(c) for c in src_cols}
        masks: dict[str, torch.Tensor] = {}  # only columns some split masks
        live = torch.zeros(total, dtype=torch.bool, device=dev)
        for d, sp in enumerate(assign):
            base = d * cap_dev
            padded = {}
            vmasks = {}
            for c in src_cols:
                t = types[c]
                tail = (t.width,) if t.kind is TypeKind.BYTES else ()
                padded[c] = np.zeros((cap_dev,) + tail, dtype=t.np_dtype)
                vmasks[c] = np.zeros(cap_dev, np.bool_)
            masked = set()
            rows = 0
            for s in sp:
                # the deadline between splits, as the local scan loop does
                check_deadline("scan")
                arrays, valids = split_valids(conn.scan_numpy(s, src_cols))
                srows = len(next(iter(arrays.values()))) if arrays else 0
                if rows + srows > cap_dev:
                    raise CapacityOverflow("TableScan shard", cap_dev, rows + srows)
                for c in src_cols:
                    a = arrays.get(c)
                    if a is not None:
                        if a.ndim > 1:  # BYTES rows may be narrower
                            padded[c][rows: rows + srows, : a.shape[1]] = a
                        else:
                            check_narrow_range(c, types[c], a)
                            padded[c][rows: rows + srows] = a
                    vm = valids.get(c)
                    if vm is not None:
                        masked.add(c)
                    vmasks[c][rows: rows + srows] = True if vm is None else vm
                rows += srows
            for c in src_cols:
                data[c][base: base + cap_dev] = torch.from_numpy(padded[c])
                if c in masked or c in masks:
                    if c not in masks:
                        # earlier shards had no mask: their validity is live
                        masks[c] = live.clone()
                    masks[c][base: base + cap_dev] = torch.from_numpy(vmasks[c])
            live[base: base + rows] = True
        cols = {c: Column(data[c], masks.get(c, live), types[c], dicts.get(c))
                for c in src_cols}
        b = Batch(cols, live).rename({s: nn for nn, s in node.columns})
        if node.predicate is not None:
            op = FilterProjectOperator(bind_scalars(node.predicate, scalars), None)
            b = self._shard_map(lambda s: op.process(s)[0], b)
        return DistBatch(b, sharded=True)

    def _exec_values(self, node: N.Values, scalars) -> DistBatch:
        return DistBatch(Batch({}, torch.ones(1, dtype=torch.bool, device=self.device)),
                         sharded=False)

    # ---- elementwise ------------------------------------------------------
    def _elementwise(self, d: DistBatch, op) -> DistBatch:
        if d.sharded:
            return DistBatch(self._shard_map(lambda s: op.process(s)[0], d.batch), True)
        return DistBatch(op.process(d.batch)[0], False)

    def _exec_filter(self, node: N.Filter, scalars) -> DistBatch:
        d = self._exec(node.child, scalars)
        return self._elementwise(
            d, FilterProjectOperator(bind_scalars(node.predicate, scalars), None))

    def _exec_project(self, node: N.Project, scalars) -> DistBatch:
        d = self._exec(node.child, scalars)
        projs = {n: bind_scalars(e, scalars) for n, e in node.exprs}
        return self._elementwise(d, FilterProjectOperator(None, projs))

    # ---- aggregation -----------------------------------------------------
    def _fold(self, d: DistBatch, op) -> Batch:
        """One operator folded over every shard (one state; the local
        executor's multi-batch fold), or over the replicated batch."""
        parts = [shard_view(d.batch, i, self.nworkers) for i in range(self.nworkers)] \
            if d.sharded else [d.batch]
        return Pipeline(parts, [op]).run()[0]

    def _exec_aggregate(self, node: N.Aggregate, scalars) -> DistBatch:
        from presto_tpu_torch.exec import leaf_route as LR
        from presto_tpu_torch.plan.bounds import agg_value_bits
        from presto_tpu_torch.runtime.memory import estimate_node_bytes

        # the fused leaf route: the kernel step once per shard and an
        # all-reduce of the [groups] states. Recorder off and rung 0 only,
        # as on the local tier; a value_overflow falls back, counted
        if self.recorder is None and self.oom_rung == 0:
            route, reason = LR.match_leaf_fragment(node, self.catalog)
            if route is not None:
                routed = LR.execute_leaf_route_distributed(route, self, node, scalars)
                if routed is not None:
                    REGISTRY.counter("agg.strategy.fused").add()
                    return DistBatch(routed, sharded=False)
            elif reason is not None:
                LR.count_fallback(reason)

        d = self._exec(node.child, scalars)
        fault_point("aggregation")
        keys = [(n, bind_scalars(e, scalars)) for n, e in node.keys]
        pax = [(n, bind_scalars(e, scalars)) for n, e in node.passengers]
        bits = agg_value_bits(node, self.catalog)
        aggs = [AggSpec(a.kind, bind_scalars(a.input, scalars) if a.input is not None else None,
                        a.name, a.dtype, value_bits=b)
                for a, b in zip(node.aggs, bits)]
        if not keys and not pax:
            REGISTRY.counter("agg.strategy.single").add()
            return DistBatch(self._fold(d, GlobalAggregationOperator(aggs, device=self.device)),
                             sharded=False)

        first = d.batch

        def dict_len(name: str):
            if name in first and first[name].dictionary is not None:
                return len(first[name].dictionary)
            return None

        strategy = pick_group_strategy(keys, pax, dict_len, live_count(first),
                                       direct_limit=self.direct_group_limit)
        if isinstance(strategy, DirectStrategy):
            # a small dense group domain: every shard folds into one
            # direct-addressed state
            try:
                return DistBatch(self._fold(d, HashAggregationOperator(
                    keys, aggs, strategy, device=self.device)), sharded=False)
            except ValueBitsOverflow:
                aggs = [dataclasses.replace(a, value_bits=63) for a in aggs]
                return DistBatch(self._fold(d, HashAggregationOperator(
                    keys, aggs, strategy, device=self.device)), sharded=False)
            except NullGroupKeys:
                # the packed direct domain has no NULL slot
                strategy = pick_group_strategy(keys, pax, dict_len, live_count(first),
                                               direct_limit=0)
        if not d.sharded:
            for _ in range(MAX_RETRIES):
                op = HashAggregationOperator(keys, aggs, strategy, passengers=pax,
                                             device=self.device)
                try:
                    return DistBatch(self._fold(d, op), sharded=False)
                except CapacityOverflow:
                    strategy = SortStrategy(strategy.max_groups * 2)
            raise CapacityOverflow("Aggregate", strategy.max_groups)
        est = estimate_node_bytes(node, self.catalog)
        # history-corrected sizing (plan/adaptive.py)
        bdec = self._adaptive_decision(node, "bucket")
        if bdec is not None and bdec.est_bytes >= 0:
            est = bdec.est_bytes
            self._note_adaptive(node, bdec, action=f"agg est_bytes={est} from actuals")
        if est > self.join_build_budget or self.oom_rung > 0:
            decision = self._spill_decision(node, est)
            REGISTRY.counter("agg.strategy.partial").add()
            return self._grouped_dist_agg(d.batch, keys, aggs, pax, decision, node=node)
        # the adaptive bypass: groups ~ rows, so the per-shard partial
        # group sort would reduce nothing before the exchange
        bypass = False
        if self.agg_bypass and self.oom_rung == 0:
            bypass = LR.bypass_partial_agg(node, self.catalog, hints=self.plan_hints)
        REGISTRY.counter("agg.strategy.bypass" if bypass else "agg.strategy.partial").add()
        return self._dist_grouped_agg(d.batch, keys, aggs, pax, bypass=bypass, node=node)

    def _dist_grouped_agg(self, b: Batch, keys, aggs, pax, bypass: bool = False,
                          node=None) -> DistBatch:
        """PARTIAL -> multi-round exchange on hash(keys) -> FINAL.

        The wire quota stays fixed (sized for the balanced case: one
        round); a retry doubles only the receive capacity, which
        overflows only when one shard owns more groups than planned."""
        fault_point("step.agg")
        fault_point("exchange.aggregate")
        Pn = self.nworkers
        cap_dev = b.capacity // Pn
        mg_partial = batch_capacity(cap_dev, minimum=64)
        quota = batch_capacity(-(-mg_partial // Pn), minimum=64)
        mg_final = batch_capacity(Pn * quota, minimum=64)
        for _ in range(MAX_RETRIES):
            mgf = mg_final
            step = EXEC_CACHE.get_or_build(
                EXEC_CACHE.key_of("dist_agg", keys, aggs, pax, mg_partial, quota, mgf,
                                  self._mesh_fp, bypass),
                lambda: self._make_agg_step(keys, aggs, pax, mg_partial, quota, mgf,
                                            bypass=bypass))
            t0 = time.perf_counter()
            with trace_span("step:dist_agg", "step", {"quota": quota, "recv_cap": mgf}):
                out, overflow, rounds, dest, exch_ovf = step(b)
                done = not bool(overflow)
            # the exchanged rows are partial group rows: the output's
            # columns plus one int64 merge count per aggregate
            row_b = batch_row_bytes(out) + 9 * len(aggs)
            # a hot partition is an EXCHANGE receive overflow only: a
            # group-capacity overflow retries the same loop but is no skew
            record_exchange(
                "aggregate", a2a_wire_bytes(row_b, Pn, quota, rounds), Pn,
                time.perf_counter() - t0, rounds=rounds,
                hot_partition=(self._hot_partition(dest)
                               if not done and bool(exch_ovf) else None))
            if done:
                self._note_exchange_skew("aggregate", node, dest, row_b)
                return DistBatch(out, sharded=True)
            mg_final *= 2
        raise CapacityOverflow("DistributedAggregate", mg_final)

    def _make_agg_step(self, keys, aggs, pax, mg: int, quota: int, mgf: int,
                       bypass: bool = False):
        """The grouped aggregation step: (row-sharded batch) -> (row-
        sharded output, overflow anywhere, rounds, per-destination rows,
        exchange receive overflow). It closes over the mesh, never over
        this executor (cached steps must not pin per-query state)."""
        mesh = self.mesh
        Pn = self.nworkers

        def bypass_phase(b: Batch):
            """Per-ROW partials: each row a singleton group with the
            partial phase's column layout (zero-normalized value plus a
            ``$n`` merge count per aggregate), so the exchange and the
            final phase are unchanged."""
            cap = b.capacity
            dev = b.device
            ones = torch.ones(cap, dtype=torch.bool, device=dev)
            cols: dict[str, Column] = {}
            for n, e in keys:
                v = evaluate(e, b)
                data, valid = _null_safe(v, b.live)
                cols[n] = Column(data, valid, e.dtype, v.dictionary)
            for n, e in pax:
                v = evaluate(e, b)
                cols[n] = Column(v.data, valid_of(v.valid, b.live), e.dtype, v.dictionary)
            for a in aggs:
                dt = _phys_dtype(a)
                if a.kind == "count_star" or a.input is None:
                    vals = torch.ones(cap, dtype=dt, device=dev)
                    contrib = b.live
                elif a.kind == "count":
                    v = evaluate(a.input, b)
                    vals = torch.ones(cap, dtype=dt, device=dev)
                    contrib = b.live & valid_of(v.valid, b.live)
                else:
                    v = evaluate(a.input, b)
                    vals = v.data.to(dt)
                    contrib = b.live & valid_of(v.valid, b.live)
                cols[a.name] = Column(torch.where(contrib, vals, torch.zeros_like(vals)), ones,
                                      a.dtype)
                cols[a.name + "$n"] = Column(contrib.to(torch.int64), ones, BIGINT)
            return Batch(cols, b.live), torch.zeros((), dtype=torch.bool, device=dev)

        def partial_phase(b: Batch):
            dev = b.device
            kvals = [evaluate(e, b) for _, e in keys]
            ksafe = [_null_safe(v, b.live) for v in kvals]
            pvals = [evaluate(e, b) for _, e in pax]
            sortables = [valid.to(torch.int8) for _, valid in ksafe] + [
                c for (data, valid), (_, e) in zip(ksafe, keys)
                for c in _key_parts(Column(data, valid, e.dtype))]
            gids, rep, ng, ovf = group_ids_sort(sortables, b.live, mg)
            ones = torch.ones(mg, dtype=torch.bool, device=dev)
            cols: dict[str, Column] = {}
            for (n, e), v, (data, valid) in zip(keys, kvals, ksafe):
                cols[n] = Column(gather_padded(data, rep, 0), gather_padded(valid, rep, False),
                                 e.dtype, v.dictionary)
            for (n, e), v in zip(pax, pvals):
                cols[n] = Column(gather_padded(v.data, rep, 0),
                                 gather_padded(valid_of(v.valid, b.live), rep, False),
                                 e.dtype, v.dictionary)
            for a in aggs:
                dt = _phys_dtype(a)
                if a.kind == "count_star" or a.input is None:
                    vals = torch.ones(b.capacity, dtype=torch.int64, device=dev)
                    contrib = b.live
                elif a.kind == "count":
                    v = evaluate(a.input, b)
                    vals = torch.ones(b.capacity, dtype=torch.int64, device=dev)
                    contrib = b.live & valid_of(v.valid, b.live)
                else:
                    v = evaluate(a.input, b)
                    vals, contrib = v.data, b.live & valid_of(v.valid, b.live)
                kind = "sum" if a.kind in ("count", "count_star") else a.kind
                agg = segment_agg(vals.to(dt), contrib, gids, mg, kind)
                n_c = segment_agg(vals, contrib, gids, mg, "count")
                cols[a.name] = Column(agg, ones, a.dtype)
                cols[a.name + "$n"] = Column(n_c, ones, BIGINT)
            live = torch.arange(mg, device=dev) < ng
            return Batch(cols, live), ovf

        def final_phase(b: Batch):
            # partial outputs are zero-normalized already; the validity
            # sort column still separates the NULL group from real zeros
            dev = b.device
            kvals = [b[n] for n, _ in keys]
            kvalid = [valid_of(c.valid, b.live) for c in kvals]
            sortables = [v.to(torch.int8) for v in kvalid] + [
                c for col in kvals for c in _key_parts(col)]
            gids, rep, ng, ovf = group_ids_sort(sortables, b.live, mgf)
            cols: dict[str, Column] = {}
            for (n, e), c, valid in zip(keys, kvals, kvalid):
                cols[n] = Column(gather_padded(c.data, rep, 0), gather_padded(valid, rep, False),
                                 e.dtype, c.dictionary)
            for n, e in pax:
                c = b[n]
                cols[n] = Column(gather_padded(c.data, rep, 0),
                                 gather_padded(valid_of(c.valid, b.live), rep, False),
                                 e.dtype, c.dictionary)
            for a in aggs:
                vals = b[a.name].data
                ncol = b[a.name + "$n"].data
                contrib = b.live & (ncol > 0)
                agg = segment_agg(vals, contrib, gids, mgf, a.merge_kind)
                ntot = segment_agg(ncol, b.live, gids, mgf, "sum")
                if a.kind in ("count", "count_star"):
                    valid = torch.ones(mgf, dtype=torch.bool, device=dev)
                else:
                    valid = ntot > 0
                agg = torch.where(valid, agg, torch.zeros_like(agg))
                cols[a.name] = Column(agg.to(a.dtype.torch_dtype), valid, a.dtype)
            live = torch.arange(mgf, device=dev) < ng
            return Batch(cols, live), ovf

        def step(b: Batch):
            parts, ovf1 = [], []
            for s in shards_of(b, mesh):
                p, o = bypass_phase(s) if bypass else partial_phase(s)
                parts.append(p)
                ovf1.append(o.to(mesh.devices[0]))
            part = join_shards(parts, mesh)
            key_sort = [c for n, _e in keys for c in _key_parts(part[n])]
            pids = partition_ids(key_sort, Pn)
            exch, ovf2, rounds, dest = exchange_multiround(
                part, pids, Pn, quota, mgf, with_rounds=True, with_stats=True)
            outs, ovf3 = [], []
            for s in shards_of(exch, mesh):
                o, f = final_phase(s)
                outs.append(o)
                ovf3.append(f.to(mesh.devices[0]))
            out = join_shards(outs, mesh)
            overflow = torch.any(torch.stack(ovf1 + ovf3)) | ovf2
            # the exchange receive overflow rides out apart: only IT means
            # "a destination was hot"
            return out, overflow, rounds, dest, ovf2

        return step

    # ---- out-of-core ------------------------------------------------------
    def _pull_host(self, d: DistBatch, key, nbuckets: int):
        """Spill a DistBatch to host RAM with per-row bucket ids of ``key``
        (``ops/hashing.bucket_ids``, decorrelated from the exchange's
        ``partition_ids``): ``(cols, live, bids)``, cols name -> (data,
        valid, dtype, dictionary) numpy tuples."""
        b = d.batch
        v = evaluate(key, b)
        data = torch.where(b.live & valid_of(v.valid, b.live), v.data.to(torch.int64), 0)
        bids = bucket_ids([data], nbuckets).cpu().numpy()
        live = b.live.cpu().numpy()
        cols = {n: (c.data.cpu().numpy(), valid_of(c.valid, b.live).cpu().numpy(), c.dtype,
                    c.dictionary)
                for n, c in b.columns.items()}
        return cols, live, bids

    def _place_sharded(self, cols: dict, sel: np.ndarray) -> Batch:
        """Host rows (boolean-selected) -> a row-sharded batch: the rows
        split into ``nworkers`` nearly equal contiguous chunks, one a
        shard, each padded to one shared shard capacity."""
        Pn = self.nworkers
        idx = np.nonzero(sel)[0]
        cap_dev = batch_capacity(max(-(-len(idx) // Pn), 1), minimum=16)
        cap = cap_dev * Pn
        chunks = np.array_split(idx, Pn)
        lv = np.zeros(cap, np.bool_)
        for p, ch in enumerate(chunks):
            lv[p * cap_dev: p * cap_dev + len(ch)] = True
        dev = self.device
        out_cols = {}
        for name, (data, valid, dt, dic) in cols.items():
            pd_ = np.zeros((cap,) + data.shape[1:], data.dtype)
            pv = np.zeros(cap, np.bool_)
            for p, ch in enumerate(chunks):
                o = p * cap_dev
                pd_[o: o + len(ch)] = data[ch]
                pv[o: o + len(ch)] = valid[ch]
            out_cols[name] = Column(torch.from_numpy(pd_).to(dev), torch.from_numpy(pv).to(dev),
                                    dt, dic)
        return Batch(out_cols, torch.from_numpy(lv).to(dev))

    def _concat_sharded_many(self, parts: list, names: list | None = None) -> DistBatch:
        """Per-shard concatenation of row-sharded batches (a bag union, no
        exchange): shard ``i`` of the output is every part's shard ``i`` in
        part order. Dictionary columns align onto merged target
        dictionaries first, and a part without a dictionary takes the
        first real one."""
        if names is None:
            names = list(parts[0].names)
        parts = [p.select(names) for p in parts]
        targets = union_target_dicts(names, parts)
        parts = [align_batch_dicts(p, targets) for p in parts]
        if len(parts) == 1:
            return DistBatch(parts[0], sharded=True)
        per_part = [shards_of(p, self.mesh) for p in parts]
        shards = []
        for i in range(self.nworkers):
            pieces = [pp[i] for pp in per_part]
            shards.append(join_shards([pc.to(pieces[0].device) for pc in pieces], self.mesh))
        out = join_shards(shards, self.mesh)
        cols = {}
        for n in names:
            dic = next((p[n].dictionary for p in parts if p[n].dictionary is not None), None)
            c = out[n]
            cols[n] = Column(c.data, c.valid, c.dtype, dic)
        return DistBatch(Batch(cols, out.live), sharded=True)

    def _host_spill_budget(self):
        """The host-RAM budget spilled partitions reserve against: the
        session's ``spill_host_budget_bytes``, else the process-wide one."""
        if self._host_budget is None:
            from presto_tpu_torch.runtime.memory import HostSpillBudget, global_host_spill_budget

            self._host_budget = (HostSpillBudget(self.spill_host_budget, name="session-spill")
                                 if self.spill_host_budget else global_host_spill_budget())
        return self._host_budget

    def _grouped_dist_agg(self, b: Batch, keys, aggs, pax, decision, node=None) -> DistBatch:
        """Grouped aggregation: ``decision.nbuckets`` passes, each over the
        rows of one key-hash bucket (compacted per shard, on the device:
        the input is resident, and what the budget bounds is the
        aggregation state). Groups partition exactly by key hash, so the
        pass outputs are disjoint and their union is the grouping; the
        planned resident buckets run first."""
        Pn = self.nworkers
        nbuckets = decision.nbuckets

        def key_sortables(local: Batch):
            out = []
            for _, e in keys:
                v = evaluate(e, local)
                ok = local.live & valid_of(v.valid, local.live)
                for s in _key_parts(v):
                    out.append(torch.where(ok, s.to(torch.int64), 0))
            return out

        # one pass computes every row's bucket id and each shard's
        # per-bucket live counts
        bids_parts, counts = [], []
        for s in shards_of(b, self.mesh):
            bids = bucket_ids(key_sortables(s), nbuckets)
            bids_parts.append(bids.to(self.device))
            counts.append(torch.bincount(bids[s.live].to(torch.int64), minlength=nbuckets)
                          .to(self.device))
        bids = torch.cat(bids_parts)
        # one readback of every shard's per-bucket counts
        cap_pass = batch_capacity(max(int(torch.stack(counts).max()), 16), minimum=64)
        outs = []
        rset = set(decision.resident)
        order = list(decision.resident) + [bk for bk in range(nbuckets) if bk not in rset]
        cap_dev = b.capacity // Pn
        for bk in order:
            parts = []
            for i, s in enumerate(shards_of(b, self.mesh)):
                lb = bids[i * cap_dev:(i + 1) * cap_dev].to(s.device)
                parts.append(_compact_local(s.with_live(s.live & (lb == bk)), cap_pass))
            fb = join_shards(parts, self.mesh)
            # the node threads through, so a bucket pass's exchange skew
            # still attributes to the Aggregate
            outs.append(self._dist_grouped_agg(fb, keys, aggs, pax, node=node).batch)
        if node is not None:
            self._note_spill(node, decision, streamed=nbuckets - len(rset))
        return self._concat_sharded_many(outs)

    # ---- joins, semi joins and windows: not on a mesh yet -----------------
    def _not_on_mesh(self, what: str):
        raise NotSupported(f"{what} on a mesh is not ported to presto_tpu_torch yet "
                           "(distributed joins and windows, ROADMAP A10c)")

    def _exec_join(self, node: N.Join, scalars) -> DistBatch:
        self._not_on_mesh(f"{node.kind} Join")

    def _exec_semijoin(self, node: N.SemiJoin, scalars) -> DistBatch:
        self._not_on_mesh("anti SemiJoin" if node.negated else "SemiJoin")

    def _exec_window(self, node: N.Window, scalars) -> DistBatch:
        self._not_on_mesh("Window")

    # ---- set operations --------------------------------------------------
    def _exec_union(self, node: N.Union, scalars) -> DistBatch:
        """UNION ALL: the per-shard concatenation of the children's
        shards; a replicated child, padded to a multiple of the mesh size,
        is read as row-sharded (shard ``i`` its ``i``-th row block)."""
        names = node.field_names()
        parts = []
        for c in node.inputs:
            d = self._exec(c, scalars)
            b = d.batch.select(names)
            if not d.sharded:
                b = _pad_rows(b, -(-b.capacity // self.nworkers) * self.nworkers)
            parts.append(b)
        return self._concat_sharded_many(parts, names=list(names))

    # ---- sort, TopN, Limit -------------------------------------------------
    @staticmethod
    def _bound_keys(keys, scalars) -> list:
        return [SortKey(bind_scalars(k.expr, scalars), k.descending, k.nulls_first)
                for k in keys]

    def _exec_sort(self, node: N.Sort, scalars) -> DistBatch:
        """Distributed sort: a sample-based range partition on the first
        sort key (the multi-round exchange), then a full sort per shard.
        Shard ``i`` owns the ``i``-th key range, so the shards in shard
        order are globally sorted. Ties on the first key go to one shard;
        a degenerate first key overflows the receive capacity, and after
        the retries the replicated sort (with its gather guard) runs."""
        d = self._exec(node.child, scalars)
        keys = self._bound_keys(node.keys, scalars)
        if d.sharded and self.nworkers > 1:
            try:
                return self._range_partition_sort(d, keys)
            except CapacityOverflow:
                pass  # pathological skew: replicate instead
        d = self._replicate(d, guard="Sort")
        return DistBatch(Pipeline([d.batch], [OrderByOperator(keys)]).run()[0], sharded=False)

    def _exec_topn(self, node: N.TopN, scalars) -> DistBatch:
        """Local-first TopN: each shard keeps its own top n, and only the
        P*n survivors are gathered for the final pass."""
        d = self._exec(node.child, scalars)
        keys = self._bound_keys(node.keys, scalars)
        if d.sharded and self.nworkers > 1:
            d = self._local_topn(d, keys, node.count)
        d = self._replicate(d, guard="TopN")
        return DistBatch(Pipeline([d.batch], [TopNOperator(keys, node.count)]).run()[0],
                         sharded=False)

    def _exec_limit(self, node: N.Limit, scalars) -> DistBatch:
        """Local-first limit: each shard keeps its first n live rows in row
        order (a range-sorted child's global prefix is a per-shard
        prefix), then the final limit runs over the gathered rest."""
        d = self._exec(node.child, scalars)
        if d.sharded and self.nworkers > 1:
            d = self._local_limit(d, node.count)
        d = self._replicate(d, guard="Limit")
        return DistBatch(Pipeline([d.batch], [LimitOperator(node.count)]).run()[0],
                         sharded=False)

    def _local_topn(self, d: DistBatch, keys, n: int) -> DistBatch:
        b = d.batch
        cap_dev = max(b.capacity // self.nworkers, 1)
        # never past the shard (a union-shaped input's capacity need not
        # be a power of two)
        cap_out = min(cap_dev, batch_capacity(min(n, cap_dev), minimum=16))

        def make_step():
            def step_body(local: Batch) -> Batch:
                vals = [evaluate(k.expr, local) for k in keys]
                order = sort_indices([v.data for v in vals], [k.descending for k in keys],
                                     local.live, nulls_first=[k.nulls_first for k in keys],
                                     valids=[v.valid for v in vals])
                take = order[:cap_out]
                keep = torch.arange(cap_out, device=local.device) < n
                return _gather(local, take, keep)

            return step_body

        step = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("dist_local_topn", tuple(keys), n, cap_out, self._mesh_fp),
            make_step)
        return DistBatch(self._shard_map(step, b), sharded=True)

    def _local_limit(self, d: DistBatch, n: int) -> DistBatch:
        b = d.batch
        cap_dev = max(b.capacity // self.nworkers, 1)
        cap_out = min(cap_dev, batch_capacity(min(n, cap_dev), minimum=16))

        def make_step():
            def step_body(local: Batch) -> Batch:
                live_rank = torch.cumsum(local.live.to(torch.int64), 0)
                keep = local.live & (live_rank <= n)
                idx, _, _ = compact_indices(keep, cap_out)
                return _gather(local, idx)

            return step_body

        step = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("dist_local_limit", n, cap_out, self._mesh_fp), make_step)
        return DistBatch(self._shard_map(step, b), sharded=True)

    @staticmethod
    def _sort_cmp(key: SortKey, batch: Batch) -> torch.Tensor:
        """NULL- and direction-normalized comparison value of the first
        sort key: ascending order of the result is the SQL order. Integer
        keys compare as int64 (a BYTES key by its most significant 7-byte
        chunk: ties go to one shard), floats as floats."""
        v = evaluate(key.expr, batch)
        s = _key_parts(v)[0]
        if s.dtype == torch.bool:
            s = s.to(torch.int64)
        if key.descending:
            s = -s if s.is_floating_point() else ~s.to(torch.int64)
        if s.is_floating_point():
            null_val = float("-inf") if key.nulls_first else float("inf")
        else:
            s = s.to(torch.int64)
            info = torch.iinfo(torch.int64)
            null_val = info.min if key.nulls_first else info.max
        return torch.where(valid_of(v.valid, batch.live), s, torch.full_like(s, null_val))

    def _range_partition_sort(self, d: DistBatch, keys) -> DistBatch:
        fault_point("exchange.sort")
        Pn = self.nworkers
        b = d.batch
        cap_dev = max(b.capacity // Pn, 1)
        nsamples = min(64, cap_dev)
        k0 = keys[0]
        sort_cmp = self._sort_cmp

        def sample_body(local: Batch):
            cmp = sort_cmp(k0, local)
            order = sort_indices([cmp], [False], local.live)
            cnt = torch.sum(local.live.to(torch.int64))
            pos = (torch.arange(nsamples, device=local.device) * torch.clamp(cnt, min=1)) \
                // nsamples
            samp = gather_padded(cmp[order], pos, 0)
            ok = torch.arange(nsamples, device=local.device) < cnt
            return samp, ok

        sample = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("dist_sort_sample", k0, nsamples, self._mesh_fp),
            lambda: sample_body)
        got = [sample(s) for s in shards_of(b, self.mesh)]
        # one readback of every shard's samples (the all-gather)
        samp = torch.cat([g[0].to(self.device) for g in got]).cpu().numpy()
        ok = torch.cat([g[1].to(self.device) for g in got]).cpu().numpy()
        pool = np.sort(samp[ok])
        if pool.size == 0:
            return d  # no live row anywhere: nothing to sort
        # P-1 evenly spaced splitters over the pooled sample
        sel = (np.arange(1, Pn) * pool.size) // Pn
        splitters = torch.from_numpy(pool[sel])
        quota = batch_capacity(-(-cap_dev // Pn), minimum=64)
        recv_cap = batch_capacity(2 * cap_dev, minimum=64)
        for _ in range(MAX_RETRIES):
            rc = recv_cap
            # the splitters are data (sampled per input): an operand, not
            # part of the cached step
            step = EXEC_CACHE.get_or_build(
                EXEC_CACHE.key_of("dist_range_sort", tuple(keys), quota, rc, self._mesh_fp),
                lambda: self._make_range_sort_step(keys, quota, rc))
            t0 = time.perf_counter()
            with trace_span("step:dist_sort", "step", {"quota": quota, "recv_cap": rc}):
                out, overflow, rounds = step(b, splitters)
                done = not bool(overflow)
            record_exchange("sort", a2a_wire_bytes(batch_row_bytes(b), Pn, quota, rounds), Pn,
                            time.perf_counter() - t0, rounds=rounds)
            if done:
                return DistBatch(out, sharded=True)
            recv_cap *= 2
        raise CapacityOverflow("RangePartitionSort", recv_cap)

    def _make_range_sort_step(self, keys, quota: int, recv_cap: int):
        mesh = self.mesh
        Pn = self.nworkers
        k0 = keys[0]
        sort_cmp = self._sort_cmp

        def sort_body(exch: Batch) -> Batch:
            vals = [evaluate(k.expr, exch) for k in keys]
            order = sort_indices([v.data for v in vals], [k.descending for k in keys],
                                 exch.live, nulls_first=[k.nulls_first for k in keys],
                                 valids=[v.valid for v in vals])
            return _gather(exch, order)

        def step(b: Batch, splitters):
            pids = []
            for s in shards_of(b, mesh):
                cmp = sort_cmp(k0, s)
                pids.append(torch.searchsorted(splitters.to(cmp.device, cmp.dtype), cmp,
                                               right=True).to(torch.int32).to(mesh.devices[0]))
            exch, ovf, rounds = exchange_multiround(b, torch.cat(pids), Pn, quota, recv_cap,
                                                    with_rounds=True)
            out = join_shards([sort_body(s) for s in shards_of(exch, mesh)], mesh)
            return out, ovf, rounds

        return step

    # ---- scalar subqueries ----------------------------------------------
    def _exec_bindscalars(self, node: N.BindScalars, scalars) -> DistBatch:
        for sv in node.scalars:
            scalars[sv.name] = self._eval_scalar(sv, scalars)
        return self._exec(node.child, scalars)

    def _eval_scalar(self, sv: N.ScalarValue, scalars):
        """Run the subplan and read its one value on the host (no row:
        NULL; more than one: an error)."""
        b = self._replicate(self._exec(sv.child, scalars)).batch
        names = sv.child.field_names()
        n = live_count(b)
        if n == 0:
            return None
        if n > 1:
            raise UserError("scalar subquery returned more than one row")
        col = b[names[0] if names[0] in b else b.names[0]]
        idx = int(torch.nonzero(b.live)[0, 0])
        if col.valid is not None and not bool(col.valid[idx]):
            return None
        raw = col.data[idx].item()
        return col.dtype.from_physical(raw) if col.dtype.kind is TypeKind.DECIMAL else raw

    def _exec_output(self, node: N.Output, scalars) -> DistBatch:
        d = self._exec(node.child, scalars)
        b = self._replicate(d).batch
        b = b.select(list(node.sources)).rename(dict(zip(node.sources, node.names)))
        return DistBatch(b, sharded=False)
