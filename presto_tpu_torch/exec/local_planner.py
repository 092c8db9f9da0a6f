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
- capacities retry and double on ``CapacityOverflow``.

Not ported: the spill and grouped tiers, the OOM ladder, fault points,
adaptive history, plan templates, result and executable caches, runtime
join filters and tracing. Every join and aggregate runs resident; a plan
node without an executor here raises ``NotSupported``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, QueryResult
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.exec import leaf_route
from presto_tpu_torch.exec.joinkeys import declared_key_interval, join_key_exprs
from presto_tpu_torch.exec.joins import BuildOutput, JoinBuildOperator, LookupJoinOperator
from presto_tpu_torch.exec.operators import (
    AggSpec,
    CapacityOverflow,
    DirectStrategy,
    FilterProjectOperator,
    GlobalAggregationOperator,
    HashAggregationOperator,
    NullGroupKeys,
    OrderByOperator,
    SortStrategy,
    TopNOperator,
    concat_batches,
    valid_of,
)
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline, prefetch_iter
from presto_tpu_torch.expr import InputRef, evaluate
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops.groupby import ValueBitsOverflow
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.bounds import agg_value_bits, estimate_rows, key_dictionary
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.runtime.errors import InternalError, NotSupported
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.spi import batch_capacity
from presto_tpu_torch.types import TypeKind

DIRECT_LIMIT = 4096
MAX_GROUP_CAP = 1 << 20
MAX_RETRIES = 6

#: payload column kinds the fused probe's int32 value tables carry
_PALLAS_PAYLOAD_KINDS = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DATE,
                         TypeKind.DECIMAL, TypeKind.VARCHAR, TypeKind.BOOLEAN)


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


def planned_join_strategy(node: N.Join, catalog) -> str:
    """The probe strategy the executor will pick for this join, from
    stats alone — the JAX package's rule without its out-of-core modes:
    pallas (fused lookup-table probe) > dense (direct-address table) >
    unique (sorted probe) > expand. Advisory like every stats decision:
    a runtime ineligibility degrades one rung, counted."""
    iv = (declared_key_interval(node.right, node.right_keys[0], catalog)
          if len(node.right_keys) == 1 else None)
    if iv is not None and cuda_join.interval_ok(iv[0], iv[1]):
        domain = iv[1] - iv[0] + 1
        outs = node.output_right
        if not outs and node.unique and node.kind == "inner" \
                and cuda_join.exists_words(domain):
            return "pallas"
        if outs and node.unique and node.kind in ("inner", "left") \
                and len(outs) <= cuda_join.MAX_VALUES \
                and cuda_join.payload_rows(domain, len(outs)):
            return "pallas"
    if iv is not None and node.unique and 0 < iv[1] - iv[0] + 1 <= (1 << 31) - 1:
        return "dense"
    if node.unique:
        return "dense" if iv is not None else "unique"
    return "expand"


class LocalExecutor:
    def __init__(self, catalog: Catalog, pallas_join_enabled: bool = True, device="cuda"):
        self.catalog = catalog
        #: prefer the fused lookup-table probe where stats permit
        self.pallas_join_enabled = pallas_join_enabled
        #: where an empty aggregation state lives
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def run(self, plan: N.PlanNode) -> QueryResult:
        """Execute to a ``QueryResult`` (names + host arrays)."""
        if not isinstance(plan, N.Output):
            raise InternalError("top-level plan must be an Output node")
        batches, names = self.run_batches(plan)
        return QueryResult(names, [b for b in batches if live_count(b) > 0])

    def run_batches(self, plan: N.Output):
        rename = dict(zip(plan.sources, plan.names))
        out = [b.select(list(plan.sources)).rename(rename)
               for b in self._exec(plan.child)]
        return out, list(plan.names)

    def _exec(self, node: N.PlanNode) -> BatchStream:
        """Execute a node to a replayable lazy BatchStream."""
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            raise NotSupported(f"executing a {type(node).__name__} node is not ported yet")
        return m(node)

    # ---- leaves ----------------------------------------------------------
    def _exec_tablescan(self, node: N.TableScan) -> BatchStream:
        """Streaming scan: one device batch per split, yielded lazily;
        the next split generates on a worker thread meanwhile."""
        conn = self.catalog.connector(node.connector)
        src_cols = [s for _, s in node.columns]
        rename = {s: n for n, s in node.columns}
        op = (FilterProjectOperator(node.predicate, None)
              if node.predicate is not None else None)
        splits = list(conn.splits(node.table))
        cap = batch_capacity(max(s.row_hint for s in splits))

        def load(split):
            b = conn.scan(split, src_cols, cap).rename(rename)
            return op.process(b)[0] if op is not None else b

        return BatchStream(lambda: prefetch_iter(load, splits))

    # ---- streaming transforms -------------------------------------------
    def _exec_filter(self, node: N.Filter) -> BatchStream:
        op = FilterProjectOperator(node.predicate, None)
        return self._exec(node.child).map(lambda b: op.process(b)[0])

    def _exec_project(self, node: N.Project) -> BatchStream:
        op = FilterProjectOperator(None, dict(node.exprs))
        return self._exec(node.child).map(lambda b: op.process(b)[0])

    # ---- aggregation ----------------------------------------------------
    def _exec_aggregate(self, node: N.Aggregate):
        # the fused leaf route (exec/leaf_route.py): a scan -> filter ->
        # partial-agg fragment over stats-bounded NULL-free columns runs
        # as ONE fused step per scan batch (the Q1 kernel for TPC-H Q1,
        # the leaf-aggregation kernel otherwise); a runtime
        # value_overflow falls back to the generic route below, counted
        route, reason = leaf_route.match_leaf_fragment(node, self.catalog)
        if route is not None:
            routed = leaf_route.execute_leaf_route(route, self, node)
            if routed is not None:
                COUNTERS["agg.strategy.fused"] += 1
                return BatchStream.of(routed)
        elif reason is not None:
            leaf_route.count_fallback(reason)

        keys, pax = list(node.keys), list(node.passengers)
        child = self._exec(node.child)
        # stats-derived |value| bounds; a violated bound trips
        # value_overflow and retries at 63 bits
        aggs = [AggSpec(a.kind, a.input, a.name, a.dtype, value_bits=b)
                for a, b in zip(node.aggs, agg_value_bits(node, self.catalog))]
        if not keys and not pax:
            COUNTERS["agg.strategy.single"] += 1
            op = GlobalAggregationOperator(aggs, device=self.device)
            return BatchStream.of(Pipeline(child, [op]).run())
        strategy = self._pick_group_strategy(keys, pax, node)
        if (isinstance(strategy, SortStrategy)
                and leaf_route.bypass_partial_agg(node, self.catalog)):
            # group cardinality ~ input cardinality: per-batch partial
            # folds reduce nothing, so aggregate the concatenated rows in
            # ONE pass with the group capacity sized by the true row count
            COUNTERS["agg.strategy.bypass"] += 1
            batches = child.materialize()
            rows = sum(live_count(b) for b in batches)
            if batches:
                child = BatchStream.of([concat_batches(batches)])
            strategy = SortStrategy(min(batch_capacity(max(rows, 16)), MAX_GROUP_CAP))
        else:
            COUNTERS["agg.strategy.partial"] += 1
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
        interval is ``iv``, or None when no table fits."""
        if not self.pallas_join_enabled or iv is None \
                or not cuda_join.interval_ok(int(iv[0]), int(iv[1])):
            return None
        lo, hi = int(iv[0]), int(iv[1])
        domain = hi - lo + 1
        if outs:
            kinds_ok = all(rfields.get(c) is not None
                           and rfields[c].kind in _PALLAS_PAYLOAD_KINDS for c in outs)
            if (unique and kind in ("inner", "left") and kinds_ok
                    and len(outs) <= cuda_join.MAX_VALUES
                    and cuda_join.payload_rows(domain, len(outs))):
                return cuda_join.PallasJoinSpec("payload", lo, hi, payload=tuple(outs))
        elif unique and kind == "inner" and cuda_join.exists_words(domain):
            return cuda_join.PallasJoinSpec("exists", lo, hi)
        return None

    def _exec_join(self, node: N.Join):
        if not node.unique:
            raise NotSupported("expansion joins (non-unique build keys) are not ported yet")
        if node.kind not in ("inner", "left"):
            raise NotSupported(f"{node.kind} joins are not ported yet")
        left = self._exec(node.left)
        # the build side is materialized (the lookup source concatenates
        # it); the probe side streams batch by batch
        right = self._exec(node.right).materialize()

        def runtime_minmax(side: int, key):
            # only a multi-key pair without stats-derived pack widths
            # pays this: a replay of the probe stream and a readback
            mn, mx = 0, 0
            for b in (left if side == 0 else right):
                v = evaluate(key, b)
                live = b.live & valid_of(v.valid, b.live)
                if bool(live.any()):
                    data = v.data.to(torch.int64)[live]
                    mn, mx = min(mn, int(data.min())), max(mx, int(data.max()))
            return mn, mx

        lkey, rkey, _verify = join_key_exprs(node.left_keys, node.right_keys,
                                             catalog=self.catalog, lnode=node.left,
                                             rnode=node.right, runtime_minmax=runtime_minmax)
        # the stats interval of a single build key: the dense and
        # fused-probe decisions both derive from it; a packed multi-key
        # build has none and takes the sorted probe, as in the JAX package
        iv = (declared_key_interval(node.right, node.right_keys[0], self.catalog)
              if len(node.right_keys) == 1 else None)
        spec = self._pallas_spec(iv, tuple(node.output_right),
                                 {f.name: f.dtype for f in node.right.fields},
                                 node.unique, node.kind)
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec)
        Pipeline(BatchStream.of(right), [build]).run()
        outs = [BuildOutput(n, n) for n in node.output_right]
        op = LookupJoinOperator(build, lkey, outs, node.kind)
        return left.map(lambda b: op.process(b)[0])

    # ---- ordering ---------------------------------------------------------
    def _exec_sort(self, node: N.Sort):
        op = OrderByOperator(list(node.keys))
        return BatchStream.of(Pipeline(self._exec(node.child), [op]).run())

    def _exec_topn(self, node: N.TopN):
        op = TopNOperator(list(node.keys), node.count)
        return BatchStream.of(Pipeline(self._exec(node.child), [op]).run())
