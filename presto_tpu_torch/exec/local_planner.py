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
  ``CapacityOverflow`` (``_retrying_expand_probe``); FULL and RIGHT joins
  are not ported;
- capacities retry and double on ``CapacityOverflow``;
- scalar subqueries: ``BindScalars`` runs each ``ScalarValue``'s subplan
  first and reads its one value on the host (``_eval_scalar``), and every
  operator below sees its expressions with the ``Unbound`` slots bound
  to literals (``bind_scalars``) through the ``scalars`` dict each
  ``_exec_*`` receives.

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
    SortKey,
    SortStrategy,
    TopNOperator,
    concat_batches,
    valid_of,
)
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline, prefetch_iter
from presto_tpu_torch.expr import InputRef, bind_scalars, evaluate
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops.groupby import ValueBitsOverflow
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.bounds import agg_value_bits, estimate_rows, key_dictionary
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.runtime.errors import InternalError, NotSupported, UserError
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
                 approx_join: bool = False, device="cuda"):
        self.catalog = catalog
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
        scalars: dict = {}
        rename = dict(zip(plan.sources, plan.names))
        out = [b.select(list(plan.sources)).rename(rename)
               for b in self._exec(plan.child, scalars)]
        return out, list(plan.names)

    def _exec(self, node: N.PlanNode, scalars: dict) -> BatchStream:
        """Execute a node to a replayable lazy BatchStream; ``scalars``
        holds the values of the scalar subqueries bound above it."""
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            raise NotSupported(f"executing a {type(node).__name__} node is not ported yet")
        return m(node, scalars)

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

        def load(split):
            b = conn.scan(split, src_cols, cap).rename(rename)
            return op.process(b)[0] if op is not None else b

        return BatchStream(lambda: prefetch_iter(load, splits))

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
        # value_overflow falls back to the generic route below, counted
        route, reason = leaf_route.match_leaf_fragment(node, self.catalog)
        if route is not None:
            routed = leaf_route.execute_leaf_route(route, self, node, scalars)
            if routed is not None:
                COUNTERS["agg.strategy.fused"] += 1
                return BatchStream.of(routed)
        elif reason is not None:
            leaf_route.count_fallback(reason)

        child = self._exec(node.child, scalars)
        keys = [(n, bind_scalars(e, scalars)) for n, e in node.keys]
        pax = [(n, bind_scalars(e, scalars)) for n, e in node.passengers]
        # stats-derived |value| bounds; a violated bound trips
        # value_overflow and retries at 63 bits
        aggs = [AggSpec(a.kind, bind_scalars(a.input, scalars) if a.input is not None else None,
                        a.name, a.dtype, value_bits=b)
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

    def _join_keys(self, node, left: BatchStream, right, scalars):
        """(probe key, build key): one integer key per side, multi-key
        pairs packed. Only a multi-key pair without stats-derived pack
        widths pays the runtime min/max: a replay of the probe stream and
        a readback."""

        def runtime_minmax(side: int, key):
            mn, mx = 0, 0
            for b in (left if side == 0 else right):
                v = evaluate(key, b)
                live = b.live & valid_of(v.valid, b.live)
                if bool(live.any()):
                    data = v.data.to(torch.int64)[live]
                    mn, mx = min(mn, int(data.min())), max(mx, int(data.max()))
            return mn, mx

        lkey, rkey, _verify = join_key_exprs([bind_scalars(k, scalars) for k in node.left_keys],
                                             [bind_scalars(k, scalars) for k in node.right_keys],
                                             catalog=self.catalog, lnode=node.left,
                                             rnode=node.right, runtime_minmax=runtime_minmax)
        return lkey, rkey

    def _exec_join(self, node: N.Join, scalars):
        if node.kind not in ("inner", "left"):
            raise NotSupported(f"{node.kind} joins are not ported yet")
        left = self._exec(node.left, scalars)
        # the build side is materialized (the lookup source concatenates
        # it); the probe side streams batch by batch
        right = self._exec(node.right, scalars).materialize()
        lkey, rkey = self._join_keys(node, left, right, scalars)
        # the dense and fused sides serve unique builds only
        iv = build_key_interval(node, self.catalog) if node.unique else None
        spec = self._pallas_spec(iv, tuple(node.output_right),
                                 {f.name: f.dtype for f in node.right.fields},
                                 node.unique, node.kind)
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec)
        Pipeline(BatchStream.of(right), [build]).run()
        outs = [BuildOutput(n, n) for n in node.output_right]
        if node.unique:
            op = LookupJoinOperator(build, lkey, outs, node.kind)
            return left.map(lambda b: op.process(b)[0])
        return left.map(self._retrying_expand_probe(build, lkey, outs, node.kind, right))

    def _retrying_expand_probe(self, build, lkey, outs, kind: str, right):
        """The expansion probe of one batch, retried at a doubled output
        capacity on ``CapacityOverflow``: probing is stateless per batch,
        so only the batch that overflowed probes again, and the raised
        capacity stays for later batches. The first capacity comes from
        the first probe batch, ``batch_capacity(max(its capacity, build
        rows, 1024))``; at most ``MAX_RETRIES`` capacities a batch. One
        operator per capacity (each counts its strategy once), as in the
        JAX package."""
        right_rows = sum(live_count(b) for b in right)
        state = {"cap": None, "ops": {}}

        def probe(b: Batch) -> Batch:
            if state["cap"] is None:
                state["cap"] = batch_capacity(max(b.capacity, right_rows, 1024))
            for _ in range(MAX_RETRIES):
                c = state["cap"]
                op = state["ops"].get(c)
                if op is None:
                    op = LookupJoinOperator(build, lkey, outs, kind, unique=False,
                                            out_capacity=c)
                    state["ops"][c] = op
                try:
                    return op.process(b)[0]
                except CapacityOverflow:
                    state["cap"] = c * 2
            raise CapacityOverflow("Join", state["cap"])

        return probe

    def _exec_semijoin(self, node: N.SemiJoin, scalars):
        """Semi (``IN`` / ``EXISTS``) or anti (negated) join, resident:
        the membership probes prefer the fused exists bitmask
        (duplicate-safe), then the dense table when stats allow, else
        the sorted keys; under ``approx_join`` a semi join whose exact
        table does not fit probes the Bloom sketch."""
        left = self._exec(node.left, scalars)
        right = self._exec(node.right, scalars).materialize()
        jt = "anti" if node.negated else "semi"
        lkey, rkey = self._join_keys(node, left, right, scalars)
        iv = build_key_interval(node, self.catalog)
        spec = self._pallas_spec(iv, (), {}, True, jt)
        build = JoinBuildOperator(rkey, dense_domain=self._dense_domain(iv, right),
                                  pallas=spec)
        Pipeline(BatchStream.of(right), [build]).run()
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
