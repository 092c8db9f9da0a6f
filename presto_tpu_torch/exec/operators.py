"""Physical operators over Batches.

Counterpart of ``presto_tpu/exec/operators.py``: push-style operators —
``process(batch) -> [Batch]`` then a ``finish() -> [Batch]`` cascade —
holding their state as device tensors. PyTorch runs eagerly, so each
``process`` call does its work directly; the JAX package's per-signature
jit steps and executable cache have no counterpart.

Ported: ``FilterProjectOperator``; ``HashAggregationOperator`` with the
direct-addressed strategy (one ``fused_small_sums`` pass per batch) and
the sort strategy with passengers (merge-by-sort into a bounded group
state); ``GlobalAggregationOperator`` (no GROUP BY); ``OrderByOperator``
and ``TopNOperator`` over concatenated batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.expr import Expr, evaluate, evaluate_predicate
from presto_tpu_torch.ops.groupby import (
    ValueBitsOverflow,
    _identity,
    fused_small_sums,
    gather_padded,
    group_ids_direct,
    group_ids_sort,
    segment_agg,
)
from presto_tpu_torch.ops.sort import sort_indices
from presto_tpu_torch.runtime.errors import NotSupported, ResourceExhausted
from presto_tpu_torch.types import DataType, TypeKind


class NullGroupKeys(RuntimeError):
    """A direct-addressed grouping met NULL key values at runtime: the
    packed-domain gid has no NULL slot, so the planner must retry with
    the sort strategy."""


class CapacityOverflow(ResourceExhausted):
    """An operator's static capacity was exceeded; the owning planner
    loop re-plans with a larger one."""

    def __init__(self, op: str, capacity: int, needed: int | None = None):
        super().__init__(f"{op}: capacity {capacity} exceeded"
                         + (f" (needed {needed})" if needed else ""))
        self.op, self.capacity, self.needed = op, capacity, needed


def valid_of(valid: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """A validity mask as a tensor (None means every row valid)."""
    return torch.ones_like(like, dtype=torch.bool) if valid is None else valid


class Operator:
    """Push-model operator protocol."""

    def process(self, batch: Batch) -> list[Batch]:
        raise NotImplementedError

    def finish(self) -> list[Batch]:
        return []


# ---------------------------------------------------------------------------
# FilterProject — the fused ScanFilterAndProject body
# ---------------------------------------------------------------------------


class FilterProjectOperator(Operator):
    """Filter + projections. ``projections`` maps output column name ->
    Expr; None means filter-only. Filtering only ANDs the live mask."""

    def __init__(self, predicate: Expr | None, projections: dict[str, Expr] | None):
        self.predicate = predicate
        self.projections = projections

    def process(self, batch: Batch) -> list[Batch]:
        live = batch.live
        if self.predicate is not None:
            live = live & evaluate_predicate(self.predicate, batch)
        if self.projections is None:
            return [batch.with_live(live)]
        src = batch.with_live(live)
        cols = {}
        for name, e in self.projections.items():
            v = evaluate(e, src)
            if isinstance(v.data, str):
                # a projected VARCHAR literal stays host-side until here:
                # an output column becomes a one-entry dictionary column
                cap, dev = batch.capacity, batch.device
                cols[name] = Column(torch.zeros(cap, dtype=torch.int32, device=dev),
                                    torch.ones(cap, dtype=torch.bool, device=dev),
                                    e.dtype, Dictionary([v.data]))
                continue
            cols[name] = Column(v.data, v.valid, v.dtype, v.dictionary)
        return [Batch(cols, live)]


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggSpec:
    """One aggregate: kind in {sum,count,min,max,count_star}; ``input``
    evaluated against the input batch (None for count_star).
    ``value_bits`` bounds the bit width of |input values| (not of the
    running sum); 63 is always safe."""

    kind: str
    input: Expr | None
    name: str
    dtype: DataType
    value_bits: int = 63


@dataclass(frozen=True)
class DirectStrategy:
    """gid = packed bounded-domain key. mins/strides over the raw key
    columns."""

    mins: tuple[int, ...]
    strides: tuple[int, ...]
    num_groups: int


@dataclass(frozen=True)
class SortStrategy:
    """Merge-by-sort grouping with a static group capacity."""

    max_groups: int


def _phys_dtype(a: AggSpec) -> torch.dtype:
    if a.kind in ("count", "count_star"):
        return torch.int64
    return a.dtype.torch_dtype


class HashAggregationOperator(Operator):
    """Streaming grouped aggregation with device-resident state.

    group_keys: list of (name, Expr) producing the key columns;
    passengers: (name, Expr) columns carried per group without grouping
    on them (functionally determined by the keys; sort strategy only).
    The port runs the single phase: every batch's agg inputs are
    evaluated and folded into the state.
    """

    def __init__(
        self,
        group_keys: Sequence[tuple[str, Expr]],
        aggs: Sequence[AggSpec],
        strategy: DirectStrategy | SortStrategy,
        passengers: Sequence[tuple[str, Expr]] = (),
        device="cuda",
    ):
        if not isinstance(strategy, (DirectStrategy, SortStrategy)):
            raise NotSupported(f"{type(strategy).__name__} is not ported yet")
        if isinstance(strategy, DirectStrategy) and passengers:
            raise NotSupported("passenger keys need the sort strategy")
        self.group_keys = list(group_keys)
        self.aggs = list(aggs)
        self.strategy = strategy
        self.passengers = list(passengers)
        self.state: dict[str, Any] | None = None
        #: where an empty state lives when finish() comes before any batch
        self.device = device
        self._dicts: dict[str, Dictionary | None] = {}

    # -- shared helpers ---------------------------------------------------

    @staticmethod
    def _agg_kind(a: AggSpec) -> str:
        return "sum" if a.kind in ("count", "count_star") else a.kind

    def _eval_inputs(self, batch: Batch):
        """agg input values + contribution masks."""
        out = []
        dev = batch.device
        for a in self.aggs:
            if a.kind == "count_star" or a.input is None:
                out.append((torch.ones(batch.capacity, dtype=torch.int64, device=dev),
                            batch.live))
            else:
                v = evaluate(a.input, batch)
                if a.kind == "count":
                    out.append((torch.ones(batch.capacity, dtype=torch.int64, device=dev),
                                batch.live & v.valid))
                else:
                    out.append((v.data, batch.live & v.valid))
        return out

    # -- direct-addressed path -------------------------------------------

    def _direct_update_impl(self, state, batch: Batch):
        """One-pass direct-addressed update: all integer sums, every
        per-aggregate count and group presence ride a single
        ``fused_small_sums`` call. Only min/max and float sums take the
        per-aggregate ``segment_agg`` path."""
        st = self.strategy
        kvals = [evaluate(e, batch) for _name, e in self.group_keys]
        nk = state["null_key"]
        for v in kvals:
            if v.valid is not None:
                nk = nk | torch.any(batch.live & ~v.valid)
        state = dict(state)
        state["null_key"] = nk
        gids, _ = group_ids_direct(
            [v.data for v in kvals], st.mins, st.strides, batch.live, st.num_groups)
        inputs = self._eval_inputs(batch)
        kinds = [self._agg_kind(a) for a in self.aggs]
        # count-kind aggregates sum all-ones columns: their sum IS their count
        is_count = [a.kind in ("count", "count_star") for a in self.aggs]
        fused = [i for i, (k, c) in enumerate(zip(kinds, is_count))
                 if k == "sum" and not c and not inputs[i][0].dtype.is_floating_point]
        bits = [self.aggs[i].value_bits for i in fused]
        rest = [i for i in range(len(self.aggs)) if i not in fused and not is_count[i]]
        unfused = [i for i in range(len(self.aggs)) if i not in fused]
        sums, fcounts, extras, oflow = fused_small_sums(
            [inputs[i][0] for i in fused],
            bits,
            [inputs[i][1] for i in fused],
            gids,
            st.num_groups,
            extra_count_masks=[batch.live] + [inputs[i][1] for i in unfused],
        )
        counts: list = [None] * len(self.aggs)
        for j, i in enumerate(fused):
            counts[i] = fcounts[j]
        for j, i in enumerate(unfused):
            counts[i] = extras[1 + j]
        new = dict(state)
        new["present"] = state["present"] | (extras[0] > 0)
        new["value_overflow"] = state["value_overflow"] | oflow
        for j, i in enumerate(fused):
            new[self.aggs[i].name] = state[self.aggs[i].name] + sums[j]
        for i in range(len(self.aggs)):
            if is_count[i]:
                new[self.aggs[i].name] = state[self.aggs[i].name] + counts[i]
        for i in rest:
            a, kind = self.aggs[i], kinds[i]
            vals, contrib = inputs[i]
            part = segment_agg(vals, contrib, gids, st.num_groups, kind)
            prev = state[a.name]
            if kind == "sum":
                new[a.name] = prev + part
            elif kind == "min":
                new[a.name] = torch.minimum(prev, part.to(prev.dtype))
            else:
                new[a.name] = torch.maximum(prev, part.to(prev.dtype))
        for a, cnt in zip(self.aggs, counts):
            new[a.name + "$n"] = state[a.name + "$n"] + cnt
        dicts = {name: v.dictionary for (name, _e), v in zip(self.group_keys, kvals)}
        return new, dicts

    def _direct_init(self, device):
        g = self.strategy.num_groups
        state: dict[str, Any] = {
            "present": torch.zeros(g, dtype=torch.bool, device=device),
            "value_overflow": torch.zeros((), dtype=torch.bool, device=device),
            "null_key": torch.zeros((), dtype=torch.bool, device=device),
        }
        for a in self.aggs:
            dt = _phys_dtype(a)
            state[a.name] = torch.full((g,), _identity(self._agg_kind(a), dt),
                                       dtype=dt, device=device)
            state[a.name + "$n"] = torch.zeros(g, dtype=torch.int64, device=device)
        return state

    # -- sort-merge path ---------------------------------------------------

    def _sort_init(self, device):
        g = self.strategy.max_groups
        state: dict[str, Any] = {
            "present": torch.zeros(g, dtype=torch.bool, device=device),
            "overflow": torch.zeros((), dtype=torch.bool, device=device),
        }
        for name, e in self.group_keys:
            if e.dtype.kind is TypeKind.BYTES:
                raise NotSupported("grouping on BYTES keys is not ported yet")
            state["keyv$" + name] = torch.zeros(g, dtype=torch.bool, device=device)
            state["key$" + name] = torch.zeros(g, dtype=e.dtype.torch_dtype, device=device)
        for name, e in self.passengers:
            shape = (g, e.dtype.width) if e.dtype.kind is TypeKind.BYTES else (g,)
            state["pax$" + name] = torch.zeros(shape, dtype=e.dtype.torch_dtype, device=device)
            state["paxv$" + name] = torch.zeros(g, dtype=torch.bool, device=device)
        for a in self.aggs:
            dt = _phys_dtype(a)
            state[a.name] = torch.full((g,), _identity(self._agg_kind(a), dt),
                                       dtype=dt, device=device)
            state[a.name + "$n"] = torch.zeros(g, dtype=torch.int64, device=device)
            state[a.name + "$has"] = torch.zeros(g, dtype=torch.bool, device=device)
        return state

    def _sort_update_impl(self, state, batch: Batch):
        """Fold a batch into the state by concatenating the state rows
        (as a pseudo-batch) with the batch's rows, then re-grouping —
        bounded memory, one multi-key sort per batch. NULL keys form
        their own group: the data is zeroed under NULL and a validity
        column joins the sort keys."""
        g = self.strategy.max_groups
        kvals = [evaluate(e, batch) for _name, e in self.group_keys]
        pvals = [evaluate(e, batch) for _name, e in self.passengers]
        inputs = self._eval_inputs(batch)
        cat_sort, cat_keys, cat_valids = [], {}, {}
        for (n, _e), v in zip(self.group_keys, kvals):
            valid = valid_of(v.valid, batch.live)
            cat_valids[n] = torch.cat([state["keyv$" + n], valid])
            cat_sort.append(cat_valids[n].to(torch.int8))
            kd = torch.where(valid, v.data, torch.zeros_like(v.data))
            cat_keys[n] = torch.cat([state["key$" + n], kd.to(state["key$" + n].dtype)])
            cat_sort.append(cat_keys[n])
        cat_live = torch.cat([state["present"], batch.live])
        gids, rep, ng, ovf = group_ids_sort(cat_sort, cat_live, g)

        new = dict(state)
        new["overflow"] = state["overflow"] | ovf
        for n, _e in self.group_keys:
            new["keyv$" + n] = gather_padded(cat_valids[n], rep, False)
            new["key$" + n] = gather_padded(cat_keys[n], rep, 0)
        for (n, _e), v in zip(self.passengers, pvals):
            old = state["pax$" + n]
            new["pax$" + n] = gather_padded(torch.cat([old, v.data.to(old.dtype)]), rep, 0)
            new["paxv$" + n] = gather_padded(
                torch.cat([state["paxv$" + n], valid_of(v.valid, batch.live)]), rep, False)
        new["present"] = torch.arange(g, device=gids.device) < ng
        for a, (vals, contrib) in zip(self.aggs, inputs):
            dt = _phys_dtype(a)
            cat_vals = torch.cat([state[a.name], vals.to(dt)])
            cat_contrib = torch.cat([state[a.name + "$has"], contrib])
            new[a.name] = segment_agg(cat_vals, cat_contrib, gids, g,
                                      self._agg_kind(a)).to(dt)
            cnt = torch.cat([state[a.name + "$n"], contrib.to(torch.int64)])
            new[a.name + "$n"] = segment_agg(cnt, cat_live, gids, g, "sum")
            new[a.name + "$has"] = new[a.name + "$n"] > 0
        dicts = {name: v.dictionary for (name, _e), v in
                 zip(self.group_keys + self.passengers, kvals + pvals)}
        return new, dicts

    # -- operator protocol -------------------------------------------------

    def _init(self, device):
        if isinstance(self.strategy, DirectStrategy):
            return self._direct_init(device)
        return self._sort_init(device)

    def process(self, batch: Batch) -> list[Batch]:
        if self.state is None:
            self.state = self._init(batch.device)
        if isinstance(self.strategy, DirectStrategy):
            self.state, self._dicts = self._direct_update_impl(self.state, batch)
        else:
            self.state, self._dicts = self._sort_update_impl(self.state, batch)
        return []

    def finish(self) -> list[Batch]:
        """Emit one Batch of G rows (live = group present)."""
        if self.state is None:
            self.state = self._init(resolve_device(self.device))
        st = self.state
        if isinstance(self.strategy, SortStrategy):
            if bool(st["overflow"]):
                raise CapacityOverflow("HashAggregation", self.strategy.max_groups)
            return [self._sort_output(st)]
        if bool(st["null_key"]):
            raise NullGroupKeys(
                "direct-addressed grouping met NULL key values "
                f"({[n for n, _ in self.group_keys]}) — replan with the "
                "sort strategy")
        if bool(st["value_overflow"]):
            raise ValueBitsOverflow(
                "a declared AggSpec.value_bits bound was exceeded at "
                f"runtime in {[a.name for a in self.aggs]} — the planner "
                "retries with the unbounded 63-bit path")
        g = self.strategy.num_groups
        dev = st["present"].device
        cols: dict[str, Column] = {}
        # decode gid -> key values
        rem = torch.arange(g, dtype=torch.int32, device=dev)
        for (name, e), m, s in zip(self.group_keys, self.strategy.mins,
                                   self.strategy.strides):
            code = torch.div(rem, s, rounding_mode="floor") + m
            rem = rem % s
            cols[name] = Column(code.to(e.dtype.torch_dtype),
                                torch.ones(g, dtype=torch.bool, device=dev),
                                e.dtype, self._dicts.get(name))
        self._agg_columns(st, g, cols)
        return [Batch(cols, st["present"])]

    def _sort_output(self, st) -> Batch:
        g = self.strategy.max_groups
        cols: dict[str, Column] = {}
        for name, e in self.group_keys:
            cols[name] = Column(st["key$" + name], st["keyv$" + name], e.dtype,
                                self._dicts.get(name))
        for name, e in self.passengers:
            cols[name] = Column(st["pax$" + name], st["paxv$" + name], e.dtype,
                                self._dicts.get(name))
        self._agg_columns(st, g, cols)
        return Batch(cols, st["present"])

    def _agg_columns(self, st, g: int, cols: dict) -> None:
        dev = st["present"].device
        for a in self.aggs:
            valid = st[a.name + "$n"] > 0
            if a.kind in ("count", "count_star"):
                valid = torch.ones(g, dtype=torch.bool, device=dev)
            data = torch.where(valid, st[a.name], torch.zeros_like(st[a.name]))
            cols[a.name] = Column(data.to(a.dtype.torch_dtype), valid, a.dtype)


# ---------------------------------------------------------------------------
# Global (ungrouped) aggregation
# ---------------------------------------------------------------------------


class GlobalAggregationOperator(Operator):
    """Aggregation without GROUP BY: one output row. Over zero rows the
    sums, mins and maxes are NULL and the counts 0."""

    def __init__(self, aggs: Sequence[AggSpec], device="cuda"):
        self.aggs = list(aggs)
        self.state: dict[str, Any] | None = None
        #: where an empty state lives when finish() comes before any batch
        self.device = device

    def _init(self, device):
        state = {}
        for a in self.aggs:
            kind = HashAggregationOperator._agg_kind(a)
            dt = _phys_dtype(a)
            state[a.name] = torch.tensor(_identity(kind, dt), dtype=dt, device=device)
            state[a.name + "$n"] = torch.zeros((), dtype=torch.int64, device=device)
        return state

    def process(self, batch: Batch) -> list[Batch]:
        if self.state is None:
            self.state = self._init(batch.device)
        new = dict(self.state)
        for a in self.aggs:
            if a.kind == "count_star" or a.input is None:
                vals = torch.ones(batch.capacity, dtype=torch.int64, device=batch.device)
                contrib, kind = batch.live, "sum"
            else:
                v = evaluate(a.input, batch)
                contrib = batch.live & valid_of(v.valid, batch.live)
                if a.kind == "count":
                    vals = torch.ones(batch.capacity, dtype=torch.int64, device=batch.device)
                    kind = "sum"
                else:
                    vals, kind = v.data, a.kind
            prev = self.state[a.name]
            masked = torch.where(contrib, vals, torch.full_like(vals, _identity(kind, vals.dtype)))
            if kind == "sum":
                # widen BEFORE the reduction: a narrow input would wrap
                new[a.name] = prev + torch.sum(masked.to(prev.dtype)).to(prev.dtype)
            elif kind == "min":
                new[a.name] = torch.minimum(prev, torch.min(masked).to(prev.dtype))
            else:
                new[a.name] = torch.maximum(prev, torch.max(masked).to(prev.dtype))
            new[a.name + "$n"] = self.state[a.name + "$n"] + torch.sum(contrib.to(torch.int64))
        self.state = new
        return []

    def finish(self) -> list[Batch]:
        if self.state is None:
            self.state = self._init(resolve_device(self.device))
        dev = self.state[self.aggs[0].name].device if self.aggs else resolve_device(self.device)
        cols = {}
        for a in self.aggs:
            n = self.state[a.name + "$n"]
            valid = (n > 0) | (a.kind in ("count", "count_star"))
            data = torch.where(valid, self.state[a.name], torch.zeros_like(self.state[a.name]))
            cols[a.name] = Column(data.to(a.dtype.torch_dtype).reshape(1), valid.reshape(1),
                                  a.dtype)
        return [Batch(cols, torch.ones(1, dtype=torch.bool, device=dev))]


# ---------------------------------------------------------------------------
# Collecting operators: ordering
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SortKey:
    expr: Expr
    descending: bool = False
    nulls_first: bool = False


class CollectingOperator(Operator):
    """Base: buffers incoming batches (a host list of device batches)."""

    def __init__(self):
        self.batches: list[Batch] = []

    def process(self, batch: Batch) -> list[Batch]:
        self.batches.append(batch)
        return []


def concat_batches(batches: list[Batch]) -> Batch:
    """Concatenate along rows. The output dictionary per column is the
    first non-None one."""
    first = batches[0]
    if len(batches) == 1:
        return first
    cols = {}
    for name in first.names:
        d = next((b[name].dictionary for b in batches
                  if b[name].dictionary is not None), None)
        cols[name] = Column(
            torch.cat([b[name].data for b in batches]),
            torch.cat([valid_of(b[name].valid, b.live) for b in batches]),
            first[name].dtype, d)
    return Batch(cols, torch.cat([b.live for b in batches]))


def _sorted_order(keys: Sequence[SortKey], batch: Batch) -> torch.Tensor:
    vals = [evaluate(k.expr, batch) for k in keys]
    return sort_indices(
        [v.data for v in vals], [k.descending for k in keys], batch.live,
        nulls_first=[k.nulls_first for k in keys],
        valids=[v.valid for v in vals])


class OrderByOperator(CollectingOperator):
    """Full sort of the concatenated input."""

    def __init__(self, keys: Sequence[SortKey]):
        super().__init__()
        self.keys = list(keys)

    def finish(self) -> list[Batch]:
        if not self.batches:
            return []
        batch = concat_batches(self.batches)
        order = _sorted_order(self.keys, batch)
        cols = {n: Column(c.data[order], valid_of(c.valid, batch.live)[order],
                          c.dtype, c.dictionary)
                for n, c in batch.columns.items()}
        return [Batch(cols, batch.live[order])]


class TopNOperator(CollectingOperator):
    """Sort + limit with bounded output."""

    def __init__(self, keys: Sequence[SortKey], n: int):
        super().__init__()
        self.keys = list(keys)
        self.n = n

    def finish(self) -> list[Batch]:
        if not self.batches:
            return []
        batch = concat_batches(self.batches)
        take = _sorted_order(self.keys, batch)[: self.n]
        cols = {n: Column(gather_padded(c.data, take, 0),
                          gather_padded(valid_of(c.valid, batch.live),
                                        take, False),
                          c.dtype, c.dictionary)
                for n, c in batch.columns.items()}
        return [Batch(cols, gather_padded(batch.live, take, False))]
