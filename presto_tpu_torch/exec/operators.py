"""Physical operators over Batches.

Counterpart of ``presto_tpu/exec/operators.py``: push-style operators —
``process(batch) -> [Batch]`` then a ``finish() -> [Batch]`` cascade —
holding their state as device tensors. PyTorch runs eagerly, so each
``process`` call does its work directly; the JAX package's per-signature
jit steps and executable cache have no counterpart.

Ported: ``FilterProjectOperator``; ``HashAggregationOperator`` with the
direct-addressed strategy (one ``fused_small_sums`` pass per batch) and
the sort strategy with passengers (merge-by-sort into a bounded group
state; a BYTES key groups by its 7-byte int64 chunks);
``GlobalAggregationOperator`` (no GROUP BY); ``OrderByOperator`` and
``TopNOperator`` over concatenated batches (BYTES sort keys included);
``LimitOperator``; ``WindowOperator`` (one sort of the concatenated
input, then segmented scans); and the UNION helpers
``union_target_dicts`` and ``align_batch_dicts`` (children of one column
with different dictionaries re-encode into their merge).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.expr import Expr, bind_scalars, evaluate, evaluate_predicate
from presto_tpu_torch.ops.groupby import (
    ValueBitsOverflow,
    _identity,
    fused_small_sums,
    gather_padded,
    group_ids_direct,
    group_ids_sort,
    segment_agg,
)
from presto_tpu_torch.ops.sort import bytes_sort_chunks, sort_indices
from presto_tpu_torch.ops.window import (
    change_flags,
    rank_values,
    segment_starts,
    windowed_agg,
)
from presto_tpu_torch.runtime.errors import InternalError, NotSupported, ResourceExhausted
from presto_tpu_torch.runtime.trace import span as trace_span
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
        #: one dictionary per projected VARCHAR literal, shared by every
        #: batch (as the JAX package's traced step shares its one)
        self._literal_dicts: dict[str, Dictionary] = {}
        # the step is shared across queries through the executable
        # cache, keyed by expression content (Param slots hash by slot,
        # never by value)
        self._step = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("filter_project", predicate, projections),
            lambda: _filter_project_step(predicate, projections))

    def process(self, batch: Batch) -> list[Batch]:
        # FilterProject usually runs via stream.map closures (never inside
        # a Pipeline), so its step span lives here
        with trace_span("step:filter_project", "step"):
            return [self.apply(batch)]

    def apply(self, batch: Batch) -> Batch:
        """The step without its span (a scan's predicate on the prefetch
        worker, whose span the consumer records)."""
        return self._step(batch, self._literal_dicts)


def _filter_project_step(predicate: Expr | None, projections: dict[str, Expr] | None):
    """The filter + projection step over one batch; ``literal_dicts`` is
    the calling operator's own dictionary per projected VARCHAR literal."""

    def step(batch: Batch, literal_dicts: dict) -> Batch:
        live = batch.live
        if predicate is not None:
            live = live & evaluate_predicate(predicate, batch)
        if projections is None:
            return batch.with_live(live)
        src = batch.with_live(live)
        cols = {}
        for name, e in projections.items():
            v = evaluate(e, src)
            if isinstance(v.data, str):
                # a projected VARCHAR literal stays host-side until here:
                # an output column becomes a one-entry dictionary column
                cap, dev = batch.capacity, batch.device
                d = literal_dicts.get(name)
                if d is None:
                    d = literal_dicts[name] = Dictionary([v.data])
                cols[name] = Column(torch.zeros(cap, dtype=torch.int32, device=dev),
                                    torch.ones(cap, dtype=torch.bool, device=dev), e.dtype, d)
                continue
            cols[name] = Column(v.data, v.valid, v.dtype, v.dictionary)
        return Batch(cols, live)

    return step


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
    #: row offset for the lag/lead window kinds (unused elsewhere)
    offset: int = 1

    @property
    def merge_kind(self) -> str:
        """How partial results combine at the FINAL phase: counts and
        sums add, min and max take the min and max."""
        return "sum" if self.kind in ("count", "count_star", "sum") else self.kind


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


def _partial_kind(a: AggSpec) -> str:
    """The fold of a single or PARTIAL phase: counts sum ones."""
    return "sum" if a.kind in ("count", "count_star") else a.kind


def _phys_dtype(a: AggSpec) -> torch.dtype:
    if a.kind in ("count", "count_star"):
        return torch.int64
    return a.dtype.torch_dtype


def _as_jnp_gather(cat: torch.Tensor) -> torch.Tensor:
    """The JAX package gathers the sort state with ``jnp.where(ok, x, 0)``,
    which promotes a bool column to int64: a BOOLEAN group key or
    passenger leaves its sort-strategy aggregation as int64 0/1 there,
    and so it does here (copied, not fixed)."""
    return cat.to(torch.int64) if cat.dtype == torch.bool else cat


class HashAggregationOperator(Operator):
    """Streaming grouped aggregation with device-resident state.

    group_keys: list of (name, Expr) producing the key columns;
    passengers: (name, Expr) columns carried per group without grouping
    on them (functionally determined by the keys; sort strategy only).
    ``phase`` "single" and "partial" evaluate the agg inputs; "final"
    merges partial outputs (columns named like the aggs) by each
    aggregate's ``merge_kind``.
    """

    def __init__(
        self,
        group_keys: Sequence[tuple[str, Expr]],
        aggs: Sequence[AggSpec],
        strategy: DirectStrategy | SortStrategy,
        passengers: Sequence[tuple[str, Expr]] = (),
        device="cuda",
        phase: str = "single",
    ):
        if not isinstance(strategy, (DirectStrategy, SortStrategy)):
            raise NotSupported(f"{type(strategy).__name__} is not ported yet")
        if isinstance(strategy, DirectStrategy) and passengers:
            raise NotSupported("passenger keys need the sort strategy")
        self.group_keys = list(group_keys)
        self.aggs = list(aggs)
        self.strategy = strategy
        self.passengers = list(passengers)
        if phase not in ("single", "partial", "final"):
            raise InternalError(f"unknown aggregation phase {phase!r}")
        self.phase = phase
        self.state: dict[str, Any] | None = None
        #: where an empty state lives when finish() comes before any batch
        self.device = device
        self._dicts: dict[str, Dictionary | None] = {}
        # the update is shared across queries through the executable
        # cache, bound to a state-less template instance (a cached bound
        # method of a live operator would pin its state)
        self._update = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("hash_agg", self.group_keys, self.aggs, strategy, phase,
                              self.passengers),
            self._build_update)

    def _build_update(self):
        tmpl = HashAggregationOperator.__new__(HashAggregationOperator)
        tmpl.group_keys, tmpl.aggs = self.group_keys, self.aggs
        tmpl.strategy, tmpl.passengers = self.strategy, self.passengers
        tmpl.device, tmpl.state, tmpl._dicts = self.device, None, {}
        tmpl.phase = self.phase
        if isinstance(self.strategy, DirectStrategy):
            return tmpl._direct_update_impl
        return tmpl._sort_update_impl

    # -- shared helpers ---------------------------------------------------

    def _agg_kind(self, a: AggSpec) -> str:
        return a.merge_kind if self.phase == "final" else _partial_kind(a)

    def _eval_inputs(self, batch: Batch):
        """agg input values + contribution masks for this phase."""
        out = []
        dev = batch.device
        for a in self.aggs:
            if self.phase == "final":
                c = batch[a.name]
                out.append((c.data, batch.live & valid_of(c.valid, batch.live)))
            elif a.kind == "count_star" or a.input is None:
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
        # count-kind aggregates sum all-ones columns: their sum IS their
        # count (a FINAL phase sums partial counts as values)
        is_count = [a.kind in ("count", "count_star") and self.phase != "final"
                    for a in self.aggs]
        fused = [i for i, (k, c) in enumerate(zip(kinds, is_count))
                 if k == "sum" and not c and not inputs[i][0].dtype.is_floating_point]
        # the per-row bound holds before the FINAL phase only: merges add
        # accumulated sums
        bits = [self.aggs[i].value_bits if self.phase != "final" else 63 for i in fused]
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
            state["keyv$" + name] = torch.zeros(g, dtype=torch.bool, device=device)
            if e.dtype.kind is TypeKind.BYTES:
                # one int64 sort column per 7-byte chunk, plus the bytes
                for j in range(-(-e.dtype.width // 7)):
                    state[f"key${name}${j}"] = torch.zeros(g, dtype=torch.int64, device=device)
                state["keyraw$" + name] = torch.zeros((g, e.dtype.width), dtype=torch.uint8,
                                                      device=device)
            else:
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
        column joins the sort keys. A BYTES key sorts as its 7-byte int64
        chunks (``bytes_sort_chunks``) and keeps its bytes beside them."""
        g = self.strategy.max_groups
        kvals = [evaluate(e, batch) for _name, e in self.group_keys]
        pvals = [evaluate(e, batch) for _name, e in self.passengers]
        inputs = self._eval_inputs(batch)
        cat_sort, cat_keys, cat_valids = [], {}, {}
        for (n, e), v in zip(self.group_keys, kvals):
            valid = valid_of(v.valid, batch.live)
            cat_valids[n] = torch.cat([state["keyv$" + n], valid])
            cat_sort.append(cat_valids[n].to(torch.int8))
            mask = valid[:, None] if v.data.dim() > 1 else valid
            kd = torch.where(mask, v.data, torch.zeros_like(v.data))
            if e.dtype.kind is TypeKind.BYTES:
                for j, c in enumerate(bytes_sort_chunks(kd)):
                    key = f"key${n}${j}"
                    cat_keys[key] = torch.cat([state[key], c])
                    cat_sort.append(cat_keys[key])
                cat_keys["keyraw$" + n] = torch.cat([state["keyraw$" + n], v.data])
            else:
                key = "key$" + n
                cat_keys[key] = torch.cat([state[key], kd.to(state[key].dtype)])
                cat_sort.append(cat_keys[key])
        cat_live = torch.cat([state["present"], batch.live])
        gids, rep, ng, ovf = group_ids_sort(cat_sort, cat_live, g)

        new = dict(state)
        new["overflow"] = state["overflow"] | ovf
        for n, _e in self.group_keys:
            new["keyv$" + n] = gather_padded(cat_valids[n], rep, False)
        for key, cat in cat_keys.items():
            new[key] = gather_padded(_as_jnp_gather(cat), rep, 0)
        for (n, _e), v in zip(self.passengers, pvals):
            old = state["pax$" + n]
            new["pax$" + n] = gather_padded(
                _as_jnp_gather(torch.cat([old, v.data.to(old.dtype)])), rep, 0)
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
        self.state, self._dicts = self._update(self.state, batch)
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
            data = st[("keyraw$" if e.dtype.kind is TypeKind.BYTES else "key$") + name]
            cols[name] = Column(data, st["keyv$" + name], e.dtype, self._dicts.get(name))
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
        # shared across queries through the executable cache, bound to a
        # state-less template (see HashAggregationOperator)
        self._update = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("global_agg", self.aggs, "single"), self._build_update)

    def _build_update(self):
        tmpl = GlobalAggregationOperator.__new__(GlobalAggregationOperator)
        tmpl.aggs, tmpl.state, tmpl.device = self.aggs, None, self.device
        return tmpl._update_impl

    def _init(self, device):
        state = {}
        for a in self.aggs:
            kind = _partial_kind(a)
            dt = _phys_dtype(a)
            state[a.name] = torch.tensor(_identity(kind, dt), dtype=dt, device=device)
            state[a.name + "$n"] = torch.zeros((), dtype=torch.int64, device=device)
        return state

    def process(self, batch: Batch) -> list[Batch]:
        if self.state is None:
            self.state = self._init(batch.device)
        self.state = self._update(self.state, batch)
        return []

    def _update_impl(self, state, batch: Batch):
        """One batch folded into ``state``: the new state."""
        new = dict(state)
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
            prev = state[a.name]
            masked = torch.where(contrib, vals, torch.full_like(vals, _identity(kind, vals.dtype)))
            if kind == "sum":
                # widen BEFORE the reduction: a narrow input would wrap
                new[a.name] = prev + torch.sum(masked.to(prev.dtype)).to(prev.dtype)
            elif kind == "min":
                new[a.name] = torch.minimum(prev, torch.min(masked).to(prev.dtype))
            else:
                new[a.name] = torch.maximum(prev, torch.max(masked).to(prev.dtype))
            new[a.name + "$n"] = state[a.name + "$n"] + torch.sum(contrib.to(torch.int64))
        return new

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


def union_target_dicts(names, sample_batches) -> dict[str, Dictionary]:
    """Per-column target dictionaries of a UNION: where the children
    carry different dictionaries for one column, the target is their
    merge (sorted, as every Dictionary); one shared dictionary, or none,
    needs no alignment. ``sample_batches`` holds one batch per child
    (a child's stream has one dictionary per column); None (an empty
    child) is skipped."""
    targets: dict[str, Dictionary] = {}
    for n in names:
        dicts: list[Dictionary] = []
        for b in sample_batches:
            if b is None or n not in b:
                continue
            d = b[n].dictionary
            if d is not None and all(d is not x for x in dicts):
                dicts.append(d)
        if len(dicts) > 1:
            merged: list[str] = []
            for d in dicts:
                merged.extend(d.values.tolist())
            targets[n] = Dictionary(merged)
    return targets


def align_batch_dicts(b: Batch, targets: dict, _cache: dict | None = None) -> Batch:
    """Re-encode the dictionary columns of ``b`` into the union's target
    dictionaries through a small code-mapping table on the device.
    ``_cache`` (keyed by column and source dictionary) builds each
    mapping once per stream instead of once per batch."""
    if not targets:
        return b
    cols = dict(b.columns)
    for n, target in targets.items():
        c = cols.get(n)
        if c is None or c.dictionary is None or c.dictionary is target:
            continue
        key = (n, id(c.dictionary))
        mapping = None if _cache is None else _cache.get(key)
        if mapping is None:
            mapping = torch.from_numpy(np.array(
                [target.code_of(v) for v in c.dictionary.values], dtype=np.int32)).to(b.device)
            if _cache is not None:
                _cache[key] = mapping
        cols[n] = Column(mapping[c.data.to(torch.int64)], c.valid, c.dtype, target)
    return Batch(cols, b.live)


#: window kinds that read their neighbours in sort order
_OFFSET_KINDS = ("lag", "lead", "first_value")


def _key_parts(v) -> list[torch.Tensor]:
    """int64 comparison columns of a window key: a BYTES key its PAD
    SPACE big-endian 7-byte chunks (one chunk up to width 7, the JAX
    package's ``_sortable``), anything else its own data."""
    if v.dtype.kind is TypeKind.BYTES:
        return bytes_sort_chunks(v.data)
    return [v.data]


class WindowOperator(CollectingOperator):
    """Window functions over the concatenated input (the JAX package's
    ``WindowOperator``): one stable multi-key sort by (partition keys,
    order keys), then every function by segmented scans and boundary
    gathers over the sorted rows (``ops/window.py``), no per-partition
    loop. The output batch stays in that sort order.

    ``funcs`` reuse AggSpec: row_number / rank / dense_rank and lag /
    lead (``offset`` rows) / first_value need order keys; sum / count /
    count_star / min / max are windowed aggregates over ``frame``
    ('range', 'rows' or 'full'). The window step is shared across
    queries through the executable cache, bound to a state-less
    template."""

    def __init__(self, partition_by: Sequence[Expr], order_keys: Sequence[SortKey],
                 funcs: Sequence[AggSpec], frame: str = "range"):
        super().__init__()
        self.partition_by = list(partition_by)
        self.order_keys = list(order_keys)
        self.funcs = list(funcs)
        self.frame = frame
        if frame not in ("range", "rows", "full"):
            raise InternalError(f"unsupported window frame {frame!r}")
        ranked = [f for f in funcs
                  if f.kind in ("row_number", "rank", "dense_rank") + _OFFSET_KINDS]
        if ranked and not self.order_keys:
            raise ValueError(f"{ranked[0].kind}() requires ORDER BY in its window")
        self._step = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("window", self.partition_by, self.order_keys, self.funcs, frame),
            self._build_step)

    def _build_step(self):
        """The window step bound to a state-less clone: a cached closure
        must never pin a live operator's buffered batches."""
        tmpl = WindowOperator.__new__(WindowOperator)
        tmpl.batches = []
        tmpl.partition_by, tmpl.order_keys = self.partition_by, self.order_keys
        tmpl.funcs, tmpl.frame = self.funcs, self.frame
        return tmpl._window

    def _sort(self, batch: Batch):
        """The sort order, and the partition and peer comparison columns
        (NULL-normalized, in input order). Partition keys sort as an
        is-null flag then the value with NULLs zeroed (NULLs one group);
        order keys with SQL null placement."""
        sort_cols, descs, nfs, valids = [], [], [], []
        part_cmp: list = []
        for e in self.partition_by:
            v = evaluate(e, batch)
            valid = valid_of(v.valid, batch.live)
            isnull = (~valid).to(torch.int32)
            sort_cols.append(isnull)
            descs.append(False)
            nfs.append(False)
            valids.append(None)
            part_cmp.append(isnull)
            for p in _key_parts(v):
                norm = torch.where(valid, p, torch.zeros_like(p))
                sort_cols.append(norm)
                descs.append(False)
                nfs.append(False)
                valids.append(None)
                part_cmp.append(norm)
        peer_cmp: list = []
        for k in self.order_keys:
            v = evaluate(k.expr, batch)
            valid = valid_of(v.valid, batch.live)
            peer_cmp.append((~valid).to(torch.int32))
            for j, p in enumerate(_key_parts(v)):
                sort_cols.append(p)
                descs.append(k.descending)
                nfs.append(k.nulls_first)
                valids.append(valid if j == 0 else None)
                peer_cmp.append(torch.where(valid, p, torch.zeros_like(p)))
        order = sort_indices(sort_cols, descs, batch.live, nulls_first=nfs, valids=valids)
        return order, part_cmp, peer_cmp

    def _offset_column(self, f: AggSpec, sorted_batch: Batch, seg_start) -> Column:
        """lag / lead / first_value: a gather fenced by the partition
        start (a row of another partition reads as NULL)."""
        live = sorted_batch.live
        cap = live.shape[0]
        idx = torch.arange(cap, device=live.device)
        v = evaluate(f.input, sorted_batch)
        cvalid = live & valid_of(v.valid, live)
        if f.kind == "first_value":
            src, ok = seg_start, torch.ones_like(live)
        elif f.kind == "lag":
            src = torch.clamp(idx - f.offset, 0, cap - 1)
            ok = (idx - f.offset) >= seg_start
        else:  # lead: the same partition iff its start matches
            src = torch.clamp(idx + f.offset, 0, cap - 1)
            ok = ((idx + f.offset) < cap) & (seg_start[src] == seg_start)
        # v.dtype is the physical storage of the shifted column (narrow
        # scan data passes through the gather unchanged)
        return Column(v.data[src], ok & cvalid[src] & live, v.dtype, v.dictionary)

    def _window(self, batch: Batch) -> Batch:
        cap, dev = batch.capacity, batch.device
        order, part_cmp, peer_cmp = self._sort(batch)
        cols = {n: Column(c.data[order], valid_of(c.valid, batch.live)[order], c.dtype,
                          c.dictionary)
                for n, c in batch.columns.items()}
        live = batch.live[order]
        sorted_batch = Batch(cols, live)
        # liveness counts: the dead tail is a segment of its own and never
        # extends a live partition's scans
        part_change = change_flags([c[order] for c in part_cmp] + [live.to(torch.int32)])
        peer_change = (part_change | change_flags([c[order] for c in peer_cmp])
                       if peer_cmp else part_change)
        row_number, rank, dense = rank_values(part_change, peer_change)
        all_valid = torch.ones(cap, dtype=torch.bool, device=dev)
        seg_start = None
        for f in self.funcs:
            if f.kind in _OFFSET_KINDS:
                if seg_start is None:
                    seg_start = segment_starts(part_change)
                cols[f.name] = self._offset_column(f, sorted_batch, seg_start)
                continue
            ranked = {"row_number": row_number, "rank": rank, "dense_rank": dense}.get(f.kind)
            if ranked is not None:
                cols[f.name] = Column(ranked, all_valid, f.dtype)
                continue
            dictionary = None
            if f.kind == "count_star" or f.input is None:
                vals, contrib = torch.ones(cap, dtype=torch.int64, device=dev), live
            else:
                v = evaluate(f.input, sorted_batch)
                dictionary = v.dictionary  # min / max over ordered codes
                contrib = live & valid_of(v.valid, live)
                if f.kind == "count":
                    vals = torch.ones(cap, dtype=torch.int64, device=dev)
                else:
                    vals = v.data.to(_phys_dtype(f))
            counting = f.kind in ("count", "count_star")
            val, cnt = windowed_agg(vals, contrib, part_change, peer_change,
                                    "sum" if counting else f.kind, self.frame)
            if counting:
                cols[f.name] = Column(val.to(f.dtype.torch_dtype), all_valid, f.dtype)
            else:
                valid = cnt > 0
                cols[f.name] = Column(
                    torch.where(valid, val, torch.zeros_like(val)).to(f.dtype.torch_dtype),
                    valid, f.dtype, dictionary)
        return Batch(cols, live)

    def finish(self) -> list[Batch]:
        if not self.batches:
            return []
        return [self._step(concat_batches(self.batches))]


def window_operator_from_node(node, scalars) -> WindowOperator:
    """Lower an ``N.Window`` plan node to a WindowOperator, its
    expressions with the scalar subqueries' values bound."""
    part = [bind_scalars(e, scalars) for e in node.partition_by]
    keys = [SortKey(bind_scalars(k.expr, scalars), k.descending, k.nulls_first)
            for k in node.order_by]
    aggs = [AggSpec(f.kind, bind_scalars(f.input, scalars) if f.input is not None else None,
                    f.name, f.dtype, offset=f.offset)
            for f in node.funcs]
    return WindowOperator(part, keys, aggs, node.frame)


class LimitOperator(Operator):
    """A row-count limit across batches: the first ``n`` live rows in
    stream order; every batch after them is dropped (the scan is not
    stopped early, as in the JAX package)."""

    def __init__(self, n: int):
        self.remaining = n

    def process(self, batch: Batch) -> list[Batch]:
        if self.remaining <= 0:
            return []
        c = int(batch.count())
        if c <= self.remaining:
            self.remaining -= c
            return [batch]
        # keep the first ``remaining`` live rows
        k = self.remaining
        self.remaining = 0
        live_rank = torch.cumsum(batch.live.to(torch.int32), dim=0)
        return [batch.with_live(batch.live & (live_rank <= k))]


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
