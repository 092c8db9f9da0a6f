"""Physical operators over Batches (the Q1 pipeline's subset).

Counterpart of ``presto_tpu/exec/operators.py``: push-style operators —
``process(batch) -> [Batch]`` then a ``finish() -> [Batch]`` cascade —
holding their state as device tensors. PyTorch runs eagerly, so each
``process`` call does its work directly; the JAX package's per-signature
jit steps and executable cache have no counterpart.

This slice ports ``FilterProjectOperator`` and ``HashAggregationOperator``
with the direct-addressed strategy, whose update folds every integer sum,
every count and group presence into one ``fused_small_sums`` pass.
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
    group_ids_direct,
    segment_agg,
)
from presto_tpu_torch.types import DataType


class NullGroupKeys(RuntimeError):
    """A direct-addressed grouping met NULL key values at runtime: the
    packed-domain gid has no NULL slot, so the planner must retry with
    the sort strategy."""


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


def _phys_dtype(a: AggSpec) -> torch.dtype:
    if a.kind in ("count", "count_star"):
        return torch.int64
    return a.dtype.torch_dtype


class HashAggregationOperator(Operator):
    """Streaming grouped aggregation with device-resident state (the
    direct-addressed strategy).

    group_keys: list of (name, Expr) producing the key columns. This
    slice ports the single phase: every batch's agg inputs are evaluated
    and folded into the state.
    """

    def __init__(
        self,
        group_keys: Sequence[tuple[str, Expr]],
        aggs: Sequence[AggSpec],
        strategy: DirectStrategy,
        device="cuda",
    ):
        if not isinstance(strategy, DirectStrategy):
            raise NotImplementedError(
                f"{type(strategy).__name__} is not ported to presto_tpu_torch "
                "yet (only DirectStrategy)")
        self.group_keys = list(group_keys)
        self.aggs = list(aggs)
        self.strategy = strategy
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

    # -- operator protocol -------------------------------------------------

    def process(self, batch: Batch) -> list[Batch]:
        if self.state is None:
            self.state = self._direct_init(batch.device)
        self.state, self._dicts = self._direct_update_impl(self.state, batch)
        return []

    def finish(self) -> list[Batch]:
        """Emit one Batch of G rows (live = group present)."""
        if self.state is None:
            self.state = self._direct_init(resolve_device(self.device))
        st = self.state
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
        live = st["present"]
        # decode gid -> key values
        rem = torch.arange(g, dtype=torch.int32, device=dev)
        for (name, e), m, s in zip(self.group_keys, self.strategy.mins,
                                   self.strategy.strides):
            code = torch.div(rem, s, rounding_mode="floor") + m
            rem = rem % s
            cols[name] = Column(code.to(e.dtype.torch_dtype),
                                torch.ones(g, dtype=torch.bool, device=dev),
                                e.dtype, self._dicts.get(name))
        for a in self.aggs:
            valid = st[a.name + "$n"] > 0
            if a.kind in ("count", "count_star"):
                valid = torch.ones(g, dtype=torch.bool, device=dev)
            data = torch.where(valid, st[a.name], torch.zeros_like(st[a.name]))
            cols[a.name] = Column(data.to(a.dtype.torch_dtype), valid, a.dtype)
        return [Batch(cols, live)]
