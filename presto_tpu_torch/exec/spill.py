"""The planned hybrid-spill tier: out-of-core joins and aggregations as a
plan choice.

Counterpart of ``presto_tpu/exec/spill.py``: keep the K hottest build
partitions device-resident, stream the cold ones from host RAM, and size
the partition count from the byte budget instead of discovering it by
running out of device memory. The budget (``runtime/memory.
node_row_bytes`` widths x stats rows) picks ``resident | hybrid |
grouped`` at plan time, so a 4x-over-budget build runs with zero OOM
ladder rungs. Three pieces, shared by the joins, semi joins and keyed
aggregations of ``exec/local_planner.py``:

- :func:`plan_spill`: the decision. ``hybrid`` keeps K resident buckets
  and streams the rest; the resident share of the budget shrinks with
  the OOM-ladder rung, so rung 1 is a re-bucket into a smaller resident
  set, not a jump to fully grouped.
- :func:`transfer_iter`: a two-slot pipeline: units k+1 and k+2 are
  assembled and copied to the device on worker threads (pageable
  ``Tensor.to`` on the device's current stream, so every copy is ordered
  before the compute that reads it) while the device works on unit k.
- :func:`expand_units`: bounded recursive re-partitioning of cold
  buckets that still exceed the unit budget (skew): bucket ``b`` under
  modulus ``N`` splits exactly into residues ``{b, b+N}`` under ``2N``,
  each split is counted (``spill.partition_overflow``) and passes the
  ``step.spill_partition`` fault site, and the depth stops at
  :data:`MAX_SPILL_RECURSION` with the typed ``SpillPartitionOverflow``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

#: recursion bound on cold-partition re-splitting: 4 doublings = 16x
#: the planned per-bucket size absorbed before the typed refusal
MAX_SPILL_RECURSION = 4

#: above this est/budget ratio hybrid keeps nothing resident — the
#: resident set would be a rounding error of the relation
HYBRID_MAX_RATIO = 64

#: partition-count ceiling (matches the ladder's grouped cap)
MAX_BUCKETS = 1 << 12


@dataclasses.dataclass(frozen=True)
class SpillDecision:
    """The plan-time out-of-core choice for one join build / agg state.

    ``resident`` lists the bucket ids kept device-resident (hot-first);
    ``resident_budget`` is the byte share reserved for them — both
    advisory until :func:`fit_resident` clamps against ACTUAL bucket
    sizes after partitioning."""

    mode: str  # "resident" | "hybrid" | "grouped"
    nbuckets: int = 1
    resident: tuple = ()
    est_bytes: int = 0
    budget: int = 0
    resident_budget: int = 0

    def explain(self) -> str:
        """The EXPLAIN detail: ``hybrid(2/8 resident)``."""
        if self.mode == "hybrid":
            return f"hybrid({len(self.resident)}/{self.nbuckets} resident)"
        if self.mode == "grouped":
            return f"grouped({self.nbuckets} buckets)"
        return "resident"


def _resident_ids(nbuckets: int, k: int, hot) -> tuple:
    """First-K bucket ids with the skew-history hot partition (when a
    recurring fingerprint recorded one) promoted to the front."""
    order = list(range(nbuckets))
    if hot is not None:
        h = int(hot) % nbuckets
        order.remove(h)
        order.insert(0, h)
    return tuple(order[:k])


def plan_spill(est_bytes: int, budget: int, hot_partition=None,
               oom_rung: int = 0) -> SpillDecision:
    """resident | hybrid | grouped for an estimated build/state size.

    Buckets are sized to ~half the budget each (so a streamed bucket
    plus the in-flight transfer slots fit beside the resident set) and
    double per ladder rung; the resident share is half the budget at
    rung 0 and HALVES per rung — rung 1 re-plans into hybrid with a
    shrunk resident set instead of jumping to fully-grouped. A rung>0
    re-plan with an under-budget estimate means the stats lied: the
    build is treated as at least 2x budget so the re-bucket is real.
    """
    budget = max(int(budget), 1)
    est = max(int(est_bytes), 0)
    if est <= budget and oom_rung == 0:
        return SpillDecision("resident", 1, (), est, budget, budget)
    est = max(est, 2 * budget)
    ratio = -(-est // budget)
    nbuckets = min(max(2, 2 * ratio) << oom_rung, MAX_BUCKETS)
    per_bucket = max(est // nbuckets, 1)
    resident_budget = budget >> (1 + oom_rung)
    k = min(resident_budget // per_bucket, nbuckets - 1)
    if oom_rung >= 3 or ratio > HYBRID_MAX_RATIO or k < 1:
        return SpillDecision("grouped", nbuckets, (), est, budget, 0)
    return SpillDecision(
        "hybrid", nbuckets, _resident_ids(nbuckets, k, hot_partition),
        est, budget, resident_budget,
    )


def fit_resident(decision: SpillDecision, bucket_rows: Callable[[int], int],
                 row_bytes: int) -> tuple[tuple, int]:
    """Clamp the planned resident set against ACTUAL partition sizes:
    residents stay resident only while their cumulative bytes fit the
    resident share of the budget (hot-first order preserved); oversized
    ones demote to the streamed tier instead of blowing the device.
    Returns ``(resident_ids, resident_bytes)``."""
    out: list[int] = []
    acc = 0
    cap = max(decision.resident_budget, 1)
    for b in decision.resident:
        nb = bucket_rows(b) * row_bytes
        if acc + nb > cap and acc > 0:
            continue
        if nb > cap:
            continue
        acc += nb
        out.append(b)
    return tuple(out), acc


# ---------------------------------------------------------------------------
# Two-slot double-buffered transfer pipeline
# ---------------------------------------------------------------------------


def transfer_iter(load, items: Sequence, label: str = "spill:transfer"):
    """Yield ``(item, load(item))`` with TWO transfers in flight.

    The transfer generalization of ``pipeline.prefetch_iter``: two worker
    slots keep a transfer running while the driver holds one loaded unit
    and the device computes, so unit k+2's host->device copy overlaps the
    compute of unit k. Each worker call is timed and re-recorded on the
    driver's trace recorder as a complete span (a worker has none), so
    exported traces show the overlap. A worker runs in a copy of the
    driver's context (the plan template's parameters) with the trace
    recorder and the metric delta cleared, as the prefetch worker does.

    The ``step.spill_transfer`` fault site fires on the driver thread
    before each submit, and each submit slot is a deadline / cancel
    checkpoint: a cancelled spilling query stops transferring within one
    unit, and its host-spill reservation releases through the ordinary
    unwind.
    """
    import contextvars

    from presto_tpu_torch.exec.pipeline import _detached, prefetch_enabled
    from presto_tpu_torch.runtime import trace
    from presto_tpu_torch.runtime.faults import fault_point
    from presto_tpu_torch.runtime.lifecycle import check_deadline

    items = list(items)
    if len(items) <= 1 or not prefetch_enabled():
        for it in items:
            check_deadline("spill-transfer")
            fault_point("step.spill_transfer")
            t0 = time.perf_counter()
            out = load(it)
            trace.add_complete(label, "step", t0, time.perf_counter() - t0, {"slot": "serial"})
            yield it, out
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def timed(it):
        t0 = time.perf_counter()
        out = load(it)
        return t0, time.perf_counter() - t0, out

    def submit(ex, it):
        return ex.submit(contextvars.copy_context().run, _detached, timed, it)

    with ThreadPoolExecutor(max_workers=2) as ex:
        pending: deque = deque()
        idx = 0
        while idx < len(items) and len(pending) < 2:
            check_deadline("spill-transfer")
            fault_point("step.spill_transfer")
            pending.append((items[idx], submit(ex, items[idx])))
            idx += 1
        while pending:
            it, fut = pending.popleft()
            t0, dur, out = fut.result()
            trace.add_complete(label, "step", t0, dur, {"slot": "worker"})
            if idx < len(items):
                check_deadline("spill-transfer")
                fault_point("step.spill_transfer")
                pending.append((items[idx], submit(ex, items[idx])))
                idx += 1
            yield it, out


# ---------------------------------------------------------------------------
# Bounded recursive re-partitioning (cold-partition overflow)
# ---------------------------------------------------------------------------


def _host(ids) -> np.ndarray:
    """Bucket ids as a host array (a tensor is copied back)."""
    if hasattr(ids, "cpu"):
        return ids.cpu().numpy()
    return np.asarray(ids)


@dataclasses.dataclass
class SpillUnit:
    """One streamed unit of work: bucket ``bucket`` of the build (and
    optionally probe) spill, restricted to hash residue ``residue``
    under ``modulus`` (depth 0: the whole planned bucket)."""

    build: "HostSpill"  # noqa: F821 — exec/grouped.HostSpill
    probe: "Optional[HostSpill]"  # noqa: F821
    bucket: int
    modulus: int
    residue: int
    depth: int = 0


def _split_side(spill, bucket: int, ids_for, residue: int, modulus: int,
                make_spill):
    """Re-hash one side's bucket under the doubled modulus into two
    child stores (residues ``residue`` and ``residue + modulus``).
    ``hash % N == b`` implies ``hash % 2N in {b, b+N}``, so the split
    is exact and loses no rows."""
    lo, hi = make_spill(), make_spill()
    for chunk in spill.chunks[bucket]:
        batch = spill._to_batch([chunk], None)
        ids = _host(ids_for(batch, 2 * modulus))
        lo.append(batch, np.where(ids == residue, 0, -1))
        hi.append(batch, np.where(ids == residue + modulus, 0, -1))
    return lo, hi


def split_unit(unit: SpillUnit, build_ids, probe_ids, make_spill):
    """Split one oversized unit into its two children (both sides split
    under the SAME doubled modulus, so probe rows stay with exactly the
    build rows they could match — outer/anti null-extension decisions
    remain per-unit-correct)."""
    blo, bhi = _split_side(unit.build, unit.bucket, build_ids,
                           unit.residue, unit.modulus, make_spill)
    plo = phi = None
    if unit.probe is not None:
        plo, phi = _split_side(unit.probe, unit.bucket, probe_ids,
                               unit.residue, unit.modulus, make_spill)
    m2 = unit.modulus * 2
    return (
        SpillUnit(blo, plo, 0, m2, unit.residue, unit.depth + 1),
        SpillUnit(bhi, phi, 0, m2, unit.residue + unit.modulus,
                  unit.depth + 1),
    )


def expand_units(build_spill, probe_spill, buckets: Sequence[int],
                 unit_budget: int, row_bytes: int, build_ids,
                 probe_ids=None, make_spill=None) -> list[SpillUnit]:
    """The streamed work list for the cold buckets, recursively
    splitting any whose build rows exceed ``unit_budget`` bytes.

    ``build_ids(batch, modulus) -> ids`` recomputes bucket ids at a
    doubled modulus (the same hash the original partitioning used).
    Every split fires the ``step.spill_partition`` fault site and the
    ``spill.partition_overflow`` counter; depth > MAX_SPILL_RECURSION
    raises the typed ``SpillPartitionOverflow`` — loud, never a silent
    device blowup."""
    from presto_tpu_torch.runtime.errors import SpillPartitionOverflow
    from presto_tpu_torch.runtime.faults import fault_point
    from presto_tpu_torch.runtime.metrics import REGISTRY

    if make_spill is None:
        from presto_tpu_torch.exec.grouped import HostSpill

        device = build_spill.device
        make_spill = lambda: HostSpill(1, device=device)  # noqa: E731
    row_bytes = max(int(row_bytes), 1)
    out: list[SpillUnit] = []
    stack = [
        SpillUnit(build_spill, probe_spill, b, build_spill.nbuckets, b, 0)
        for b in reversed(list(buckets))
    ]
    while stack:
        u = stack.pop()
        rows = u.build.bucket_rows(u.bucket)
        if rows * row_bytes <= unit_budget or rows <= 16:
            out.append(u)
            continue
        if u.depth >= MAX_SPILL_RECURSION:
            raise SpillPartitionOverflow(
                f"spill partition (residue {u.residue} mod {u.modulus}) "
                f"still holds ~{rows * row_bytes} bytes over the "
                f"{unit_budget}-byte unit budget after "
                f"{MAX_SPILL_RECURSION} recursive splits — one key's "
                "duplicate run cannot be partitioned further"
            )
        fault_point("step.spill_partition")
        REGISTRY.counter("spill.partition_overflow").add()
        lo, hi = split_unit(u, build_ids, probe_ids, make_spill)
        u.build.release_bucket(u.bucket)
        if u.probe is not None:
            u.probe.release_bucket(u.bucket)
        stack.append(hi)
        stack.append(lo)
    return out
