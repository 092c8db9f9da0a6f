"""Grouping: row -> group-id assignment + segment aggregation.

Counterpart of ``presto_tpu/ops/groupby.py``: ``group_ids_direct`` and
``group_ids_sort`` assign group ids, ``fused_small_sums`` and
``segment_agg`` fold values per group. Dead rows go to one extra
"trash" group (``max_groups``), and integer sums are int64-exact.

``fused_small_sums`` takes the lane-sums kernel (``ops/cuda_groupby``)
exactly where the JAX package takes its Pallas route — integer values
whose declared bounds are at most 31 bits — and otherwise the exact
generic route, written as int64 ``index_add_``.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.ops import cuda_groupby
from presto_tpu_torch.runtime.errors import InternalError

_INT_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32, torch.int64: 64}


class ValueBitsOverflow(Exception):
    """A declared AggSpec.value_bits bound was violated at runtime."""


def _value_width(dtype: torch.dtype) -> int:
    """Magnitude bits of an integer dtype (bits - 1)."""
    if dtype not in _INT_BITS:
        raise InternalError(f"integer values expected, got {dtype}")
    return _INT_BITS[dtype] - 1


# ---------------------------------------------------------------------------
# group-id assignment
# ---------------------------------------------------------------------------


def group_ids_direct(key_cols, mins, strides, live, num_groups: int):
    """Direct-addressed gids: gid = sum_i (k_i - min_i) * stride_i.

    The packed gid is CLIPPED into [0, num_groups) (an out-of-domain key
    lands in an edge group rather than vanishing). Dead rows get gid ==
    num_groups (the trash group). Returns (gids int32, present bool[G])
    where present[g] marks groups with at least one live row.
    """
    gid = None
    for k, m, s in zip(key_cols, mins, strides):
        t = (k.to(torch.int32) - int(m)) * int(s)
        gid = t if gid is None else gid + t
    gid = torch.clamp(gid, 0, num_groups - 1)
    gid = torch.where(live, gid, torch.full_like(gid, num_groups))
    present = torch.zeros(num_groups + 1, dtype=torch.bool, device=gid.device)
    present[gid.to(torch.int64)] = True
    return gid.to(torch.int32), present[:num_groups]


def gather_padded(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr[idx]`` along dim 0, with an out-of-range idx (>= len)
    giving ``fill``; 2-D (BYTES) rows fill whole."""
    cap = arr.shape[0]
    picked = arr[torch.clamp(idx, max=cap - 1).to(torch.int64)]
    ok = idx < cap
    if picked.dim() > 1:
        ok = ok[:, None]
    return torch.where(ok, picked, torch.full_like(picked, fill))


def stable_argsort(k: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (bool keys sort as uint8: False first)."""
    if k.dtype == torch.bool:
        k = k.to(torch.uint8)
    return torch.argsort(k, stable=True)


def group_ids_sort(key_cols, live, max_groups: int):
    """Sort-based gids for arbitrary 1-D keys (the JAX package's
    algorithm, so groups come out in the same order).

    Returns (gids[cap], rep_idx[max_groups], ngroups, overflow):
    - gids: per-row group id in [0, max_groups) for live rows,
      ``max_groups`` (trash) for dead rows;
    - rep_idx: original row index of each group's first member in sort
      order (sentinel ``cap`` for unused slots);
    - overflow: True when distinct live keys exceeded max_groups.
    """
    cap = live.shape[0]
    dev = live.device
    order = torch.arange(cap, device=dev)
    for k in reversed(list(key_cols)):
        order = order[stable_argsort(k[order])]
    # liveness is the most significant key: live rows first
    order = order[stable_argsort(~live[order])]
    sl = live[order]
    boundary = ~sl[:-1]
    for k in key_cols:
        ks = k[order]
        boundary = boundary | (ks[1:] != ks[:-1])
    newgrp = torch.cat([sl[:1], boundary & sl[1:]])
    ngroups = newgrp.sum()
    gid_sorted = torch.cumsum(newgrp.to(torch.int32), 0, dtype=torch.int32) - 1
    gid_sorted = torch.where(sl, torch.clamp(gid_sorted, max=max_groups),
                             torch.full_like(gid_sorted, max_groups))
    gids = torch.empty(cap, dtype=torch.int32, device=dev)
    gids[order] = gid_sorted
    # each group's first sorted position -> its original row; positions
    # that start no group scatter into the trash slot
    slot = torch.where(newgrp, gid_sorted, torch.full_like(gid_sorted, max_groups))
    rep = torch.full((max_groups + 1,), cap, dtype=torch.int64, device=dev)
    rep.scatter_(0, slot.to(torch.int64), order)
    return gids, rep[:max_groups], ngroups, ngroups > max_groups


# ---------------------------------------------------------------------------
# segment aggregation
# ---------------------------------------------------------------------------


def _identity(kind: str, dtype: torch.dtype):
    if kind == "min":
        return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max
    if kind == "max":
        return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    return 0


def segment_agg(values, contrib, gids, max_groups: int, kind: str):
    """Aggregate ``values`` per group.

    contrib: bool mask of rows that contribute (live AND value-valid).
    kind: 'sum' | 'count' | 'min' | 'max'. Integer sums come back int64
    (exact); groups with no contributing rows yield the kind's identity.
    """
    dev = contrib.device
    g = torch.where(contrib, gids.to(torch.int64),
                    torch.full_like(gids, max_groups, dtype=torch.int64))
    if kind == "count":
        acc = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        return acc.index_add_(0, g, contrib.to(torch.int64))[:max_groups]
    if kind == "sum":
        if values.dtype.is_floating_point:
            v = torch.where(contrib, values, torch.zeros_like(values))
            acc = torch.zeros(max_groups + 1, dtype=values.dtype, device=dev)
        else:
            v = torch.where(contrib, values, torch.zeros_like(values)).to(torch.int64)
            acc = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        return acc.index_add_(0, g, v)[:max_groups]
    if kind in ("min", "max"):
        ident = _identity(kind, values.dtype)
        acc = torch.full((max_groups + 1,), ident, dtype=values.dtype, device=dev)
        reduce = "amin" if kind == "min" else "amax"
        return acc.scatter_reduce_(0, g, values, reduce)[:max_groups]
    raise InternalError(f"unknown aggregate kind {kind!r}")


def fused_small_sums(values, bits_list, contribs, gids, max_groups: int,
                     extra_count_masks=(), kernel: bool = True):
    """Exact integer segment sums for many aggregates in ONE data pass.

    values/bits_list/contribs: per-aggregate integer value tensors,
    static |value| bit bounds, and contribution masks. gids: per-row
    group id (``max_groups`` = trash). extra_count_masks: additional bool
    masks to count per group (e.g. ``live`` for group presence).
    ``kernel=False`` keeps to the generic route (plain PyTorch, exact
    int64) where the lane-sums kernel would otherwise take the call.

    Returns (sums, counts, extra_counts, value_overflow): int64 [G] sums
    per value, int64 [G] counts per contrib and per extra mask, and a
    bool scalar that is True when a contributing |value| exceeded its
    declared bits bound.
    """
    # identical mask objects (e.g. one ``live`` reused for every
    # aggregate) get ONE count column — slots map back through uniq
    all_masks = list(contribs) + list(extra_count_masks)
    uniq: dict[int, int] = {}
    slot = []
    mask_cols = []
    for m in all_masks:
        if id(m) not in uniq:
            uniq[id(m)] = len(mask_cols)
            mask_cols.append(m)
        slot.append(uniq[id(m)])

    if kernel and kernel_route(values, bits_list, len(mask_cols), max_groups):
        zeroed, eff_bits, oflow = lane_sum_inputs(values, bits_list, contribs,
                                                  gids.device)
        sums, counts_all, k_oflow = cuda_groupby.fused_lane_sums(
            zeroed, eff_bits, mask_cols, gids.to(torch.int32), max_groups)
        oflow = oflow | k_oflow
    else:
        sums, counts_all, oflow = _generic_sums(
            values, bits_list, contribs, mask_cols, gids, max_groups)
    counts = [counts_all[slot[i]] for i in range(len(contribs))]
    extra = [counts_all[slot[len(contribs) + i]]
             for i in range(len(extra_count_masks))]
    return sums, counts, extra, oflow


def kernel_route(values, bits_list, nmasks: int, max_groups: int) -> bool:
    """Where the JAX package takes its Pallas route: integer values whose
    declared bounds are at most 31 bits (within the kernel's limits)."""
    return (all(not v.dtype.is_floating_point and v.dtype != torch.bool
                for v in values)
            and all(b <= 31 for b in bits_list)
            and cuda_groupby.supported(len(values), nmasks, max_groups))


def lane_sum_inputs(values, bits_list, contribs, device):
    """The lane-sums kernel's value arguments: each value zeroed where it
    does not contribute and cast to int32; the effective bounds; and the
    bound check on the ORIGINAL dtype, made before the cast (a wide value
    would wrap and dodge the in-kernel check)."""
    eff_bits = [min(b, _value_width(v.dtype)) for v, b in zip(values, bits_list)]
    oflow = torch.zeros((), dtype=torch.bool, device=device)
    zeroed = []
    for v, c, eb in zip(values, contribs, eff_bits):
        z = torch.where(c, v, torch.zeros_like(v))
        if eb < _value_width(v.dtype):
            oflow = oflow | torch.any((torch.abs(z) >> eb) != 0)
        zeroed.append(z.to(torch.int32))
    return zeroed, eff_bits, oflow


def _generic_sums(values, bits_list, contribs, mask_cols, gids, max_groups: int):
    """The exact generic route: int64 ``index_add_`` per value and mask,
    with the declared-bound check of the JAX package's einsum route."""
    dev = gids.device
    in_domain = (gids >= 0) & (gids < max_groups)
    g = torch.where(in_domain, gids, torch.full_like(gids, max_groups)).to(torch.int64)
    oflow = torch.zeros((), dtype=torch.bool, device=dev)
    sums = []
    for v, bits, c in zip(values, bits_list, contribs):
        if v.dtype.is_floating_point:
            raise InternalError("fused_small_sums: integer values expected")
        vv = torch.where(c, v, torch.zeros_like(v)).to(torch.int64)
        if bits < _value_width(v.dtype):
            oflow = oflow | torch.any((torch.abs(vv) >> bits) != 0)
        acc = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        sums.append(acc.index_add_(0, g, vv)[:max_groups])
    counts = []
    for m in mask_cols:
        acc = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        counts.append(acc.index_add_(0, g, m.to(torch.int64))[:max_groups])
    return sums, counts, oflow
