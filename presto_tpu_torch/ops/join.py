"""Join kernels in plain PyTorch: sorted build + search probe, dense table.

Counterpart of ``presto_tpu/ops/join.py``: the lookup source is a sorted
int64 key array plus a row-index permutation, probed with
``torch.searchsorted``; where connector stats bound the key domain, a
dense direct-address row table makes the probe one gather. The
semi/anti-join membership probes (``probe_exists``,
``probe_exists_dense``) ask the same two sides whether a key exists,
duplicates allowed, and the expansion probe (``probe_expand``) emits one
output row per matching (probe, build) pair for duplicate build keys,
into a static output capacity with an overflow flag. Dead build slots
carry the int64 maximum as a sentinel, so a LIVE key equal to it is
flagged (``sentinel_hit``) and the join build refuses it. Where the
planner proves a non-negative key under 2^(62 - pack_bits), the build
sorts ``(key << pack_bits) | row`` as one int64 (``pack_bits``) and the
unique probe reads key and row with one gather; a live key outside that
range sets ``sentinel_hit`` instead of mispacking.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from presto_tpu_torch.ops.groupby import gather_padded, stable_argsort

I64_MAX = torch.iinfo(torch.int64).max


class BuildSide(NamedTuple):
    """A sorted, compacted build side (the lookup source)."""

    sorted_keys: torch.Tensor  # [build_cap] int64, dead slots = I64_MAX
    row_idx: torch.Tensor  # [build_cap] original row index (cap = dead)
    #: 0-d bool: a LIVE key equals I64_MAX, or (packed) lies outside
    #: [0, 2^(62 - pack_bits))
    sentinel_hit: torch.Tensor
    #: [build_cap] int64 (key << pack_bits) | row, key-sorted, dead =
    #: I64_MAX; present only on a packed build
    packed: torch.Tensor | None = None


def build_lookup(keys: torch.Tensor, live: torch.Tensor, build_capacity: int,
                 pack_bits: int | None = None) -> BuildSide:
    """Compact live rows and sort them by key (stable) into
    ``build_capacity`` >= len(keys) slots. ``pack_bits``: the caller
    proves 0 <= key < 2^(62 - pack_bits) and capacity <= 2^pack_bits,
    so rows sort as ONE packed int64 (ties by row, as the stable sort);
    a live key outside the range sets ``sentinel_hit``."""
    cap = keys.shape[0]
    k0 = keys.to(torch.int64)
    if pack_bits is not None:
        bad = (k0 < 0) | (k0 >= (1 << (62 - pack_bits)))
        sentinel_hit = (live & bad).any()
        rows = torch.arange(cap, dtype=torch.int64, device=keys.device)
        packed = torch.where(live & ~bad, (k0 << pack_bits) | rows,
                             torch.full_like(k0, I64_MAX))
        sp = gather_padded(torch.sort(packed).values,
                           torch.arange(build_capacity, device=keys.device), I64_MAX)
        dead = sp == I64_MAX
        sorted_keys = torch.where(dead, sp, sp >> pack_bits)
        row_idx = torch.where(dead, torch.full_like(sp, cap), sp & ((1 << pack_bits) - 1))
        return BuildSide(sorted_keys, row_idx, sentinel_hit, sp)
    sentinel_hit = (live & (k0 == I64_MAX)).any()
    k = torch.where(live, k0, torch.full_like(k0, I64_MAX))
    order = stable_argsort(k)
    take = torch.arange(build_capacity, device=keys.device)
    sorted_keys = gather_padded(k[order], take, I64_MAX)
    row_idx = gather_padded(order, take, cap)
    row_idx = torch.where(sorted_keys == I64_MAX, torch.full_like(row_idx, cap), row_idx)
    return BuildSide(sorted_keys, row_idx, sentinel_hit)


class UniqueProbe(NamedTuple):
    build_row: torch.Tensor  # [probe_cap] build-side original row (cap = miss)
    matched: torch.Tensor  # [probe_cap] bool


def probe_unique(build: BuildSide, probe_keys: torch.Tensor,
                 probe_live: torch.Tensor, pack_bits: int | None = None) -> UniqueProbe:
    """FK->PK probe: each probe row matches at most one build row; the
    output is aligned with the probe batch (no expansion). With a packed
    build (``pack_bits``) key check and row fetch ride one gather."""
    pk = probe_keys.to(torch.int64)
    if pack_bits is not None and build.packed is not None:
        in_range = (pk >= 0) & (pk < (1 << (62 - pack_bits)))
        # an out-of-range key cannot match: shift a harmless 0 instead
        target = torch.where(in_range, pk, torch.zeros_like(pk)) << pack_bits
        hit = gather_padded(build.packed, torch.searchsorted(build.packed, target), I64_MAX)
        matched = (((hit >> pack_bits) == pk) & probe_live & (hit != I64_MAX) & in_range)
        row = hit & ((1 << pack_bits) - 1)
        miss = build.row_idx.shape[0]
        return UniqueProbe(torch.where(matched, row, torch.full_like(row, miss)), matched)
    pos = torch.searchsorted(build.sorted_keys, pk)
    hit = gather_padded(build.sorted_keys, pos, I64_MAX)
    matched = (hit == pk) & probe_live & (pk != I64_MAX)
    miss = build.row_idx.shape[0]
    row = gather_padded(build.row_idx, pos, 0)
    return UniqueProbe(torch.where(matched, row, torch.full_like(row, miss)), matched)


class ExpandedProbe(NamedTuple):
    probe_row: torch.Tensor  # [out_cap] probe-side row (probe_cap = none)
    build_row: torch.Tensor  # [out_cap] build-side original row (cap = miss)
    live: torch.Tensor  # [out_cap] bool
    n_out: torch.Tensor  # 0-d int64: the output rows needed
    overflow: torch.Tensor  # 0-d bool: n_out > out_capacity


def probe_expand(build: BuildSide, probe_keys: torch.Tensor, probe_live: torch.Tensor,
                 out_capacity: int, left: bool = False,
                 emit_live: torch.Tensor | None = None) -> ExpandedProbe:
    """The join probe for duplicate build keys: one output row per
    (probe row, matching build row) pair, laid out by an exclusive prefix
    sum of each probe row's match count into ``out_capacity`` slots; the
    probe row owning a slot is found by a search over the offsets. With
    ``left=True`` a probe row without a match emits one row whose
    ``build_row`` is the miss sentinel (build columns gather as NULL).

    ``emit_live`` (left only): the rows that emit a null-extended row when
    nothing matches, by default ``probe_live``; a live probe row whose key
    is NULL is left out of ``probe_live`` (NULL matches nothing) but still
    appears in a LEFT join's result."""
    probe_cap = probe_keys.shape[0]
    pk = torch.where(probe_live, probe_keys.to(torch.int64), torch.full_like(
        probe_keys, I64_MAX, dtype=torch.int64))
    lo = torch.searchsorted(build.sorted_keys, pk)
    hi = torch.searchsorted(build.sorted_keys, pk, right=True)
    matches = torch.where(probe_live & (pk != I64_MAX), hi - lo, torch.zeros_like(lo))
    el = probe_live if emit_live is None else emit_live
    counts = (torch.where(el & (matches == 0), torch.ones_like(matches), matches)
              if left else matches)
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix
    total = counts.sum()
    j = torch.arange(out_capacity, device=probe_keys.device)
    # the probe row owning output slot j: the last i with offsets[i] <= j
    probe_row = torch.clamp(torch.searchsorted(offsets, j, right=True) - 1, 0, probe_cap - 1)
    rank = j - offsets[probe_row]
    valid = (j < total) & (rank >= 0) & (rank < counts[probe_row])
    is_match = valid & (rank < matches[probe_row])
    miss = build.row_idx.shape[0]
    build_row = torch.where(is_match, gather_padded(build.row_idx, lo[probe_row] + rank, 0),
                            torch.full_like(j, miss))
    probe_row = torch.where(valid, probe_row, torch.full_like(probe_row, probe_cap))
    return ExpandedProbe(probe_row, build_row, valid, total, total > out_capacity)


class DenseSide(NamedTuple):
    """Dense direct-address lookup table over a bounded key domain."""

    table: torch.Tensor  # [domain] int32: build row, sentinel = miss
    key_min: int
    sentinel: int  # the build batch capacity
    overflow: torch.Tensor  # 0-d bool: a live key fell outside the domain


def build_dense(keys: torch.Tensor, live: torch.Tensor, key_min: int, domain: int) -> DenseSide:
    """One scatter builds the table; duplicate keys keep one row
    (callers use the row payload only when build keys are unique —
    existence tests are right regardless)."""
    cap = keys.shape[0]
    slot = keys.to(torch.int64) - key_min
    in_range = (slot >= 0) & (slot < domain)
    ok = live & in_range
    table = torch.full((domain + 1,), cap, dtype=torch.int32, device=keys.device)
    table.scatter_(0, torch.where(ok, slot, torch.full_like(slot, domain)),
                   torch.arange(cap, dtype=torch.int32, device=keys.device))
    return DenseSide(table[:domain], int(key_min), cap, (live & ~in_range).any())


def probe_unique_dense(dense: DenseSide, probe_keys: torch.Tensor,
                       probe_live: torch.Tensor) -> UniqueProbe:
    """FK->PK probe against a dense table: one gather, no sort."""
    domain = dense.table.shape[0]
    slot = probe_keys.to(torch.int64) - dense.key_min
    inr = (slot >= 0) & (slot < domain) & probe_live
    row = dense.table[torch.clamp(slot, 0, domain - 1)]
    row = torch.where(inr, row, torch.full_like(row, dense.sentinel))
    return UniqueProbe(row, row != dense.sentinel)


def probe_exists_dense(dense: DenseSide, probe_keys: torch.Tensor,
                       probe_live: torch.Tensor) -> torch.Tensor:
    """Semi-join membership via the dense table (duplicate-safe: the
    table keeps one row per key, and existence needs no more)."""
    return probe_unique_dense(dense, probe_keys, probe_live).matched


def probe_exists(build: BuildSide, probe_keys: torch.Tensor,
                 probe_live: torch.Tensor) -> torch.Tensor:
    """Semi-join membership: True where the probe key exists in the
    sorted build keys."""
    pk = probe_keys.to(torch.int64)
    pos = torch.searchsorted(build.sorted_keys, pk)
    hit = gather_padded(build.sorted_keys, pos, I64_MAX)
    return (hit == pk) & probe_live & (pk != I64_MAX)
