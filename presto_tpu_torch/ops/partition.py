"""Partitioning: row -> destination packing for the exchange.

Counterpart of ``presto_tpu/ops/partition.py``: rows are scattered into a
dense ``[P, Q]`` send tensor (P destinations x Q quota rows) that feeds
the all-to-all (``parallel/exchange.py``). A partition past its quota
raises the overflow flag; the multi-round exchange drains the rest in
later rounds.
"""

from __future__ import annotations

import torch


def partition_layout(pids: torch.Tensor, live: torch.Tensor, num_partitions: int,
                     quota: int):
    """Each row's slot in the [P, quota] send buffer.

    Returns ``(slot, counts, overflow)``:
    - ``slot[cap]`` (int32): the flat destination slot ``p*quota + rank``,
      or ``P*quota`` (dropped) for dead and overflowing rows; a row's
      rank within its partition is stable by row order;
    - ``counts[P]`` (int32): rows destined to each partition, before
      overflow;
    - ``overflow``: some partition exceeded its quota."""
    cap = pids.shape[0]
    dev = pids.device
    p = torch.where(live, pids.to(torch.int64), num_partitions)
    order = torch.argsort(p, stable=True)
    ps = p[order]
    counts = torch.bincount(p, minlength=num_partitions + 1)[:num_partitions]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(cap, device=dev)
    start_of_row = torch.where(ps < num_partitions,
                               starts[torch.clamp(ps, max=num_partitions - 1)], 0)
    rank = torch.empty(cap, dtype=torch.int64, device=dev)
    rank[order] = pos - start_of_row
    ok = live & (rank < quota)
    slot = torch.where(ok, p * quota + rank, num_partitions * quota)
    overflow = torch.any(counts > quota)
    return slot.to(torch.int32), counts.to(torch.int32), overflow


def destination_counts(pids: torch.Tensor, mask: torch.Tensor, num_partitions: int):
    """Per-destination histogram (int64 [P]) of the masked rows: the
    exchange-skew telemetry's primitive, read back once per query. The
    extra slot absorbs masked-off rows (their pid may be garbage)."""
    dest = torch.where(mask, pids.to(torch.int64), num_partitions)
    return torch.bincount(dest, minlength=num_partitions + 1)[:num_partitions]


def scatter_to_buffer(values: torch.Tensor, slot: torch.Tensor, num_partitions: int,
                      quota: int, fill=0) -> torch.Tensor:
    """Scatter a column into the dense [P, quota] send tensor (the drop
    slot ``P*quota`` is cut off)."""
    tail = tuple(values.shape[1:])
    flat = torch.full((num_partitions * quota + 1,) + tail, fill, dtype=values.dtype,
                      device=values.device)
    flat[slot.to(torch.int64)] = values
    return flat[:-1].reshape((num_partitions, quota) + tail)
