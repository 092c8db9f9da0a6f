"""Grouped (bucketed) execution with host-RAM offload: the spill tier's
store.

Counterpart of ``presto_tpu/exec/grouped.py`` (Grace hash join:
partition both sides, process one partition at a time):

- the "disk" is host RAM: device batches go to numpy once per input
  batch, one device-side hash of the key gives every row its bucket
  (``ops/hashing.partition_ids``), and one stable sort of the live rows
  by bucket on the host partitions them;
- each bucket then runs the normal device join or aggregation.

A :class:`HostSpill` keeps, per bucket, chunks of the live rows: each
column's data and validity (a column without a mask stores all-true), so
a bucket comes back as a ``Batch`` whose live rows are exactly the
spilled ones. Its bytes are reserved against a ``runtime/memory.
HostSpillBudget`` before they are kept.
"""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.expr import Expr, evaluate
from presto_tpu_torch.spi import batch_capacity


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class HostSpill:
    """Per-bucket host-side row store for one relation.

    With a ``budget`` (a ``runtime/memory.HostSpillBudget``), every
    appended chunk's bytes are reserved under ``tag`` before they are
    kept and released by :meth:`release` (or per bucket by
    :meth:`release_bucket`). Buckets come back as batches on
    ``device`` (None: the device of the first appended batch)."""

    def __init__(self, nbuckets: int, budget=None, tag: str = "spill", device=None):
        self.nbuckets = nbuckets
        #: bucket -> list of {col -> (data, valid)} row chunks
        self.chunks: list[list[dict]] = [[] for _ in range(nbuckets)]
        self.meta: dict[str, tuple] = {}  # col -> (dtype, dictionary)
        self.budget = budget
        self.tag = tag
        self.device = None if device is None else resolve_device(device)
        self._bytes = 0

    @staticmethod
    def _chunk_bytes(rows: dict) -> int:
        return sum(d.nbytes + v.nbytes for d, v in rows.values())

    def append(self, batch: Batch, bucket_ids: np.ndarray) -> None:
        if self.device is None:
            self.device = batch.device
        live = _host(batch.live)
        host = {}
        for name, col in batch.columns.items():
            self.meta[name] = (col.dtype, col.dictionary)
            valid = (np.ones(live.shape[0], dtype=np.bool_) if col.valid is None
                     else _host(col.valid))
            host[name] = (_host(col.data), valid)
        # one stable sort of the live rows by bucket (a row whose id is
        # outside [0, nbuckets) belongs to no bucket): each bucket's rows
        # in batch order, as a boolean select per bucket would give them,
        # in one pass instead of one a bucket
        ids = np.asarray(bucket_ids)
        keep = np.flatnonzero(live & (ids >= 0) & (ids < self.nbuckets))
        order = keep[np.argsort(ids[keep], kind="stable")]
        ends = np.cumsum(np.bincount(ids[keep], minlength=self.nbuckets))
        for b in range(self.nbuckets):
            sel = order[(ends[b - 1] if b else 0):ends[b]]
            if not sel.size:
                continue
            rows = {name: (data[sel], valid[sel]) for name, (data, valid) in host.items()}
            nbytes = self._chunk_bytes(rows)
            if self.budget is not None:
                self.budget.reserve(self.tag, nbytes)
            self._bytes += nbytes
            self.chunks[b].append(rows)

    def total_bytes(self) -> int:
        """Host bytes currently kept (== reserved under ``tag``)."""
        return self._bytes

    def release_bucket(self, b: int) -> int:
        """Drop bucket ``b``'s chunks, returning its reservation."""
        freed = sum(self._chunk_bytes(c) for c in self.chunks[b])
        self.chunks[b] = []
        if freed and self.budget is not None:
            self.budget.release(self.tag, freed)
        self._bytes -= freed
        return freed

    def release(self) -> int:
        """Drop every chunk and return the whole reservation."""
        return sum(self.release_bucket(b) for b in range(self.nbuckets))

    def bucket_rows(self, b: int) -> int:
        return sum(len(next(iter(c.values()))[0]) for c in self.chunks[b])

    def max_chunk_rows(self) -> int:
        return max((len(next(iter(c.values()))[0]) for chunks in self.chunks for c in chunks),
                   default=0)

    def _to_batch(self, chunk_list: list[dict], capacity: int | None) -> Batch:
        """Chunk list -> one device Batch padded to ``capacity``."""
        names = list(chunk_list[0])
        arrays = {name: np.concatenate([c[name][0] for c in chunk_list]) for name in names}
        valids = {name: np.concatenate([c[name][1] for c in chunk_list]) for name in names}
        n = len(next(iter(arrays.values())))
        cap = capacity or batch_capacity(max(n, 16), minimum=16)
        types = {name: self.meta[name][0] for name in names}
        dicts = {name: self.meta[name][1] for name in names if self.meta[name][1] is not None}
        return Batch.from_numpy(arrays, types, count=n, valids=valids, dictionaries=dicts,
                                capacity=cap, device=self.device)

    def bucket_batch(self, b: int, capacity: int | None = None) -> Batch | None:
        """Bucket ``b`` as one device Batch (None when empty)."""
        if not self.chunks[b]:
            return None
        return self._to_batch(self.chunks[b], capacity)


def bucket_ids_for(batch: Batch, key: Expr, nbuckets: int) -> np.ndarray:
    """Device-side hash of the join key -> host bucket ids [capacity]."""
    from presto_tpu_torch.ops.hashing import partition_ids

    v = evaluate(key, batch)
    return _host(partition_ids([v.data], nbuckets))


def spill_stream(stream, key: Expr, nbuckets: int, spill: HostSpill | None = None) -> HostSpill:
    """Drain a batch stream into a per-bucket host spill (optionally a
    pre-made, budget-accounted store)."""
    if spill is None:
        spill = HostSpill(nbuckets)
    for batch in stream:
        spill.append(batch, bucket_ids_for(batch, key, nbuckets))
    return spill


def bucket_batches(spill: HostSpill, b: int, chunk_rows: int, capacity: int | None = None):
    """Yield bucket ``b`` as device batches of at most ``chunk_rows`` rows
    each (a single larger chunk passes whole), padded to one shared
    ``capacity``."""
    chunks = spill.chunks[b]
    if not chunks:
        return
    pending: list[dict] = []
    pending_rows = 0
    for c in chunks:
        rows = len(next(iter(c.values()))[0])
        if pending_rows and pending_rows + rows > chunk_rows:
            yield spill._to_batch(pending, capacity)
            pending, pending_rows = [], 0
        pending.append(c)
        pending_rows += rows
    if pending:
        yield spill._to_batch(pending, capacity)
