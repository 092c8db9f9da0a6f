"""Distributed exchange: the data plane between shards.

Counterpart of ``presto_tpu/parallel/exchange.py``. The JAX package's
exchanges are collectives inside ``shard_map`` steps; here the single
controller drives them as plain functions over a row-sharded batch (one
tensor per column, shard-major: ``parallel/mesh.py``):

- hash-partitioned exchange -> an all-to-all of the ``[P, quota]`` send
  buffers: receiver ``j`` gets every sender's block ``j`` in sender
  order (``split_axis=0, concat_axis=0``); on one device that is one
  permutation of a ``[P, P, quota]`` tensor per column;
- broadcast -> an all-gather, the shards concatenated in shard order;
- the overflow flags and counts combine as int64 sums / ORs (psum).

Nothing here is a kernel: the JAX package writes partition, compaction
and the exchange in ``jnp`` outside any ``pallas_call``, and so they are
plain PyTorch here. The multi-round exchange's round loop is a device
``while_loop`` in the JAX package, whose condition reads a psum'd
pending flag; here the host reads that flag once a round
(:data:`flag_reads` counts the reads).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops.partition import destination_counts, partition_layout, scatter_to_buffer

#: host reads of the multi-round exchange's pending flag, process-wide
#: (one before the first round and one after each round)
flag_reads = 0


def _send_slots(pids, live, nsend: int, num_partitions: int, quota: int):
    """Every sender shard's send-buffer slots (``partition_layout`` per
    shard), as slots of the stacked ``[nsend * P * quota]`` buffer; a
    dropped row goes to its one drop slot. Returns (global slot, the
    sent mask, per-sender overflow flags)."""
    cap = pids.shape[0] // nsend
    width = num_partitions * quota
    slots, ovfs = [], []
    for i in range(nsend):
        s, _counts, ovf = partition_layout(pids[i * cap:(i + 1) * cap],
                                           live[i * cap:(i + 1) * cap], num_partitions, quota)
        s = s.to(torch.int64)
        slots.append(torch.where(s < width, s + i * width, nsend * width))
        ovfs.append(ovf)
    slot = torch.cat(slots)
    return slot, slot < nsend * width, torch.stack(ovfs)


def _a2a(values, slot, num_partitions: int, quota: int, fill=0):
    """Scatter ``values`` into every sender's [P, quota] buffer and run
    the all-to-all: ``[P_dest, P_send * quota, ...]``, sender-major."""
    P = num_partitions
    buf = scatter_to_buffer(values, slot, P * P, quota, fill)  # [send * dest, quota]
    tail = tuple(values.shape[1:])
    return buf.reshape((P, P, quota) + tail).transpose(0, 1).reshape((P, P * quota) + tail)


def _shared_valid(c: Column, live) -> bool:
    return c.valid is None or c.valid is live


def exchange_local(batch: Batch, pids, num_partitions: int, quota: int):
    """Single-round hash-partitioned shuffle of a row-sharded batch.

    ``pids``: each row's destination shard (``ops.hashing.partition_ids``
    over the repartitioning keys). Returns ``(received, overflow)``: the
    row-sharded batch of ``P * quota`` rows a shard holding every row its
    key owns, and whether some sender overflowed a quota (those rows are
    dropped)."""
    P = num_partitions
    slot, _sent, ovfs = _send_slots(pids, batch.live, P, P, quota)
    live = _a2a(batch.live, slot, P, quota, False).reshape(-1)
    cols = {}
    for name, c in batch.columns.items():
        data = _a2a(c.data, slot, P, quota)
        tail = tuple(c.data.shape[1:])
        valid = live if _shared_valid(c, batch.live) else \
            _a2a(c.valid, slot, P, quota, False).reshape(-1)
        cols[name] = Column(data.reshape((-1,) + tail), valid, c.dtype, c.dictionary)
    return Batch(cols, live), torch.any(ovfs)


def exchange_multiround(batch: Batch, pids, num_partitions: int, quota: int, recv_cap: int,
                        max_rounds: int | None = None, with_rounds: bool = False,
                        with_stats: bool = False):
    """Skew-aware shuffle: multi-round, fixed wire quota.

    Every round moves at most ``quota`` rows per (sender, destination)
    pair; undelivered rows wait for the next round. Each receiver appends
    the rows it got, in receive order, at its write offset into a
    ``recv_cap`` buffer. Returns ``(received, overflow)`` with
    ``overflow`` a receiver past ``recv_cap`` or rows still undrained
    after ``max_rounds`` (default: the rounds a sender needs to drain its
    whole shard to one destination); ``with_rounds`` adds the executed
    round count, ``with_stats`` the global per-destination delivered
    rows (int64 [P])."""
    global flag_reads
    P = num_partitions
    cap = batch.capacity // P
    dev = batch.device
    if max_rounds is None:
        max_rounds = max(1, -(-cap // quota))
    names = list(batch.columns)
    shared = {n: _shared_valid(batch.columns[n], batch.live) for n in names}
    bufs = {}
    for n in names:
        c = batch.columns[n]
        tail = tuple(c.data.shape[1:])
        bufs[n] = (torch.zeros((P, recv_cap + 1) + tail, dtype=c.data.dtype, device=dev),
                   None if shared[n] else torch.zeros((P, recv_cap + 1), dtype=torch.bool,
                                                      device=dev))
    remaining = batch.live
    off = torch.zeros(P, dtype=torch.int64, device=dev)
    dest = torch.zeros(P, dtype=torch.int64, device=dev)
    rnd = 0
    flag_reads += 1
    pending = bool(torch.any(remaining))
    rows = torch.arange(P, device=dev)[:, None]
    while pending and rnd < max_rounds:
        slot, sent, _ = _send_slots(pids, remaining, P, P, quota)
        got = _a2a(sent, slot, P, quota, False)
        pos = off[:, None] + torch.cumsum(got.to(torch.int64), 1) - 1
        pos = torch.where(got, torch.clamp(pos, max=recv_cap), recv_cap)  # dead slots drop
        for n in names:
            c = batch.columns[n]
            data, valid = bufs[n]
            data[rows, pos] = _a2a(c.data, slot, P, quota)
            if valid is not None:
                valid[rows, pos] = _a2a(c.valid, slot, P, quota, False)
        off = off + got.sum(1)
        if with_stats:
            dest = dest + destination_counts(pids, sent, P)
        remaining = remaining & ~sent
        rnd += 1
        flag_reads += 1
        pending = bool(torch.any(remaining))
    live = (torch.arange(recv_cap, device=dev)[None, :] < off[:, None]).reshape(-1)
    cols = {}
    for n in names:
        c = batch.columns[n]
        data, valid = bufs[n]
        tail = tuple(c.data.shape[1:])
        cols[n] = Column(data[:, :recv_cap].reshape((-1,) + tail),
                         live if valid is None else valid[:, :recv_cap].reshape(-1),
                         c.dtype, c.dictionary)
    overflow = torch.any(off > recv_cap) | torch.any(remaining)
    res = (Batch(cols, live), overflow)
    if with_rounds:
        res = res + (rnd,)
    if with_stats:
        res = res + (dest,)
    return res


def broadcast_local(batch: Batch) -> Batch:
    """Every shard ends up with all rows: the all-gather of a row-sharded
    batch is its shards concatenated in shard order, which is the global
    batch itself."""
    return batch


def any_flag(flags) -> torch.Tensor:
    """Combine per-shard flags (the psum of their int32 casts > 0)."""
    if isinstance(flags, torch.Tensor):
        return torch.any(flags)
    return torch.any(torch.stack([torch.as_tensor(f) for f in flags]))


# ---------------------------------------------------------------------------
# Exchange metrics
# ---------------------------------------------------------------------------
#
# Wire bytes are capacity-based, as in the JAX package: an all-to-all
# moves the full [P, quota] send tensor per column per shard whatever
# the liveness, so bytes = rounds x P senders x (P x quota) rows x row
# bytes; a gather moves each shard to the P - 1 others. Dispatch time is
# the host's wall from the exchange's dispatch to its result being
# usable.


def a2a_wire_bytes(row_bytes: int, num_partitions: int, quota: int, rounds: int = 1) -> int:
    """Total bytes one hash-partitioned exchange moved (all shards, all
    rounds)."""
    return int(rounds) * num_partitions * num_partitions * quota * row_bytes


def gather_wire_bytes(row_bytes: int, capacity: int, mesh_size: int) -> int:
    """Bytes a replication of a row-sharded batch of global ``capacity``
    moves (each shard travels to the other P - 1)."""
    return capacity * max(mesh_size - 1, 0) * row_bytes


def record_exchange(site: str, nbytes: int, partitions: int, dispatch_s: float,
                    rounds: int = 1, hot_partition: int | None = None) -> None:
    """Publish one exchange dispatch: the counters, the
    ``exchange.dispatch_s`` histogram and a completed ``exchange:<site>``
    span carrying the byte, partition and round accounting.
    ``hot_partition`` names the partition that tripped a capacity
    overflow (``exchange.quota_overflow``)."""
    from presto_tpu_torch.runtime import trace
    from presto_tpu_torch.runtime.metrics import REGISTRY

    REGISTRY.counter("exchange.dispatches").add()
    REGISTRY.counter("exchange.bytes").add(float(nbytes))
    REGISTRY.counter("exchange.rounds").add(float(rounds))
    REGISTRY.histogram("exchange.dispatch_s").add(dispatch_s)
    args = {"bytes": int(nbytes), "partitions": int(partitions), "rounds": int(rounds)}
    if hot_partition is not None:
        REGISTRY.counter("exchange.quota_overflow").add()
        args["hot_partition"] = int(hot_partition)
    trace.add_complete(f"exchange:{site}", "exchange", time.perf_counter() - dispatch_s,
                       dispatch_s, args)


def skew_ratio(counts) -> float:
    """max/mean partition ratio of a per-destination row histogram (1.0
    balanced, P everything on one destination, 0.0 nothing moved)."""
    counts = np.asarray(counts)
    total = float(np.sum(counts))
    if total <= 0 or len(counts) == 0:
        return 0.0
    return float(np.max(counts) / (total / len(counts)))


# ---------------------------------------------------------------------------
# Standalone steps (tests and the shuffle measurements)
# ---------------------------------------------------------------------------


def make_shuffle_step(mesh, num_partitions: int, quota: int):
    """(row-sharded Batch, pids) -> (row-sharded Batch, overflow)."""

    def step(batch: Batch, pids):
        return exchange_local(batch, pids, num_partitions, quota)

    return step


def make_multiround_shuffle_step(mesh, num_partitions: int, quota: int, recv_cap: int):
    """(row-sharded Batch, pids) -> (row-sharded Batch, overflow) through
    the multi-round exchange: a skewed key stream completes at a small
    fixed wire quota in extra rounds."""

    def step(batch: Batch, pids):
        return exchange_multiround(batch, pids, num_partitions, quota, recv_cap)

    return step


def make_broadcast_step(mesh):
    """row-sharded Batch -> replicated Batch (all rows everywhere)."""
    return broadcast_local
