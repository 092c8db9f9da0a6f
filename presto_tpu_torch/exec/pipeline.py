"""Pipelines and the push loop that runs them.

Counterpart of ``presto_tpu/exec/pipeline.py``: a pipeline is
``source -> operators``; a push loop on the host runs it, and
pipeline-breaking operators (aggregations) buffer device-side and emit
on ``finish()``. CUDA launches are asynchronous, so the loop runs ahead
of the device while the next split is generated on a worker thread.

The JAX package's deadline, trace and fault hooks are not ported yet.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Sequence

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.exec.operators import Operator
from presto_tpu_torch.spi import Connector, Split, batch_capacity


@dataclass
class OperatorStats:
    """Per-operator runtime stats."""

    name: str
    input_batches: int = 0
    output_batches: int = 0
    wall_s: float = 0.0


class ScanSource:
    """Pulls splits from a connector and yields device batches of one
    shared capacity bucket."""

    def __init__(
        self,
        connector: Connector,
        table: str,
        columns: Sequence[str] | None,
        splits: Sequence[Split] | None = None,
        capacity: int | None = None,
    ):
        self.connector = connector
        self.table = table
        self.columns = list(columns) if columns is not None else None
        self.splits = list(splits) if splits is not None else list(connector.splits(table))
        self.capacity = capacity or batch_capacity(
            max(s.row_hint for s in self.splits)
        )

    def __iter__(self) -> Iterator[Batch]:
        def load(split):
            return self.connector.scan(split, self.columns, self.capacity)

        return prefetch_iter(load, self.splits)


def prefetch_enabled() -> bool:
    """On when the host has more than one core: with one, the worker
    thread only contends with generation for the interpreter lock."""
    try:
        ncpu = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        ncpu = os.cpu_count() or 1
    return ncpu > 1


def prefetch_iter(load, items):
    """One-slot prefetch: item k+1 loads (generate + host-to-device copy)
    on a worker thread while the consumer holds item k. Exactly one item
    is in flight (bounded host memory)."""
    if len(items) <= 1 or not prefetch_enabled():
        for it in items:
            yield load(it)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(load, items[0])
        for nxt in items[1:]:
            out = fut.result()
            fut = ex.submit(load, nxt)
            yield out
        yield fut.result()


class BatchStream:
    """A REPLAYABLE lazy batch stream — the executor's unit of data flow.

    ``make_iter`` returns a fresh iterator on every call, so a retry loop
    (capacity-overflow doubling) can re-drain the stream; replaying a
    scan-rooted stream regenerates the data. Streams rooted at
    materialized results wrap a list (replay is free)."""

    def __init__(self, make_iter: Callable[[], Iterator[Batch]]):
        self._make = make_iter

    @classmethod
    def of(cls, batches: Sequence[Batch]) -> "BatchStream":
        return cls(lambda: iter(batches))

    def __iter__(self) -> Iterator[Batch]:
        return self._make()

    def map(self, fn: Callable[[Batch], Batch]) -> "BatchStream":
        return BatchStream(lambda: (fn(b) for b in self))

    def peek(self) -> "Batch | None":
        """The first batch, or None when empty (replays the stream's
        first batch)."""
        return next(iter(self), None)

    def materialize(self) -> list[Batch]:
        return list(self)


class Pipeline:
    """source -> op chain; run() returns the terminal output batches."""

    def __init__(self, source: Iterable[Batch], operators: Sequence[Operator]):
        self.source = source
        self.operators = list(operators)
        self.stats = [OperatorStats(type(op).__name__) for op in self.operators]

    def run(self) -> list[Batch]:
        outputs: list[Batch] = []

        def push(i: int, batch: Batch):
            if i == len(self.operators):
                outputs.append(batch)
                return
            st = self.stats[i]
            st.input_batches += 1
            t0 = time.perf_counter()
            produced = self.operators[i].process(batch)
            st.wall_s += time.perf_counter() - t0
            for b in produced:
                st.output_batches += 1
                push(i + 1, b)

        for batch in self.source:
            push(0, batch)
        for i, op in enumerate(self.operators):
            t0 = time.perf_counter()
            tail = op.finish()
            self.stats[i].wall_s += time.perf_counter() - t0
            for b in tail:
                self.stats[i].output_batches += 1
                push(i + 1, b)
        return outputs
