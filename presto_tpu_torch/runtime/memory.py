"""Device-memory budgeting and arbitration: the capacity planner.

Counterpart of ``presto_tpu/runtime/memory.py``. Budgeting happens at
plan time: the executor estimates a fragment's device-resident bytes from
connector stats (``estimate_node_bytes``) and chooses hybrid or grouped
execution with host-RAM offload (``exec/spill.py``) before it launches,
instead of reacting to pressure mid-flight.

Arbitration (:class:`MemoryPool`): concurrent queries reserve their peak
estimated bytes at admission from a shared pool and release on every
terminal state; a query that does not fit queues (bounded FIFO,
``admission_queue_timeout_s``). When the estimate is wrong low anyway,
the OOM ladder (``runtime/lifecycle.py``) takes over.
:class:`HostSpillBudget` bounds the host RAM the spill tier holds.

``device_budget_bytes`` on the card is half the device's total memory
minus what the CUDA caching allocator holds at first use
(``torch.cuda.memory_allocated``), floored at :data:`MIN_BUDGET_BYTES`;
on the CPU it is :data:`DEFAULT_BUDGET_BYTES`, the JAX package's CPU
value, so CPU planning decisions (bucket counts, probe chunks) match it.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import torch

from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.types import DataType, TypeKind

#: the budget where the device reports no memory (the CPU)
DEFAULT_BUDGET_BYTES = 8 << 30

#: floor on the computed budget: a warm process whose allocator already
#: holds most of the device must still run small queries
MIN_BUDGET_BYTES = 256 << 20

#: headroom over the device budget shared by the default admission limit
#: (runtime/lifecycle.py) and the default pool capacity: estimates are
#: loose upper shapes, so both backstops only reject queries that would
#: dwarf the device under any strategy
DEFAULT_POOL_HEADROOM = 64

#: default-device budget, snapshotted at first use, so bucket counts and
#: probe chunks do not drift with the allocator's live bytes between
#: queries
_DEFAULT_BUDGET: int | None = None


def budget_from(limit: int, in_use: int) -> int:
    """Half the device's ``limit`` minus the ``in_use`` bytes already
    held, floored at :data:`MIN_BUDGET_BYTES`."""
    return max(int(limit * 0.5) - int(in_use), MIN_BUDGET_BYTES)


def device_budget_bytes(device=None) -> int:
    """Usable device memory for resident operator state: on a CUDA
    device :func:`budget_from` its total memory and the caching
    allocator's bytes at the call; on the CPU
    :data:`DEFAULT_BUDGET_BYTES`. The default device (the card when
    there is one) is measured once per process; an explicit ``device``
    is measured fresh."""
    global _DEFAULT_BUDGET
    if device is None and _DEFAULT_BUDGET is not None:
        return _DEFAULT_BUDGET
    if device is None:
        dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    else:
        dev = torch.device(device)
    budget = DEFAULT_BUDGET_BYTES
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        budget = budget_from(torch.cuda.get_device_properties(index).total_memory,
                             torch.cuda.memory_allocated(index))
    if device is None:
        _DEFAULT_BUDGET = budget
    return budget


def executor_budget_bytes(device) -> int:
    """The budget an executor on ``device`` plans against: the default
    device's snapshot on the card, :data:`DEFAULT_BUDGET_BYTES` on the
    CPU (a CPU session plans as the JAX package does on the CPU, on a
    machine with a card too)."""
    return device_budget_bytes() if torch.device(device).type == "cuda" \
        else device_budget_bytes(device)


class MemoryPool:
    """Byte-reservation arbiter shared by concurrent queries.

    ``reserve`` blocks in strict FIFO order (head-of-line: a large
    query cannot be starved by a stream of small ones) until the
    reservation fits or ``timeout_s`` expires; ``release`` is
    idempotent per query id and wakes every waiter. Reservations are
    *estimates* — the pool bounds concurrent admission, the grouped
    tiers bound true residency.
    """

    def __init__(self, capacity_bytes: int, name: str = "pool"):
        self.capacity_bytes = int(capacity_bytes)
        self.name = name
        self._cv = threading.Condition()
        self._reservations: dict[str, int] = {}
        self._queue: deque = deque()  # FIFO waiter tickets
        #: serving-layer attribution: query_id -> tenant, plus the
        #: per-tenant byte rollup the fairness scheduler's byte quotas
        #: read (server/scheduler.py)
        self._tenant_of: dict[str, str] = {}
        self._tenant_bytes: dict[str, int] = {}
        #: callbacks fired (outside the lock) after every release —
        #: lets the fairness scheduler re-check byte-quota-blocked
        #: waiters the moment capacity frees
        self._release_listeners: list = []

    # ---- observability ---------------------------------------------------
    @property
    def reserved_bytes(self) -> int:
        with self._cv:
            return sum(self._reservations.values())

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.reserved_bytes

    @property
    def active_count(self) -> int:
        with self._cv:
            return len(self._reservations)

    @property
    def queued_count(self) -> int:
        with self._cv:
            return len(self._queue)

    def reservations(self) -> "dict[str, int]":
        with self._cv:
            return dict(self._reservations)

    def snapshot(self) -> "dict[str, int]":
        """One internally-consistent reading of the pool gauges (a
        single lock acquisition — the ``system.memory_pool`` row must
        not mix states from before and after a concurrent release)."""
        with self._cv:
            reserved = sum(self._reservations.values())
            return {
                "capacity_bytes": self.capacity_bytes,
                "reserved_bytes": reserved,
                "free_bytes": self.capacity_bytes - reserved,
                "active_queries": len(self._reservations),
                "queued_queries": len(self._queue),
            }

    def describe(self) -> str:
        """One-line pool state for admission error messages."""
        with self._cv:
            reserved = sum(self._reservations.values())
            return (
                f"pool {self.name!r}: {reserved}/{self.capacity_bytes} "
                f"bytes reserved by {len(self._reservations)} queries, "
                f"{len(self._queue)} queued"
            )

    def add_release_listener(self, fn) -> None:
        """Register a callback invoked (with no arguments, outside the
        pool lock) after every release."""
        with self._cv:
            self._release_listeners.append(fn)

    def remove_release_listener(self, fn) -> None:
        """Unregister (idempotent) — a scheduler detaching from the
        process-global pool must not stay pinned by its listener."""
        with self._cv:
            try:
                self._release_listeners.remove(fn)
            except ValueError:
                pass

    def tenant_reserved_bytes(self, tenant: str) -> int:
        """Live bytes reserved by queries tagged with ``tenant`` (the
        fairness scheduler's byte-quota operand)."""
        with self._cv:
            return self._tenant_bytes.get(tenant, 0)

    # ---- reserve / release ----------------------------------------------
    def reserve(self, query_id: str, nbytes: int,
                timeout_s: float | None = None, detail: str = "",
                tenant: str | None = None) -> float:
        """Reserve ``nbytes`` for ``query_id``, blocking FIFO until the
        pool has room. Returns the seconds spent queued. Raises
        ``ResourceExhausted`` immediately when the reservation can
        NEVER fit, or after ``timeout_s`` in the queue."""
        from presto_tpu_torch.runtime.errors import ResourceExhausted

        nbytes = max(0, int(nbytes))
        ctx = f" ({detail})" if detail else ""
        if nbytes > self.capacity_bytes:
            REGISTRY.counter("memory.rejected").add()
            raise ResourceExhausted(
                f"admission control: reservation of {nbytes} bytes{ctx} "
                f"exceeds the whole memory pool capacity of "
                f"{self.capacity_bytes} bytes ({self.describe()}; set the "
                "memory_pool_bytes session property to raise it)"
            )
        t0 = time.monotonic()
        deadline = None if timeout_s is None else t0 + timeout_s
        ticket = object()
        waited = False
        with self._cv:
            self._queue.append(ticket)
            try:
                while not (
                    self._queue[0] is ticket
                    and sum(self._reservations.values()) + nbytes
                    <= self.capacity_bytes
                ):
                    remaining = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        REGISTRY.counter("memory.queue_timeouts").add()
                        REGISTRY.counter("memory.queued").add()
                        # the longest waits are exactly the ones that
                        # time out — they must show in the histogram
                        REGISTRY.histogram("memory.queued_s").add(
                            time.monotonic() - t0
                        )
                        raise ResourceExhausted(
                            f"admission queue timeout: {query_id} waited "
                            f"{timeout_s}s to reserve {nbytes} bytes{ctx} "
                            f"({self.describe()}; raise "
                            "admission_queue_timeout_s or "
                            "memory_pool_bytes)"
                        )
                    waited = True
                    self._cv.wait(remaining)
                self._reservations[query_id] = (
                    self._reservations.get(query_id, 0) + nbytes
                )
                if tenant:
                    self._tenant_of[query_id] = tenant
                    self._tenant_bytes[tenant] = (
                        self._tenant_bytes.get(tenant, 0) + nbytes
                    )
            finally:
                self._queue.remove(ticket)
                self._cv.notify_all()
        queued_s = time.monotonic() - t0
        REGISTRY.counter("memory.reserved").add()
        if waited:
            REGISTRY.counter("memory.queued").add()
            REGISTRY.histogram("memory.queued_s").add(queued_s)
        return queued_s

    def release(self, query_id: str) -> int:
        """Drop ``query_id``'s reservation (idempotent; every terminal
        state calls this). Returns the bytes freed."""
        with self._cv:
            freed = self._reservations.pop(query_id, None)
            if freed is not None:
                tenant = self._tenant_of.pop(query_id, None)
                if tenant is not None:
                    left = self._tenant_bytes.get(tenant, 0) - freed
                    if left > 0:
                        self._tenant_bytes[tenant] = left
                    else:
                        self._tenant_bytes.pop(tenant, None)
            listeners = list(self._release_listeners)
            self._cv.notify_all()
        if freed is None:
            return 0
        REGISTRY.counter("memory.released").add()
        for fn in listeners:
            try:
                fn()
            except Exception:  # noqa: BLE001 — listeners never leak back
                pass
        return freed


#: default host-side spill capacity as a multiple of the device budget
#: (host RAM plays the spill-disk role; the ratio mirrors a typical
#: host:device memory ratio, overridable per session via the
#: ``spill_host_budget_bytes`` property)
DEFAULT_HOST_SPILL_FACTOR = 16


class HostSpillBudget:
    """Byte budget over HOST-side spill state (exec/grouped.HostSpill).

    The out-of-core tier's "disk" is host RAM, which before this class
    grew invisibly: every spilled partition chunk now reserves its
    bytes here under a per-store TAG (the tenant-tag discipline of
    :class:`MemoryPool`), and overflow raises the typed
    ``SpillBudgetExceeded`` instead of silently eating the host.
    Reservations are additive per tag; ``release`` clamps and is
    idempotent (success and fault paths both release in ``finally``)."""

    def __init__(self, capacity_bytes: int, name: str = "host-spill"):
        self.capacity_bytes = int(capacity_bytes)
        self.name = name
        self._lock = threading.Lock()
        self._tags: dict[str, int] = {}
        self.peak_bytes = 0

    @property
    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(self._tags.values())

    def snapshot(self) -> "dict":
        with self._lock:
            reserved = sum(self._tags.values())
            return {
                "capacity_bytes": self.capacity_bytes,
                "reserved_bytes": reserved,
                "free_bytes": self.capacity_bytes - reserved,
                "tags": dict(self._tags),
                "peak_bytes": self.peak_bytes,
            }

    def reserve(self, tag: str, nbytes: int) -> None:
        """Add ``nbytes`` to ``tag``'s reservation, or fail typed and
        loud when the total would exceed capacity."""
        from presto_tpu_torch.runtime.errors import SpillBudgetExceeded

        nbytes = max(0, int(nbytes))
        with self._lock:
            total = sum(self._tags.values()) + nbytes
            if total > self.capacity_bytes:
                REGISTRY.counter("spill.host_rejected").add()
                raise SpillBudgetExceeded(
                    f"host spill budget {self.name!r}: reserving {nbytes} "
                    f"more bytes for {tag!r} would hold {total} of "
                    f"{self.capacity_bytes} capacity (raise the "
                    "spill_host_budget_bytes session property)"
                )
            self._tags[tag] = self._tags.get(tag, 0) + nbytes
            self.peak_bytes = max(self.peak_bytes, total)

    def release(self, tag: str, nbytes: int | None = None) -> int:
        """Drop ``nbytes`` of ``tag``'s reservation (all of it when
        None). Clamped and idempotent; returns the bytes freed."""
        with self._lock:
            held = self._tags.get(tag, 0)
            freed = held if nbytes is None else min(held, max(0, int(nbytes)))
            left = held - freed
            if left > 0:
                self._tags[tag] = left
            else:
                self._tags.pop(tag, None)
            return freed


_GLOBAL_HOST_SPILL: HostSpillBudget | None = None

_GLOBAL_POOL: MemoryPool | None = None
_GLOBAL_POOL_LOCK = threading.Lock()


def global_host_spill_budget() -> HostSpillBudget:
    """The process-wide default host-spill budget (sessions without a
    ``spill_host_budget_bytes`` override account against it). Sized
    lazily so the device-budget snapshot rule holds."""
    global _GLOBAL_HOST_SPILL
    with _GLOBAL_POOL_LOCK:
        if _GLOBAL_HOST_SPILL is None:
            _GLOBAL_HOST_SPILL = HostSpillBudget(
                device_budget_bytes() * DEFAULT_HOST_SPILL_FACTOR,
                name="global-host-spill",
            )
        return _GLOBAL_HOST_SPILL


def global_pool() -> MemoryPool:
    """The process-wide default pool every Session without an explicit
    pool (or ``memory_pool_bytes`` override) arbitrates through —
    concurrent sessions in one process share the device, so they share
    the pool. Sized lazily at first use."""
    global _GLOBAL_POOL
    with _GLOBAL_POOL_LOCK:
        if _GLOBAL_POOL is None:
            _GLOBAL_POOL = MemoryPool(
                device_budget_bytes() * DEFAULT_POOL_HEADROOM, name="global"
            )
        return _GLOBAL_POOL


def pool_leaks() -> "dict[str, int]":
    """Reservations still held in the global pool (the test-suite
    leak-check: every terminal query state must have released)."""
    return {} if _GLOBAL_POOL is None else _GLOBAL_POOL.reservations()


def column_bytes(dtype: DataType) -> int:
    """Per-row device bytes of a column (data + validity mask)."""
    if dtype.kind is TypeKind.BYTES:
        return dtype.width + 1
    return dtype.np_dtype.itemsize + 1


def node_row_bytes(node: N.PlanNode, catalog=None) -> int:
    """Per-row device bytes of a node's output (+1 for the live mask).
    With a ``catalog``, columns that resolve to a source scan column count
    at their narrowed physical width; computed columns stay canonical."""
    total = 1
    for f in node.fields:
        dt = f.dtype
        if catalog is not None and not dt.is_narrowed:
            dt = _physical_field_type(node, f.name, dt, catalog)
        total += column_bytes(dt)
    return total


def _physical_field_type(node, name: str, dtype: DataType, catalog) -> DataType:
    from presto_tpu_torch.plan.bounds import resolve_source_column

    src = resolve_source_column(node, name)
    if src is None:
        return dtype
    conn = catalog.connectors.get(src[0])
    if conn is None or not hasattr(conn, "physical_schema"):
        return dtype
    try:
        return conn.physical_schema(src[1], [src[2]])[src[2]]
    except KeyError:
        return dtype


def estimate_node_bytes(node: N.PlanNode, catalog) -> int:
    """Estimated device-resident bytes if the node's output were fully
    materialized (stats-based, physical-width-aware): the grouped
    execution trigger and the admission operand."""
    from presto_tpu_torch.plan.bounds import estimate_rows

    return estimate_rows(node, catalog) * node_row_bytes(node, catalog)
