"""Executable cache: operator step callables reused across queries.

Counterpart of ``presto_tpu/cache/exec_cache.py``. The engine builds its
operators per query (per-query state must never be shared), but a step's
computation is pure config. The JAX package caches the jitted step, so a
repeated query skips trace and compile. The port has no jit: an entry is
the step callable an operator builds, the closure over its exprs,
strategies and capacities, and a hit hands the same callable to the next
query's operator. Keys, call sites and counters follow the JAX package's,
so a warm identical query counts the same ``exec_cache.hit`` and
``exec_cache.miss`` in both packages.

Keys are content fingerprints of everything the closure bakes in, led
by the step-kind tag every call site passes first (``kind:fp``, which
``system.exec_cache`` shows as provenance). A key that cannot be
fingerprinted builds uncached (``exec_cache.uncacheable``), never a
guessed key. The cache is process-wide and a bounded LRU
(``exec_cache_max_entries``); ``exec_cache.evicted`` counts evictions.
A miss records an ``exec_cache:build`` span.

The ledger (``system.exec_cache``): each entry keeps its hits, its calls,
and the walls of its slowest (``cold_call_s``) and fastest
(``warm_call_s``) invocation; ``compile_s_saved = hits x (cold - warm)``.
These walls are the port's own: a first Python call and the first launch
of its kernels (the CUDA context, a kernel module's first load), not an
XLA trace and compile, so they run far below the JAX package's and the
adaptive controller's compile-budget gate admits decisions the JAX
package refuses (ROADMAP C20). There is no ``exec.traces`` probe: the
port traces nothing.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from presto_tpu_torch.cache.fingerprint import try_fingerprint
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.trace import span as trace_span

DEFAULT_MAX_ENTRIES = 256


class CacheEntry:
    """One cached step plus its ledger row."""

    __slots__ = ("value", "kind", "key", "hits", "calls", "created_at", "last_used",
                 "cold_call_s", "warm_call_s", "_lock")

    def __init__(self, value, kind: str, key: str):
        self.value = value
        self.kind = kind
        self.key = key
        #: lookups served by this entry after the building miss
        self.hits = 0
        #: invocations of the (callable) entry
        self.calls = 0
        self.created_at = time.time()
        self.last_used = self.created_at
        #: slowest invocation wall (-1 until called)
        self.cold_call_s = -1.0
        #: fastest invocation wall
        self.warm_call_s = -1.0
        #: entries are shared across threads
        self._lock = threading.Lock()

    @property
    def compile_s_saved(self) -> float:
        """hits x (cold - warm), 0 until two calls measured both
        extremes."""
        if self.cold_call_s < 0 or self.warm_call_s < 0 or self.calls < 2:
            return 0.0
        return self.hits * max(self.cold_call_s - self.warm_call_s, 0.0)

    def record_call(self, wall_s: float) -> None:
        with self._lock:
            self.calls += 1
            self.last_used = time.time()
            if wall_s > self.cold_call_s:
                self.cold_call_s = wall_s
            if self.warm_call_s < 0 or wall_s < self.warm_call_s:
                self.warm_call_s = wall_s

    def to_dict(self) -> dict:
        now = time.time()
        with self._lock:
            return {
                "kind": self.kind,
                "key": self.key,
                "hits": self.hits,
                "calls": self.calls,
                "cold_call_s": round(max(self.cold_call_s, 0.0), 6),
                "warm_call_s": round(max(self.warm_call_s, 0.0), 6),
                "compile_s_saved": round(self.compile_s_saved, 6),
                "age_s": round(max(now - self.created_at, 0.0), 3),
                "idle_s": round(max(now - self.last_used, 0.0), 3),
            }


class _TimedStep:
    """Forwarding wrapper timing each invocation into its entry's ledger
    row. A failed call (an overflow, an injected fault) passes through
    untimed."""

    __slots__ = ("_fn", "_meta")

    def __init__(self, fn, meta: CacheEntry):
        self._fn = fn
        self._meta = meta

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        self._meta.record_call(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


class ExecutableCache:
    """Bounded LRU of (fingerprint key) -> built step entry."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()

    def set_max_entries(self, n: int) -> None:
        with self._lock:
            self.max_entries = int(n)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            REGISTRY.counter("exec_cache.evicted").add()

    def key_of(self, *parts) -> Optional[str]:
        """Content key for a step config; None = uncacheable. A leading
        string part (the step-kind tag) prefixes the key as ``kind:fp``."""
        fp = try_fingerprint(parts)
        if fp is None:
            return None
        if parts and isinstance(parts[0], str):
            return f"{parts[0]}:{fp}"
        return fp

    @staticmethod
    def _kind_of(key: str) -> str:
        kind, sep, _ = key.partition(":")
        return kind if sep else ""

    def get_or_build(self, key: Optional[str], builder: Callable[[], Any]):
        """The one lookup path. ``builder()`` runs outside the lock; a
        racing duplicate build keeps the first-inserted entry, so every
        caller shares one callable."""
        if key is None:
            REGISTRY.counter("exec_cache.uncacheable").add()
            return builder()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                entry.hits += 1
                entry.last_used = time.time()
                REGISTRY.counter("exec_cache.hit").add()
                return entry.value
        REGISTRY.counter("exec_cache.miss").add()
        # only a miss gets a span, as in the JAX package
        with trace_span("exec_cache:build", "cache", {"hit": False}):
            built = builder()
        meta = CacheEntry(built, self._kind_of(key), key)
        if callable(built) and not isinstance(built, type):
            meta.value = _TimedStep(built, meta)
        with self._lock:
            entry = self._entries.setdefault(key, meta)
            self._entries.move_to_end(key)
            self._evict_locked()
        return entry.value

    def stats_rows(self) -> "list[dict]":
        """Ledger snapshot, LRU-oldest first (the ``system.exec_cache``
        scan), taken under the lock."""
        with self._lock:
            return [e.to_dict() for e in self._entries.values()]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


#: the process-wide executable cache
EXEC_CACHE = ExecutableCache()
