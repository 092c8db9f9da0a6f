"""Versioned result cache: final query results keyed by plan fingerprint.

Counterpart of ``presto_tpu/cache/result_cache.py``. A hit returns the
finished ``QueryResult`` without touching the device.

- The key encodes the data: ``plan_fingerprint`` folds every referenced
  table's catalog version, so a CTAS / DROP / INSERT bump makes the next
  identical query compute another key. The stored version snapshot is
  re-checked at lookup anyway, and the catalog's invalidation listener
  drops entries eagerly on DDL, so stale rows do not hold budget.
- Admission (``admissible``): deterministic plans only (no volatile
  function, no volatile connector such as ``system``), never while a
  fault injector is installed, and only for finished queries: the
  session populates after success, so a failed query cannot populate.
- The cache is per session: sessions own private memory catalogs, so
  equal fingerprints across sessions do not imply equal data.

Budget: a byte-bounded LRU on ``QueryResult.nbytes``; a result over the
whole budget is not stored (``result_cache.skipped``). Stored results
and every hit are copies (``QueryResult.copy``), so a caller that
changes its rows changes nobody else's. Counters: ``result_cache.hit`` /
``.miss`` / ``.populated`` / ``.evicted`` / ``.invalidated`` /
``.skipped`` / ``.uncacheable``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from presto_tpu_torch.cache.fingerprint import plan_is_deterministic
from presto_tpu_torch.runtime.metrics import REGISTRY


@dataclass
class CacheEntry:
    result: object  # the stored QueryResult (never handed out directly)
    versions: "tuple[tuple[str, int], ...]"  # (table, version) when stored
    nbytes: int
    #: the populating run probed an approximate join sketch: a hit
    #: restores ``QueryInfo.approximate`` as that run reported it
    approximate: bool = False


class ResultCache:
    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._bytes = 0

    @staticmethod
    def admissible(plan, catalog) -> bool:
        """May this plan's result be cached or served from the cache?"""
        from presto_tpu_torch.runtime.faults import active

        if active() is not None:
            return False
        return plan_is_deterministic(plan, catalog)

    def get(self, key: Optional[str], catalog):
        """The cached result (a copy) or None."""
        hit = self.get_entry(key, catalog)
        return None if hit is None else hit[0]

    def get_entry(self, key: Optional[str], catalog):
        """(a copy of the result, CacheEntry) or None. Version drift
        against the live catalog drops the entry."""
        if key is None:
            REGISTRY.counter("result_cache.uncacheable").add()
            return None
        entry = self._entries.get(key)
        if entry is None:
            REGISTRY.counter("result_cache.miss").add()
            return None
        if any(catalog.version(t) != v for t, v in entry.versions):
            self._drop(key)
            REGISTRY.counter("result_cache.invalidated").add()
            REGISTRY.counter("result_cache.miss").add()
            return None
        self._entries.move_to_end(key)
        REGISTRY.counter("result_cache.hit").add()
        return entry.result.copy(), entry

    def put(self, key: Optional[str], result, versions, max_bytes: Optional[int] = None,
            approximate: bool = False) -> bool:
        """Store a finished result (a copy). ``max_bytes`` refreshes the
        budget from the session property at each populate."""
        if key is None:
            return False
        if max_bytes is not None:
            self.max_bytes = int(max_bytes)
        nbytes = result.nbytes
        if nbytes > self.max_bytes:
            REGISTRY.counter("result_cache.skipped").add()
            return False
        if key in self._entries:
            self._drop(key)
        self._entries[key] = CacheEntry(result.copy(), tuple(versions), nbytes, approximate)
        self._bytes += nbytes
        while self._bytes > self.max_bytes and self._entries:
            old_key = next(iter(self._entries))
            if old_key == key and len(self._entries) == 1:
                break  # never evict the entry just inserted to fit itself
            self._drop(old_key)
            REGISTRY.counter("result_cache.evicted").add()
        REGISTRY.counter("result_cache.populated").add()
        return True

    def invalidate_table(self, table: str) -> None:
        """Drop every entry that read ``table`` (the catalog calls this on
        DDL)."""
        stale = [k for k, e in self._entries.items() if any(t == table for t, _v in e.versions)]
        for k in stale:
            self._drop(k)
            REGISTRY.counter("result_cache.invalidated").add()

    def _drop(self, key: str) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        """The cached keys, LRU-oldest first."""
        return list(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0
