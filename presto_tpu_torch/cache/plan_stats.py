"""Plan-fingerprint-keyed runtime statistics history.

Counterpart of ``presto_tpu/cache/plan_stats.py``. Each entry maps one
``plan_fingerprint`` to the latest estimate-vs-actual rows of a completed
run (per node: estimated rows, actual rows, measured selectivity, chosen
strategy, misestimate ratio, exchange skew, hot partition, spill mode,
wall and route fallback: ``StatsRecorder.estimate_vs_actual``) and a
``runs`` counter, so recurring plans stand apart from one-offs. The
session reads it back (``Session._plan_hints``) for the adaptive
aggregation bypass, the adaptive controller and the spill tier's hot
partition.

- The key encodes the data: ``plan_fingerprint`` folds every referenced
  table's catalog version, so after DDL an identical query records under
  a new fingerprint.
- The stored version snapshot is re-checked at read, and the catalog's
  invalidation listener drops entries eagerly on DDL.
- Volatile plans (system-table scans) are not recorded.

The store is per session and a bounded LRU by entry count
(``plan_stats_limit``); ``to_json`` / ``load_json`` carry it across a
restart.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from presto_tpu_torch.runtime.metrics import REGISTRY


@dataclass
class PlanStatsEntry:
    fingerprint: str
    query_id: str  # the latest recording run
    versions: "tuple[tuple[str, int], ...]"  # (table, version) at record
    #: per-node estimate-vs-actual dicts (StatsRecorder.estimate_vs_actual)
    records: list = field(default_factory=list)
    #: completed runs recorded under this fingerprint (records hold the
    #: LATEST run; runs makes recurrence visible to adaptive consumers)
    runs: int = 1


class PlanStatsStore:
    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._entries: "OrderedDict[str, PlanStatsEntry]" = OrderedDict()

    def resize(self, max_entries: int) -> None:
        """Apply a changed ``plan_stats_limit`` immediately: a shrink
        evicts oldest entries NOW, not at the next recorded query (the
        query_history_limit take-effect rule)."""
        self.max_entries = max_entries
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            REGISTRY.counter("plan_stats.evicted").add()

    # ---- record ----------------------------------------------------------
    def put(self, fp: Optional[str], query_id: str, versions,
            records: list) -> bool:
        """Record one completed run's per-node history (latest-wins per
        fingerprint; ``runs`` accumulates). No-op for unfingerprintable
        plans or runs that produced no estimate snapshot."""
        if fp is None or not records:
            return False
        prev = self._entries.pop(fp, None)
        self._entries[fp] = PlanStatsEntry(
            fp, query_id, tuple(versions), list(records),
            runs=1 if prev is None else prev.runs + 1,
        )
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            REGISTRY.counter("plan_stats.evicted").add()
        REGISTRY.counter("plan_stats.recorded").add()
        return True

    # ---- read ------------------------------------------------------------
    def get(self, fp: Optional[str],
            catalog=None) -> Optional[PlanStatsEntry]:
        """History for one fingerprint; with a ``catalog``, version
        drift drops the entry (the lazy half of invalidation)."""
        if fp is None:
            return None
        entry = self._entries.get(fp)
        if entry is None:
            return None
        if catalog is not None and any(
            catalog.version(t) != v for t, v in entry.versions
        ):
            self._entries.pop(fp, None)
            REGISTRY.counter("plan_stats.invalidated").add()
            return None
        return entry

    def entries(self, catalog=None) -> "list[PlanStatsEntry]":
        """Every live entry, oldest first (with a ``catalog``,
        version-stale entries are dropped on the way out — the
        ``system.plan_stats`` scan path)."""
        if catalog is not None:
            for fp in [
                fp for fp, e in self._entries.items()
                if any(catalog.version(t) != v for t, v in e.versions)
            ]:
                self._entries.pop(fp, None)
                REGISTRY.counter("plan_stats.invalidated").add()
        return list(self._entries.values())

    # ---- invalidation ----------------------------------------------------
    def invalidate_table(self, table: str) -> None:
        """Eagerly drop every entry whose run read ``table`` (wired to
        the catalog's DDL invalidation listeners by the Session, the
        same hook the result cache rides)."""
        stale = [
            fp for fp, e in self._entries.items()
            if any(t == table for t, _v in e.versions)
        ]
        for fp in stale:
            self._entries.pop(fp, None)
            REGISTRY.counter("plan_stats.invalidated").add()

    # ---- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    # ---- persistence (Session.export_plan_stats / import_plan_stats) ----
    #: export format version — an import refuses a payload whose
    #: format it cannot interpret (forward-compatibility contract)
    EXPORT_VERSION = 1

    def to_json(self) -> str:
        """The whole history as a JSON document, oldest entry first —
        the warm-restart half of adaptive execution: a restarted server
        imports this so history-driven decisions don't start cold."""
        import json

        return json.dumps({
            "format": self.EXPORT_VERSION,
            "entries": [
                {
                    "fingerprint": e.fingerprint,
                    "query_id": e.query_id,
                    "versions": [[t, v] for t, v in e.versions],
                    "records": e.records,
                    "runs": e.runs,
                }
                for e in self._entries.values()
            ],
        })

    def load_json(self, text: str, catalog=None) -> int:
        """Merge an exported history document into this store,
        returning the number of entries imported. Version-checked
        twice: the document FORMAT must be one this build understands
        (ValueError otherwise), and with a ``catalog`` each entry's
        recorded (table, version) snapshot must match the CURRENT
        table epochs — an entry recorded against data that has since
        changed is silently skipped (``plan_stats.import_stale``), the
        same staleness contract get() enforces. Existing in-memory
        entries win over imported ones (they are newer by
        construction)."""
        import json

        doc = json.loads(text)
        if not isinstance(doc, dict) or doc.get("format") != \
                self.EXPORT_VERSION:
            raise ValueError(
                "unsupported plan-stats export format: "
                f"{doc.get('format') if isinstance(doc, dict) else doc!r}"
            )
        imported = 0
        for raw in doc.get("entries", []):
            fp = raw.get("fingerprint")
            records = raw.get("records") or []
            if not fp or not records or fp in self._entries:
                continue
            versions = tuple(
                (str(t), int(v)) for t, v in raw.get("versions", [])
            )
            if catalog is not None and any(
                catalog.version(t) != v for t, v in versions
            ):
                REGISTRY.counter("plan_stats.import_stale").add()
                continue
            self._entries[fp] = PlanStatsEntry(
                fp, str(raw.get("query_id", "")), versions,
                list(records), runs=max(1, int(raw.get("runs", 1))),
            )
            self._entries.move_to_end(fp, last=False)  # imported = oldest
            imported += 1
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            REGISTRY.counter("plan_stats.evicted").add()
        if imported:
            REGISTRY.counter("plan_stats.imported").add(imported)
        return imported
