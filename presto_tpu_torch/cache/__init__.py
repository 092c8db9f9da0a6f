"""Query caching: content fingerprints, the executable cache, the
runtime-statistics cache, the versioned result cache and the plan-stats
history.

Counterpart of ``presto_tpu/cache/``:

- :mod:`presto_tpu_torch.cache.fingerprint`: canonical content hashes of
  plans, fragments and expressions; nothing keys on object identity.
- :mod:`presto_tpu_torch.cache.exec_cache`: a bounded process-wide LRU of
  operator step callables keyed by step-config fingerprint.
- :mod:`presto_tpu_torch.cache.result_cache`: a per-session byte-budgeted
  LRU of final results keyed by plan fingerprint, invalidated through the
  catalog's per-table versions.
- :mod:`presto_tpu_torch.cache.stats_cache`: multi-key join min/max
  readbacks kept across a session's queries.
- :mod:`presto_tpu_torch.cache.plan_stats`: the fingerprint-keyed
  estimate-vs-actual history behind ``system.plan_stats``.
"""

from presto_tpu_torch.cache.exec_cache import EXEC_CACHE, ExecutableCache
from presto_tpu_torch.cache.fingerprint import (
    expr_fingerprint,
    fingerprint,
    plan_fingerprint,
    referenced_tables,
    try_fingerprint,
)
from presto_tpu_torch.cache.plan_stats import PlanStatsStore
from presto_tpu_torch.cache.result_cache import ResultCache

__all__ = [
    "EXEC_CACHE",
    "ExecutableCache",
    "PlanStatsStore",
    "ResultCache",
    "expr_fingerprint",
    "fingerprint",
    "plan_fingerprint",
    "referenced_tables",
    "try_fingerprint",
]
