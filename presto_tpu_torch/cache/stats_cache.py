"""Cross-query runtime-statistics cache (join-key min/max readbacks).

Counterpart of ``presto_tpu/cache/stats_cache.py``. The multi-key join
planner (``exec/joinkeys.py``) needs tight (min, max) bounds per key to
pack several keys into one int64; where connector stats do not cover a
key it reduces the key on the device and reads the bounds back, one of
the few synchronous round trips of planning. This cache keeps those
readbacks across a session's queries, keyed by content: (catalog token,
subtree fingerprint, key-expr fingerprint, referenced-table versions).
The subtree fingerprint pins which rows flowed into the reduction, the
versions invalidate on DDL, the catalog token keeps sessions apart.

A bounded LRU; values are two ints. Counters ``stats_cache.hit`` /
``stats_cache.miss``; a miss records a ``stats_cache:minmax_probe`` span.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

from presto_tpu_torch.cache.fingerprint import referenced_tables, try_fingerprint
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.trace import span as trace_span

MAX_ENTRIES = 4096

_entries: "OrderedDict[str, tuple[int, int]]" = OrderedDict()


def _has_unbound(obj) -> bool:
    """Does the subtree hold an Unbound scalar-subquery slot or a Param
    literal slot? Both are bound outside the expression tree, so the
    rows of a probe depend on values the fingerprint cannot see."""
    from presto_tpu_torch.expr import Param, Unbound

    if isinstance(obj, (Unbound, Param)):
        return True
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(_has_unbound(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return any(_has_unbound(x) for x in obj)
    return False


def minmax_key(catalog, node, key_expr) -> Optional[str]:
    """Content key for one runtime min/max probe; None = uncacheable (the
    caller then probes per query)."""
    if _has_unbound(node) or _has_unbound(key_expr):
        return None
    try:
        versions = tuple((t, catalog.version(t)) for _c, t in referenced_tables(node))
    except Exception:  # noqa: BLE001 -- an unresolvable subtree is uncacheable
        return None
    return try_fingerprint(("minmax", catalog.cache_token(), node, key_expr, versions))


def peek(key: Optional[str]):
    """The cached (min, max) for ``key`` without computing."""
    if key is None:
        return None
    return _entries.get(key)


def cached_minmax(key: Optional[str], compute: Callable[[], "tuple[int, int]"]):
    """The (min, max) for ``key``, computed (and stored) on a miss."""
    if key is not None:
        hit = _entries.get(key)
        if hit is not None:
            _entries.move_to_end(key)
            REGISTRY.counter("stats_cache.hit").add()
            return hit
    REGISTRY.counter("stats_cache.miss").add()
    with trace_span("stats_cache:minmax_probe", "cache"):
        value = compute()
    if key is not None:
        _entries[key] = value
        while len(_entries) > MAX_ENTRIES:
            _entries.popitem(last=False)
    return value


def clear() -> None:
    _entries.clear()
