"""Process-wide event counters.

Counterpart of the counter half of ``presto_tpu/runtime/metrics.py``:
one ``Counter`` keyed by the JAX package's metric names
(``join.strategy.pallas``, ``exec.pallas_join_route``,
``join.pallas_fallback``, ``agg.strategy.bypass``, ...), so a run can
show which route each operator took. Readers reset it themselves.
"""

from __future__ import annotations

from collections import Counter

COUNTERS: Counter = Counter()
