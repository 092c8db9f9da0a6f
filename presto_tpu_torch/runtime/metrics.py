"""Process-wide event counters.

Counterpart of the counter half of ``presto_tpu/runtime/metrics.py``:
one ``Counter`` keyed by the JAX package's metric names
(``join.strategy.pallas``, ``exec.pallas_join_route``,
``join.pallas_fallback``, ``agg.strategy.{fused,single,bypass,partial}``,
``exec.leaf_fused_route``, ``exec.leaf_route_fallback`` and its
per-reason ``exec.leaf_route_fallback.<reason>``,
``exec.q1_fused_route``, ``exec.q1_route_fallback``, and the runtime
join filters' ``join.filter_rows_in`` / ``join.filter_rows_pruned``,
added once per query), so a run can show which route each operator took.
A FULL OUTER probe counts no strategy, as in the JAX package. Readers
reset it themselves.

A two-key join counts as ``join.strategy.unique`` (its packed build takes
the sorted probe), as in the JAX package. String predicates take no
route there and count none here; the kernels' launches are counted on
their modules (``ops/cuda_strings.like_launches``, ``prefix_launches``).
"""

from __future__ import annotations

from collections import Counter

COUNTERS: Counter = Counter()
