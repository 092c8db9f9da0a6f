"""The adaptive aggregation-strategy decision.

Counterpart of the strategy half of ``presto_tpu/exec/leaf_route.py``:
``bypass_partial_agg`` is copied as it is there. The fused leaf route
itself (the generalized leaf-aggregation kernel) is not ported yet, so
``agg_strategy_for`` never answers ``fused``; no aggregation of the
ported queries (joins below every keyed aggregate) matches it.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.expr import InputRef
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.types import TypeKind

#: partial aggregation is bypassed when groups * BYPASS_RATIO exceeds
#: input rows (expected reduction factor below 2x) ...
BYPASS_RATIO = 2
#: ... and the group count is genuinely high (noise floor)
BYPASS_MIN_GROUPS = 1024


def bypass_partial_agg(node, catalog) -> bool:
    """Should this keyed aggregation BYPASS partial aggregation and
    stream rows to one final pass? True when the estimated group
    cardinality is high relative to input rows (reduction factor under
    ``BYPASS_RATIO``) and genuinely large (``BYPASS_MIN_GROUPS``). The
    JAX package also reads plan-stats history here; the port has none,
    which is the first run of every query there."""
    from presto_tpu_torch.exec.local_planner import DIRECT_LIMIT
    from presto_tpu_torch.plan.bounds import estimate_groups, estimate_rows, key_dictionary

    if not isinstance(node, N.Aggregate) or not node.keys:
        return False
    # dense direct-addressed dictionary domains: the fold is an O(rows)
    # segment-sum into a tiny state — partial always wins there
    domains = []
    for name, e in node.keys:
        if not (isinstance(e, InputRef) and e.dtype.kind is TypeKind.VARCHAR):
            domains = None
            break
        d = key_dictionary(node.child, name, catalog)
        if d is None:
            domains = None
            break
        domains.append(len(d))
    if domains and int(np.prod(domains)) <= DIRECT_LIMIT:
        return False
    g = estimate_groups(node, catalog)
    if g is None:
        return False
    rows = estimate_rows(node.child, catalog)
    return g >= BYPASS_MIN_GROUPS and g * BYPASS_RATIO > rows


def agg_strategy_for(node, catalog) -> str:
    """The aggregation strategy the executor will pick for this node,
    from stats alone: ``bypass`` (stream rows to one final pass) >
    ``partial`` (per-morsel folds); keyless aggregation is ``single``."""
    if not isinstance(node, N.Aggregate):
        return ""
    if not node.keys:
        return "single"
    if bypass_partial_agg(node, catalog):
        return "bypass"
    return "partial"
