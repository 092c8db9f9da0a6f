"""Runtime join filters: where a join's build side may prune a scan.

Counterpart of ``presto_tpu/plan/joinfilters.py``, the plan-side half of
sideways information passing: when a join's build side finishes, its key
domain (min/max and a two-hash Bloom bitmask) is pushed into the
probe-side table scan, so rows that cannot join are dropped at the scan
(their live bit cleared) before any operator above works on them. This
module decides where a filter may go; EXPLAIN and the executor
(``exec/local_planner.py``) both ask ``filter_edge_for``, so what EXPLAIN
renders is what runs.

Soundness rules, as in the JAX package:

- only INNER equi-joins and non-negated SEMI joins push filters (a probe
  row that cannot match adds nothing to their output); LEFT/FULL outer
  and ANTI joins keep unmatched probe rows;
- only single-key joins over numeric keys (the key normalization is the
  identity there, so build bounds are in the scan column's domain);
  VARCHAR and BYTES keys never get one;
- the probe key must trace back to a scan column through Filter and
  Project renames; a computed key does not.
"""

from __future__ import annotations

from typing import Optional

from presto_tpu_torch.expr import Expr, InputRef
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.types import TypeKind

#: key kinds whose join-key normalization is the identity
_FILTERABLE_KINDS = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DATE,
                     TypeKind.DECIMAL, TypeKind.TIMESTAMP)


def filterable_key_pair(lk: Expr, rk: Expr) -> bool:
    """May a filter derived from build key ``rk`` prune the scan column
    behind probe key ``lk``? Both must be numeric kinds."""
    return lk.dtype.kind in _FILTERABLE_KINDS and rk.dtype.kind in _FILTERABLE_KINDS


def probe_scan_target(node: N.PlanNode, key: Expr) -> Optional[tuple[N.TableScan, str]]:
    """The (scan node, scan output column) a probe key traces back to
    through Filter and Project renames, or None."""
    if not isinstance(key, InputRef):
        return None
    name = key.name
    while True:
        if isinstance(node, N.TableScan):
            return (node, name) if any(n == name for n, _src in node.columns) else None
        if isinstance(node, N.Filter):
            node = node.child
            continue
        if isinstance(node, N.Project):
            e = next((e for n, e in node.exprs if n == name), None)
            if not isinstance(e, InputRef):
                return None
            name = e.name
            node = node.child
            continue
        return None


def filter_edge_for(node: N.PlanNode) -> Optional[tuple[N.TableScan, str]]:
    """The (probe scan, scan column) a filter of this join's build side
    may prune, or None when the join is ineligible (module docstring)."""
    eligible = ((isinstance(node, N.Join) and node.kind == "inner")
                or (isinstance(node, N.SemiJoin) and not node.negated))
    if not eligible or len(node.left_keys) != 1 or len(node.right_keys) != 1:
        return None
    if not filterable_key_pair(node.left_keys[0], node.right_keys[0]):
        return None
    return probe_scan_target(node.left, node.left_keys[0])


def filter_edges(plan: N.PlanNode) -> list[tuple[N.PlanNode, N.TableScan, str]]:
    """Every (join node, probe scan, scan column) filter edge of the plan."""
    out = []

    def walk(n: N.PlanNode):
        if isinstance(n, (N.Join, N.SemiJoin)):
            tgt = filter_edge_for(n)
            if tgt is not None:
                out.append((n, tgt[0], tgt[1]))
        for c in n.children:
            walk(c)

    walk(plan)
    return out
