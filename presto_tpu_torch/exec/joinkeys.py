"""Join-key normalization (the single-key subset).

Counterpart of ``presto_tpu/exec/joinkeys.py``. The port joins on ONE
integer-like key column per side, which the probes read as int64: an
integer, date or decimal key passes through as it is, and a dictionary
VARCHAR key joins on its codes when both sides provably share one
dictionary. Multi-key packing, the hash-and-verify route for BYTES keys
and cross-dictionary string keys raise ``NotSupported``.
"""

from __future__ import annotations

from typing import Sequence

from presto_tpu_torch.expr import Expr, InputRef
from presto_tpu_torch.plan.bounds import expr_interval, key_dictionary, node_intervals
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.types import TypeKind


def declared_key_interval(node, key: Expr, catalog):
    """Connector-DECLARED (min, max) physical interval of a join key
    over a plan subtree, or None when unbounded."""
    iv = expr_interval(key, node_intervals(node, catalog))
    if iv is None:
        return None
    return (int(iv[0]), int(iv[1]))


def join_key_exprs(lkeys: Sequence[Expr], rkeys: Sequence[Expr], *, catalog, lnode, rnode):
    """(probe key, build key, verify pairs) for one key pair. ``verify``
    is always empty here: no ported key needs a by-value re-check."""
    if len(lkeys) != 1 or len(rkeys) != 1:
        raise NotSupported(f"multi-key joins ({len(lkeys)} keys) are not ported yet")
    lk, rk = lkeys[0], rkeys[0]
    kinds = {lk.dtype.kind, rk.dtype.kind}
    if TypeKind.BYTES in kinds:
        raise NotSupported("joins on BYTES string keys (hash + verify) are not ported yet")
    if TypeKind.VARCHAR in kinds:
        if lk.dtype.kind is not rk.dtype.kind:
            raise NotSupported("join key type mismatch (VARCHAR vs non-VARCHAR); "
                               "cast one side explicitly")
        dl = key_dictionary(lnode, lk.name, catalog) if isinstance(lk, InputRef) else None
        dr = key_dictionary(rnode, rk.name, catalog) if isinstance(rk, InputRef) else None
        if dl is None or dl is not dr:
            raise NotSupported("joins on VARCHAR keys of different or unknown "
                               "dictionaries are not ported yet")
    return lk, rk, []
