"""Join-key normalization: every join key becomes ONE integer column.

Counterpart of ``presto_tpu/exec/joinkeys.py`` for integer-like keys. An
integer, date or decimal key passes through as it is, and a dictionary
VARCHAR key joins on its codes when both sides provably share one
dictionary. A multi-key pair bit-packs into one int64,
``k0 << (w1 + ...) | ... | k_last``, with per-key widths from the
connector stats intervals (``plan/bounds.py``) when they cover both sides,
else from a runtime min/max over both sides (a device readback per key,
paid only then). The hash-and-verify route for BYTES keys, the 63-bit mix
for keys that cannot pack (negative or wider than 63 bits together) and
cross-dictionary string keys raise ``NotSupported``.
"""

from __future__ import annotations

from typing import Callable, Sequence

from presto_tpu_torch.expr import Call, Expr, InputRef, Literal
from presto_tpu_torch.plan.bounds import expr_interval, key_dictionary, node_intervals
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.types import BIGINT, TypeKind


def declared_key_interval(node, key: Expr, catalog):
    """Connector-DECLARED (min, max) physical interval of a join key
    over a plan subtree, or None when unbounded."""
    iv = expr_interval(key, node_intervals(node, catalog))
    if iv is None:
        return None
    return (int(iv[0]), int(iv[1]))


def _check_pair(lk: Expr, rk: Expr, catalog, lnode, rnode) -> None:
    """Refuse the key pairs the port cannot join exactly."""
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


def join_key_exprs(lkeys: Sequence[Expr], rkeys: Sequence[Expr], *, catalog, lnode, rnode,
                   runtime_minmax: Callable[[int, Expr], tuple[int, int]] | None = None):
    """(probe key, build key, verify pairs). ``verify`` is always empty:
    no ported key needs a by-value re-check.

    ``runtime_minmax(side, expr)`` -> (min, max) over the live, valid
    rows of that side (0: probe, 1: build); called only for a multi-key
    pair whose stats intervals do not give exact pack widths."""
    for lk, rk in zip(lkeys, rkeys):
        _check_pair(lk, rk, catalog, lnode, rnode)
    if len(lkeys) == 1:
        return lkeys[0], rkeys[0], []
    lenv = node_intervals(lnode, catalog)
    renv = node_intervals(rnode, catalog)
    memo: dict = {}

    def minmax(side: int, key: Expr):
        if runtime_minmax is None:
            return None
        k = (side, id(key))
        if k not in memo:
            memo[k] = runtime_minmax(side, key)
        return memo[k]

    def key_widths(use_stats: bool):
        """Per-key pack widths, or None when exact packing is impossible
        at this rung (a negative key would pack wrongly)."""
        widths = []
        for lk, rk in zip(lkeys, rkeys):
            mx = 0
            for side, env, key in ((0, lenv, lk), (1, renv, rk)):
                iv = expr_interval(key, env) if use_stats else None
                if iv is None:
                    iv = minmax(side, key)
                if iv is None:
                    raise NotSupported(f"{len(lkeys)}-key join without stats intervals "
                                       "needs a runtime min/max")
                mn, m = int(iv[0]), int(iv[1])
                if mn < 0:
                    return None
                mx = max(mx, m)
            widths.append(max(1, int(mx).bit_length()))
        return widths

    widths = key_widths(use_stats=True)
    if widths is None or sum(widths) > 63:
        # stats intervals can be loose (derived-column keys): retry with
        # tight runtime minima/maxima for every key before giving up
        widths = key_widths(use_stats=False)
    if widths is None or sum(widths) > 63:
        raise NotSupported(f"{len(lkeys)}-key join whose keys do not pack into 63 bits "
                           "(the hash-and-verify mix) is not ported yet")

    def pack(keys):
        e = Call(BIGINT, "cast_bigint", (keys[0],))
        for k, w in zip(keys[1:], widths[1:]):
            shifted = Call(BIGINT, "mul", (e, Literal(BIGINT, 1 << w)))
            e = Call(BIGINT, "add", (shifted, Call(BIGINT, "cast_bigint", (k,))))
        return e

    return pack(list(lkeys)), pack(list(rkeys)), []
