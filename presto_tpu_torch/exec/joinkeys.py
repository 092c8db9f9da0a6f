"""Join-key normalization: every join key becomes ONE integer column.

Counterpart of ``presto_tpu/exec/joinkeys.py``. The sorted and dense
probes stay single-key, so:

- an integer, date or decimal key passes through as it is;
- a BYTES key of at most 7 bytes packs exactly (``bytes_pack``,
  order-preserving, PAD SPACE); a wider one hashes to 63 bits
  (``bytes_hash``) and adds a verify pair, which the probe re-checks on
  the original bytes;
- a dictionary VARCHAR key joins on its codes when both sides provably
  share one dictionary; keys of two different dictionaries are
  materialized to comparable fixed-width BYTES (``dict_bytes``) and then
  packed or hashed as above; a key whose dictionary is unknown at plan
  time passes its codes through, and the probe's runtime guard refuses
  codes of two different dictionaries;
- a multi-key pair bit-packs into one int64,
  ``k0 << (w1 + ...) | ... | k_last``, with per-key widths from the
  connector stats intervals (``plan/bounds.py``) when they cover both
  sides, else from a runtime min/max over both sides (a device readback
  per key, paid only then);
- keys that cannot pack (a negative key, widths over 63 bits together,
  or a ``bytes_hash`` component) fold into one 63-bit FNV mix
  (``hash63_mix``) with a verify pair for every component that is not
  itself a ``bytes_hash``.

The JAX package also keeps a cross-query cache of runtime min/max
readbacks (``presto_tpu/cache/stats_cache.py``); the port has no cache
tier and reads them back in every query. A cached min/max equals the
readback, so the packing is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from presto_tpu_torch.expr import Call, Expr, InputRef, Literal, Unbound
from presto_tpu_torch.plan.bounds import expr_interval, key_dictionary, node_intervals
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.types import BIGINT, TypeKind, fixed_bytes


def declared_key_interval(node, key: Expr, catalog):
    """Connector-DECLARED (min, max) physical interval of a join key
    over a plan subtree, or None when unbounded. The runtime join
    filter starts from it before the build's own products exist."""
    iv = expr_interval(key, node_intervals(node, catalog))
    if iv is None:
        return None
    return (int(iv[0]), int(iv[1]))


def _has_unbound(obj) -> bool:
    """Does the subtree hold a scalar-subquery slot? Its rows then
    depend on a value bound outside it, so its content is no memo key."""
    if isinstance(obj, Unbound):
        return True
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(_has_unbound(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return any(_has_unbound(x) for x in obj)
    return False


def _content_key(node, key: Expr):
    """A query-scoped memo key for one runtime min/max: the plan
    subtree and key expression by content (equal subtrees carry the same
    rows), or None when they hold an unbound slot or do not hash."""
    if _has_unbound(node) or _has_unbound(key):
        return None
    try:
        hash((node, key))
    except TypeError:
        return None
    return ("minmax", node, key)


def _is_hash(e: Expr) -> bool:
    return isinstance(e, Call) and e.fn == "bytes_hash"


def join_key_exprs(lkeys: Sequence[Expr], rkeys: Sequence[Expr], *, catalog, lnode, rnode,
                   runtime_minmax: Callable[[int, Expr], tuple[int, int]] | None = None,
                   runtime_dict: Callable[[int, Expr], object] | None = None,
                   minmax_memo: dict | None = None):
    """Normalize (probe, build) key lists to ONE int64 pair.

    Returns ``(probe key, build key, verify)``: ``verify`` lists the
    (probe expr, build expr) pairs the probe must re-check by value
    (hash keys only). ``runtime_minmax(side, expr)`` -> (min, max) over
    the live, valid rows of that side (0: probe, 1: build), called only
    for a multi-key pair whose stats intervals do not give exact pack
    widths; ``minmax_memo``, a dict the executor keeps for one query,
    shares those readbacks between the query's joins by content.
    ``runtime_dict(side, expr)`` -> the dictionary a VARCHAR key column
    carries, asked when the plan does not show it."""
    verify: list[tuple[Expr, Expr]] = []

    def dict_of(node, side: int, e: Expr):
        if not (isinstance(e, InputRef) and e.dtype.kind is TypeKind.VARCHAR):
            return None
        d = key_dictionary(node, e.name, catalog)
        if d is None and runtime_dict is not None:
            d = runtime_dict(side, e)
        return d

    def as_bytes_pair(lk: Expr, rk: Expr):
        """BYTES normalization: pack (<= 7 bytes) or hash + verify."""
        if lk.dtype.width != rk.dtype.width:
            # equal CHAR values of different declared widths would
            # pack or hash differently (padding is part of the bytes)
            raise NotSupported("string join keys of unequal width")
        if lk.dtype.width <= 7:
            fn = "bytes_pack"
        else:
            fn = "bytes_hash"
            verify.append((lk, rk))
        return Call(BIGINT, fn, (lk,)), Call(BIGINT, fn, (rk,))

    def wrap(lk: Expr, rk: Expr):
        """-> (probe key, build key, unproven-dictionary flag)."""
        if lk.dtype.kind is TypeKind.VARCHAR or rk.dtype.kind is TypeKind.VARCHAR:
            if lk.dtype.kind is not rk.dtype.kind:
                raise NotSupported("join key type mismatch (VARCHAR vs non-VARCHAR); "
                                   "cast one side explicitly")
            dl, dr = dict_of(lnode, 0, lk), dict_of(rnode, 1, rk)
            if dl is not None and dl is dr:
                return lk, rk, False  # one shared dictionary: codes are exact
            if dl is not None and dr is not None:
                # different dictionaries: compare by value, not by code
                t = fixed_bytes(max(dl.max_bytes, dr.max_bytes, 1))
                return (*as_bytes_pair(Call(t, "dict_bytes", (lk,)),
                                       Call(t, "dict_bytes", (rk,))), False)
            # unprovable at plan time: codes pass through, and the probe's
            # runtime guard refuses two different dictionaries
            return lk, rk, True
        if lk.dtype.kind is TypeKind.BYTES:
            return (*as_bytes_pair(lk, rk), False)
        return lk, rk, False

    wrapped = [wrap(lk, rk) for lk, rk in zip(lkeys, rkeys)]
    lkeys = [w[0] for w in wrapped]
    rkeys = [w[1] for w in wrapped]
    if len(lkeys) == 1:
        return lkeys[0], rkeys[0], verify

    lenv = node_intervals(lnode, catalog)
    renv = node_intervals(rnode, catalog)
    memo = {} if minmax_memo is None else minmax_memo
    local: dict = {}  # identity keys never outlive this call

    def cached_minmax(side: int, key: Expr):
        if runtime_minmax is None:
            raise NotSupported(f"{len(lkeys)}-key join without stats intervals "
                               "needs a runtime min/max")
        ck = _content_key(lnode if side == 0 else rnode, key)
        cache, k = (local, (side, id(key))) if ck is None else (memo, ck)
        if k not in cache:
            cache[k] = runtime_minmax(side, key)
        return cache[k]

    def key_widths(use_stats: bool):
        """Per-key pack widths, or None when exact packing is impossible
        at this rung (a negative key would pack wrongly)."""
        widths = []
        for lk, rk in zip(lkeys, rkeys):
            mx = 0
            for side, env, key in ((0, lenv, lk), (1, renv, rk)):
                iv = expr_interval(key, env) if use_stats else None
                if iv is None:
                    iv = cached_minmax(side, key)
                mn, m = int(iv[0]), int(iv[1])
                if mn < 0:
                    return None
                mx = max(mx, m)
            widths.append(max(1, int(mx).bit_length()))
        return widths

    # a bytes_hash component fills the whole 63-bit budget by itself, so
    # with two or more keys no width ladder can succeed: straight to the mix
    has_hash = any(_is_hash(k) for pair in zip(lkeys, rkeys) for k in pair)
    widths = None if has_hash else key_widths(use_stats=True)
    if not has_hash and (widths is None or sum(widths) > 63):
        # stats intervals can be loose (derived-column keys): retry with
        # tight runtime minima/maxima for every key before falling back
        widths = key_widths(use_stats=False)
    if widths is None or sum(widths) > 63:
        # exact packing is impossible: ONE 63-bit FNV mix, candidates
        # verified on the key pairs (a bytes_hash component is already
        # verified on its original bytes)
        if any(w[2] for w in wrapped):
            raise NotSupported("multi-key hash fallback over a dictionary VARCHAR key "
                               "with unprovable dictionary provenance: codes are not "
                               "comparable across dictionaries")
        verify.extend((lk, rk) for lk, rk in zip(lkeys, rkeys) if not _is_hash(lk))
        return (Call(BIGINT, "hash63_mix", tuple(lkeys)),
                Call(BIGINT, "hash63_mix", tuple(rkeys)), verify)

    def pack(keys):
        e = Call(BIGINT, "cast_bigint", (keys[0],))
        for k, w in zip(keys[1:], widths[1:]):
            shifted = Call(BIGINT, "mul", (e, Literal(BIGINT, 1 << w)))
            e = Call(BIGINT, "add", (shifted, Call(BIGINT, "cast_bigint", (k,))))
        return e

    return pack(lkeys), pack(rkeys), verify
