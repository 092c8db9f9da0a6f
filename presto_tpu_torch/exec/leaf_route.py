"""The fused leaf route and the adaptive aggregation-strategy decision.

Counterpart of ``presto_tpu/exec/leaf_route.py`` (local execution):

**1. The leaf-fragment router.** :func:`match_leaf_fragment` recognizes
``scan -> {filter} -> partial-agg`` fragments: filter predicates as
interval tests over stats-bounded columns, aggregates drawn from
sum/count/avg(=sum+count)/min/max over products of at most two linear
terms, group keys packed from small dictionary/int domains into a flat
group id, and the keyless specialization (TPC-H Q6). A *filter-only*
join on the way down — a unique INNER join with no build-side outputs,
or a non-negated single-key semi join — folds into the fragment as a
dense membership bitmap over the probe key's declared domain (the SSB
Q1 flight's date join; TPC-H Q4's EXISTS wherever ``o_orderkey``'s
domain is at most ``MEMBER_DOMAIN_LIMIT``). Matched
fragments run as one fused step per scan batch: the leaf-aggregation
kernel (``ops/cuda_agg``, ``csrc/leaf_agg.cu``), or for TPC-H Q1 its
hand-built specialization (``exec/q1_route``, the Q1 kernel).

Admission (the JAX package's, copied): every routed column must DECLARE
NULL-freedom and value bounds; a runtime violation (``value_overflow``)
falls back to the generic operators, counted in
``exec.leaf_route_fallback`` (+ per-reason counters), never a wrong
answer. Fragments that are leaf-shaped but fail admission count the
same way. ``narrow_storage`` off disables routing (results identical).

**2. Adaptive aggregation strategy.** :func:`bypass_partial_agg` and
:func:`agg_strategy_for`, from stats, corrected by the plan-stats
history of a recurring fingerprint (``hints``).

On a mesh (:func:`execute_leaf_route_distributed`) the fused step runs
once per shard of the row-sharded scan and the [groups] states
all-reduce (sums, counts and flags add or OR, min and max take the min
and max). The steps and the state combine are shared across queries
through the executable cache (``leaf_route_step`` / ``leaf_route_fold`` /
``leaf_dist_step``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.expr import Call, Expr, InputRef, evaluate
from presto_tpu_torch.ops.cuda_agg import (
    MAX_GROUPS,
    LeafAggSpec,
    Term,
    ValueAgg,
    agg_step,
    combine_states,
    null_violation,
    state_keys,
    supported,
)
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.bounds import expr_interval
from presto_tpu_torch.runtime.faults import fault_point
from presto_tpu_torch.runtime.lifecycle import check_deadline
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.spi import batch_capacity, stats_physical_interval
from presto_tpu_torch.types import TypeKind

_INTEGERISH = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DECIMAL, TypeKind.DATE)

#: membership bitmaps cover at most this many key slots (a bool tensor
#: on the device; the SSB date domain is ~7e4)
MEMBER_DOMAIN_LIMIT = 1 << 22

#: int32 value domain every routed column must declare bounds inside
_I32 = (1 << 31) - 1

#: partial aggregation is bypassed when groups * BYPASS_RATIO exceeds
#: input rows (expected reduction factor below 2x) ...
BYPASS_RATIO = 2
#: ... and the group count is genuinely high (noise floor)
BYPASS_MIN_GROUPS = 1024


@dataclass(frozen=True)
class KeyDecode:
    """How one group-key output column decodes from the flat gid."""

    name: str
    dtype: object
    src: str  # source column (dictionary lookup)
    lo: int
    stride: int
    domain: int


@dataclass(frozen=True)
class Membership:
    """A filter-only join folded into the fragment: probe rows survive
    iff their key hits the build side's key set, tested via a dense
    bitmap over the probe column's DECLARED [lo, hi] domain."""

    build: object  # the build-side plan subtree (executed normally)
    build_key: Expr
    probe_col: str  # canonical (scan output) column name
    lo: int
    hi: int


class LeafRoute:
    """A matched leaf fragment, ready to execute."""

    __slots__ = ("kind", "scan", "q1", "spec", "src_cols", "rename",
                 "outputs", "key_out", "member")

    def __init__(self, kind, scan, q1=None, spec=None, src_cols=(),
                 rename=None, outputs=None, key_out=(), member=None):
        self.kind = kind  # "q1" | "generic"
        self.scan = scan
        self.q1 = q1  # exec/q1_route.Q1Route for the specialization
        self.spec = spec  # ops/cuda_agg.LeafAggSpec
        self.src_cols = list(src_cols)  # source columns to scan
        self.rename = dict(rename or {})  # source -> canonical name
        self.outputs = dict(outputs or {})  # agg name -> state key
        self.key_out = list(key_out)  # [KeyDecode]
        self.member = member


def _split_and(e: Expr, out: list) -> None:
    if isinstance(e, Call) and e.fn == "and":
        for a in e.args:
            _split_and(a, out)
    else:
        out.append(e)


def _const_physical(e: Expr) -> Optional[int]:
    """Physical value of a literal-only integerish expression (the
    analyzer leaves shapes like ``0.06 - 0.01`` unfolded), via the
    interval engine: a point interval is a constant."""
    if _refs(e):
        return None
    iv = expr_interval(e, {})
    if iv is None or iv[0] != iv[1]:
        return None
    return int(iv[0])


def _refs(e: Expr) -> set:
    from presto_tpu_torch.plan.prune import expr_refs

    out: set = set()
    expr_refs(e, out)
    return out


def _scale(dt) -> int:
    return dt.scale if dt.kind is TypeKind.DECIMAL else 0


def _rescaled_const(value: int, from_scale: int, to_scale: int,
                    fn: str) -> Optional[tuple[Optional[int], Optional[int]]]:
    """Closed [lo, hi] bounds on a column's OWN physical scale implied
    by ``col <fn> const`` where the comparison runs at scale
    ``max(from, to)`` (``expr._cmp_physicals``): exact integer bound
    conversion, or None for an unsupported comparison kind."""
    # comparison scale s = max(column scale, constant scale); the
    # column is compared as col * f with f = 10^(s - col_scale)
    s = max(from_scale, to_scale)
    lit = value * (10 ** (s - from_scale))
    f = 10 ** (s - to_scale)
    if fn == "le":  # col*f <= L  <=>  col <= floor(L/f)
        return (None, lit // f)
    if fn == "lt":  # col*f < L  <=>  col <= ceil(L/f) - 1
        return (None, -(-lit // f) - 1)
    if fn == "ge":
        return (-(-lit // f), None)
    if fn == "gt":
        return (lit // f + 1, None)
    if fn == "eq":
        if lit % f:
            return (1, 0)  # unsatisfiable: empty closed interval
        return (lit // f, lit // f)
    return None


def _interval_test(e: Expr) -> Optional[tuple[str, Optional[int], Optional[int]]]:
    """Parse one conjunct as a closed interval test over a single
    integerish column reference, bounds in the column's own physical
    scale. None: not an interval test (no route)."""
    if not isinstance(e, Call):
        return None
    if e.fn == "between" and len(e.args) == 3:
        ref, lo_e, hi_e = e.args
        if not (isinstance(ref, InputRef) and ref.dtype.kind in _INTEGERISH):
            return None
        lo_c, hi_c = _const_physical(lo_e), _const_physical(hi_e)
        if lo_c is None or hi_c is None:
            return None
        lo_b = _rescaled_const(lo_c, _scale(lo_e.dtype), _scale(ref.dtype), "ge")
        hi_b = _rescaled_const(hi_c, _scale(hi_e.dtype), _scale(ref.dtype), "le")
        if lo_b is None or hi_b is None:
            return None
        return (ref.name, lo_b[0], hi_b[1])
    if e.fn not in ("le", "lt", "ge", "gt", "eq") or len(e.args) != 2:
        return None
    a, b = e.args
    flip = {"le": "ge", "lt": "gt", "ge": "le", "gt": "lt", "eq": "eq"}
    if isinstance(a, InputRef) and a.dtype.kind in _INTEGERISH:
        ref, const, fn = a, b, e.fn
    elif isinstance(b, InputRef) and b.dtype.kind in _INTEGERISH:
        ref, const, fn = b, a, flip[e.fn]
    else:
        return None
    c = _const_physical(const)
    if c is None:
        return None
    bounds = _rescaled_const(c, _scale(const.dtype), _scale(ref.dtype), fn)
    return None if bounds is None else (ref.name, bounds[0], bounds[1])


# ---------------------------------------------------------------------------
# value grammar: products of at most two linear terms, exact scales
# ---------------------------------------------------------------------------


def _parse_term(e: Expr, col_idx) -> Optional[Term]:
    """``c0 + c1 * col`` over physical ints at the term's own scale;
    None when the shape or a rescale is inexact."""
    if isinstance(e, InputRef):
        if e.dtype.kind not in _INTEGERISH:
            return None
        i = col_idx(e.name)
        return None if i is None else Term(i, 0, 1)
    c = _const_physical(e)
    if c is not None:
        return Term(-1, c, 0)
    if not (isinstance(e, Call) and e.fn in ("add", "sub")
            and len(e.args) == 2 and e.dtype.kind in _INTEGERISH):
        return None
    s_out = _scale(e.dtype)
    a, b = e.args
    ca, cb = _const_physical(a), _const_physical(b)
    sign = -1 if e.fn == "sub" else 1
    if ca is not None and isinstance(b, InputRef):
        const, const_s, col = ca, _scale(a.dtype), b
        col_sign, const_sign = sign, 1
    elif cb is not None and isinstance(a, InputRef):
        const, const_s, col = cb, _scale(b.dtype), a
        col_sign, const_sign = 1, sign
    else:
        return None
    if col.dtype.kind not in _INTEGERISH:
        return None
    s_col = _scale(col.dtype)
    # evaluate() brings both sides to decimal(38, out.scale): exact
    # only when neither side is scaled DOWN
    if s_out < const_s or s_out < s_col:
        return None
    i = col_idx(col.name)
    if i is None:
        return None
    return Term(i, const_sign * const * (10 ** (s_out - const_s)),
                col_sign * (10 ** (s_out - s_col)))


def _parse_value(op: str, e: Expr, col_idx, env) -> Optional[ValueAgg]:
    """One aggregate input as a ValueAgg, with the |value| bit bound
    proven from the declared column intervals (``env``). None: outside
    the grammar, or unboundable."""
    a = b = None
    t = _parse_term(e, col_idx)
    if t is not None:
        a = t
    elif isinstance(e, Call) and e.fn == "mul" and len(e.args) == 2:
        u, v = e.args
        su, sv = _scale(u.dtype), _scale(v.dtype)
        if e.dtype.kind is TypeKind.DECIMAL and su + sv != _scale(e.dtype):
            return None  # excess-scale rounding: not an exact product
        a, b = _parse_term(u, col_idx), _parse_term(v, col_idx)
        if a is None or b is None:
            return None
    else:
        return None
    iv = expr_interval(e, env)
    if iv is None:
        return None
    bits = max(1, max(abs(iv[0]), abs(iv[1])).bit_length())
    if bits > 63:
        return None
    # the JAX package's int32-exactness proof (its TPU kernel multiplies
    # in int32): a term whose hull or raw coefficients pass int32 marks
    # the value bits > 31. Kept so both packages build the same spec;
    # the CUDA kernel is int64 throughout. Coefficients past 2^62 are
    # rejected outright (the int64 intermediates need the headroom)
    for t in (a, b):
        if t is None:
            continue
        if abs(t.c0) > (1 << 62) or abs(t.c1) > (1 << 62):
            return None
        if max(abs(t.c0), abs(t.c1)) > _I32:
            bits = max(bits, 32)
        if t.col < 0:
            continue
        civ = env.get(col_idx.names[t.col])
        if civ is None:
            return None
        if abs(t.c1) * max(abs(civ[0]), abs(civ[1]), 1) > (1 << 62):
            return None
        lo = t.c0 + min(t.c1 * civ[0], t.c1 * civ[1])
        hi = t.c0 + max(t.c1 * civ[0], t.c1 * civ[1])
        if max(abs(lo), abs(hi)) > _I32:
            bits = max(bits, 32)
    return ValueAgg(op, a, b, bits)


class _ColIndex:
    """Interns canonical column names to spec column indices."""

    def __init__(self, allowed):
        self.allowed = allowed  # name -> declared interval (or None)
        self.names: list[str] = []
        self._idx: dict[str, int] = {}

    def __call__(self, name: str) -> Optional[int]:
        if name not in self.allowed:
            return None
        i = self._idx.get(name)
        if i is None:
            i = len(self.names)
            self._idx[name] = i
            self.names.append(name)
        return i


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

#: membership keys must normalize as the IDENTITY on both sides
#: (DECIMAL excluded: scale alignment is the join normalizer's business)
_MEMBER_KINDS = (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DATE)


def match_leaf_fragment(node, catalog):
    """Recognize a routable leaf fragment under ``node``.

    Returns ``(route, reason)``: a :class:`LeafRoute` on a match; on a
    miss, ``reason`` is a fallback-counter tag when the fragment WAS
    leaf-shaped (scan -> filters [-> filter-only join] -> partial agg)
    but failed admission (stats gaps, grammar, domains), or None when
    the node simply isn't a leaf fragment (joins with outputs, nested
    aggregates, ...) — only admission failures are "fallbacks"."""
    from presto_tpu_torch.exec.q1_route import match_q1_fragment
    from presto_tpu_torch.spi import narrow_enabled

    if not isinstance(node, N.Aggregate) or node.passengers:
        return None, None
    if not narrow_enabled():
        # narrowing is what arms the kernels; with it off the generic
        # route is the honest baseline (results identical)
        return None, None
    q1 = match_q1_fragment(node, catalog)
    if q1 is not None:
        return LeafRoute("q1", q1.scan, q1=q1, src_cols=list(q1.rename),
                         rename=dict(q1.rename), outputs=dict(q1.outputs)), None

    conjuncts: list = []
    n = node.child
    while isinstance(n, N.Filter):
        _split_and(n.predicate, conjuncts)
        n = n.child
    member_node = mkey = None
    if isinstance(n, N.Join):
        if not (n.kind == "inner" and n.unique and not n.output_right
                and len(n.left_keys) == 1 and len(n.right_keys) == 1):
            return None, None  # a real join: not a filter-only leaf
        member_node, probe, mkey = n, n.left, n.left_keys[0]
    elif isinstance(n, N.SemiJoin):
        if n.negated or len(n.left_keys) != 1 or len(n.right_keys) != 1:
            return None, None
        member_node, probe, mkey = n, n.left, n.left_keys[0]
    if member_node is not None:
        n = probe
        while isinstance(n, N.Filter):
            _split_and(n.predicate, conjuncts)
            n = n.child
    if not isinstance(n, N.TableScan):
        return None, None
    scan = n
    if scan.predicate is not None:
        _split_and(scan.predicate, conjuncts)

    # ---- the fragment IS leaf-shaped; misses are loud from here ------
    conn = catalog.connectors.get(scan.connector)
    if conn is None:
        return None, "connector"
    try:
        dicts = conn.dictionaries(scan.table)
        schema = conn.schema(scan.table)
    except (KeyError, AttributeError):
        return None, "connector"
    out_to_src = dict(scan.columns)
    if len(set(out_to_src.values())) != len(out_to_src):
        return None, "column"  # aliased duplicate source columns

    used: set = set()
    for _name, e in node.keys:
        used |= _refs(e)
    for a in node.aggs:
        if a.input is not None:
            used |= _refs(a.input)
    for c in conjuncts:
        used |= _refs(c)
    if mkey is not None:
        used |= _refs(mkey)

    env: dict = {}
    for name in used:
        src = out_to_src.get(name)
        if src is None:
            return None, "column"  # references a computed column
        stats = catalog.stats(scan.connector, scan.table, src)
        if stats is None or getattr(stats, "null_fraction", 1.0):
            return None, "stats"  # NULL-freedom/bounds must be DECLARED
        if schema[src].kind is TypeKind.VARCHAR:
            d = dicts.get(src)
            iv = (0, max(len(d) - 1, 0)) if d is not None else None
        else:
            iv = stats_physical_interval(stats, schema[src])
        if iv is None or iv[0] < -_I32 - 1 or iv[1] > _I32:
            return None, "stats"  # unbounded / outside int32
        env[name] = (int(iv[0]), int(iv[1]))

    col_idx = _ColIndex(env)

    # ---- group keys: small packed domains ----------------------------
    key_info = []
    G = 1
    for out_name, e in node.keys:
        if not isinstance(e, InputRef) or e.name not in env:
            return None, "key_shape"
        src = out_to_src[e.name]
        if e.dtype.kind is TypeKind.VARCHAR and dicts.get(src) is None:
            return None, "key_domain"
        lo, hi = env[e.name]
        domain = hi - lo + 1
        if domain < 1 or domain > MAX_GROUPS:
            return None, "key_domain"
        G *= domain
        if G > MAX_GROUPS:
            return None, "key_domain"
        key_info.append((out_name, e, src, lo, domain))
    strides = []
    acc = 1
    for *_rest, domain in reversed(key_info):
        strides.append(acc)
        acc *= domain
    strides.reverse()
    keys_spec = []
    key_out = []
    for (out_name, e, src, lo, domain), stride in zip(key_info, strides):
        keys_spec.append((col_idx(e.name), lo, stride))
        key_out.append(KeyDecode(out_name, e.dtype, src, lo, stride, domain))

    # ---- aggregates --------------------------------------------------
    outputs: dict = {}
    values: list = []
    for a in node.aggs:
        if a.kind == "count_star":
            outputs[a.name] = "count"
            continue
        if a.kind == "count":
            # NULL-free columns make count(col) == count(*) — proven by
            # the declared null_fraction == 0 admission above
            if isinstance(a.input, InputRef) and a.input.name in env:
                col_idx(a.input.name)
                outputs[a.name] = "count"
                continue
            return None, "agg_kind"
        if a.kind not in ("sum", "min", "max") or a.input is None:
            return None, "agg_kind"
        v = _parse_value(a.kind, a.input, col_idx, env)
        if v is None:
            return None, "value_shape"
        outputs[a.name] = f"{a.kind}_{len(values)}"
        values.append(v)

    # ---- filters: intersected closed intervals per column ------------
    fmap: dict = {}
    for c in conjuncts:
        t = _interval_test(c)
        if t is None:
            return None, "filter_shape"
        name, lo, hi = t
        if name not in env:
            return None, "column"
        i = col_idx(name)
        old = fmap.get(i, (None, None))
        if lo is not None:
            lo = lo if old[0] is None else max(lo, old[0])
        else:
            lo = old[0]
        if hi is not None:
            hi = hi if old[1] is None else min(hi, old[1])
        else:
            hi = old[1]
        fmap[i] = (lo, hi)

    # ---- membership (the filter-only join) ---------------------------
    member = None
    if member_node is not None:
        rk = member_node.right_keys[0]
        if not (isinstance(mkey, InputRef)
                and mkey.dtype.kind in _MEMBER_KINDS
                and rk.dtype.kind in _MEMBER_KINDS):
            return None, "membership"
        lo, hi = env[mkey.name]
        if hi - lo + 1 > MEMBER_DOMAIN_LIMIT:
            return None, "membership"
        col_idx(mkey.name)
        member = Membership(member_node.right, rk, mkey.name, lo, hi)

    # guards: declared intervals of every column whose values feed the
    # arithmetic (keys and value terms) — the runtime stats check
    guard_cols = {i for i, _lo, _s in keys_spec}
    for v in values:
        for t in (v.a, v.b):
            if t is not None and t.col >= 0:
                guard_cols.add(t.col)
    guards = tuple((i, env[col_idx.names[i]][0], env[col_idx.names[i]][1])
                   for i in sorted(guard_cols))
    if not col_idx.names:
        # a bare count(*) over an unfiltered scan references no columns
        # at all — there is nothing to fuse; the generic route is
        # already optimal (not a fallback)
        return None, None
    # clamp filter bounds into int32 (the JAX package's kernel casts
    # them to int32; every admitted column stores <= int32 with the
    # dtype extreme kept free, so the clamp is exact) — a bound past the
    # int32 edge is always-true, a crossed pair is unsatisfiable
    filters = []
    for i, (lo, hi) in sorted(fmap.items()):
        if (lo is not None and lo > _I32) or (hi is not None and hi < -_I32 - 1):
            lo, hi = 1, 0  # unsatisfiable closed interval
        else:
            if lo is not None:
                lo = max(lo, -_I32 - 1)
            if hi is not None:
                hi = min(hi, _I32)
        filters.append((i, lo, hi))
    spec = LeafAggSpec(
        cols=tuple(col_idx.names),
        filters=tuple(filters),
        keys=tuple(keys_spec),
        groups=G,
        values=tuple(values),
        guards=guards,
    )
    if not supported(spec):
        # beyond one kernel launch's columns or values: the generic
        # operators answer (ROADMAP C9)
        return None, "kernel_limits"
    src_cols = [out_to_src[c] for c in col_idx.names]
    rename = {out_to_src[c]: c for c in col_idx.names}
    return LeafRoute("generic", scan, spec=spec, src_cols=src_cols, rename=rename,
                     outputs=outputs, key_out=key_out, member=member), None


def count_fallback(reason: str) -> None:
    """One aggregate counter plus a per-reason counter, so 'why didn't
    this leaf route?' is always answerable from the counters."""
    REGISTRY.counter("exec.leaf_route_fallback").add()
    REGISTRY.counter(f"exec.leaf_route_fallback.{reason}").add()


# ---------------------------------------------------------------------------
# execution — local
# ---------------------------------------------------------------------------


def _membership_bitmap(member: Membership, batches, device) -> torch.Tensor:
    """Dense bool bitmap over the probe key's declared [lo, hi] domain
    from the executed build side, on ``device`` (NULL build keys never
    match; build keys outside the probe's declared domain cannot match
    in-range probe rows, so dropping them is exact)."""
    lo, hi = member.lo, member.hi
    bitmap = torch.zeros(hi - lo + 1, dtype=torch.bool, device=device)
    for b in batches:
        v = evaluate(member.build_key, b)
        keep = b.live if v.valid is None else b.live & v.valid
        k = v.data.to(torch.int64)
        keep = keep & (k >= lo) & (k <= hi)
        bitmap[(k[keep] - lo).to(device)] = True
    return bitmap


def _apply_membership(batch: Batch, probe_col: str, lo: int, hi: int, bitmap):
    """AND the membership test into the live mask, keeping every
    NULL-free column's validity the live mask. Returns ``(batch, oob)``:
    ``oob`` flags any live non-NULL probe key OUTSIDE the declared
    [lo, hi] domain — such a row has no bitmap slot but the generic join
    might match it, so the caller treats the flag exactly like
    ``value_overflow`` (fall back loudly, never silently drop the row).
    NULL keys never match a join and are dropped without flagging."""
    c = batch[probe_col]
    k = c.data.to(torch.int64)
    in_range = (k >= lo) & (k <= hi)
    considered = batch.live if c.valid is None else batch.live & c.valid
    oob = torch.any(considered & ~in_range)
    idx = torch.clamp(k - lo, 0, hi - lo)
    keep = in_range & bitmap[idx]
    if c.valid is not None:
        keep = keep & c.valid
    live = batch.live & keep
    cols = {name: Column(col.data, live if col.valid is not None else None,
                         col.dtype, col.dictionary)
            for name, col in batch.columns.items()}
    return Batch(cols, live), oob


def decode_leaf_state(route: LeafRoute, conn, aggs, state) -> Batch:
    """Decode a combined [groups] state into the Aggregate's output
    batch — key columns reconstructed from the flat gid by stride,
    aggregate columns with the generic route's NULL semantics (empty
    groups: counts 0, sums/mins/maxes NULL; a keyless fragment always
    emits its one row, like GlobalAggregationOperator)."""
    G = route.spec.groups
    dicts = conn.dictionaries(route.scan.table)
    present = state["present"]
    dev = present.device
    all_true = torch.ones(G, dtype=torch.bool, device=dev)
    live = present if route.key_out else all_true
    gid = torch.arange(G, dtype=torch.int32, device=dev)
    cols = {}
    for kd in route.key_out:
        code = kd.lo + torch.div(gid, kd.stride, rounding_mode="floor") % kd.domain
        cols[kd.name] = Column(code.to(kd.dtype.torch_dtype), all_true, kd.dtype,
                               dicts.get(kd.src))
    for a in aggs:
        skey = route.outputs[a.name]
        if skey == "count":
            cols[a.name] = Column(state["count"].to(a.dtype.torch_dtype), all_true, a.dtype)
        else:
            data = torch.where(present, state[skey], torch.zeros_like(state[skey]))
            cols[a.name] = Column(data.to(a.dtype.torch_dtype), present, a.dtype)
    return Batch(cols, live)


def _local_step(spec, mb):
    """The routed fragment's step over one scan batch: the membership
    bitmap (``mb`` = probe column, lo, hi) applied when the fragment
    folded a filter-only join, then the fused filter + aggregate."""

    def step(b: Batch, bitmap):
        # declared NULL-freedom's runtime check, on the PRE-membership
        # batch (membership rebuilds validity as the live mask)
        nulls = null_violation(b)
        oob = None
        if bitmap is not None:
            b, oob = _apply_membership(b, mb[0], mb[1], mb[2], bitmap)
        s = agg_step(spec, b)
        s["value_overflow"] = s["value_overflow"] | nulls
        if oob is not None:
            s["value_overflow"] = s["value_overflow"] | oob
        return s

    return step


def execute_leaf_route(route: LeafRoute, executor, node, scalars):
    """Run a matched fragment on the local executor: stream scan splits
    through the fused step (membership bitmap applied per batch when the
    fragment folded a filter-only join), combine states, decode. None on
    runtime ``value_overflow`` (violated advisory stats) — counted, and
    the caller falls back to the generic operator route."""
    from presto_tpu_torch.exec.pipeline import prefetch_iter

    catalog = executor.catalog
    if route.kind == "q1":
        from presto_tpu_torch.exec.q1_route import execute_q1_route

        q1_conn = catalog.connector(route.q1.scan.connector)
        if not list(q1_conn.splits(route.q1.scan.table)):
            return None  # empty table: nothing to stream (not a fallback)
        out = execute_q1_route(route.q1, catalog, node.aggs)
        if out is None:
            count_fallback("value_overflow")
            return None
        REGISTRY.counter("exec.leaf_fused_route").add()
        return out

    fault_point("aggregation")
    fault_point("step.agg")
    spec = route.spec
    scan = route.scan
    conn = catalog.connector(scan.connector)
    bitmap = None
    if route.member is not None:
        build = executor._exec(route.member.build, scalars).materialize()
        bitmap = _membership_bitmap(route.member, build, conn.device)
    splits = list(conn.splits(scan.table))
    if not splits:
        return None
    cap = batch_capacity(max(s.row_hint for s in splits))

    def load(split):
        fault_point("scan")
        return conn.scan(split, route.src_cols, cap).rename(route.rename)

    mb = None if route.member is None else (route.member.probe_col, route.member.lo,
                                            route.member.hi)
    # the step and the combine are shared across queries through the
    # executable cache
    fold = EXEC_CACHE.get_or_build(EXEC_CACHE.key_of("leaf_route_fold", tuple(state_keys(spec))),
                                   lambda: lambda a, b: combine_states(spec, a, b))
    state = None
    step = None
    for b in prefetch_iter(load, splits):
        # the query's deadline and cancel scope, per split, on its thread
        check_deadline("scan")
        if step is None:
            step = EXEC_CACHE.get_or_build(
                EXEC_CACHE.key_of("leaf_route_step", spec, mb, b.device.type),
                lambda: _local_step(spec, mb))
        s = step(b, bitmap)
        state = s if state is None else fold(state, s)
    if bool(state["value_overflow"]):  # read once, after the last split
        count_fallback("value_overflow")
        return None
    REGISTRY.counter("exec.leaf_fused_route").add()
    return [decode_leaf_state(route, conn, node.aggs, state)]


# ---------------------------------------------------------------------------
# execution — distributed
# ---------------------------------------------------------------------------


def _dist_step(spec, member_bounds, q1: bool):
    """The routed fragment's step over one shard of a row-sharded scan:
    the membership bitmap applied when the fragment folded a filter-only
    join, then the Q1 step (``workloads.q1_fused_step``, the Q1 kernel on
    a CUDA shard) or the fused leaf step (the leaf kernel on a CUDA
    shard), at the shard's capacity."""

    def step(b: Batch, bitmap):
        nulls = null_violation(b)
        oob = None
        if bitmap is not None:
            col, lo, hi = member_bounds
            b, oob = _apply_membership(b, col, lo, hi, bitmap)
        if q1:
            from presto_tpu_torch.workloads import q1_fused_step

            state = q1_fused_step(b)
        else:
            state = agg_step(spec, b)
        state["value_overflow"] = state["value_overflow"] | nulls
        if oob is not None:
            state["value_overflow"] = state["value_overflow"] | oob
        return state

    return step


def execute_leaf_route_distributed(route: LeafRoute, executor, node, scalars):
    """Run a matched fragment on the DISTRIBUTED executor: the row-sharded
    scan feeds the fused step once per shard, and the partial states
    all-reduce into one replicated [groups] state (sums, counts and flags
    add or OR; min and max states take the min and max:
    ``workloads.allreduce_state``), decoded on the host. Returns the
    output batch, or None on a runtime ``value_overflow`` anywhere
    (counted; the caller falls back)."""
    from presto_tpu_torch.parallel.mesh import shards_of
    from presto_tpu_torch.workloads import allreduce_state

    fault_point("aggregation")
    fault_point("step.agg")
    conn = executor.catalog.connector(route.scan.connector)
    d = executor._exec(route.scan, scalars)
    b = d.batch
    # canonical names for the step (q1: the kernel's; generic: the scan
    # output names the spec was built over)
    rename_out = {out: route.rename[src] for out, src in route.scan.columns
                  if src in route.rename}
    b = b.select(list(rename_out)).rename(rename_out)
    bitmap = None
    member_bounds = None
    if route.member is not None:
        dm = executor._exec(route.member.build, scalars)
        mb = executor._replicate(dm).batch
        bitmap = _membership_bitmap(route.member, [mb], b.device)
        m = route.member
        member_bounds = (rename_out.get(m.probe_col, m.probe_col), m.lo, m.hi)
    q1 = route.kind == "q1"
    step = EXEC_CACHE.get_or_build(
        EXEC_CACHE.key_of("leaf_dist_step", "q1" if q1 else route.spec, member_bounds,
                          executor._mesh_fp, b.device.type),
        lambda: _dist_step(route.spec, member_bounds, q1))
    mesh = executor.mesh
    states = [step(sb, None if bitmap is None else bitmap.to(sb.device))
              for sb in shards_of(b, mesh)]
    state = allreduce_state(states)
    if bool(state["value_overflow"]):
        count_fallback("value_overflow")
        return None
    REGISTRY.counter("exec.leaf_fused_route").add()
    if q1:
        from presto_tpu_torch.exec.q1_route import decode_q1_state

        REGISTRY.counter("exec.q1_fused_route").add()
        return decode_q1_state(route.q1, conn, node.aggs, state)
    return decode_leaf_state(route, conn, node.aggs, state)


# ---------------------------------------------------------------------------
# adaptive aggregation strategy
# ---------------------------------------------------------------------------


def bypass_partial_agg(node, catalog, hints=None) -> bool:
    """Should this keyed aggregation BYPASS partial aggregation and
    stream rows to one final pass? True when the group cardinality is
    high relative to input rows (reduction factor under
    ``BYPASS_RATIO``) and genuinely large (``BYPASS_MIN_GROUPS``).
    Observed history (``hints``: plan-stats records of a recurring
    fingerprint, keyed by ``id(plan node)``) beats the NDV estimate."""
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
    rec = hints.get(id(node)) if hints else None
    if rec is not None and rec.get("actual_rows", -1) >= 0:
        groups = rec["actual_rows"]
        crec = hints.get(id(node.child))
        rows = crec.get("actual_rows", -1) if crec else -1
        if rows < 0 and rec.get("selectivity", -1.0) > 0:
            rows = int(round(groups / rec["selectivity"]))
        if rows > 0:
            return groups >= BYPASS_MIN_GROUPS and groups * BYPASS_RATIO > rows
        return False  # observed empty input: nothing to bypass
    g = estimate_groups(node, catalog)
    if g is None:
        return False
    rows = estimate_rows(node.child, catalog)
    return g >= BYPASS_MIN_GROUPS and g * BYPASS_RATIO > rows


def agg_strategy_for(node, catalog, hints=None, fused_enabled: bool = True,
                     bypass_enabled: bool = True) -> str:
    """The aggregation strategy the executor will pick for this node,
    from stats alone: ``fused`` (the leaf route) > ``bypass`` (stream
    rows to one final pass) > ``partial`` (per-morsel folds); keyless
    unrouted aggregation is ``single``. Advisory: a runtime
    ``value_overflow`` degrades fused to the generic route, counted.
    ``hints`` is the plan-stats history of a recurring fingerprint;
    ``fused_enabled=False`` describes runs that skip the leaf route (a
    stats recorder is attached: EXPLAIN ANALYZE, ``Session.execute``);
    ``bypass_enabled`` is the ``partial_agg_bypass`` session property."""
    if not isinstance(node, N.Aggregate):
        return ""
    if fused_enabled:
        route, _reason = match_leaf_fragment(node, catalog)
        if route is not None:
            return "fused"
    if not node.keys:
        return "single"
    if bypass_enabled and bypass_partial_agg(node, catalog, hints=hints):
        return "bypass"
    return "partial"
