"""SQL-path routing onto the fused TPC-H Q1 leaf kernel.

Counterpart of ``presto_tpu/exec/q1_route.py``: recognizes the Q1 leaf
fragment (scan -> shipdate filter -> 6-group partial aggregation) inside
an analyzed plan and runs it through ``workloads.q1_fused_step``, which
on a CUDA batch is the Q1 kernel (``ops/cuda_q1``, ``csrc/q1.cu``). It is
the hand-built specialization of the fused leaf route
(``exec/leaf_route.py`` tries it first): Q1's 3-factor ``charge`` product
is outside the 2-term value grammar of ``ops/cuda_agg``.

Matching is STRICT and stats-guarded, as in the JAX package: the
shipdate cutoff literal, the ``ep*(1-disc)`` / ``ep*(1-disc)*(1+tax)``
product shapes, decimal scales, the 3x2 returnflag/linestatus
dictionary domains, and every scanned column's declared bounds (qty <
2^13, ep < 2^24, disc in [0, 100], tax in [0, 27], scaled) and
NULL-freedom must line up. A runtime ``value_overflow`` (violated
stats) falls back to the generic route, counted. The JAX package's
executable cache and fault points have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.exec.pipeline import prefetch_iter
from presto_tpu_torch.expr import Call, InputRef, Literal
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.runtime.faults import fault_point
from presto_tpu_torch.runtime.lifecycle import check_deadline
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.spi import batch_capacity, stats_physical_interval
from presto_tpu_torch.types import TypeKind

#: l_shipdate <= date '1998-12-01' - interval '90' day, the kernel's
#: baked-in cutoff (ops/cuda_q1.CUTOFF)
CUTOFF_DAYS = int(np.datetime64("1998-09-02").astype("datetime64[D]").astype(np.int64))

#: kernel value-domain guards over the SCALED (physical) values — the
#: in-kernel overflow guard's: a column whose DECLARED bounds exceed
#: these never routes
_DOMAINS = {
    "l_quantity": (0, (1 << 13) - 1),
    "l_extendedprice": (0, (1 << 24) - 1),
    "l_discount": (0, 100),
    "l_tax": (0, 27),
}

#: the seven kernel input columns, canonical names
KERNEL_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_returnflag", "l_linestatus", "l_shipdate")


class Q1Route:
    """A matched Q1 leaf fragment, ready to execute."""

    __slots__ = ("scan", "rename", "outputs", "key_names", "key_dtypes")

    def __init__(self, scan, rename, outputs, key_names, key_dtypes):
        self.scan = scan  # N.TableScan
        #: source column -> kernel canonical name
        self.rename = rename
        #: aggregate output name -> kernel state key
        self.outputs = outputs
        #: (returnflag output name, linestatus output name)
        self.key_names = key_names
        self.key_dtypes = key_dtypes


def _is_one(e) -> bool:
    return (isinstance(e, Literal) and e.value == 1
            and e.dtype.kind in (TypeKind.INTEGER, TypeKind.BIGINT, TypeKind.DECIMAL))


def _dec2_ref(e) -> Optional[str]:
    """Name of a bare decimal(p,2) column reference, else None."""
    if (isinstance(e, InputRef) and e.dtype.kind is TypeKind.DECIMAL
            and e.dtype.scale == 2):
        return e.name
    return None


def _split_dp(e):
    """mul(ep, sub(1, disc)) at scale 4 -> (ep_name, disc_name)."""
    if not (isinstance(e, Call) and e.fn == "mul"
            and e.dtype.kind is TypeKind.DECIMAL and e.dtype.scale == 4
            and len(e.args) == 2):
        return None
    ep = _dec2_ref(e.args[0])
    b = e.args[1]
    if (ep is None or not isinstance(b, Call) or b.fn != "sub"
            or len(b.args) != 2 or not _is_one(b.args[0])):
        return None
    disc = _dec2_ref(b.args[1])
    return None if disc is None else (ep, disc)


def _split_ch(e):
    """mul(mul(ep, sub(1, disc)), add(1, tax)) -> (ep, disc, tax)."""
    if not (isinstance(e, Call) and e.fn == "mul"
            and e.dtype.kind is TypeKind.DECIMAL and e.dtype.scale == 4
            and len(e.args) == 2):
        return None
    dp = _split_dp(e.args[0])
    t = e.args[1]
    if (dp is None or not isinstance(t, Call) or t.fn != "add"
            or len(t.args) != 2 or not _is_one(t.args[0])):
        return None
    tax = _dec2_ref(t.args[1])
    return None if tax is None else (*dp, tax)


def match_q1_fragment(node: N.Aggregate, catalog) -> Optional[Q1Route]:
    """The strict structural + stats match described in the module
    docstring; None on any mismatch."""
    if not isinstance(node, N.Aggregate) or node.passengers:
        return None
    if len(node.keys) != 2:
        return None
    # ---- fragment shape: Aggregate -> [Filter ->] TableScan ----------
    child = node.child
    if isinstance(child, N.Filter) and isinstance(child.child, N.TableScan):
        scan, pred = child.child, child.predicate
        if scan.predicate is not None:
            return None
    elif isinstance(child, N.TableScan) and child.predicate is not None:
        scan, pred = child, child.predicate
    else:
        return None
    # ---- predicate: ship <= date '1998-09-02' ------------------------
    if not (isinstance(pred, Call) and pred.fn == "le" and len(pred.args) == 2):
        return None
    ship_ref, cutoff = pred.args
    if not (isinstance(ship_ref, InputRef)
            and ship_ref.dtype.kind is TypeKind.DATE
            and isinstance(cutoff, Literal)
            and cutoff.dtype.kind is TypeKind.DATE):
        return None
    try:
        if int(cutoff.dtype.to_physical(cutoff.value)) != CUTOFF_DAYS:
            return None
    except (TypeError, ValueError):
        return None
    # ---- aggregates -> kernel outputs --------------------------------
    roles: dict[str, str] = {}  # kernel name -> aggregate-side name

    def bind(role: str, name: str) -> bool:
        if roles.get(role, name) != name:
            return False
        roles[role] = name
        return True

    outputs: dict[str, str] = {}
    bare_sums: list[str] = []
    counted: list[str] = []
    for a in node.aggs:
        if a.kind == "count_star":
            outputs[a.name] = "count_order"
            continue
        if a.kind == "count" and isinstance(a.input, InputRef):
            counted.append(a.input.name)
            outputs[a.name] = "count_order"
            continue
        if a.kind != "sum" or a.input is None:
            return None
        e = a.input
        name = _dec2_ref(e)
        if name is not None:
            bare_sums.append(a.name)
            continue
        ch = _split_ch(e)
        if ch is not None:
            if not (bind("l_extendedprice", ch[0])
                    and bind("l_discount", ch[1]) and bind("l_tax", ch[2])):
                return None
            outputs[a.name] = "sum_charge"
            continue
        dp = _split_dp(e)
        if dp is not None:
            if not (bind("l_extendedprice", dp[0]) and bind("l_discount", dp[1])):
                return None
            outputs[a.name] = "sum_disc_price"
            continue
        return None
    if "l_extendedprice" not in roles or "l_tax" not in roles:
        return None  # both product shapes are required to pin ep/disc/tax
    # bare decimal sums resolve against the product-pinned roles; the
    # one remaining distinct column is quantity
    inv = {v: k for k, v in roles.items()}
    qty_name = None
    for out_name in bare_sums:
        a = next(x for x in node.aggs if x.name == out_name)
        col = a.input.name
        role = inv.get(col)
        if role == "l_extendedprice":
            outputs[out_name] = "sum_base_price"
        elif role == "l_discount":
            outputs[out_name] = "sum_disc"
        elif role == "l_tax":
            return None  # the kernel has no sum(tax) output
        elif qty_name is None or qty_name == col:
            qty_name = col
            outputs[out_name] = "sum_qty"
        else:
            return None  # two distinct unexplained sum columns
    if qty_name is None:
        return None
    roles["l_quantity"] = qty_name
    roles["l_shipdate"] = ship_ref.name
    # ---- keys: returnflag x linestatus dictionaries ------------------
    (rf_out, rf_e), (ls_out, ls_e) = node.keys
    for e in (rf_e, ls_e):
        if not (isinstance(e, InputRef) and e.dtype.kind is TypeKind.VARCHAR):
            return None
    roles["l_returnflag"] = rf_e.name
    roles["l_linestatus"] = ls_e.name
    # counted columns must be kernel columns (proven NULL-free below)
    if any(c not in roles.values() for c in counted):
        return None
    # ---- resolve to scan source columns + stats guards ---------------
    out_to_src = dict(scan.columns)
    conn = catalog.connectors.get(scan.connector)
    if conn is None:
        return None
    try:
        dicts = conn.dictionaries(scan.table)
        schema = conn.schema(scan.table)
    except (KeyError, AttributeError):
        return None
    rename: dict[str, str] = {}
    for kname, aggname in roles.items():
        src = out_to_src.get(aggname)
        if src is None:
            return None
        rename[src] = kname
        stats = catalog.stats(scan.connector, scan.table, src)
        if stats is None or getattr(stats, "null_fraction", 1.0):
            return None  # NULL-freedom and bounds must be DECLARED
        if kname in _DOMAINS:
            iv = stats_physical_interval(stats, schema[src])
            lo, hi = _DOMAINS[kname]
            if iv is None or iv[0] < lo or iv[1] > hi:
                return None
        if kname == "l_shipdate":
            iv = stats_physical_interval(stats, schema[src])
            if iv is None or iv[0] < -(1 << 31) or iv[1] >= (1 << 31):
                return None  # the kernel compares shipdate as int32
    if len(rename) != 7:
        return None  # two roles share one source column: not Q1's shape
    d_rf = dicts.get(out_to_src[rf_e.name])
    d_ls = dicts.get(out_to_src[ls_e.name])
    if d_rf is None or d_ls is None or len(d_rf) != 3 or len(d_ls) != 2:
        return None  # gid = rf*2 + ls needs exactly the 3x2 domain
    return Q1Route(scan, rename, outputs, (rf_out, ls_out), (rf_e.dtype, ls_e.dtype))


def _q1_split_step(b: Batch) -> dict:
    """The fused Q1 step over one scan split, with the declared
    NULL-freedom's runtime check folded into ``value_overflow``."""
    from presto_tpu_torch.ops.cuda_agg import null_violation
    from presto_tpu_torch.workloads import q1_fused_step

    nulls = null_violation(b)
    s = q1_fused_step(b)
    s["value_overflow"] = s["value_overflow"] | nulls
    return s


def _q1_fold(a: dict, b: dict) -> dict:
    from presto_tpu_torch.workloads import combine_q1_states

    return combine_q1_states(a, b)


def execute_q1_route(route: Q1Route, catalog, aggs) -> Optional[list[Batch]]:
    """Run the matched fragment: stream scan splits through the fused
    step (the Q1 kernel on the card, the generic one-pass step on the
    CPU), combine states, decode the 6-group output batch. Returns None
    when ``value_overflow`` tripped (violated advisory stats) — the
    caller falls back to the generic operator route."""
    fault_point("aggregation")
    fault_point("step.agg")
    scan = route.scan
    conn = catalog.connector(scan.connector)
    src_cols = list(route.rename)
    splits = list(conn.splits(scan.table))
    if not splits:
        return None
    cap = batch_capacity(max(s.row_hint for s in splits))

    def load(split):
        fault_point("scan")
        return conn.scan(split, src_cols, cap).rename(route.rename)

    # the step and the combine are shared across queries through the
    # executable cache (the kernel choice is made per launch by
    # ``ops/cuda_q1``, so the step's key names only the device type)
    fold = EXEC_CACHE.get_or_build(EXEC_CACHE.key_of("q1_route_fold"), lambda: _q1_fold)
    state = None
    step = None
    for b in prefetch_iter(load, splits):
        # the query's deadline and cancel scope, per split, on its thread
        check_deadline("scan")
        if step is None:
            step = EXEC_CACHE.get_or_build(
                EXEC_CACHE.key_of("q1_route_step", b.device.type), lambda: _q1_split_step)
        s = step(b)
        state = s if state is None else fold(state, s)
    if state is None or bool(state["value_overflow"]):
        REGISTRY.counter("exec.q1_route_fallback").add()
        return None
    REGISTRY.counter("exec.q1_fused_route").add()
    return [decode_q1_state(route, conn, aggs, state)]


def decode_q1_state(route: Q1Route, conn, aggs, state) -> Batch:
    """Decode a combined ``q1_fused_step`` [6]-group state into the
    Aggregate's output batch."""
    scan = route.scan
    G = 6
    dicts = conn.dictionaries(scan.table)
    out_to_src = dict(scan.columns)
    present = state["present"]
    dev = present.device
    gid = torch.arange(G, dtype=torch.int32, device=dev)
    all_true = torch.ones(G, dtype=torch.bool, device=dev)
    rf_out, ls_out = route.key_names
    cols = {
        rf_out: Column(torch.div(gid, 2, rounding_mode="floor"), all_true,
                       route.key_dtypes[0], dicts.get(out_to_src[rf_out])),
        ls_out: Column(gid % 2, all_true, route.key_dtypes[1],
                       dicts.get(out_to_src[ls_out])),
    }
    for a in aggs:
        kkey = route.outputs[a.name]
        data = state[kkey]
        if kkey == "count_order":
            valid = all_true  # counts are 0, not NULL, for empty groups
        else:
            valid = present
            data = torch.where(valid, data, torch.zeros_like(data))
        cols[a.name] = Column(data.to(a.dtype.torch_dtype), valid, a.dtype)
    return Batch(cols, present)
