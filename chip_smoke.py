#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
``presto_tpu_torch`` only (nothing of JAX or of the JAX package), needs
one CUDA card, and exits nonzero on any failure. Phases:

1. build every CUDA kernel of the path from ``presto_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card,
   exactly, at several shapes, in the connector's narrow column widths
   and in wider ones, and at the guard cases that must flag;
3. resident TPC-H Q1: SF1 ``lineitem`` tiled x10 (about 60M rows) in
   the connector's narrow storage, through ``workloads.q1_fused_step``
   (the Q1 kernel); equal to 10x a numpy recomputation, and the kernel
   equal to its plain version on that batch;
4. the Q1 pipeline at SF1 (scan -> filter -> direct hash aggregation ->
   the lane-sums kernel); equal to the numpy recomputation;
5. time each kernel, its plain version and, where one exists, one
   PyTorch library call computing the same function, at the main path's
   shapes, and print them with the least time the card could take. A
   kernel's time is its own device time in the profiler's CUDA trace;
   its wrapper call (output zeroing and result slicing included) is
   timed apart with CUDA events;
6. TPC-H Q3 and Q10 at SF1 through ``Session.sql`` (the join-probe
   kernels: exists on Q3's customer join, payload on Q10's nation join),
   each equal to an exact int64 numpy recomputation, each through the
   fused route, each equal to the same query with ``pallas_join`` off;
   the wall time of a first and a second run; then the join probes are
   timed as in phase 5, at the inputs this phase gave them.

The card's name and power limit come first and again before the last
lines, which are one JSON line ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.connectors.tpch.queries import QUERIES
from presto_tpu_torch.expr import evaluate, evaluate_predicate
from presto_tpu_torch.ops import _build, cuda_groupby, cuda_join, cuda_q1
from presto_tpu_torch.ops.groupby import group_ids_direct, lane_sum_inputs
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.types import DATE, decimal, varchar
from presto_tpu_torch.workloads import (
    Q1_BITS, Q1_COLS, q1_aggs, q1_exprs, q1_fused_step, q1_pipeline)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (the fp32 figure)
FACTOR = 10  # resident batch = SF1 lineitem tiled this many times
CUTOFF = 10471  # date '1998-09-02'
I32MAX = (1 << 31) - 1


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# widths of a layout other than the connector's narrow one: the Q1
# kernel's generic instantiation reads these
WIDE = {"l_shipdate": np.int32, "l_returnflag": np.int32, "l_linestatus": np.int16,
        "l_quantity": np.int32, "l_discount": np.int16, "l_tax": np.int32}


def q1_batch_random(rng, cap: int, rows: int | None = None, widths=None) -> Batch:
    """Q1 columns on the card, narrow as the connector stores them unless
    ``widths`` overrides a column's dtype."""
    rows = cap if rows is None else rows
    dec2 = decimal(12, 2)
    spec = {
        "l_shipdate": (np.int16, 9000, 11500, DATE),  # straddles the cutoff
        "l_returnflag": (np.int8, 0, 3, varchar()),
        "l_linestatus": (np.int8, 0, 2, varchar()),
        "l_quantity": (np.int16, 100, 5001, dec2),
        "l_extendedprice": (np.int32, 90000, 10_500_000, dec2),
        "l_discount": (np.int8, 0, 11, dec2),
        "l_tax": (np.int8, 0, 9, dec2),
    }
    widths = widths or {}
    live_np = np.zeros(cap, np.bool_)
    live_np[:rows] = True
    live = torch.from_numpy(live_np).cuda()
    cols = {name: Column(torch.from_numpy(
                rng.integers(lo, hi, cap).astype(widths.get(name, dt))).cuda(), live, typ)
            for name, (dt, lo, hi, typ) in spec.items()}
    return Batch(cols, live)


def with_value(b: Batch, name: str, row: int, value: int) -> Batch:
    """``b`` with one contributing row's ``name`` set to ``value``."""
    cols = dict(b.columns)
    for n, v in ((name, value), ("l_shipdate", 9100)):
        data = cols[n].data.clone()
        data[row] = v
        cols[n] = Column(data, b.live, cols[n].dtype)
    return Batch(cols, b.live)


def compare(got: dict, want: dict, what: str) -> int:
    """Exact comparison of two result dicts; returns the max |diff|."""
    err = 0
    for k in want:
        g, w = got[k], want[k]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: {k} dtype/shape {g.dtype}{tuple(g.shape)} != {w.dtype}{tuple(w.shape)}")
        d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        err = max(err, d)
        check(d == 0, f"{what}: {k} differs from the plain version by {d}")
    return err


def check_q1_kernel(rng) -> int:
    err = 0
    cases = [("cap 2^16", q1_batch_random(rng, 1 << 16)),
             ("cap 2^20", q1_batch_random(rng, 1 << 20)),
             ("ragged live 2^20-1371", q1_batch_random(rng, 1 << 20, (1 << 20) - 1371)),
             ("cap 1000003", q1_batch_random(rng, 1_000_003))]
    cases += [("wide widths cap 2^20", q1_batch_random(rng, 1 << 20, widths=WIDE)),
              ("wide widths ragged 1000003-77",
               q1_batch_random(rng, 1_000_003, 1_000_003 - 77, widths=WIDE))]
    base = q1_batch_random(rng, 1 << 16)
    wide = q1_batch_random(rng, 1 << 16, widths=WIDE)
    guards = [("guard disc=-56", with_value(base, "l_discount", 11, -56)),
              ("guard ep=2^25", with_value(base, "l_extendedprice", 7, 1 << 25)),
              ("guard rf=5", with_value(base, "l_returnflag", 3, 5)),
              ("guard wide qty=2^14", with_value(wide, "l_quantity", 5, 1 << 14)),
              ("guard wide ls=2", with_value(wide, "l_linestatus", 9, 2))]
    for what, b in cases + guards:
        got = cuda_q1.q1_step(b)
        want = cuda_q1.q1_step_plain(b)
        torch.cuda.synchronize()
        err = max(err, compare(got, want, f"q1_step {what}"))
        flagged = bool(got["value_overflow"])
        check(flagged == what.startswith("guard"),
              f"q1_step {what}: value_overflow={flagged}")
        log(f"  q1_step {what}: equal to plain, value_overflow={flagged}")
    return err


def lane_inputs_random(rng, cap: int, groups: int, live_rows: int | None = None):
    live_rows = cap if live_rows is None else live_rows
    g = rng.integers(0, groups + 1, cap).astype(np.int32)  # groups + trash
    g[live_rows:] = groups
    v1 = rng.integers(-(2**30), 2**30, cap).astype(np.int32)
    v2 = rng.integers(-5000, 5000, cap).astype(np.int32)
    v3 = rng.integers(0, 2**24, cap).astype(np.int32)
    v4 = rng.integers(-100, 100, cap).astype(np.int32)
    masks = [rng.random(cap) < p for p in (0.9, 0.8, 0.5, 0.99, 0.7)]
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return [t(v) for v in (v1, v2, v3, v4)], [31, 13, 24, 7], [t(m) for m in masks], t(g)


def check_lane_kernel(rng) -> int:
    err = 0
    cases = [("cap 2^16", 1 << 16, 6, None), ("cap 2^20", 1 << 20, 6, None),
             ("dead tail 2^20-1371", 1 << 20, 6, (1 << 20) - 1371),
             ("cap 1000003", 1_000_003, 6, None),
             ("64 groups (shared copies)", 1 << 20, 64, None)]
    for what, cap, groups, live_rows in cases:
        vals, bits, masks, g = lane_inputs_random(rng, cap, groups, live_rows)
        got = cuda_groupby.fused_lane_sums(vals, bits, masks, g, groups)
        want = cuda_groupby.fused_lane_sums_plain(vals, bits, masks, g, groups)
        torch.cuda.synchronize()
        gd = {f"s{i}": s for i, s in enumerate(got[0])}
        gd.update({f"c{i}": c for i, c in enumerate(got[1])}, flag=got[2])
        wd = {f"s{i}": s for i, s in enumerate(want[0])}
        wd.update({f"c{i}": c for i, c in enumerate(want[1])}, flag=want[2])
        err = max(err, compare(gd, wd, f"fused_lane_sums {what}"))
        check(not bool(got[2]), f"fused_lane_sums {what}: flagged in bounds")
        log(f"  fused_lane_sums {what}: equal to plain")
    vals, bits, masks, g = lane_inputs_random(rng, 1 << 16, 6)
    vals[1][5] = 1 << 14  # beyond its declared 13 bits
    got = cuda_groupby.fused_lane_sums(vals, bits, masks, g, 6)
    want = cuda_groupby.fused_lane_sums_plain(vals, bits, masks, g, 6)
    check(bool(got[2]) and bool(want[2]), "fused_lane_sums: bound violation not flagged")
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        check(torch.equal(a, b), "fused_lane_sums: bound-violation sums differ")
    log("  fused_lane_sums value beyond declared bits: flagged by both")
    return err


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def probe_keys(rng, dtype, kmin: int, kmax: int, n: int, spread: int = 2000) -> np.ndarray:
    """Probe keys around the domain and across its ends, with the ends,
    their out-of-domain neighbours and the dtype's extremes planted."""
    info = np.iinfo(dtype)
    k = rng.integers(max(info.min, kmin - spread), min(info.max, kmax + spread), n,
                     endpoint=True)
    edges = [e for e in (kmin, kmax, kmin - 1, kmax + 1, info.min, info.max)
             if info.min <= e <= info.max]
    k[: len(edges)] = edges
    return k.astype(dtype)


def live_mask(rng, n: int) -> np.ndarray:
    live = rng.random(n) < 0.85  # dead rows throughout
    live[:6] = True  # the planted edge keys are live
    return live


def check_exists_kernel(rng) -> int:
    err = 0
    cases = [(dt, kmin, kmax, cap)
             for dt, kmin, kmax in (("int8", -100, 100), ("int16", -3000, 20000),
                                    ("int32", 1, 150000))
             for cap in (1 << 16, 1 << 20, 1_000_003)]
    cases += [("int32", -70000, 70000, 1 << 20),  # negative key_min
              ("int32", I32MAX - 50000, I32MAX, 1_000_003),  # key_max = 2^31-1
              ("int32", 0, 16384 * 32 - 1, 1 << 20)]  # a table at the exists budget
    for dt, kmin, kmax, cap in cases:
        bk = rng.integers(kmin, kmax, 5000, endpoint=True).astype(dt)
        bk[:2] = [kmin, kmax]
        blive = live_mask(rng, bk.shape[0])
        table, oob = cuda_join.build_exists_table(_t(bk), _t(blive), kmin, kmax)
        check(not bool(oob), "exists table: in-domain build flagged oob")
        pk, plive = _t(probe_keys(rng, dt, kmin, kmax, cap)), _t(live_mask(rng, cap))
        got = cuda_join.exists_probe(table, kmin, kmax, pk, plive)
        want = cuda_join.exists_probe_plain(table, kmin, kmax, pk, plive)
        torch.cuda.synchronize()
        d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        err = max(err, d)
        check(d == 0, f"exists_probe {dt} [{kmin}, {kmax}] cap {cap}: differs from plain")
        check(not bool(got[~plive].any()), f"exists_probe {dt} cap {cap}: a dead row matched")
        log(f"  exists_probe {dt} [{kmin}, {kmax}] table {table.shape[0]} words cap {cap}: "
            f"equal to plain, {int(got.sum())} hits")
    return err


def check_payload_kernel(rng) -> int:
    err = 0
    for nval in (1, 2, 3, 4):
        for dt, kmin, kmax in (("int8", -60, 90), ("int16", -500, 2500),
                               ("int32", I32MAX - 3000, I32MAX)):
            for cap in (1 << 16, 1 << 20, 1_000_003):
                bk = (rng.permutation(kmax - kmin + 1)[:400] + kmin).astype(dt)
                blive = live_mask(rng, bk.shape[0])
                vals = [rng.integers(-(1 << 31), 1 << 31, bk.shape[0]).astype(np.int32)]
                vals += [rng.integers(-128, 128, bk.shape[0]).astype(np.int8)
                         for _ in range(nval - 1)]
                tables, oob = cuda_join.build_payload_tables(
                    _t(bk), _t(blive), kmin, kmax, [_t(v) for v in vals])
                check(not bool(oob), "payload tables: in-domain build flagged oob")
                pk = _t(probe_keys(rng, dt, kmin, kmax, cap, spread=300))
                plive = _t(live_mask(rng, cap))
                gm, gv = cuda_join.payload_probe(tables, kmin, kmax, pk, plive)
                wm, wv = cuda_join.payload_probe_plain(tables, kmin, kmax, pk, plive)
                torch.cuda.synchronize()
                for g, w in zip([gm] + gv, [wm] + wv):
                    d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                    err = max(err, d)
                    check(d == 0, f"payload_probe nval {nval} {dt} cap {cap}: "
                          "differs from plain")
                check(not bool(gm[~plive].any()), "payload_probe: a dead row matched")
            log(f"  payload_probe nval {nval} {dt} [{kmin}, {kmax}] caps 2^16, 2^20, "
                "1000003: equal to plain")
    return err


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------


def q1_expected(arrays) -> dict:
    """Independent int64 numpy recomputation of Q1's six groups."""
    m = arrays["l_shipdate"] <= CUTOFF
    gid = (arrays["l_returnflag"].astype(np.int64) * 2
           + arrays["l_linestatus"].astype(np.int64))[m]
    qty = arrays["l_quantity"][m].astype(np.int64)
    ep = arrays["l_extendedprice"][m].astype(np.int64)
    dp = ep * (100 - arrays["l_discount"][m].astype(np.int64))
    ch = (dp * (100 + arrays["l_tax"][m].astype(np.int64)) + 50) // 100

    def seg(v):
        out = np.zeros(6, np.int64)
        np.add.at(out, gid, v)
        return out

    return {"sum_qty": seg(qty), "sum_base_price": seg(ep),
            "sum_disc_price": seg(dp), "sum_charge": seg(ch),
            "count_order": np.bincount(gid, minlength=6).astype(np.int64)}


def days(iso: str) -> int:
    return int((np.datetime64(iso, "D") - np.datetime64("1970-01-01", "D")).astype(np.int64))


def _lookup(sorted_keys: np.ndarray, keys: np.ndarray):
    """(position in ``sorted_keys``, found) for each of ``keys``."""
    if sorted_keys.size == 0:
        return np.zeros(keys.shape, np.int64), np.zeros(keys.shape, bool)
    pos = np.clip(np.searchsorted(sorted_keys, keys), 0, sorted_keys.size - 1)
    return pos, sorted_keys[pos] == keys


def _text(rows: np.ndarray) -> list:
    return [bytes(r).rstrip(b"\x00").decode("latin1") for r in rows]


def q3_expected(conn) -> dict:
    """TPC-H Q3 recomputed in int64 numpy from the connector's arrays
    (the semantics of ``presto_tpu/oracle/tpch_oracle.py`` q3, without
    pandas): revenue as the scaled int64 sum(ep * (100 - disc)), groups
    in key order, ties kept in that order by the sort."""
    cut = days("1995-03-15")
    c = conn.table_numpy("customer", ["c_custkey", "c_mktsegment"])
    building = conn.dictionaries("customer")["c_mktsegment"].code_of("BUILDING")
    cust = np.sort(c["c_custkey"][c["c_mktsegment"] == building])
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
    om = (o["o_orderdate"] < cut) & _lookup(cust, o["o_custkey"])[1]
    order = np.argsort(o["o_orderkey"][om])
    ok = o["o_orderkey"][om][order]
    od, op = o["o_orderdate"][om][order], o["o_shippriority"][om][order]
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_extendedprice", "l_discount",
                                       "l_shipdate"])
    lm = li["l_shipdate"] > cut
    pos, hit = _lookup(ok, li["l_orderkey"][lm])
    rev = (li["l_extendedprice"][lm][hit].astype(np.int64)
           * (100 - li["l_discount"][lm][hit].astype(np.int64)))
    sums = np.zeros(ok.size, np.int64)
    np.add.at(sums, pos[hit], rev)
    present = np.bincount(pos[hit], minlength=ok.size) > 0
    keys, revs, dates, prio = ok[present], sums[present], od[present], op[present]
    top = np.lexsort((keys, dates, -revs))[:10]
    return {"l_orderkey": keys[top], "revenue": revs[top], "o_orderdate": dates[top],
            "o_shippriority": prio[top]}


def q10_expected(conn) -> dict:
    """TPC-H Q10 recomputed in int64 numpy (``tpch_oracle.py`` q10's
    semantics, without pandas); strings decoded as the engine decodes
    them (BYTES zero padding stripped, latin-1)."""
    lo, hi = days("1993-10-01"), days("1994-01-01")
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    om = (o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi)
    order = np.argsort(o["o_orderkey"][om])
    ok, oc = o["o_orderkey"][om][order], o["o_custkey"][om][order]
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_extendedprice", "l_discount",
                                       "l_returnflag"])
    r = conn.dictionaries("lineitem")["l_returnflag"].code_of("R")
    lm = li["l_returnflag"] == r
    pos, hit = _lookup(ok, li["l_orderkey"][lm])
    rev = (li["l_extendedprice"][lm][hit].astype(np.int64)
           * (100 - li["l_discount"][lm][hit].astype(np.int64)))
    custs, inv = np.unique(oc[pos[hit]], return_inverse=True)
    sums = np.zeros(custs.size, np.int64)
    np.add.at(sums, inv, rev)
    top = np.lexsort((custs, -sums))[:20]
    ccols = ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone", "c_acctbal",
             "c_comment"]
    c = conn.table_numpy("customer", ccols)
    corder = np.argsort(c["c_custkey"])
    cpos, chit = _lookup(c["c_custkey"][corder], custs[top])
    check(bool(chit.all()), "Q10 oracle: an order's customer is missing")
    row = corder[cpos]
    n = conn.table_numpy("nation", ["n_nationkey", "n_name"])
    npos, nhit = _lookup(np.sort(n["n_nationkey"]), c["c_nationkey"][row])
    check(bool(nhit.all()), "Q10 oracle: a customer's nation is missing")
    names = conn.dictionaries("nation")["n_name"].values
    return {"c_custkey": custs[top], "c_name": _text(c["c_name"][row]), "revenue": sums[top],
            "c_acctbal": c["c_acctbal"][row],
            "n_name": list(names[n["n_name"][np.argsort(n["n_nationkey"])][npos]]),
            "c_address": _text(c["c_address"][row]), "c_phone": _text(c["c_phone"][row]),
            "c_comment": _text(c["c_comment"][row])}


def same_result(res, want: dict, what: str) -> None:
    """``res`` (a QueryResult) equals ``want`` exactly, column by column."""
    check(res.names == list(want), f"{what}: columns {res.names} != {list(want)}")
    for name, w in want.items():
        got = res.column(name)
        check(len(got) == len(w) and list(got) == list(w),
              f"{what}: column {name} differs:\n{list(got)[:5]}\n{list(w)[:5]}")


def resident_batch(arrays, phys, factor: int) -> Batch:
    live = torch.ones(len(arrays["l_tax"]) * factor, dtype=torch.bool, device="cuda")
    cols = {}
    for c in Q1_COLS:
        t = phys[c]
        data = torch.from_numpy(arrays[c].astype(t.np_dtype)).cuda().repeat(factor)
        cols[c] = Column(data, live, t)
    return Batch(cols, live)


def call_ms(fn, runs: int) -> float:
    """Median milliseconds of one call of ``fn``, bracketed by CUDA events
    (host time included: a call whose Python outlasts its kernels is
    timed by its Python)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int, flush: torch.Tensor | None = None,
              kernel: str | None = None) -> float:
    """Device milliseconds per call of ``fn``, from the profiler's CUDA
    trace, averaged over ``runs`` calls: the time of the kernels whose
    name contains ``kernel``, or of every kernel ``fn`` launches when
    ``kernel`` is None. ``flush`` (a buffer larger than L2) is rewritten
    before each call so each call starts with a cold cache; its kernels
    are left out of the sum."""
    from torch.profiler import ProfilerActivity, profile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if flush is not None:
                flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if "bitwise_not" not in e.key and (kernel is None or kernel in e.key))
    check(total_us > 0, f"the profiler recorded no device time for {kernel or 'fn'}")
    return total_us / runs / 1e3


def bound(nbytes, ops):
    """Least time the card could take: bytes at the memory rate or
    integer operations at the non-tensor rate, whichever is larger."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def wall_breakdown(session, conn, sql: str):
    """(device busy ms, connector-scan s) of one more run of ``sql``:
    the device time of every kernel and copy in the profiler's CUDA
    trace, and the host time spent inside ``conn.scan`` (generation,
    narrowing and the copy to the card; the scans run on the prefetch
    thread, so they overlap the rest)."""
    from torch.profiler import ProfilerActivity, profile

    scan_s = [0.0]
    original = conn.scan

    def timed_scan(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            scan_s[0] += time.perf_counter() - t0

    conn.scan = timed_scan
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            session.sql(sql)
            torch.cuda.synchronize()
    finally:
        del conn.scan
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return busy_us / 1e3, scan_s[0]


def run_join_queries(flush: torch.Tensor, sf: float = 1, device: str = "cuda") -> dict:
    """Phase 6: Q3 and Q10 at SF1 through Session.sql, then the join
    probes timed at the inputs the first runs gave them."""
    conn = TpchConnector(sf=sf, device=device)
    t0 = time.perf_counter()
    want = {"q3": q3_expected(conn), "q10": q10_expected(conn)}
    log(f"phase 6: numpy recomputation of Q3 and Q10 at SF1 in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel_of = {"q3": ("exists", "exists_probe"), "q10": ("payload", "payload_probe")}
    probe_batches = len(conn.splits("lineitem"))
    captured, launches = {}, {}
    originals = {name: getattr(cuda_join, name) for _, name in kernel_of.values()}

    def capture(mode, name):
        def wrapper(*args):
            captured.setdefault(mode, args)  # the first call of the main path
            return originals[name](*args)
        return wrapper

    for q, (mode, name) in kernel_of.items():
        session = Session({"tpch": conn}, device=device)
        setattr(cuda_join, name, capture(mode, name))
        COUNTERS.clear()
        cuda_join.exists_launches = cuda_join.payload_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.sql(QUERIES[q])
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        n_exists, n_payload = cuda_join.exists_launches, cuda_join.payload_launches
        route = dict(COUNTERS)
        setattr(cuda_join, name, originals[name])
        same_result(res, want[q], f"{q} at SF1")
        check(route.get("exec.pallas_join_route", 0) == 1,
              f"{q}: {route.get('exec.pallas_join_route', 0)} joins took the fused route, not 1")
        check(route.get("join.pallas_fallback", 0) == 0,
              f"{q}: {route.get('join.pallas_fallback')} fused-probe fallbacks")
        # the fused join probes the lineitem stream: one launch per split
        launches[mode] = n_exists if mode == "exists" else n_payload
        check(launches[mode] == probe_batches and n_exists + n_payload == probe_batches,
              f"{q}: {n_exists} exists and {n_payload} payload launches for "
              f"{probe_batches} lineitem batches")
        t0 = time.perf_counter()
        again = session.sql(QUERIES[q])
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        same_result(again, want[q], f"{q} at SF1, second run")
        busy_ms, scan_s = wall_breakdown(session, conn, QUERIES[q])
        COUNTERS.clear()
        cuda_join.exists_launches = cuda_join.payload_launches = 0
        off = Session({"tpch": conn}, properties={"pallas_join": False},
                      device=device).sql(QUERIES[q])
        check(COUNTERS["exec.pallas_join_route"] == 0 and cuda_join.exists_launches == 0
              and cuda_join.payload_launches == 0, f"{q}: pallas_join off still probed fused")
        same_result(off, want[q], f"{q} at SF1 with pallas_join off")
        strategies = {k: v for k, v in route.items() if k.startswith(("join.", "agg."))}
        log(f"  {q}: {len(res)} rows equal to numpy, with pallas_join off too; wall first "
            f"{first:.3f} s, second {second:.3f} s; exists launches {n_exists}, payload "
            f"launches {n_payload}; routes {strategies}")
        log(f"  {q} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
            f"connector scans (host generation + copy to the card) {scan_s:.3f} s")

    out = {}
    for mode, args in captured.items():
        if mode == "exists":
            table, kmin, kmax, keys, live = args
            fn = lambda: cuda_join.exists_probe(table, kmin, kmax, keys, live)  # noqa: E731
            plain = lambda: cuda_join.exists_probe_plain(table, kmin, kmax, keys, live)  # noqa: E731
            nbytes = keys.numel() * (keys.element_size() + 2) + table.numel() * 4
            extra = {"table": table.numel()}
        else:
            tables, kmin, kmax, keys, live = args
            fn = lambda: cuda_join.payload_probe(tables, kmin, kmax, keys, live)  # noqa: E731
            plain = lambda: cuda_join.payload_probe_plain(tables, kmin, kmax, keys, live)  # noqa: E731
            nval = len(tables) - 1
            nbytes = (keys.numel() * (keys.element_size() + 2 + 4 * nval)
                      + sum(t.numel() * 4 for t in tables))
            extra = {"table": sum(t.numel() for t in tables), "nval": nval}
        got, wanted = fn(), plain()
        got = [got] if isinstance(got, torch.Tensor) else [got[0]] + got[1]
        wanted = [wanted] if isinstance(wanted, torch.Tensor) else [wanted[0]] + wanted[1]
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, wanted))
        check(err == 0, f"{mode} probe differs from plain at the main path's inputs")
        kernel = "exists_kernel" if mode == "exists" else "payload_kernel"
        out[mode] = {"ms": device_ms(fn, 50, flush, kernel=kernel), "call_ms": call_ms(fn, 50),
                     "plain_ms": device_ms(plain, 10, flush), "rows": keys.numel(),
                     "key": str(keys.dtype).replace("torch.", ""), "bytes": nbytes,
                     "ops": 8 * keys.numel(), "launches": launches[mode], "err": err, **extra}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    log(f"card (name, power limit) for every number below: {smi[0]}")
    log(f"device: {dev_name} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.sources():
        check(_build.library_path(name).exists(), f"kernel {name} was not built")
    log(f"phase 1: built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- phase 2: kernels vs plain ----------------------------------------
    rng = np.random.default_rng(20261016)
    log("phase 2: kernels against their plain versions (exact)")
    q1_err = check_q1_kernel(rng)
    lane_err = check_lane_kernel(rng)
    exists_err = check_exists_kernel(rng)
    payload_err = check_payload_kernel(rng)

    # ---- phase 3: resident Q1 at SF1 x10 ----------------------------------
    t0 = time.perf_counter()
    conn = TpchConnector(sf=1, device="cuda")
    arrays = conn.table_numpy("lineitem", Q1_COLS)
    phys = conn.physical_schema("lineitem", Q1_COLS)
    want = q1_expected(arrays)
    batch = resident_batch(arrays, phys, FACTOR)
    torch.cuda.synchronize()
    n = batch.capacity
    log(f"phase 3: resident SF1 x{FACTOR} lineitem, {n} rows "
        f"({sum(batch[c].data.element_size() for c in Q1_COLS) + 1} B/row), "
        f"set up in {time.perf_counter() - t0:.1f} s")
    check(cuda_q1.supported(batch), "resident batch is not eligible for the Q1 kernel")
    cuda_q1.launches = 0
    cuda_groupby.launches = 0
    state = q1_fused_step(batch)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state = q1_fused_step(batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    q1_launches = cuda_q1.launches
    check(q1_launches > 0, "the resident Q1 step never launched the Q1 kernel")
    check(not bool(state["value_overflow"]), "resident Q1: value_overflow")
    for k, w in want.items():
        got = state[k].cpu().numpy()
        check(np.array_equal(got, FACTOR * w), f"resident Q1 {k}: {got} != {FACTOR} x {w}")
    # the kernel against its plain version at the main path's own shape
    q1_err = max(q1_err, compare(cuda_q1.q1_step(batch), cuda_q1.q1_step_plain(batch),
                                 f"q1_step resident {n} rows"))
    med = statistics.median(step_ms)
    log(f"  equal to {FACTOR}x numpy and q1_step equal to plain; q1_fused_step median "
        f"{med:.4f} ms over {len(step_ms)} runs = {n / (med / 1e3):.4e} rows/s; "
        f"Q1 kernel launches {q1_launches}")

    # ---- phase 4: the Q1 pipeline at SF1 ----------------------------------
    cuda_q1.launches = 0
    cuda_groupby.launches = 0
    t0 = time.perf_counter()
    pipe = q1_pipeline(TpchConnector(sf=1, device="cuda"))
    out = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane_launches = cuda_groupby.launches
    check(lane_launches > 0, "the Q1 pipeline never launched the lane-sums kernel")
    check(len(out) == 1, f"pipeline emitted {len(out)} batches")
    res = out[0]
    present = want["count_order"] > 0
    check(np.array_equal(res.live.cpu().numpy(), present), "pipeline: group presence")
    codes = np.arange(6)
    check(np.array_equal(res["l_returnflag"].data.cpu().numpy(), codes // 2)
          and np.array_equal(res["l_linestatus"].data.cpu().numpy(), codes % 2),
          "pipeline: group keys")
    for k, w in want.items():
        got = res[k].data.cpu().numpy()
        check(np.array_equal(got, w), f"pipeline {k}: {got} != {w}")
    nsplits = len(pipe.source.splits)
    log(f"phase 4: Q1 pipeline at SF1 ({nsplits} splits of capacity "
        f"{pipe.source.capacity}) equal to numpy; wall {wall:.3f} s; "
        f"lane-sums kernel launches {lane_launches}")

    # ---- phase 5: kernel times at the main path's shapes ------------------
    flush = torch.empty(1 << 27, dtype=torch.int8, device="cuda")  # 128 MB > L2
    q1_bytes = sum(batch[c].data.numel() * batch[c].data.element_size()
                   for c in Q1_COLS) + n + (6 * 6 + 1) * 8
    contributing = int((batch["l_shipdate"].data <= CUTOFF).sum())
    q1_ops = 2 * n + 14 * contributing  # filter; gid, dp, charge, guard, 6 adds
    q1_ms = device_ms(lambda: cuda_q1.q1_step(batch), 20, kernel="q1_kernel")
    q1_call_ms = call_ms(lambda: cuda_q1.q1_step(batch), 20)
    q1_plain_ms = device_ms(lambda: cuda_q1.q1_step_plain(batch), 3)

    split_batch = conn.scan(conn.splits("lineitem")[0], Q1_COLS, pipe.source.capacity)
    pred, _, _ = q1_exprs()
    live = split_batch.live & evaluate_predicate(pred, split_batch)
    filtered = split_batch.with_live(live)
    gids, _ = group_ids_direct([split_batch["l_returnflag"].data,
                                split_batch["l_linestatus"].data],
                               (0, 0), (2, 1), live, 6)
    vals = [evaluate(a.input, filtered) for a in q1_aggs()[:4]]
    contribs = [live & v.valid for v in vals]
    bits = [Q1_BITS[n_] for n_ in ("sum_qty", "sum_base_price", "sum_disc_price",
                                   "sum_charge")]
    zeroed, eff_bits, _ = lane_sum_inputs([v.data for v in vals], bits, contribs, live.device)
    masks = contribs + [live]
    cap = gids.shape[0]
    lane_bytes = (sum(z.numel() * z.element_size() for z in zeroed) + len(masks) * cap
                  + cap * 4 + (6 * (len(zeroed) + len(masks)) + 1) * 8)
    lane_ops = cap * (3 * len(zeroed) + len(masks) + 2)
    lane_ms = device_ms(lambda: cuda_groupby.fused_lane_sums(zeroed, eff_bits, masks, gids, 6),
                        50, flush, kernel="lane_sums_kernel")
    lane_call_ms = call_ms(
        lambda: cuda_groupby.fused_lane_sums(zeroed, eff_bits, masks, gids, 6), 50)
    lane_plain_ms = device_ms(
        lambda: cuda_groupby.fused_lane_sums_plain(zeroed, eff_bits, masks, gids, 6), 10, flush)
    stacked = torch.stack([z.to(torch.int64) for z in zeroed]
                          + [m_.to(torch.int64) for m_ in masks], dim=1)
    g64 = torch.where((gids >= 0) & (gids < 6), gids, torch.full_like(gids, 6)).to(torch.int64)
    lib_out = torch.zeros(7, stacked.shape[1], dtype=torch.int64, device="cuda")

    def library():
        lib_out.zero_()
        lib_out.index_add_(0, g64, stacked)

    lane_lib_ms = device_ms(library, 10, flush)
    got = cuda_groupby.fused_lane_sums(zeroed, eff_bits, masks, gids, 6)
    check(torch.equal(torch.stack(got[0] + got[1], dim=1), lib_out[:6]),
          "fused_lane_sums differs from the index_add_ library call")

    q1_bound, q1_by = bound(q1_bytes, q1_ops)
    lane_bound, lane_by = bound(lane_bytes, lane_ops)
    log(f"phase 5 (kernel device ms; call = wrapper, events; plain and index_add_ = "
        f"device ms of all their kernels): q1_step {q1_ms:.4f} (call {q1_call_ms:.4f}, "
        f"plain {q1_plain_ms:.4f}, bound {q1_bound:.4f}) at {n} rows; fused_lane_sums "
        f"{lane_ms:.4f} (call {lane_call_ms:.4f}, plain {lane_plain_ms:.4f}, index_add_ "
        f"{lane_lib_ms:.4f}, bound {lane_bound:.4f}) at {cap} rows, "
        f"{len(zeroed)} values + {len(masks)} masks")

    join = run_join_queries(flush)
    ex, pay = join["exists"], join["payload"]
    exists_bound, exists_by = bound(ex["bytes"], ex["ops"])
    payload_bound, payload_by = bound(pay["bytes"], pay["ops"])
    log(f"phase 5, join probes at phase 6's inputs (kernel device ms; call = wrapper, "
        f"events; plain = device ms of its kernels): exists_probe {ex['ms']:.4f} (call "
        f"{ex['call_ms']:.4f}, plain {ex['plain_ms']:.4f}, bound {exists_bound:.4f}) at "
        f"{ex['rows']} rows, {ex['key']} keys, {ex['table']} words; payload_probe "
        f"{pay['ms']:.4f} (call {pay['call_ms']:.4f}, plain {pay['plain_ms']:.4f}, bound "
        f"{payload_bound:.4f}) at {pay['rows']} rows, {pay['key']} keys, {pay['nval']} "
        f"value(s) over {pay['table']} slots; no single PyTorch call computes either")

    log(smi[0])
    kernels = [
        {"name": "q1_step", "route": "cuda", "source": "presto_tpu_torch/csrc/q1.cu",
         "replaces": "presto_tpu/ops/pallas_q1.py:114",
         "jax_function": "presto_tpu/ops/pallas_q1.py:174 q1_step",
         "launches": q1_launches, "max_abs_err": q1_err, "ms": q1_ms, "kernel_ms": q1_ms,
         "call_ms": q1_call_ms,
         "plain_ms": q1_plain_ms, "bound_ms": q1_bound, "bound_by": q1_by,
         "library_ms": None, "rows": n, "bytes": q1_bytes, "ops": q1_ops},
        {"name": "fused_lane_sums", "route": "cuda",
         "source": "presto_tpu_torch/csrc/lane_sums.cu",
         "replaces": "presto_tpu/ops/pallas_groupby.py:138",
         "jax_function": "presto_tpu/ops/pallas_groupby.py:177 fused_lane_sums",
         "launches": lane_launches, "max_abs_err": lane_err, "ms": lane_ms,
         "kernel_ms": lane_ms, "call_ms": lane_call_ms, "plain_ms": lane_plain_ms,
         "bound_ms": lane_bound,
         "bound_by": lane_by, "library_ms": lane_lib_ms, "rows": cap,
         "bytes": lane_bytes, "ops": lane_ops},
        {"name": "exists_probe", "route": "cuda", "source": "presto_tpu_torch/csrc/join_probe.cu",
         "replaces": "presto_tpu/ops/pallas_join.py:281",
         "jax_function": "presto_tpu/ops/pallas_join.py:329 exists_probe",
         "launches": ex["launches"], "max_abs_err": max(exists_err, ex["err"]), "ms": ex["ms"],
         "kernel_ms": ex["ms"], "call_ms": ex["call_ms"], "plain_ms": ex["plain_ms"],
         "bound_ms": exists_bound, "bound_by": exists_by, "library_ms": None,
         "rows": ex["rows"], "bytes": ex["bytes"], "ops": ex["ops"]},
        {"name": "payload_probe", "route": "cuda",
         "source": "presto_tpu_torch/csrc/join_probe.cu",
         "replaces": "presto_tpu/ops/pallas_join.py:305",
         "jax_function": "presto_tpu/ops/pallas_join.py:372 payload_probe",
         "launches": pay["launches"], "max_abs_err": max(payload_err, pay["err"]),
         "ms": pay["ms"], "kernel_ms": pay["ms"], "call_ms": pay["call_ms"],
         "plain_ms": pay["plain_ms"], "bound_ms": payload_bound, "bound_by": payload_by,
         "library_ms": None, "rows": pay["rows"], "bytes": pay["bytes"], "ops": pay["ops"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
