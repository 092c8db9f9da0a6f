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
   timed as in phase 5, at the inputs this phase gave them;
7. TPC-H Q1 and Q6 and SSB Q1.1-1.3 at SF1 through ``Session.sql`` on
   the fused leaf route (Q1 on the Q1 kernel once per ``lineitem`` split,
   the others on the leaf-aggregation kernel once per scan split, no
   fallback), each equal to an exact numpy recomputation, and equal
   again with ``narrow_storage`` off (the generic operators); then the
   leaf kernel is timed as in phase 5 at the first Q6 split, and over a
   resident SF1 x10 ``lineitem``;
8. the string predicates at SF1: TPC-H Q9 and SSB ``q_like_part`` and
   ``q_like_phone`` through ``Session.sql``, each in a session holding
   only its own connector (the LIKE kernel once per split of the
   filtered table, then the leaf kernel on ``lineorder`` for
   ``q_like_part`` and the join probes on ``lineitem`` for Q9, no
   fallback), each equal to an exact int64 numpy recomputation, with the
   wall of a first and a second run and the device busy time of a third;
   then ``starts_with(p_name, 'forest')`` over ``part`` through the scan
   -> FilterProject pipeline (the prefix kernel once per split), equal to
   ``p_name like 'forest%'`` and to Python's ``str.startswith``; then the
   LIKE kernel is timed as in phase 5 at the first Q9 ``part`` split and
   over SF1 ``o_comment``, and the prefix kernel at the first ``part``
   split of the pipeline.

The card's name and power limit come first and again before the last
lines, which are one JSON line ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
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
from presto_tpu_torch.ops import _build, cuda_agg, cuda_groupby, cuda_join, cuda_q1, cuda_strings
from presto_tpu_torch.ops.groupby import group_ids_direct, lane_sum_inputs
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.types import DATE, decimal, torch_dtype_of, varchar
from presto_tpu_torch.workloads import (
    Q1_BITS, Q1_COLS, part_name_pipeline, q1_aggs, q1_exprs, q1_fused_step, q1_pipeline)

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


def _col(rng, dtype, lo: int, hi: int, n: int) -> np.ndarray:
    return rng.integers(lo, hi, n, endpoint=True).astype(dtype)


def leaf_cases(rng, cap: int, live_rows: int | None = None):
    """Leaf-aggregation kernel cases: (name, spec, column arrays, live)
    with numpy inputs, shared by phase 2 and the CPU tests. The names
    say what each case exercises; a case named ``guard ...`` or ``bits
    violation`` must set value_overflow."""
    live = np.zeros(cap, np.bool_)
    live[: cap if live_rows is None else live_rows] = True
    live &= rng.random(cap) < 0.97  # dead rows throughout
    S, V, T = cuda_agg.LeafAggSpec, cuda_agg.ValueAgg, cuda_agg.Term
    q6_cols = [_col(rng, np.int16, 8035, 10591, cap), _col(rng, np.int8, 0, 10, cap),
               _col(rng, np.int16, 100, 5000, cap), _col(rng, np.int32, 90000, 10495000, cap)]
    q6 = S(("ship", "disc", "qty", "ep"), ((0, 8766, 9130), (1, 5, 7), (2, None, 2399)), (),
           1, (V("sum", T(3), T(1), 31),), ((1, 0, 10), (3, 90000, 10495000)))
    out = [("keyless Q6 shape", q6, q6_cols)]
    ssb_cols = [_col(rng, np.int32, 19920101, 19981231, cap), _col(rng, np.int16, 0, 1000, cap),
                _col(rng, np.int16, 100, 5000, cap), _col(rng, np.int32, 90, 99995, cap)]
    out.append(("keyless SSB Q1.1 shape", S(
        ("date", "disc", "qty", "ep"), ((1, 100, 300), (2, None, 2499)), (), 1,
        (V("sum", T(3), T(1), 27),), ((1, 0, 1000), (3, 90, 99995))), ssb_cols))
    k_cols = [_col(rng, np.int8, 0, 2, cap), _col(rng, np.int8, 0, 1, cap),
              _col(rng, np.int16, 100, 5000, cap), _col(rng, np.int32, 90000, 10495000, cap)]
    out.append(("6 groups, sums", S(
        ("rf", "ls", "qty", "ep"), ((2, 200, None),), ((0, 0, 2), (1, 0, 1)), 6,
        (V("sum", T(2), None, 13), V("sum", T(3), T(1, 100, -1), 31)),
        ((0, 0, 2), (1, 0, 1), (2, 100, 5000), (3, 90000, 10495000))), k_cols))
    g_cols = [_col(rng, np.int8, -3, 12, cap), _col(rng, np.int16, 100, 131, cap),
              _col(rng, np.int32, -10**6, 10**6, cap), _col(rng, np.int8, -100, 100, cap)]
    out.append(("512 groups, sum/min/max", S(
        ("k1", "k2", "a", "b"), ((3, -50, None),), ((0, -3, 32), (1, 100, 1)), 512,
        (V("sum", T(2), None, 20), V("sum", T(2), T(3), 27), V("min", T(2), T(3), 27),
         V("max", T(3, 7, 1), None, 7)),
        ((0, -3, 12), (1, 100, 131), (2, -10**6, 10**6), (3, -100, 100))), g_cols))
    out.append(("min/max only, 16 groups", S(
        ("k1", "k2", "a", "b"), (), ((0, -3, 1),), 16,
        (V("min", T(2), None, 20), V("max", T(2), None, 20), V("max", T(3, -5, -3), T(2), 30)),
        ((0, -3, 12), (2, -10**6, 10**6), (3, -100, 100))), g_cols))
    out.append(("wide coefficients, bits > 31", S(
        ("k1", "k2", "a", "b"), ((2, 0, None),), ((0, -3, 1),), 16,
        (V("sum", T(2, 3, 1_000_003), T(3), 57), V("sum", T(2, -(1 << 40), 1), None, 41)),
        ((0, -3, 12), (2, -10**6, 10**6), (3, -100, 100))), g_cols))
    out.append(("one-sided filters, negative coefficients", S(
        ("k1", "k2", "a", "b"), ((2, None, 500_000), (3, -20, None)), ((1, 100, 1),), 32,
        (V("sum", T(3, 100, -1), T(2, -5, -3), 30),),
        ((1, 100, 131), (2, -10**6, 10**6), (3, -100, 100))), g_cols))
    out.append(("unsatisfiable filter", S(
        ("k1", "k2", "a", "b"), ((2, 1, 0),), (), 1, (V("sum", T(2), None, 20),),
        ((2, -10**6, 10**6),)), g_cols))
    out.append(("count only", S(
        ("k1", "k2", "a", "b"), ((3, 0, 50),), ((0, -3, 1),), 16, (), ((0, -3, 12),)), g_cols))
    w_cols = [_col(rng, dt, -100, 100, cap)
              for dt in (np.int8, np.int16, np.int32, np.int64, np.int8, np.int16)]
    six = S(tuple(f"c{i}" for i in range(6)), ((0, -90, 90), (5, None, 95)), ((1, -100, 1),),
            201, tuple(V("sum", T(i), T((i + 1) % 6, 2, 1), 15) for i in range(5))
            + (V("min", T(3), None, 7),),
            ((1, -100, 100),) + tuple((i, -100, 100) for i in range(6) if i != 1))
    out.append(("6 columns, 6 values, an int64 column", six, w_cols))
    # the kernel's word-reading instance takes only the Q6 shape (at most
    # 4 narrow columns, 1 value); narrow columns past it take the generic one
    out.append(("6 narrow columns, 6 values", six,
                [c.astype(np.int32) if c.dtype == np.int64 else c for c in w_cols]))
    x_cols = w_cols + [_col(rng, dt, -1000, 1000, cap)
                       for dt in (np.int16, np.int32, np.int16, np.int32, np.int64, np.int16)]
    out.append(("12 columns, 10 values", S(
        tuple(f"c{i}" for i in range(12)), ((6, -900, 900), (11, -500, None)),
        ((4, -100, 1),), 201,
        tuple(V("sum" if i % 3 else "max", T(6 + i % 6), T(i % 6, 1, 1), 18) for i in range(10)),
        tuple((i, -1000, 1000) for i in range(12))),
        x_cols))
    # declared bounds violated: the kernel and the plain version flag them
    bad_v = [c.copy() for c in k_cols]
    passing = np.flatnonzero(live & (bad_v[2] >= 200))
    bad_v[3][passing[: 3]] = 20_000_000  # ep beyond its guard
    out.append(("guard value column", out[2][1], bad_v))
    bad_k = [c.copy() for c in k_cols]
    passing = np.flatnonzero(live & (bad_k[2] >= 200))
    bad_k[0][passing[: 2]] = 5  # returnflag code beyond its domain
    out.append(("guard key column", out[2][1], bad_k))
    out.append(("bits violation", S(
        ("rf", "ls", "qty", "ep"), (), ((0, 0, 2), (1, 0, 1)), 6,
        (V("sum", T(3), None, 20),), ((0, 0, 2), (1, 0, 1))), k_cols))
    return [(name, spec, cols, live) for name, spec, cols in out]


def leaf_batch(spec, cols, live, device) -> Batch:
    """A port batch of a leaf case: NULL-free columns sharing ``live``."""
    from presto_tpu_torch.types import BIGINT

    lt = torch.from_numpy(live).to(device)
    return Batch({n: Column(torch.from_numpy(np.ascontiguousarray(c)).to(device), lt, BIGINT)
                  for n, c in zip(spec.cols, cols)}, lt)


def check_leaf_agg_kernel(rng) -> int:
    err = 0
    for cap, live_rows in ((1 << 16, None), (1 << 20, None), (1_000_003, 999_000)):
        cases = leaf_cases(rng, cap, live_rows)
        for what, spec, cols, live in cases:
            b = leaf_batch(spec, cols, live, "cuda")
            got = cuda_agg.agg_step(spec, b)
            want = cuda_agg.agg_step_plain(spec, b)
            torch.cuda.synchronize()
            err = max(err, compare(got, want, f"agg_step {what} cap {cap}"))
            flagged = bool(got["value_overflow"])
            check(flagged == what.startswith(("guard", "bits")),
                  f"agg_step {what} cap {cap}: value_overflow={flagged}")
        log(f"  agg_step: {len(cases)} specs at cap {cap}: equal to plain, flags as expected")
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


# ---------------------------------------------------------------------------
# phase 7: the fused leaf route through Session.sql
# ---------------------------------------------------------------------------


def q1_sql_expected(conn) -> dict:
    """TPC-H Q1 as ``Session.sql`` returns it, recomputed in numpy: the
    decimal sums as scaled int64, the averages in float32 as the engine
    computes DOUBLE (sum times the float32 reciprocal of 10^scale, then
    one division by the count), groups in key order."""
    a = conn.table_numpy("lineitem", Q1_COLS)
    base = q1_expected(a)
    m = a["l_shipdate"] <= CUTOFF
    gid = (a["l_returnflag"].astype(np.int64) * 2 + a["l_linestatus"].astype(np.int64))[m]
    sum_disc = np.zeros(6, np.int64)
    np.add.at(sum_disc, gid, a["l_discount"][m].astype(np.int64))
    n = base["count_order"]
    g = np.flatnonzero(n > 0)
    d = conn.dictionaries("lineitem")
    inv = np.float32(1) / np.float32(100)

    def avg(s):
        return (s[g].astype(np.float32) * inv) / n[g].astype(np.float32)

    return {"l_returnflag": list(d["l_returnflag"].values[g // 2]),
            "l_linestatus": list(d["l_linestatus"].values[g % 2]),
            "sum_qty": base["sum_qty"][g], "sum_base_price": base["sum_base_price"][g],
            "sum_disc_price": base["sum_disc_price"][g], "sum_charge": base["sum_charge"][g],
            "avg_qty": avg(base["sum_qty"]), "avg_price": avg(base["sum_base_price"]),
            "avg_disc": avg(sum_disc), "count_order": n[g]}


Q6_COLS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
SSB_COLS = ["lo_orderdate", "lo_discount", "lo_quantity", "lo_extendedprice"]


def q6_mask(a) -> np.ndarray:
    """TPC-H Q6's filter on physical values: shipdate in 1994, discount
    between 0.05 and 0.07, quantity below 24."""
    ship, disc, qty = a["l_shipdate"], a["l_discount"], a["l_quantity"]
    return ((ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
            & (disc >= 5) & (disc <= 7) & (qty < 2400))


def revenue(ep, disc, m) -> dict:
    """sum(extendedprice * discount) at scale 4 over rows ``m``."""
    return {"revenue": np.array([int((ep[m].astype(np.int64) * disc[m].astype(np.int64)).sum())])}


def ssb_expected(conn) -> dict:
    """The SSB Q1 flight recomputed in int64 numpy: the date join as a
    set of date keys, the discount and quantity ranges on physical
    (scaled) values, revenue as the scale-4 sum."""
    d = conn.table_numpy("date", ["d_datekey", "d_year", "d_yearmonthnum", "d_weeknuminyear"])
    lo = conn.table_numpy("lineorder", SSB_COLS)
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    dates = {"q1_1": d["d_year"] == 1993, "q1_2": d["d_yearmonthnum"] == 199401,
             "q1_3": (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994)}
    ranges = {"q1_1": ((100, 300), (None, 2499)), "q1_2": ((400, 600), (2600, 3500)),
              "q1_3": ((500, 700), (2600, 3500))}
    out = {}
    for q, dm in dates.items():
        (dlo, dhi), (qlo, qhi) = ranges[q]
        m = np.isin(lo["lo_orderdate"], d["d_datekey"][dm]) & (disc >= dlo) & (disc <= dhi)
        m &= qty <= qhi
        if qlo is not None:
            m &= qty >= qlo
        out[q] = revenue(lo["lo_extendedprice"], disc, m)
    return out


def resident_q6(session, conn, want_rev: int, factor: int) -> dict:
    """Q6's leaf step over SF1 lineitem tiled ``factor`` times on the card
    in the connector's narrow storage, with the spec the matcher builds
    for Q6: equal to ``factor`` x the numpy revenue; timed."""
    from presto_tpu_torch.exec.leaf_route import match_leaf_fragment
    from presto_tpu_torch.plan import nodes as N

    node = session.plan(QUERIES["q6"])
    while not isinstance(node, N.Aggregate):
        node = node.child
    route, reason = match_leaf_fragment(node, session.catalog)
    check(route is not None and route.kind == "generic", f"Q6 did not match ({reason})")
    spec = route.spec
    arrays = conn.table_numpy("lineitem", route.src_cols)
    phys = conn.physical_schema("lineitem", route.src_cols)
    rows = len(arrays[route.src_cols[0]]) * factor

    def resident(a: np.ndarray) -> torch.Tensor:
        # 4 spare bytes: the leaf kernel reads narrow columns a 32-bit
        # word at a time, and the wrapper would copy a column without them
        buf = torch.empty(rows + 4, dtype=torch_dtype_of(a.dtype), device=conn.device)
        buf[:rows] = torch.from_numpy(a).to(conn.device).repeat(factor)
        return buf[:rows]

    live = resident(np.ones(rows // factor, np.bool_))
    cols = {route.rename[c]: Column(resident(arrays[c].astype(phys[c].np_dtype)), live, phys[c])
            for c in route.src_cols}
    batch = Batch(cols, live)
    torch.cuda.synchronize()
    state = cuda_agg.agg_step(spec, batch)
    got = int(state["sum_0"][0])
    check(got == factor * want_rev and not bool(state["value_overflow"]),
          f"resident Q6 step: {got} != {factor} x {want_rev}")
    err = compare(state, cuda_agg.agg_step_plain(spec, batch), "agg_step resident Q6")
    nbytes = sum(c.data.numel() * c.data.element_size() for c in cols.values()) + rows + 3 * 8
    return {"rows": rows, "bytes": nbytes, "err": err,
            "ms": device_ms(lambda: cuda_agg.agg_step(spec, batch), 20, kernel="leaf_agg_kernel"),
            "call_ms": call_ms(lambda: cuda_agg.agg_step(spec, batch), 20),
            "row_bytes": nbytes / rows}


def leaf_library_ms(spec, b, flush) -> float:
    """Device ms of the yardstick: one ``index_add_`` of the
    precomputed [rows, values + 1] int64 matrix (each passing row's sum
    values and a 1) into [groups + 1] (the trash group last). Sum
    values only, as Q6 has."""
    cols = [b[c].data.to(torch.int64) for c in spec.cols]
    live = b.live
    for ci, lo, hi in spec.filters:
        live = live & (cols[ci] >= lo if lo is not None else True)
        live = live & (cols[ci] <= hi if hi is not None else True)
    gid = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
    for ci, lo, stride in spec.keys:
        gid = gid + (cols[ci] - lo) * stride
    gid = torch.where(live, gid, torch.full_like(gid, spec.groups))

    def term(t):
        return t.c0 + t.c1 * cols[t.col] if t.col >= 0 else torch.full_like(gid, t.c0)

    vals = [term(v.a) * (term(v.b) if v.b is not None else 1) for v in spec.values]
    mat = torch.stack([torch.where(live, v, torch.zeros_like(v)) for v in vals]
                      + [live.to(torch.int64)], dim=1)
    out = torch.zeros(spec.groups + 1, mat.shape[1], dtype=torch.int64, device=b.device)

    def library():
        out.zero_()
        out.index_add_(0, gid, mat)

    ms = device_ms(library, 10, flush)
    got = cuda_agg.agg_step(spec, b)
    want = torch.stack([got[k] for k in cuda_agg.state_keys(spec)] + [got["count"]], dim=1)
    check(torch.equal(out[: spec.groups], want), "agg_step differs from the index_add_ call")
    return ms


def run_leaf_queries(flush: torch.Tensor, sf: float = 1, device: str = "cuda") -> dict:
    """Phase 7: TPC-H Q1 and Q6 and the SSB Q1 flight at SF1 through
    Session.sql on the fused leaf route (Q1 on the Q1 kernel, the others
    on the leaf-aggregation kernel), each equal to an exact numpy
    recomputation, and equal again with ``narrow_storage`` off (the
    generic operators); then the leaf kernel timed at the first Q6
    split and over a resident SF1 x10 lineitem."""
    from presto_tpu_torch.connectors.ssb import SsbConnector
    from presto_tpu_torch.connectors.ssb.queries import QUERIES as SSB
    from presto_tpu_torch.exec import leaf_route

    tconn = TpchConnector(sf=sf, device=device)
    sconn = SsbConnector(sf=sf, device=device)
    t0 = time.perf_counter()
    li = tconn.table_numpy("lineitem", Q6_COLS)
    want = {"q1": q1_sql_expected(tconn),
            "q6": revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li))}
    want.update({f"ssb {q}": w for q, w in ssb_expected(sconn).items()})
    log(f"phase 7: numpy recomputation of Q1, Q6 and SSB Q1.1-1.3 at SF1 in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {"q1": (QUERIES["q1"], tconn, "lineitem"), "q6": (QUERIES["q6"], tconn, "lineitem")}
    runs.update({f"ssb {q}": (SSB[q], sconn, "lineorder") for q in ("q1_1", "q1_2", "q1_3")})
    captured = []
    original = leaf_route.agg_step

    def capture(spec, batch):
        if not captured:
            captured.append((spec, batch))  # the first Q6 split of the main path
        return original(spec, batch)

    out = {"leaf_launches": 0, "walls": {}}
    narrow_before = os.environ.get("PRESTO_TPU_NARROW")
    try:
        for name, (sql, conn, table) in runs.items():
            # narrow_storage mirrors a process-wide switch: say it each time
            on = Session({"tpch": tconn, "ssb": sconn}, properties={"narrow_storage": True},
                         device=device)
            leaf_route.agg_step = capture if name == "q6" else original
            COUNTERS.clear()
            cuda_q1.launches = cuda_agg.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = on.sql(sql)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            n_q1, n_leaf = cuda_q1.launches, cuda_agg.launches
            route = dict(COUNTERS)
            leaf_route.agg_step = original
            same_result(res, want[name], f"{name} at SF1")
            splits = len(conn.splits(table))
            check(route.get("exec.leaf_fused_route", 0) == 1
                  and not any(k.startswith("exec.leaf_route_fallback") for k in route),
                  f"{name}: leaf route counters {route}")
            if name == "q1":
                check(n_q1 == splits and n_leaf == 0 and route.get("exec.q1_fused_route") == 1,
                      f"q1: {n_q1} Q1-kernel and {n_leaf} leaf-kernel launches for {splits} "
                      "lineitem splits")
            else:
                check(n_leaf == splits and n_q1 == 0,
                      f"{name}: {n_leaf} leaf-kernel and {n_q1} Q1-kernel launches for "
                      f"{splits} {table} splits")
                out["leaf_launches"] += n_leaf
            t0 = time.perf_counter()
            again = on.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            same_result(again, want[name], f"{name} at SF1, second run")
            busy_ms, scan_s = wall_breakdown(on, conn, sql)
            COUNTERS.clear()
            cuda_q1.launches = cuda_agg.launches = 0
            off = Session({"tpch": tconn, "ssb": sconn}, properties={"narrow_storage": False},
                          device=device).sql(sql)
            check(COUNTERS["exec.leaf_fused_route"] == 0 and cuda_q1.launches == 0
                  and cuda_agg.launches == 0, f"{name}: narrow_storage off still took the route")
            same_result(off, want[name], f"{name} at SF1 with narrow_storage off")
            out["walls"][name] = (first, second, busy_ms, scan_s)
            log(f"  {name}: {len(res)} rows equal to numpy, with narrow_storage off too; wall "
                f"first {first:.3f} s, second {second:.3f} s; Q1-kernel launches {n_q1}, "
                f"leaf-kernel launches {n_leaf} ({splits} splits); routes "
                f"{ {k: v for k, v in route.items() if k.startswith(('exec.', 'agg.'))} }")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans (host generation + copy to the card) {scan_s:.3f} s")
    finally:
        leaf_route.agg_step = original
        if narrow_before is None:
            os.environ.pop("PRESTO_TPU_NARROW", None)
        else:
            os.environ["PRESTO_TPU_NARROW"] = narrow_before

    spec, b = captured[0]
    fn = lambda: cuda_agg.agg_step(spec, b)  # noqa: E731
    plain = lambda: cuda_agg.agg_step_plain(spec, b)  # noqa: E731
    err = compare(fn(), plain(), "agg_step at the first Q6 split")
    nbytes = (sum(b[c].data.numel() * b[c].data.element_size() for c in spec.cols)
              + b.capacity + (spec.groups * (len(spec.values) + 1) + 1) * 8)
    out["split"] = {"ms": device_ms(fn, 50, flush, kernel="leaf_agg_kernel"),
                    "call_ms": call_ms(fn, 50), "plain_ms": device_ms(plain, 10, flush),
                    "library_ms": leaf_library_ms(spec, b, flush), "rows": b.capacity,
                    "bytes": nbytes, "err": err,
                    "ops": b.capacity * (2 * len(spec.cols) + 4 * len(spec.values) + 4),
                    "widths": [b[c].data.element_size() for c in spec.cols]}
    on = Session({"tpch": tconn}, properties={"narrow_storage": True}, device=device)
    out["resident"] = resident_q6(on, tconn, int(want["q6"]["revenue"][0]), FACTOR)
    return out


# ---------------------------------------------------------------------------
# phases 2 and 8: string predicates on byte columns
# ---------------------------------------------------------------------------

LIKE_ALPHABET = b"ab10"
PREFIXES = ["", "a", "ab", "1a0", "aaaaaaaa", "b" * 80]
# every LIKE pattern of the two query sets over its own SF1 column:
# (name, connector key, table, column, LIKE patterns, prefixes)
SF1_STRING_COLUMNS = [
    ("TPC-H p_name", "tpch", "part", "p_name", ["%green%", "forest%"], ["forest"]),
    ("TPC-H o_comment", "tpch", "orders", "o_comment", ["%special%requests%"], []),
    ("TPC-H s_comment", "tpch", "supplier", "s_comment", ["%Customer%Complaints%"], []),
    ("SSB p_name", "ssb", "part", "p_name", ["%sky%"], []),
    ("SSB c_name", "ssb", "customer", "c_name", ["Customer%1"], []),
]


def like_patterns() -> list:
    """The LIKE pattern set: the fixed shapes (empty, only wildcards, an
    exact literal, prefix, suffix, both anchors, ordered segments,
    repeated bytes for the greedy rule, '%1' for the suffix rule, a
    segment longer than any width), then 16 random ones from a seed."""
    fixed = ["", "%", "%%", "ab", "ab%", "%ab", "a%b", "%a%b%",
             "%aa%", "%aa%a%", "aa%aa", "%aaa", "a%a", "%1", "1%1", "%01%1",
             "%" + "a" * 80 + "%", "a" * 80, "a" * 80 + "%", "%" + "b" * 80]
    rng = np.random.default_rng(4)
    out = list(fixed)
    while len(out) < len(fixed) + 16:
        segs = ["".join(chr(c) for c in rng.choice(list(LIKE_ALPHABET), rng.integers(0, 3)))
                for _ in range(rng.integers(1, 4))]
        p = "%".join(segs)
        if p not in out:
            out.append(p)
    return out


def string_rows(width: int, cap: int, seed: int) -> np.ndarray:
    """[cap, width] uint8: zero-padded strings over a small alphabet (so
    the patterns hit), '011' rows for the suffix rule, and about 6 % dead
    rows of arbitrary bytes, zeros inside them included (a row's length
    is its count of nonzero bytes)."""
    rng = np.random.default_rng(seed)
    out = rng.choice(np.frombuffer(LIKE_ALPHABET, np.uint8), size=(cap, width))
    lens = rng.integers(0, width + 1, cap)
    out[np.arange(width)[None, :] >= lens[:, None]] = 0
    k = min(width, 3)
    out[::17, :] = 0
    out[::17, :k] = np.frombuffer(b"011", np.uint8)[:k]
    dead = rng.random(cap) < 0.06
    out[dead] = rng.integers(0, 256, (int(dead.sum()), width))
    return out


def small_capacity(width: int) -> int:
    """A row count under 2^10 and not a multiple of 256 for every width
    up to 256 (a last tile that is partial)."""
    return 1021 - 3 * width


def like_oracle(texts: list, pattern: str) -> np.ndarray:
    """LIKE with '%' over decoded strings by Python's ``re``."""
    rx = re.compile(".*".join(re.escape(s) for s in pattern.split("%")), re.DOTALL)
    return np.fromiter((rx.fullmatch(t) is not None for t in texts), np.bool_, len(texts))


def column_rows(conn, table: str, column: str) -> np.ndarray:
    """A BYTES column of the whole table, zero-padded to its schema width
    as the scans deliver it."""
    a = conn.table_numpy(table, [column])[column]
    out = np.zeros((a.shape[0], conn.schema(table)[column].width), np.uint8)
    out[:, : a.shape[1]] = a
    return out


def _mask_err(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    check(got.dtype == torch.bool and got.shape == want.shape,
          f"{what}: {got.dtype}{tuple(got.shape)} != {want.dtype}{tuple(want.shape)}")
    d = int((got.to(torch.int8) - want.to(device=got.device, dtype=torch.int8)).abs().max()) \
        if got.numel() else 0
    check(d == 0, f"{what}: differs from the plain version")
    return d


def check_string_kernels(connectors) -> tuple:
    """Phase 2 for the LIKE and prefix kernels: the pattern set over
    widths 1 to 256 at capacities that are not multiples of 256, then
    every LIKE pattern of the query sets over its own SF1 column, each
    against the plain version and, on the SF1 columns, Python's ``re``.
    Returns (LIKE max error, prefix max error, SF1 columns on the card)."""
    like_err = prefix_err = 0
    for width in (1, 7, 22, 55, 79, 256):
        for cap in (small_capacity(width), (1 << 17) + 3):
            data = _t(string_rows(width, cap, width + cap))
            for p in like_patterns():
                like_err = max(like_err, _mask_err(
                    cuda_strings.like_mask(data, p), cuda_strings.like_mask_plain(data, p),
                    f"like_mask {p!r} W={width} cap {cap}"))
            for p in PREFIXES:
                prefix_err = max(prefix_err, _mask_err(
                    cuda_strings.starts_with_mask(data, p),
                    cuda_strings.starts_with_mask_plain(data, p),
                    f"starts_with_mask {p!r} W={width} cap {cap}"))
        torch.cuda.synchronize()
    log(f"  like_mask: {len(like_patterns())} patterns, starts_with_mask: {len(PREFIXES)} "
        "prefixes, widths 1, 7, 22, 55, 79, 256 at 2 capacities each: equal to plain")
    for p in ("a_b", "%_"):
        try:
            cuda_strings.like_mask(data, p)
        except NotImplementedError:
            continue
        raise RuntimeError(f"like_mask accepted {p!r}")
    columns = {}
    for name, key, table, column, patterns, prefixes in SF1_STRING_COLUMNS:
        rows = column_rows(connectors[key], table, column)
        data = _t(rows)
        columns[name] = data
        texts = _text(rows)
        for p in patterns:
            got = cuda_strings.like_mask(data, p)
            like_err = max(like_err, _mask_err(got, cuda_strings.like_mask_plain(data, p),
                                               f"like_mask {name} {p!r}"))
            want = torch.from_numpy(like_oracle(texts, p))
            check(torch.equal(got.cpu(), want), f"like_mask {name} {p!r} differs from re")
            log(f"  like_mask {name} [{data.shape[0]}, {data.shape[1]}] {p!r}: equal to plain "
                f"and to re, {int(want.sum())} rows match")
        for p in prefixes:
            got = cuda_strings.starts_with_mask(data, p)
            prefix_err = max(prefix_err, _mask_err(
                got, cuda_strings.starts_with_mask_plain(data, p), f"starts_with {name} {p!r}"))
            want = torch.tensor([t.startswith(p) for t in texts])
            check(torch.equal(got.cpu(), want), f"starts_with {name} {p!r} differs from str")
            log(f"  starts_with_mask {name} {p!r}: equal to plain and to str.startswith, "
                f"{int(want.sum())} rows match")
    return like_err, prefix_err, columns


def q9_expected(conn) -> dict:
    """TPC-H Q9 recomputed in int64 numpy: green parts by Python's ``in``,
    each join an exact key lookup (partsupp's on the pair of keys), the
    profit at scale 4 (ep * (100 - disc) - supplycost * qty), grouped by
    nation name and order year, sorted by nation and year descending."""
    p = conn.table_numpy("part", ["p_partkey", "p_name"])
    green = np.array(["green" in t for t in _text(p["p_name"])], dtype=bool)
    parts = np.sort(p["p_partkey"][green])
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                                       "l_extendedprice", "l_discount"])
    m = _lookup(parts, li["l_partkey"])[1]
    li = {k: v[m] for k, v in li.items()}
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey"])
    so = np.argsort(s["s_suppkey"])
    spos, shit = _lookup(s["s_suppkey"][so], li["l_suppkey"])
    n = conn.table_numpy("nation", ["n_nationkey", "n_name"])
    no = np.argsort(n["n_nationkey"])
    npos, nhit = _lookup(n["n_nationkey"][no], s["s_nationkey"][so][spos])
    ps = conn.table_numpy("partsupp", ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    mult = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max(initial=0))) + 1
    pk = ps["ps_partkey"].astype(np.int64) * mult + ps["ps_suppkey"]
    po = np.argsort(pk)
    ppos, phit = _lookup(pk[po], li["l_partkey"].astype(np.int64) * mult + li["l_suppkey"])
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    oo = np.argsort(o["o_orderkey"])
    opos, ohit = _lookup(o["o_orderkey"][oo], li["l_orderkey"])
    hit = shit & nhit & phit & ohit
    qty, ep, disc = (li[c].astype(np.int64)[hit]
                     for c in ("l_quantity", "l_extendedprice", "l_discount"))
    amount = ep * (100 - disc) - ps["ps_supplycost"][po][ppos][hit].astype(np.int64) * qty
    days_ = o["o_orderdate"][oo][opos][hit].astype(np.int64)
    year = (np.datetime64("1970-01-01", "D") + days_).astype("datetime64[Y]").astype(np.int64) + 1970
    code = n["n_name"][no][npos][hit].astype(np.int64)  # dictionary codes sort as the names
    keys, inv = np.unique(code * 10000 + year, return_inverse=True)
    sums = np.zeros(keys.size, np.int64)
    np.add.at(sums, inv, amount)
    kc, ky = keys // 10000, keys % 10000
    order = np.lexsort((-ky, kc))
    names = conn.dictionaries("nation")["n_name"].values
    return {"nation": list(names[kc[order]]), "o_year": ky[order], "sum_profit": sums[order]}


def like_part_expected(conn) -> dict:
    """SSB ``q_like_part``: count and revenue of the lineorder rows whose
    part name contains 'sky' (Python's ``in``)."""
    p = conn.table_numpy("part", ["p_partkey", "p_name"])
    sky = np.sort(p["p_partkey"][np.array(["sky" in t for t in _text(p["p_name"])], bool)])
    lo = conn.table_numpy("lineorder", ["lo_partkey", "lo_revenue"])
    m = _lookup(sky, lo["lo_partkey"])[1]
    return {"cnt": np.array([int(m.sum())]),
            "revenue": np.array([int(lo["lo_revenue"][m].astype(np.int64).sum())])}


def like_phone_expected(conn) -> dict:
    """SSB ``q_like_phone``: lineorder rows per customer region, for the
    customers whose name matches 'Customer%1' (Python's ``re``) and whose
    phone does not start with '33'; regions in name order."""
    c = conn.table_numpy("customer", ["c_custkey", "c_name", "c_region", "c_phone"])
    keep = like_oracle(_text(c["c_name"]), "Customer%1")
    keep &= np.array([t[:2] != "33" for t in _text(c["c_phone"])], bool)
    order = np.argsort(c["c_custkey"][keep])
    keys, regions = c["c_custkey"][keep][order], c["c_region"][keep][order]
    lo = conn.table_numpy("lineorder", ["lo_custkey"])
    pos, hit = _lookup(keys, lo["lo_custkey"])
    names = conn.dictionaries("customer")["c_region"].values
    counts = np.bincount(regions[pos[hit]].astype(np.int64), minlength=len(names))
    present = np.flatnonzero(counts)
    return {"c_region": list(names[present]), "cnt": counts[present]}


def prefix_rows_expected(conn, prefix: str) -> np.ndarray:
    """Sorted part keys whose name starts with ``prefix`` (``str``)."""
    p = conn.table_numpy("part", ["p_partkey", "p_name"])
    return np.sort(p["p_partkey"][np.array([t.startswith(prefix) for t in _text(p["p_name"])],
                                           bool)])


def pipeline_keys(pipe) -> np.ndarray:
    """Sorted ``p_partkey`` of the live rows a part pipeline emits."""
    parts = [b["p_partkey"].data[b.live].to(torch.int64).cpu().numpy() for b in pipe.run()]
    return np.sort(np.concatenate(parts)) if parts else np.zeros(0, np.int64)


def _reset_launches() -> None:
    cuda_q1.launches = cuda_groupby.launches = cuda_agg.launches = 0
    cuda_join.exists_launches = cuda_join.payload_launches = 0
    cuda_strings.like_launches = cuda_strings.prefix_launches = 0


def _launch_counts() -> dict:
    return {"q1": cuda_q1.launches, "lane_sums": cuda_groupby.launches,
            "leaf_agg": cuda_agg.launches, "exists": cuda_join.exists_launches,
            "payload": cuda_join.payload_launches, "like": cuda_strings.like_launches,
            "prefix": cuda_strings.prefix_launches}


# each query at SF1: (connector key, the table LIKE filters, the other
# kernels it must launch once per split of the named table: Q9's part and
# nation joins probe the lineitem stream, q_like_part folds its join into
# the leaf route, q_like_phone's 5-group count takes the direct route)
STRING_QUERIES = {
    "q9": ("tpch", "part", {"exists": "lineitem", "payload": "lineitem"}),
    "ssb q_like_part": ("ssb", "part", {"leaf_agg": "lineorder"}),
    "ssb q_like_phone": ("ssb", "customer", {"lane_sums": "lineorder"}),
}


def run_string_queries(connectors: dict, sf: float = 1, device: str = "cuda") -> dict:
    """Phase 8: Q9, ``q_like_part`` and ``q_like_phone`` at SF1 through
    Session.sql, each in a session holding only its own connector, then
    the ``starts_with`` pipeline over ``part``. Returns the launch counts,
    walls and the inputs the kernels were given (for phase 5)."""
    from presto_tpu_torch.connectors.ssb.queries import QUERIES as SSB

    t0 = time.perf_counter()
    want = {"q9": q9_expected(connectors["tpch"]),
            "ssb q_like_part": like_part_expected(connectors["ssb"]),
            "ssb q_like_phone": like_phone_expected(connectors["ssb"])}
    log(f"phase 8: numpy recomputation of Q9, q_like_part and q_like_phone at SF{sf:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    sqls = {"q9": QUERIES["q9"], "ssb q_like_part": SSB["q_like_part"],
            "ssb q_like_phone": SSB["q_like_phone"]}
    captured = {}
    original_like = cuda_strings.like_mask

    def capture_like(data, pattern):
        captured.setdefault("like", (data, pattern))  # Q9's first part split
        return original_like(data, pattern)

    out = {"like_launches": 0, "walls": {}, "launches": {}}
    for name, (key, ftable, others) in STRING_QUERIES.items():
        conn = connectors[key]
        session = Session({key: conn}, device=device)
        cuda_strings.like_mask = capture_like if name == "q9" else original_like
        try:
            COUNTERS.clear()
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = session.sql(sqls[name])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            n = _launch_counts()
            route = dict(COUNTERS)
        finally:
            cuda_strings.like_mask = original_like
        same_result(res, want[name], f"{name} at SF{sf:g}")
        splits = len(conn.splits(ftable))
        check(n["like"] == splits, f"{name}: {n['like']} LIKE launches for {splits} "
              f"{ftable} splits")
        for kernel, table in others.items():
            k = len(conn.splits(table))
            check(n[kernel] == k, f"{name}: {n[kernel]} {kernel} launches for {k} {table} splits")
        fallbacks = {k: v for k, v in route.items()
                     if k.startswith(("join.pallas_fallback", "exec.leaf_route_fallback"))}
        check(not fallbacks, f"{name}: fallbacks counted {fallbacks}")
        out["like_launches"] += n["like"]
        out["launches"][name] = n
        t0 = time.perf_counter()
        again = session.sql(sqls[name])
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        same_result(again, want[name], f"{name} at SF{sf:g}, second run")
        busy_ms, scan_s = wall_breakdown(session, conn, sqls[name])
        out["walls"][name] = (first, second, busy_ms, scan_s)
        log(f"  {name}: {len(res)} rows equal to numpy; wall first {first:.3f} s, second "
            f"{second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
            f"{ {k: v for k, v in route.items() if k.startswith(('exec.', 'agg.', 'join.'))} }")
        log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
            f"connector scans (host generation + copy to the card) {scan_s:.3f} s")

    # starts_with over part through the scan -> FilterProject pipeline
    tconn = connectors["tpch"]
    original_prefix = cuda_strings.starts_with_mask

    def capture_prefix(data, prefix):
        captured.setdefault("prefix", (data, prefix))
        return original_prefix(data, prefix)

    want_keys = prefix_rows_expected(tconn, "forest")
    cuda_strings.starts_with_mask = capture_prefix
    try:
        _reset_launches()
        t0 = time.perf_counter()
        got = pipeline_keys(part_name_pipeline(tconn, "starts_with", "forest"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = _launch_counts()
    finally:
        cuda_strings.starts_with_mask = original_prefix
    splits = len(tconn.splits("part"))
    check(n["prefix"] == splits and n["like"] == 0,
          f"starts_with pipeline: {n['prefix']} prefix launches for {splits} part splits")
    check(np.array_equal(got, want_keys), "starts_with pipeline differs from str.startswith")
    like_keys = pipeline_keys(part_name_pipeline(tconn, "like", "forest%"))
    check(np.array_equal(got, like_keys), "starts_with pipeline differs from like 'forest%'")
    out["prefix_launches"] = n["prefix"]
    log(f"  starts_with(p_name, 'forest') pipeline: {got.size} rows equal to str.startswith "
        f"and to p_name like 'forest%'; wall {wall:.3f} s; prefix launches {n['prefix']} "
        f"({splits} part splits)")
    out["captured"] = captured
    return out


def time_like(data: torch.Tensor, pattern: str, flush) -> dict:
    """Phase 5 numbers of the LIKE kernel on ``data``: its bound counts
    each row read once and one bool written, and one byte comparison per
    byte read (the least any matcher does)."""
    fn = lambda: cuda_strings.like_mask(data, pattern)  # noqa: E731
    plain = lambda: cuda_strings.like_mask_plain(data, pattern)  # noqa: E731
    err = _mask_err(fn(), plain(), f"like_mask {pattern!r} at phase 5")
    n, w = data.shape
    return {"ms": device_ms(fn, 50, flush, kernel="like_kernel"), "call_ms": call_ms(fn, 50),
            "plain_ms": device_ms(plain, 5, flush), "rows": n, "width": w,
            "pattern": pattern, "bytes": n * (w + 1), "ops": n * w, "err": err}


def time_prefix(data: torch.Tensor, prefix: str, flush) -> dict:
    """Phase 5 numbers of the prefix kernel on ``data``: its bound counts
    the L prefix bytes of each row read once, one bool written and L
    comparisons a row."""
    fn = lambda: cuda_strings.starts_with_mask(data, prefix)  # noqa: E731
    plain = lambda: cuda_strings.starts_with_mask_plain(data, prefix)  # noqa: E731
    err = _mask_err(fn(), plain(), f"starts_with_mask {prefix!r} at phase 5")
    n, w = data.shape
    length = len(prefix.encode("latin1"))
    return {"ms": device_ms(fn, 50, flush, kernel="prefix_kernel"), "call_ms": call_ms(fn, 50),
            "plain_ms": device_ms(plain, 10, flush), "rows": n, "width": w,
            "prefix": prefix, "bytes": n * (length + 1), "ops": n * length, "err": err}


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
    leaf_err = check_leaf_agg_kernel(rng)
    from presto_tpu_torch.connectors.ssb import SsbConnector

    string_conns = {"tpch": TpchConnector(sf=1, device="cuda"),
                    "ssb": SsbConnector(sf=1, device="cuda")}
    like_err, prefix_err, sf1_strings = check_string_kernels(string_conns)

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

    leaf = run_leaf_queries(flush)
    sp, res_ = leaf["split"], leaf["resident"]
    leaf_bound, leaf_by = bound(sp["bytes"], sp["ops"])
    res_bound, _ = bound(res_["bytes"], 0)
    log(f"phase 5, leaf-aggregation kernel at phase 7's first Q6 split (kernel device ms; "
        f"call = wrapper, events; plain and index_add_ = device ms of all their kernels): "
        f"agg_step {sp['ms']:.4f} (call {sp['call_ms']:.4f}, plain {sp['plain_ms']:.4f}, "
        f"index_add_ {sp['library_ms']:.4f}, bound {leaf_bound:.4f}) at {sp['rows']} rows, "
        f"column widths {sp['widths']} B + live, {sp['bytes']} B")
    log(f"  Q6 leaf step over resident SF1 x{FACTOR} lineitem: {res_['rows']} rows, "
        f"{res_['row_bytes']:.2f} B/row, kernel {res_['ms']:.4f} ms (call {res_['call_ms']:.4f} "
        f"ms, bound {res_bound:.4f} ms) = {res_['rows'] / (res_['ms'] / 1e3):.4e} rows/s; "
        f"equal to {FACTOR}x numpy and to plain")
    for name, (first, second, busy, scan) in leaf["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")

    strings = run_string_queries(string_conns)
    like_data, like_pattern = strings["captured"]["like"]
    lk = time_like(like_data, like_pattern, flush)
    lk_big = time_like(sf1_strings["TPC-H o_comment"], "%special%requests%", flush)
    prefix_data, prefix = strings["captured"]["prefix"]
    px = time_prefix(prefix_data, prefix, flush)
    like_bound, like_by = bound(lk["bytes"], lk["ops"])
    big_bound, _ = bound(lk_big["bytes"], lk_big["ops"])
    prefix_bound, prefix_by = bound(px["bytes"], px["ops"])
    log(f"phase 5, string kernels (kernel device ms; call = wrapper, events; plain = device "
        f"ms of all its kernels; no single PyTorch call computes either): like_mask "
        f"{lk['pattern']!r} at phase 8's first Q9 part split [{lk['rows']}, {lk['width']}] "
        f"{lk['ms']:.4f} (call {lk['call_ms']:.4f}, plain {lk['plain_ms']:.4f}, bound "
        f"{like_bound:.4f}); over SF1 o_comment [{lk_big['rows']}, {lk_big['width']}] "
        f"{lk_big['pattern']!r} {lk_big['ms']:.4f} (call {lk_big['call_ms']:.4f}, plain "
        f"{lk_big['plain_ms']:.4f}, bound {big_bound:.4f}); starts_with_mask {px['prefix']!r} "
        f"at the pipeline's first part split [{px['rows']}, {px['width']}] {px['ms']:.4f} "
        f"(call {px['call_ms']:.4f}, plain {px['plain_ms']:.4f}, bound {prefix_bound:.4f})")
    for name, (first, second, busy, scan) in strings["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")

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
        {"name": "leaf_agg", "route": "cuda", "source": "presto_tpu_torch/csrc/leaf_agg.cu",
         "replaces": "presto_tpu/ops/pallas_agg.py:180",
         "jax_function": "presto_tpu/ops/pallas_agg.py:246 _pallas_step (via agg_step :346)",
         "launches": leaf["leaf_launches"], "max_abs_err": max(leaf_err, sp["err"], res_["err"]),
         "ms": sp["ms"], "kernel_ms": sp["ms"], "call_ms": sp["call_ms"],
         "plain_ms": sp["plain_ms"], "bound_ms": leaf_bound, "bound_by": leaf_by,
         "library_ms": sp["library_ms"], "rows": sp["rows"], "bytes": sp["bytes"],
         "ops": sp["ops"], "resident_ms": res_["ms"], "resident_bound_ms": res_bound,
         "resident_rows": res_["rows"]},
        {"name": "like_mask", "route": "cuda", "source": "presto_tpu_torch/csrc/strings.cu",
         "replaces": "presto_tpu/ops/pallas_strings.py:118",
         "jax_function": "presto_tpu/ops/pallas_strings.py:190 like_mask_pallas",
         "launches": strings["like_launches"], "max_abs_err": max(like_err, lk["err"],
                                                                   lk_big["err"]),
         "ms": lk["ms"], "kernel_ms": lk["ms"], "call_ms": lk["call_ms"],
         "plain_ms": lk["plain_ms"], "bound_ms": like_bound, "bound_by": like_by,
         "library_ms": None, "rows": lk["rows"], "width": lk["width"], "bytes": lk["bytes"],
         "ops": lk["ops"], "pattern": lk["pattern"], "o_comment_ms": lk_big["ms"],
         "o_comment_call_ms": lk_big["call_ms"], "o_comment_plain_ms": lk_big["plain_ms"],
         "o_comment_bound_ms": big_bound, "o_comment_rows": lk_big["rows"]},
        {"name": "starts_with_mask", "route": "cuda",
         "source": "presto_tpu_torch/csrc/strings.cu",
         "replaces": "presto_tpu/ops/pallas_strings.py:246",
         "jax_function": "presto_tpu/ops/pallas_strings.py:251 starts_with_pallas",
         "launches": strings["prefix_launches"], "max_abs_err": max(prefix_err, px["err"]),
         "ms": px["ms"], "kernel_ms": px["ms"], "call_ms": px["call_ms"],
         "plain_ms": px["plain_ms"], "bound_ms": prefix_bound, "bound_by": prefix_by,
         "library_ms": None, "rows": px["rows"], "width": px["width"], "bytes": px["bytes"],
         "ops": px["ops"], "prefix": px["prefix"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
