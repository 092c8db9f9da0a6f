#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
``presto_tpu_torch`` only (nothing of JAX or of the JAX package), needs
one CUDA card, and exits nonzero on any failure. Phases:

1. build every CUDA kernel of the path from ``presto_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card,
   exactly, at several shapes, in the connector's narrow column widths
   and in wider ones, and at the guard cases that must flag; the
   leaf-aggregation and lane-sums kernels also at the edges of their
   2048-row tiles (capacities 1, 15, 17, 2047, 2049), with every row
   dead, on columns that are views one element into their buffer, and
   in every instance they have (each must run at least once); the
   exists and sketch kernels also in the keep and anti modes the join
   operator launches (int8/int16/int32 keys, capacities 1, 3, 15, 17,
   2^16, 2^20 and 1,000,003, views, all rows dead, no validity and NULL
   keys; every output byte 0 or 1; both instances of each must run); the
   payload kernel through ``payload_keep`` (inner and left, 0, 1, 4 and
   16 value columns written as int8/int16/int32/int64) and
   ``payload_probe`` at the same keys, capacities and views, its tables
   staged in shared memory and not (all four instances must run); the
   LIKE kernel on the pattern set and an edge set (segments of 31-65
   bytes, more segments than its tables hold, common first bytes,
   ``Customer%1``-shaped anchors) over widths 1-256 at tile-edge and
   ragged capacities, aligned and as row views (all six instances must
   run); the prefix kernel on the same rows with fixed prefixes and ones
   taken from a row (1-8, 63, 64, 65 and W bytes), at bases 0-3 bytes
   past an aligned word (both instances must run, each launch on the
   instance its prefix calls for);
3. resident TPC-H Q1: SF1 ``lineitem`` tiled x10 (about 60M rows) in
   the connector's narrow storage, through ``workloads.q1_fused_step``
   (the Q1 kernel); equal to 10x a numpy recomputation, and the kernel
   equal to its plain version on that batch;
4. the Q1 pipeline at SF1 (scan -> filter -> direct hash aggregation ->
   the lane-sums kernel, every launch on its staged instance for 4
   values and 5 masks); equal to the numpy recomputation;
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
   timed as in phase 5, at the inputs this phase gave them (the exists
   kernel at the first ``exists_keep`` call of Q3's operator and the
   payload kernel at the first ``payload_keep`` call of Q10's, each with
   the device time of that whole probe batch, whose trace must hold one
   kernel); in phases 6, 8 and 9 every exists, sketch and payload launch
   must take a vector instance, and every payload launch of Q9 and Q10
   must come from one ``payload_keep`` call (one per ``lineitem``
   split);
7. TPC-H Q1 and Q6 and SSB Q1.1-1.3 at SF1 through ``Session.sql`` on
   the fused leaf route (Q1 on the Q1 kernel once per ``lineitem`` split,
   the others on the leaf-aggregation kernel's staged instance once per
   scan split, no fallback), each equal to an exact numpy recomputation,
   and equal again in a second run and with ``narrow_storage`` off (the
   generic operators);
   then the leaf kernel is timed as in phase 5 at the first Q6 split, at
   the first SSB Q1.1 split, and over a resident SF1 x10 ``lineitem``;
8. the string predicates at SF1: TPC-H Q9 and SSB ``q_like_part`` and
   ``q_like_phone`` through ``Session.sql``, each in a session holding
   only its own connector (the LIKE kernel once per split of the
   filtered table, then the leaf kernel on ``lineorder`` for
   ``q_like_part`` and the join probes on ``lineitem`` for Q9, no
   fallback), each equal to an exact int64 numpy recomputation, with the
   wall of a first and a second run and the device busy time of a third;
   then ``starts_with(p_name, 'forest')`` over ``part`` through the scan
   -> FilterProject pipeline (the prefix kernel once per split), equal to
   ``p_name like 'forest%'`` and to Python's ``str.startswith``; every
   LIKE launch of the queries on the staged instance of its pattern's
   matcher; then the LIKE kernel is timed as in phase 5 at each query's
   first split of the table it filters and over SF1 ``o_comment``, and
   the prefix kernel at the first ``part`` split of the pipeline, the
   lane-sums kernel at the first ``q_like_phone`` ``lineorder`` split and
   the exists and payload kernels at Q9's first ``lineitem`` probe
   batches;
9. semi and anti joins at SF1 through ``Session.sql``: TPC-H Q4 exact
   (the dense membership probe) and with ``approx_join`` (the sketch
   kernel once per ``orders`` split, equal to a numpy Bloom oracle that
   also applies the runtime join filter's range and Bloom bits, and at
   least the exact count in every group), the JAX tests' ``semi`` and
   ``anti`` statements exact and approximate (``anti`` stays exact and
   never launches the sketch), ``semi_anti_part`` (the exists kernel once
   per ``part`` split for each of its two joins), Q4 at sf 0.01 on the
   leaf route's membership fold (the leaf kernel once per ``orders``
   split), each with the walls of a first and a second run, the device
   busy time of a third and the launches per kernel; then the resident
   Q3 join step (``workloads.q3_probe_step``, the Q3 kernel) over SF1
   ``lineitem`` and over SF1 x10, equal to the benchmark's oracle and to
   its plain version; then the sketch kernel is timed as in phase 5 at
   the first probe batch of Q4 and of ``semi`` under ``approx_join``,
   the exists kernel at ``semi_anti_part``'s first anti-join batch (each
   with its whole probe batch, one kernel), the lane-sums kernel at
   Q4's first ``orders`` split and the Q3 kernel at SF1 and SF1 x10;
10. expansion and LEFT OUTER joins through ``Session.sql``: TPC-H Q13 at
   SF1 (a LEFT expansion join of ``customer`` with the ``orders`` its ON
   clause's ``not like`` keeps, the LIKE kernel once per ``orders``
   split on its staged Shift-And instance) and Q5 at sf 0.05 (an inner
   expansion join on ``c_nationkey = s_nationkey``; sf 0.05 is the
   largest round scale at which the JAX package's own retry ladder
   answers it), each equal to an exact numpy recomputation, with the
   walls of a first and a second run, the device busy time of a third,
   the launches per kernel, ``join.strategy.expand`` and the output
   capacities each expansion probe's retry ladder tried;
11. the conditional expression library, DISTINCT and BYTES keys at SF1
   through ``Session.sql``: TPC-H Q7, Q8, Q12, Q14, Q16 and Q19, SSB
   ``q3_3``, ``q3_4``, ``q4_1``, ``q4_2`` and ``q4_3``, and three
   statements (``AD_HOC``: ORDER BY a BYTES column under OR and unary
   minus; GROUP BY a BYTES substring with ``count(DISTINCT ...)``; CASE,
   IS NULL and COALESCE over a LEFT join's NULL-extended rows), each
   equal to an exact numpy recomputation (Q8's and Q14's DOUBLE ratios
   with the same float32 operations) and to the strategy counters its
   plan predicts (``planned_routes``), with the walls of a first and a
   second run, the device busy time of a third and its five largest
   device ops, and the launches per kernel (LIKE once per ``supplier``
   split for Q16, none elsewhere; every probe launch on a vector
   instance); the first exists and payload call of each probe shape the
   phase launches (rows and key type) is launched again and held to its
   plain version, and every row count of its probe launches must be one
   so held; ``count(*)`` beside a DISTINCT aggregate must be refused;
12. scalar subqueries, WITH and the ``<>``-correlated EXISTS at SF1
   through ``Session.sql``: TPC-H Q2 and Q17 (correlated scalar
   subqueries, decorrelated into a group-by and a unique join), Q11
   (an uncorrelated scalar in HAVING), Q15 (WITH, its view planned twice,
   and ``total_revenue = (select max ...)``, whose DECIMAL value makes
   the scalar round trip), Q20 (a correlated scalar on two keys under
   IN; ``p_name like 'forest%'`` runs the LIKE kernel once per ``part``
   split, as the JAX package routes it), Q21 (EXISTS and NOT EXISTS
   correlated by ``<>``: min/max per order, LEFT-joined) and Q22 (an
   uncorrelated scalar beside NOT EXISTS), each equal to an exact numpy
   recomputation (DOUBLE steps with the same float32 operations) and to
   the strategy counters its plan predicts, with the walls of a first
   and a second run, the device busy time of a third and its five
   largest device ops, and the launches per kernel; every exists and
   payload launch shape and Q20's first LIKE launch held to the plain
   version;
13. the join features at SF1 through ``Session.sql``: a join of two
   dictionaries' keys (``dict_bytes``, then ``bytes_pack``), a 15-byte
   BYTES key on a unique build (``bytes_hash`` and a verify pair), a
   two-key join with a negative key (``hash63_mix``, verified, an
   expansion), FULL OUTER joins on an expansion and a unique build,
   RIGHT joins (Q13 written with RIGHT JOIN, and a RIGHT join whose
   swapped LEFT join takes the payload kernel in left mode), and the
   runtime join filters on Q3 and Q10 (and Q3 with them off), each equal
   to a numpy recomputation, to the strategy counters its plan predicts
   and to the filter's counters recomputed in numpy from its range and
   Bloom bits, with the walls of a first and a second run, the device
   busy time of a third and its five largest device ops, and the
   launches per kernel; Q9's and Q21's filter counters likewise; every
   exists and payload launch shape held to the plain version;
14. the first half of the SQL surface at SF1 through ``Session.sql``
   (``SURFACE_SQL``): plain LIMIT twice (the first rows in split order),
   a SELECT without FROM, UNION ALL across two dictionaries, UNION
   DISTINCT, INTERSECT and EXCEPT, IN over a UNION build, the math
   functions with ``stddev`` / ``variance`` grouped, the string
   functions over BYTES (and a LIKE over ``||``, the LIKE kernel once
   per ``customer`` split) and over dictionary VARCHAR, the date
   functions over the orders-lineitem join and the casts under a LIMIT,
   each equal to a numpy recomputation (DOUBLE columns within
   ``DOUBLE_TOL``) and to the strategy counters its plan predicts, with
   the walls of a first and a second run, the device busy time of a
   third and its five largest device ops, and the launches per kernel;
   the first lane-sums, leaf, LIKE, exists and payload call of each
   launch shape held to the plain version; the share of the phase's
   device busy time that the set operations' ``index_add_`` folds take;
15. window functions and GROUPING SETS / ROLLUP / CUBE at SF1 through
   ``Session.sql`` (``WINDOW_SQL``): rank, row_number top-3, ROWS and
   RANGE running aggregates, lag / lead / first_value over 6M
   ``lineitem`` rows in one Window, a float32 running sum per supplier
   whose maximum must be exact, windows over a group-by and over a join,
   a nested ``sum(sum(...)) over``, max over a dictionary VARCHAR, wide
   BYTES partition and order keys, ROLLUP, CUBE, GROUPING SETS (the
   ``_col1`` name) and a rank over a rollup partitioned by
   ``grouping()``; each equal to a numpy recomputation (stable sorts and
   segment arithmetic; DOUBLE columns within ``DOUBLE_TOL``) and to the
   strategy counters its plan predicts, with the walls of a first and a
   second run, the device busy time of a third and its five largest
   device ops, the launches per kernel (the leaf kernel once per split
   and grouping set), the Window operator's device time in
   ``WINDOW_SHARE``'s statements; every lane-sums, leaf, LIKE, exists and
   payload launch shape held to the plain version.

Phase 5 also times the prefix kernel at the first ``part`` split of the
``starts_with`` pipeline and over SF1 ``o_comment`` with
``COMMENT_PREFIX``, each with its bound and the floor of the 32-byte
sectors its rows' prefixes lie in; the LIKE kernel at Q16's first
``supplier`` split, at Q20's first ``part`` split and at phase 14's
``concat_like`` shape (131,072 x 33), and the payload
kernel at the first batch of each row count other than 2^20 that phase
11 probes (Q7's expansion output
of 2^21 rows among them); and, beside every exists-kernel shape, its
one-call library yardstick, ``torch.isin`` of the probe keys in the
build keys with the live and validity masks (``exists_library``). Each
phase's seconds are printed before the JSON lines.

The card's name and power limit come first and again before the last
lines, which are one JSON line ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
from presto_tpu_torch.exec.joins import LookupJoinOperator
from presto_tpu_torch.expr import evaluate, evaluate_predicate
from presto_tpu_torch.ops import _build, cuda_agg, cuda_groupby, cuda_join, cuda_q1, cuda_strings
from presto_tpu_torch.ops.groupby import group_ids_direct, lane_sum_inputs
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.spi import batch_capacity
from presto_tpu_torch.types import DATE, decimal, varchar
from presto_tpu_torch.workloads import (
    Q1_BITS, Q1_COLS, Q3_COLS, Q3_CUTOFF, Q3_KEY_MIN, part_name_pipeline, q1_aggs, q1_exprs,
    q1_fused_step, q1_pipeline, q3_domain, q3_probe_step, q3_probe_table)

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


def lane_inputs_random(rng, cap: int, groups: int, live_rows: int | None = None,
                       nvalues: int = 4, nmasks: int = 5, device: str = "cuda"):
    """Lane-sums inputs: up to 4 int32 values within their bounds (dead
    rows too), byte masks, and gids over ``groups`` + trash (trash from
    ``live_rows`` on); values and masks past 4 and 5 repeat with a shift."""
    live_rows = cap if live_rows is None else live_rows
    g = rng.integers(0, groups + 1, cap).astype(np.int32)  # groups + trash
    g[live_rows:] = groups
    v1 = rng.integers(-(2**30), 2**30, cap).astype(np.int32)
    v2 = rng.integers(-5000, 5000, cap).astype(np.int32)
    v3 = rng.integers(0, 2**24, cap).astype(np.int32)
    v4 = rng.integers(-100, 100, cap).astype(np.int32)
    vals, bits = [v1, v2, v3, v4], [31, 13, 24, 7]
    vals = [np.roll(vals[j % 4], j // 4) for j in range(nvalues)]
    bits = [bits[j % 4] for j in range(nvalues)]
    masks = [np.roll(rng.random(cap) < p, j // 5)
             for j, p in enumerate([0.9, 0.8, 0.5, 0.99, 0.7] * 4)][:nmasks]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [t(v) for v in vals], bits, [t(m) for m in masks], t(g)


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a view that starts one element into a fresh
    buffer: not 16-byte aligned, so the kernels read it directly."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t)
    return buf[1:]


def lane_dict(res) -> dict:
    """fused_lane_sums' (sums, counts, flag) as one dict for compare()."""
    d = {f"s{i}": s for i, s in enumerate(res[0])}
    d.update({f"c{i}": c for i, c in enumerate(res[1])}, flag=res[2])
    return d


#: phase 2's lane-sums cases: (name, capacity, groups, live rows, values,
#: masks, the instance that must run). Tile edges at the kernel's 2048-row
#: tiles; the main path's shapes (4 values + 5 masks over 6 groups, and
#: the counts only of Q4 and q_like_phone over 5) and the others.
LANE_CASES = [
    ("cap 2^16", 1 << 16, 6, None, 4, 5, "staged_k4m5"),
    ("cap 2^20", 1 << 20, 6, None, 4, 5, "staged_k4m5"),
    ("dead tail 2^20-1371", 1 << 20, 6, (1 << 20) - 1371, 4, 5, "staged_k4m5"),
    ("cap 1000003", 1_000_003, 6, None, 4, 5, "staged_k4m5"),
    ("cap 1", 1, 6, None, 4, 5, "staged_k4m5"),
    ("cap 15", 15, 6, None, 4, 5, "staged_k4m5"),
    ("cap 17", 17, 6, None, 4, 5, "staged_k4m5"),
    ("one tile - 1", 2047, 6, None, 4, 5, "staged_k4m5"),
    ("one tile + 1", 2049, 6, None, 4, 5, "staged_k4m5"),
    ("all rows dead", 1 << 16, 6, 0, 4, 5, "staged_k4m5"),
    ("64 groups (shared copies)", 1 << 20, 64, None, 4, 5, "staged_shared"),
    ("0 values, 1 mask, 5 groups", 1 << 20, 5, None, 0, 1, "staged_k0m1"),
    ("0 values, 2 masks, 5 groups", 131_072, 5, None, 0, 2, "staged"),
    ("0 values, 2 masks, ragged", 100_003, 5, 99_000, 0, 2, "staged"),
    ("2 values, 3 masks, 12 groups", 1_000_003, 12, None, 2, 3, "staged"),
    ("16 values, 16 masks, 32 groups (direct)", 70_001, 32, None, 16, 16, "direct"),
]


def check_lane_kernel(rng) -> int:
    err = 0
    cuda_groupby.reset_launches()
    cases = [(*c, False) for c in LANE_CASES]
    cases += [("unaligned views, cap 2^20", 1 << 20, 6, None, 4, 5, "direct", True),
              ("unaligned views, 0 values, 1 mask", 131_073, 5, None, 0, 1, "direct", True)]
    for what, cap, groups, live_rows, k, m, inst, view in cases:
        vals, bits, masks, g = lane_inputs_random(rng, cap, groups, live_rows, k, m)
        if view:  # one value (if any) and one mask start one element in
            vals = [unaligned(v) if j == 0 else v for j, v in enumerate(vals)]
            masks = [unaligned(mk) if j == m - 1 else mk for j, mk in enumerate(masks)]
        before = dict(cuda_groupby.launches_by_instance)
        got = cuda_groupby.fused_lane_sums(vals, bits, masks, g, groups)
        want = cuda_groupby.fused_lane_sums_plain(vals, bits, masks, g, groups)
        torch.cuda.synchronize()
        ran = [i for i, c in cuda_groupby.launches_by_instance.items() if c != before[i]]
        check(ran == [inst], f"fused_lane_sums {what}: instance {ran}, expected {inst}")
        err = max(err, compare(lane_dict(got), lane_dict(want), f"fused_lane_sums {what}"))
        check(not bool(got[2]), f"fused_lane_sums {what}: flagged in bounds")
        log(f"  fused_lane_sums {what} ({inst}): equal to plain")
    vals, bits, masks, g = lane_inputs_random(rng, 1 << 16, 6)
    vals[1][5] = 1 << 14  # beyond its declared 13 bits
    for inst, vs in (("staged_k4m5", vals), ("direct", [unaligned(v) for v in vals])):
        got = cuda_groupby.fused_lane_sums(vs, bits, masks, g, 6)
        want = cuda_groupby.fused_lane_sums_plain(vs, bits, masks, g, 6)
        check(bool(got[2]) and bool(want[2]),
              f"fused_lane_sums ({inst}): bound violation not flagged")
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            check(torch.equal(a, b), f"fused_lane_sums ({inst}): bound-violation sums differ")
    log("  fused_lane_sums value beyond declared bits: flagged by both (staged and direct)")
    idle = [i for i, c in cuda_groupby.launches_by_instance.items() if c == 0]
    check(not idle, f"fused_lane_sums: instances never held to plain: {idle}")
    return err


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def probe_keys(rng, dtype, kmin: int, kmax: int, n: int, spread: int = 2000) -> np.ndarray:
    """Probe keys around the domain and across its ends, with the ends,
    their out-of-domain neighbours and the dtype's extremes planted (as
    many as fit)."""
    info = np.iinfo(dtype)
    k = rng.integers(max(info.min, kmin - spread), min(info.max, kmax + spread), n,
                     endpoint=True)
    edges = [e for e in (kmin, kmax, kmin - 1, kmax + 1, info.min, info.max)
             if info.min <= e <= info.max][:n]
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


#: phase 2's payload tables: (key dtype, key_min, key_max), each small
#: enough for 16 value columns
PAYLOAD_DOMAINS = (("int8", -60, 90), ("int16", -500, 400), ("int32", I32MAX - 400, I32MAX))
VALUE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _keep_err(got, want, what: str) -> int:
    """The largest difference between two ``payload_keep`` results
    (matched, values, live), exactly equal or raise; every mask byte 0
    or 1."""
    (gm, gv, gl), (wm, wv, wl) = got, want
    err = max(_mask_err(gm, wm, f"{what}: matched"), _mask_err(gl, wl, f"{what}: live"))
    for m in (gm, gl):
        check(m.numel() == 0 or int(m.view(torch.uint8).max()) <= 1,
              f"{what}: a bool byte past 1")
    check(len(gv) == len(wv), f"{what}: {len(gv)} value columns, expected {len(wv)}")
    for j, (g, w) in enumerate(zip(gv, wv)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: value {j} is {g.dtype}{tuple(g.shape)}, expected {w.dtype}")
        d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        check(d == 0, f"{what}: value {j} differs from the plain version")
        err = max(err, d)
    return err


def check_payload_kernel(rng) -> int:
    """The payload kernel against its plain versions, exactly: through
    ``payload_keep`` (the operator's entry) and ``payload_probe`` (the
    JAX package's contract), int8/int16/int32 keys around and past the
    domain, 0, 1, 4 and 16 value columns written as int8/int16/int32/
    int64, inner and left, no validity and NULL keys, every capacity of
    ``PROBE_CAPS``, the keys, live and validity aligned (vector
    instances), views one element into their buffers (scalar ones) and
    with every row dead; tables that are staged in shared memory and,
    with 16 value columns or a wide domain, tables that are not. Every
    mask byte must be 0 or 1, each launch must take the instance its
    inputs call for, and every instance must run. Returns the largest
    difference."""
    err = 0
    cuda_join.reset_launches()
    cases = [(dt, kmin, kmax, nval) for dt, kmin, kmax in PAYLOAD_DOMAINS
             for nval in (0, 1, 4, 16)]
    cases.append(("int32", 1, 8000, 1))  # a table too large to stage
    for dt, kmin, kmax, nval in cases:
        bk = (rng.permutation(kmax - kmin + 1)[:400] + kmin).astype(dt)
        vals = [_t(rng.integers(-(1 << 31), 1 << 31, bk.shape[0]).astype(np.int32))
                for _ in range(nval)]
        tables, oob = cuda_join.build_payload_tables(
            _t(bk), _t(live_mask(rng, bk.shape[0])), kmin, kmax, vals)
        check(not bool(oob), "payload tables: in-domain build flagged oob")
        for cap in PROBE_CAPS:
            keys = _t(probe_keys(rng, dt, kmin, kmax, cap, spread=300))
            live, valid = _t(live_mask(rng, cap)), _t(rng.random(cap) < 0.9)
            dead = torch.zeros_like(live)
            dtypes = [VALUE_DTYPES[(j + cap) % 4] for j in range(nval)]
            for what, k, lv, vd in (("aligned", keys, live, valid),
                                    ("views", unaligned(keys), unaligned(live), unaligned(valid)),
                                    ("all dead", keys, dead, valid)):
                inst = cuda_join.payload_instance(tables, kmin, kmax, k, lv, vd)
                check(inst.startswith("scalar") == (what == "views"),
                      f"payload {what}: instance {inst}")
                for v in (None, vd):
                    for inner in (True, False):
                        name = (f"payload_keep {dt} nval {nval} cap {cap} {what} "
                                f"valid={v is not None} {'inner' if inner else 'left'}")
                        before = dict(cuda_join.launches_by_instance["payload"])
                        got = cuda_join.payload_keep(tables, kmin, kmax, k, lv, v, dtypes, inner)
                        want = cuda_join.payload_keep_plain(tables, kmin, kmax, k, lv, v, dtypes,
                                                            inner)
                        torch.cuda.synchronize()
                        ran = [i for i, c in cuda_join.launches_by_instance["payload"].items()
                               if c != before[i]]
                        check(ran == [cuda_join.payload_instance(tables, kmin, kmax, k, lv, v)],
                              f"{name}: instance {ran}")
                        err = max(err, _keep_err(got, want, name))
                        check(not bool(got[0][~lv].any()), f"{name}: a dead row matched")
                        if not inner:
                            check(got[2] is lv, f"{name}: a left join's live mask changed")
                gm, gv = cuda_join.payload_probe(tables, kmin, kmax, k, lv)
                wm, wv = cuda_join.payload_probe_plain(tables, kmin, kmax, k, lv)
                torch.cuda.synchronize()
                err = max(err, _keep_err((gm, gv, gm), (wm, wv, wm),
                                         f"payload_probe {dt} nval {nval} cap {cap} {what}"))
        log(f"  payload_keep (inner, left; value types {[str(d)[6:] for d in VALUE_DTYPES]}) "
            f"and payload_probe {dt} [{kmin}, {kmax}] nval {nval}, caps {PROBE_CAPS}, aligned, "
            "views and all dead, no validity and NULL keys: equal to plain, bytes 0 or 1")
    idle = [i for i, c in cuda_join.launches_by_instance["payload"].items() if c == 0]
    check(not idle, f"payload instances never held to plain: {idle}")
    log(f"  payload launches by instance in phase 2: {cuda_join.launches_by_instance['payload']}")
    return err


def full_range_keys(rng, dtype, n: int) -> np.ndarray:
    """Keys over the whole range of ``dtype``, its extremes planted."""
    info = np.iinfo(dtype)
    k = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    k[:3] = [info.min, info.max, -1]
    return k


def check_sketch_kernel(rng) -> int:
    """The sketch kernel against its plain version: keys over the full
    int8/int16/int32 range, live masks with holes, capacities that are
    and are not multiples of 1024, Bloom tables of a few thousand live
    build keys (a fifth of the probe keys planted from the build)."""
    err = 0
    for dt in ("int8", "int16", "int32"):
        for cap in (1000, 1 << 16, 1 << 20, 1_000_003):
            bk = full_range_keys(rng, dt, 5000)
            table = cuda_join.build_sketch_table(_t(bk), _t(live_mask(rng, bk.shape[0])))
            pk = full_range_keys(rng, dt, cap)
            pk[3: cap // 5] = rng.choice(bk, cap // 5 - 3)
            plive = _t(live_mask(rng, cap))
            got = cuda_join.sketch_probe(table, cuda_join.SKETCH_BITS, _t(pk), plive)
            want = cuda_join.sketch_probe_plain(table, cuda_join.SKETCH_BITS, _t(pk), plive)
            torch.cuda.synchronize()
            d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            err = max(err, d)
            check(d == 0, f"sketch_probe {dt} cap {cap}: differs from plain")
            check(not bool(got[~plive].any()), f"sketch_probe {dt} cap {cap}: a dead row hit")
        log(f"  sketch_probe {dt} full-range keys, caps 1000, 2^16, 2^20, 1000003: "
            "equal to plain")
    return err


#: phase 2's capacities for the exists and sketch kernels' keep modes:
#: tails of 1, 3, 15 and 1 rows past whole 16-byte groups, and the main
#: path's sizes
PROBE_CAPS = (1, 3, 15, 17, 1 << 16, 1 << 20, 1_000_003)


def check_probe_keep_kernels(rng) -> dict:
    """The exists kernel's keep and anti modes and the sketch kernel's
    keep mode (the operators' ``exists_keep`` / ``sketch_keep``) against
    their plain versions, exactly: int8, int16 and int32 keys around and
    past the domain (the sketch built from the same domain, so keys hit
    and miss), every capacity of ``PROBE_CAPS``, each with the keys, live
    and validity aligned (the vector instance, ragged tails included),
    as views one element into their buffers (the scalar instance), and
    with every row dead; no validity and NULL keys planted. Every output
    byte must be 0 or 1, each launch must take the instance its inputs
    call for, and each instance of each kernel must run. Returns the
    largest difference per kernel."""
    err = {"exists": 0, "sketch": 0}
    cuda_join.reset_launches()
    for dt, kmin, kmax in (("int8", -100, 100), ("int16", -3000, 20000), ("int32", 1, 150000)):
        bk = rng.integers(kmin, kmax, 5000, endpoint=True).astype(dt)
        bk[:2] = [kmin, kmax]
        blive = _t(live_mask(rng, bk.shape[0]))
        table, oob = cuda_join.build_exists_table(_t(bk), blive, kmin, kmax)
        check(not bool(oob), "exists table: in-domain build flagged oob")
        sketch = cuda_join.build_sketch_table(_t(bk), blive)
        for cap in PROBE_CAPS:
            keys = _t(probe_keys(rng, dt, kmin, kmax, cap))
            live, valid = _t(live_mask(rng, cap)), _t(rng.random(cap) < 0.9)
            dead = torch.zeros_like(live)
            variants = [("aligned", keys, live, valid, "vector"),
                        ("views", unaligned(keys), unaligned(live), unaligned(valid), "scalar"),
                        ("all dead", keys, dead, valid, "vector")]
            for what, k, lv, vd, inst in variants:
                for v in (None, vd):
                    calls = [("exists", anti, lambda anti=anti: cuda_join.exists_keep(
                                  table, kmin, kmax, k, lv, v, anti),
                              lambda anti=anti: cuda_join.exists_keep_plain(
                                  table, kmin, kmax, k, lv, v, anti)) for anti in (False, True)]
                    calls.append(("sketch", False,
                                  lambda: cuda_join.sketch_keep(sketch, cuda_join.SKETCH_BITS,
                                                                k, lv, v),
                                  lambda: cuda_join.sketch_keep_plain(
                                      sketch, cuda_join.SKETCH_BITS, k, lv, v)))
                    for kernel, anti, fn, plain in calls:
                        name = (f"{kernel}_keep {dt} cap {cap} {what} "
                                f"{'anti' if anti else 'keep'} valid={v is not None}")
                        before = dict(cuda_join.launches_by_instance[kernel])
                        got = fn()
                        want = plain()
                        torch.cuda.synchronize()
                        ran = [i for i, c in cuda_join.launches_by_instance[kernel].items()
                               if c != before[i]]
                        check(ran == [inst], f"{name}: instance {ran}, expected {inst}")
                        err[kernel] = max(err[kernel], _mask_err(got, want, name))
                        check(int(got.view(torch.uint8).max()) <= 1,
                              f"{name}: a bool byte past 1")
                        check(not bool(got[~lv].any()), f"{name}: a dead row is live")
        log(f"  exists_keep (keep, anti) and sketch_keep {dt}, caps {PROBE_CAPS}, aligned, "
            "views and all dead, no validity and NULL keys: equal to plain, bytes 0 or 1")
    idle = [f"{k} {i}" for k in ("exists", "sketch")
            for i, c in cuda_join.launches_by_instance[k].items() if c == 0]
    check(not idle, f"probe instances never held to plain: {idle}")
    log("  probe launches by instance in phase 2: "
        f"{ {k: cuda_join.launches_by_instance[k] for k in ('exists', 'sketch')} }")
    return err


def check_q3_kernel(rng) -> int:
    """The Q3 kernel against its plain version: a domain whose bitmask
    spans several of the JAX package's 16384-word partitions, probe keys
    below key_min, past the domain and past the padded table, shipdates
    on both sides of the cutoff, dead rows, several capacities, and the
    columns in other widths than the connector's."""
    err = 0
    domain = 2_000_001  # 62,501 words: 4 partitions of 16384
    w, nparts = cuda_join.q3_partitions(domain)
    for cap, widths in ((1000, None), (1 << 16, None), (1 << 20, None), (1_000_003, None),
                        (1 << 20, ("int32", "int32", "int32", "int16")),
                        (1 << 16, ("int16", "int8", "int32", "int32"))):
        key_min = 1 if widths is None or widths[0] != "int16" else -200
        hi = domain if widths is None or widths[0] != "int16" else 32767
        bk = rng.integers(key_min, hi, 50_000, endpoint=True)
        table, oob = cuda_join.build_exists_table(
            _t(bk.astype(np.int32)), _t(live_mask(rng, bk.shape[0])), key_min, hi,
            pad_words=w * nparts)
        check(not bool(oob), "Q3 table: in-domain build flagged oob")
        kw, sw, ew, dw = widths or ("int32", "int16", "int32", "int8")
        ki = np.iinfo(kw)
        keys = rng.integers(max(ki.min, key_min - 5000), min(ki.max, key_min + 32 * w * nparts
                                                                 + 5000), cap)
        keys[: cap // 3] = rng.choice(bk, cap // 3)
        keys[:2] = [ki.min, ki.max]
        ship = rng.integers(9000, 9400, cap) if sw == "int16" else rng.integers(-50, 60, cap)
        cut = 9204 if sw == "int16" else 0
        ep = rng.integers(90000, 10_500_000, cap) if ew == "int32" else rng.integers(0, 120, cap)
        disc = rng.integers(0, 11, cap)
        cols = [_t(a.astype(dt)) for a, dt in ((keys, kw), (ship, sw), (ep, ew), (disc, dw))]
        plive = _t(live_mask(rng, cap))
        got = cuda_join.q3_probe_step(table, key_min, domain, cut, *cols, plive)
        want = cuda_join.q3_probe_step_plain(table, key_min, domain, cut, *cols, plive)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            check(g.dtype == torch.int64 and w_.dtype == torch.int64 and g.dim() == 0,
                  "q3_probe_step: results must be int64 scalars")
            d = abs(int(g) - int(w_))
            err = max(err, d)
            check(d == 0, f"q3_probe_step cap {cap} widths {widths}: differs from plain by {d}")
        log(f"  q3_probe_step cap {cap}, widths {widths or 'narrow'}: equal to plain "
            f"({int(got[0])} hits over {w * nparts} words)")
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
    bad_q6 = [c.copy() for c in q6_cols]
    passing = np.flatnonzero(live & (bad_q6[0] >= 8766) & (bad_q6[0] <= 9130)
                             & (bad_q6[1] >= 5) & (bad_q6[1] <= 7) & (bad_q6[2] <= 2399))
    bad_q6[3][passing[-2:]] = 20_000_000  # ep beyond its guard, on the narrow shape
    out.append(("guard Q6 shape", q6, bad_q6))
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


#: phase 2's leaf-aggregation capacities (and live rows): the split and
#: resident shapes, a ragged one, tile edges at the staged instance's
#: 2048-row tiles, and a batch with every row dead
LEAF_CAPS = [(1 << 16, None), (1 << 20, None), (1_000_003, 999_000), (1, None), (15, None),
             (17, None), (2047, None), (2049, None), (1 << 16, 0)]


def check_leaf_agg_kernel(rng) -> int:
    err = 0
    cuda_agg.reset_launches()
    runs = [(cap, live_rows, False) for cap, live_rows in LEAF_CAPS]
    runs.append((1 << 20, (1 << 20) - 77, True))  # every column a view one element in
    for cap, live_rows, view in runs:
        cases = leaf_cases(rng, cap, live_rows)
        for what, spec, cols, live in cases:
            b = leaf_batch(spec, cols, live, "cuda")
            if view:
                cols_v = {c: Column(unaligned(b[c].data), b.live, b[c].dtype) for c in spec.cols}
                b = Batch(cols_v, b.live)
            inst = cuda_agg.instance(spec, [b[c].data for c in spec.cols], b.live)
            check(inst == ("generic" if len(spec.values) > 1 or any(
                c.dtype.itemsize > 4 for c in cols) else "direct" if view else "staged"),
                  f"agg_step {what} cap {cap}: instance {inst}")
            before = cuda_agg.launches_by_instance[inst]
            got = cuda_agg.agg_step(spec, b)
            want = cuda_agg.agg_step_plain(spec, b)
            torch.cuda.synchronize()
            check(cuda_agg.launches_by_instance[inst] == before + 1,
                  f"agg_step {what} cap {cap}: the {inst} instance did not run")
            err = max(err, compare(got, want, f"agg_step {what} cap {cap} ({inst})"))
            if cap >= 1 << 16 and live_rows != 0:  # enough passing rows to plant a violation
                flagged = bool(got["value_overflow"])
                check(flagged == what.startswith(("guard", "bits")),
                      f"agg_step {what} cap {cap}: value_overflow={flagged}")
        log(f"  agg_step: {len(cases)} specs at cap {cap}, live rows "
            f"{cap if live_rows is None else live_rows}{', unaligned views' if view else ''}: "
            f"equal to plain, flags as expected")
    idle = [i for i, c in cuda_agg.launches_by_instance.items() if c == 0]
    check(not idle, f"agg_step: instances never held to plain: {idle}")
    log(f"  agg_step launches by instance: {cuda_agg.launches_by_instance}")
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
    trace of ``runs`` calls: the time of the kernels whose name contains
    ``kernel``, or of every kernel ``fn`` launches when ``kernel`` is
    None. ``flush`` (a buffer larger than L2) is rewritten before each
    call so each call starts with a cold cache; its kernels are left out
    of the sum. A trace can come back without some device events, so the
    time is the mean of the events recorded times the events one call
    launches (the larger count of two traces of one call), not the sum
    over ``runs``."""
    from torch.profiler import ProfilerActivity, profile

    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

    def trace(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and "bitwise_not" not in e.key and (kernel is None or kernel in e.key)]
        return sum(e.self_device_time_total for e in mine), sum(e.count for e in mine)

    fn()
    torch.cuda.synchronize()
    total_us = count = 0
    for _attempt in range(3):  # a trace can come back without device events: profile again
        total_us, count = trace(runs)
        if total_us > 0:
            break
    check(total_us > 0, f"the profiler recorded no device time for {kernel or 'fn'}")
    per_call = max(trace(1)[1], trace(1)[1], 1)
    return total_us / count * per_call / 1e3


def bound(nbytes, ops):
    """Least time the card could take: bytes at the memory rate or
    integer operations at the non-tensor rate, whichever is larger."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def device_kernels(fn, calls: int = 20) -> dict:
    """{name: count} of the device kernels (and copies) that ``calls``
    warmed-up calls of ``fn`` run, from the profiler's CUDA trace. A
    trace can come back without some device events, so a count can read
    short, never long."""
    from torch.profiler import ProfilerActivity, profile

    # a trace can come back without device events (a filtered probe batch
    # of a few microseconds lost all three traces once in a full run):
    # warm up and profile again, up to five times
    for _attempt in range(5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages() if e.self_device_time_total > 0}
        if names:
            return names
    return {}


@contextlib.contextmanager
def first_probe(mode: str, anti: bool | None = None):
    """While in the block, keep the first ``LookupJoinOperator._pallas_probe``
    call on the ``mode`` route (``exists``, ``sketch`` or ``payload``;
    with ``anti``, of an anti join or of another kind) as ``seen["op"] =
    (operator, batch)``, and the arguments of the ``cuda_join.<mode>_keep``
    call it made as ``seen["args"]``; ``seen["calls"]`` counts every
    ``<mode>_keep`` call made inside a ``_pallas_probe`` call. Yields
    ``seen``."""
    seen = {"calls": 0}
    active = [0]
    original_probe = LookupJoinOperator._pallas_probe
    name = f"{mode}_keep"
    original_keep = getattr(cuda_join, name)

    def probe(op, batch):
        take = ("op" not in seen and op.build.pallas.mode == mode
                and (anti is None or (op.join_type == "anti") == anti))
        if take:
            seen["op"] = (op, batch)
        active[0] = 2 if take else 1
        try:
            return original_probe(op, batch)
        finally:
            active[0] = 0

    def keep(*args):
        if active[0]:
            seen["calls"] += 1
        if active[0] == 2:
            seen["args"] = args
        return original_keep(*args)

    LookupJoinOperator._pallas_probe = probe
    setattr(cuda_join, name, keep)
    try:
        yield seen
    finally:
        LookupJoinOperator._pallas_probe = original_probe
        setattr(cuda_join, name, original_keep)


@contextlib.contextmanager
def each_probe_shape(query: dict):
    """While in the block, keep the first ``exists_keep`` and
    ``payload_keep`` call made inside ``LookupJoinOperator._pallas_probe``
    for each (kernel, probe rows, key dtype), as ``seen[(mode, rows,
    dtype)] = {"op": (operator, batch), "args": args, "query":
    query["name"]}`` (the ``seen`` entries :func:`time_probe` reads).
    Yields ``seen``."""
    seen: dict = {}
    current: list = [None]
    original_probe = LookupJoinOperator._pallas_probe
    originals = {m: getattr(cuda_join, f"{m}_keep") for m in ("exists", "payload")}

    def probe(op, batch):
        current[0] = (op, batch)
        try:
            return original_probe(op, batch)
        finally:
            current[0] = None

    def keeper(mode):
        def keep(*args):
            if current[0] is not None:
                key = (mode, args[3].numel(), str(args[3].dtype).replace("torch.", ""))
                seen.setdefault(key, {"op": current[0], "args": args, "query": query["name"]})
            return originals[mode](*args)
        return keep

    LookupJoinOperator._pallas_probe = probe
    for m in originals:
        setattr(cuda_join, f"{m}_keep", keeper(m))
    try:
        yield seen
    finally:
        LookupJoinOperator._pallas_probe = original_probe
        for m, fn in originals.items():
            setattr(cuda_join, f"{m}_keep", fn)


def hold_probe_shapes(seen: dict) -> dict:
    """Each captured main-path probe call (from :func:`each_probe_shape`)
    launched again and held to its plain version, bool bytes included.
    Returns the largest difference per kernel."""
    err = {"exists": 0, "payload": 0}
    for (mode, rows, key), t in sorted(seen.items()):
        what = f"{mode}_keep at {t['query']}'s first {rows}-row {key} batch"
        if mode == "payload":
            d = _keep_err(cuda_join.payload_keep(*t["args"]),
                          cuda_join.payload_keep_plain(*t["args"]), what)
        else:
            got = cuda_join.exists_keep(*t["args"])
            d = _mask_err(got, cuda_join.exists_keep_plain(*t["args"]), what)
            check(int(got.view(torch.uint8).max()) <= 1, f"{what}: a bool byte past 1")
        err[mode] = max(err[mode], d)
        log(f"  {what}: equal to its plain version")
    return err


def check_vector_probes(name: str, n: dict) -> None:
    """Every exists, sketch and payload launch of a main-path run on a
    vector instance (``n``: the run's ``_launch_counts()``)."""
    for kernel, by in n["probe_by_instance"].items():
        scalar = sum(c for i, c in by.items() if i.startswith("scalar"))
        check(scalar == 0, f"{name}: {kernel} launches by instance {by}")


def time_probe(mode: str, seen: dict, launches: int, flush) -> dict:
    """Phase 5 numbers of the exists, sketch or payload kernel at the
    inputs a main-path query gave it (``seen``: from :func:`first_probe`),
    as the operator launched it: kernel, wrapper call and plain ms; the
    bound counts each key, live byte (and validity byte, when the operator
    passed one), each output once (a bool, or for payload one or two mask
    bytes and each value in its width) and the tables once, and 8 integer
    operations a row (exists), 24 (sketch: two finalizers, the seed, two
    masks and two bit tests) or 8 and 2 a value (payload). Then the device
    ms of every kernel of one whole ``_pallas_probe`` call on the same
    batch, whose trace must hold exactly one kernel, this one. For payload
    also the JAX-contract entry ``payload_probe`` on the probe live mask
    ``live && valid`` (int32 values, no validity), as ``contract_*``."""
    args = seen["args"]
    if mode == "payload":
        keep, plain = cuda_join.payload_keep, cuda_join.payload_keep_plain
        tables, kmin, kmax, keys, live, valid, dtypes, inner = args
    elif mode == "exists":
        keep, plain = cuda_join.exists_keep, cuda_join.exists_keep_plain
        keys, live, valid, anti = args[3], args[4], args[5], args[6]
    else:
        keep, plain = cuda_join.sketch_keep, cuda_join.sketch_keep_plain
        keys, live, valid, anti = args[2], args[3], args[4], False
    fn = lambda: keep(*args)  # noqa: E731
    got = fn()
    if mode == "payload":
        err = _keep_err(got, plain(*args), "payload_keep at phase 5")
    else:
        err = _mask_err(got, plain(*args), f"{mode}_keep at phase 5")
        check(int(got.view(torch.uint8).max()) <= 1, f"{mode}_keep wrote a bool byte past 1")
    op, batch = seen["op"]
    whole = lambda: op._pallas_probe(batch)  # noqa: E731
    # one kernel a batch: every device event of 20 batches is this
    # kernel's, at most 20 of them (the trace may drop some, never add),
    # and the wrapper counted one launch a batch run (the warm-up, and a
    # second trace when the first came back without device events)
    batches = [0]

    def counted():
        batches[0] += 1
        return whole()

    before = getattr(cuda_join, f"{mode}_launches")
    kernels = device_kernels(counted, 20)
    launched = getattr(cuda_join, f"{mode}_launches") - before
    check(len(kernels) == 1 and f"{mode}_kernel" in next(iter(kernels))
          and next(iter(kernels.values())) <= 20 and launched == batches[0],
          f"20 {mode} probe batches ran the device kernels {kernels} and {launched} launches "
          f"in {batches[0]} batches")
    n = keys.numel()
    out = {"rows": n, "key": str(keys.dtype).replace("torch.", ""), "err": err,
           "valid": valid is not None, "launches": launches,
           "probe_kernels": len(kernels), "probe_events": next(iter(kernels.values()))}
    if mode == "payload":
        widths = [torch.empty(0, dtype=d).element_size() for d in dtypes]
        table_bytes = sum(t.numel() * 4 for t in tables)
        out.update(nval=len(dtypes), widths=widths, inner=bool(inner), anti=False,
                   table=sum(t.numel() for t in tables),
                   bytes=n * (keys.element_size() + 2 + (valid is not None) + bool(inner)
                              + sum(widths)) + table_bytes,
                   ops=(8 + 2 * len(dtypes)) * n,
                   instance=cuda_join.payload_instance(tables, kmin, kmax, keys, live, valid))
        plive = live if valid is None else live & valid
        contract = lambda: cuda_join.payload_probe(tables, kmin, kmax, keys, plive)  # noqa: E731
        contract_plain = lambda: cuda_join.payload_probe_plain(  # noqa: E731
            tables, kmin, kmax, keys, plive)
        gm, gv = contract()
        wm, wv = contract_plain()
        err = max(err, _keep_err((gm, gv, gm), (wm, wv, wm), "payload_probe at phase 5"))
        cb, cby = bound(n * (keys.element_size() + 2 + 4 * len(dtypes)) + table_bytes,
                        (8 + 2 * len(dtypes)) * n)
        out.update(err=err, contract_ms=device_ms(contract, 50, flush, kernel="payload_kernel"),
                   contract_call_ms=call_ms(contract, 50),
                   contract_plain_ms=device_ms(contract_plain, 10, flush),
                   contract_bound_ms=cb, contract_bound_by=cby)
    else:
        table = args[0]
        out.update(anti=bool(anti), inner=False, table=table.numel(),
                   bytes=n * (keys.element_size() + 2 + (valid is not None)) + table.numel() * 4,
                   ops=(8 if mode == "exists" else 24) * n,
                   instance=cuda_join.instance(keys, live, valid))
    if mode == "exists":
        lib = exists_library(*args)
        err = max(err, _mask_err(lib(), got, "torch.isin yardstick at phase 5"))
        out.update(err=err, library_ms=device_ms(lib, 50, flush))
    out.update(ms=device_ms(fn, 50, flush, kernel=f"{mode}_kernel"), call_ms=call_ms(fn, 50),
               plain_ms=device_ms(lambda: plain(*args), 10, flush),
               probe_ms=device_ms(whole, 50, flush))
    return out


def exists_library(table, key_min: int, key_max: int, keys, live, valid, anti):
    """The exists kernel's function as one PyTorch library call,
    ``torch.isin`` of the probe keys in the build keys that the bitmask
    holds (recovered from it here, outside the timing; those a key of the
    probe's dtype cannot hold are left out: no probe key equals them),
    and the live and validity masks around it. Returns the call."""
    bits = (table.to(torch.int64)[:, None] >> torch.arange(32, device=table.device)) & 1
    build = torch.nonzero(bits.reshape(-1)).reshape(-1) + key_min
    info = torch.iinfo(keys.dtype)
    build = build[(build >= info.min) & (build <= min(info.max, key_max))].to(keys.dtype)

    def call():
        m = torch.isin(keys, build)
        if valid is not None:
            m &= valid
        return live & ~m if anti else live & m

    return call


def probe_shape(t: dict) -> dict:
    """``time_probe``'s numbers with the bound: one shape's entry in the
    kernels' JSON line."""
    b, by = bound(t["bytes"], t["ops"])
    return {**t, "bound_ms": b, "bound_by": by}


def log_probe(kernel: str, label: str, shapes: dict) -> None:
    t = shapes[label]
    mode = ("inner" if t["inner"] else "left") if kernel == "payload" else \
        ("anti" if t["anti"] else "keep")
    values = (f"{t['nval']} value(s) of {t['widths']} B over {t['table']} table slots, "
              if kernel == "payload" else "")
    log(f"phase 5, {kernel} kernel at {label} ({t['rows']} rows, {t['key']} keys, validity "
        f"{'passed' if t['valid'] else 'none'}, {mode} mode, {values}{t['instance']} instance; "
        f"kernel device ms, call = wrapper by events, plain = device ms of its kernels; "
        + ("library = torch.isin and its masks" if kernel == "exists"
           else "no single PyTorch call computes it")
        + f"): {t['ms']:.4f} (call {t['call_ms']:.4f}, plain "
        f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']}"
        + (f", library {t['library_ms']:.4f}" if kernel == "exists" else "")
        + f"); one whole _pallas_probe call {t['probe_ms']:.4f} device ms in "
        f"{t['probe_kernels']} kernel; {t['launches']} launches in its query")
    if kernel == "payload":
        log(f"  payload_probe (the JAX contract: int32 values, the probe live mask) on the same "
            f"batch: {t['contract_ms']:.4f} (call {t['contract_call_ms']:.4f}, plain "
            f"{t['contract_plain_ms']:.4f}, bound {t['contract_bound_ms']:.4f} by "
            f"{t['contract_bound_by']})")


def time_lane(args, flush) -> dict:
    """Phase 5 numbers of the lane-sums kernel at the inputs it was given
    (values, bits, masks, gids, groups): its bound counts each value, mask
    and gid element once and the output once, and 3 integer operations a
    value, 1 a mask and 2 a row; its yardstick is one ``index_add_`` of
    the values and masks, stacked as int64, into [groups + 1] rows (the
    trash group last)."""
    vals, bits, masks, gids, groups = args
    fn = lambda: cuda_groupby.fused_lane_sums(vals, bits, masks, gids, groups)  # noqa: E731
    plain = lambda: cuda_groupby.fused_lane_sums_plain(  # noqa: E731
        vals, bits, masks, gids, groups)
    got = fn()
    err = compare(lane_dict(got), lane_dict(plain()), "fused_lane_sums at phase 5")
    cap = gids.shape[0]
    nbytes = (sum(t.numel() * t.element_size() for t in [*vals, *masks, gids])
              + (groups * (len(vals) + len(masks)) + 1) * 8)
    stacked = torch.stack([v.to(torch.int64) for v in vals]
                          + [mk.to(torch.int64) for mk in masks], dim=1)
    g64 = torch.where((gids >= 0) & (gids < groups), gids,
                      torch.full_like(gids, groups)).to(torch.int64)
    lib_out = torch.zeros(groups + 1, stacked.shape[1], dtype=torch.int64, device=gids.device)

    def library():
        lib_out.zero_()
        lib_out.index_add_(0, g64, stacked)

    library_ms = device_ms(library, 10, flush)
    check(torch.equal(torch.stack(got[0] + got[1], dim=1), lib_out[:groups]),
          "fused_lane_sums differs from the index_add_ library call")
    return {"ms": device_ms(fn, 50, flush, kernel="lane_sums_kernel"),
            "call_ms": call_ms(fn, 50), "plain_ms": device_ms(plain, 10, flush),
            "library_ms": library_ms, "rows": cap, "bytes": nbytes,
            "ops": cap * (3 * len(vals) + len(masks) + 2), "err": err,
            "shape": [len(vals), len(masks), groups],
            "instance": cuda_groupby.instance(vals, masks, gids, groups)}


def q1_lane_inputs(conn, capacity: int) -> tuple:
    """The lane-sums kernel's arguments (values, bits, masks, gids,
    groups) at the Q1 pipeline's first ``lineitem`` split, as its direct
    hash aggregation makes them: 4 values, 5 masks, 6 groups."""
    split = conn.scan(conn.splits("lineitem")[0], Q1_COLS, capacity)
    pred, _, _ = q1_exprs()
    live = split.live & evaluate_predicate(pred, split)
    filtered = split.with_live(live)
    gids, _ = group_ids_direct([split["l_returnflag"].data, split["l_linestatus"].data],
                               (0, 0), (2, 1), live, 6)
    vals = [evaluate(a.input, filtered) for a in q1_aggs()[:4]]
    contribs = [live & v.valid for v in vals]
    bits = [Q1_BITS[n] for n in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")]
    zeroed, eff_bits, _ = lane_sum_inputs([v.data for v in vals], bits, contribs, live.device)
    return zeroed, eff_bits, contribs + [live], gids, 6


def time_leaf(spec, b, flush) -> dict:
    """Phase 5 numbers of the leaf-aggregation kernel on batch ``b``: its
    bound counts each spec column and ``live`` once and the output once,
    and 2 integer operations a column, 4 a value and 4 more a row."""
    fn = lambda: cuda_agg.agg_step(spec, b)  # noqa: E731
    plain = lambda: cuda_agg.agg_step_plain(spec, b)  # noqa: E731
    err = compare(fn(), plain(), f"agg_step at phase 5, {b.capacity} rows")
    nbytes = (sum(b[c].data.numel() * b[c].data.element_size() for c in spec.cols)
              + b.capacity + (spec.groups * (len(spec.values) + 1) + 1) * 8)
    return {"ms": device_ms(fn, 50, flush, kernel="leaf_"), "call_ms": call_ms(fn, 50),
            "plain_ms": device_ms(plain, 10, flush),
            "library_ms": leaf_library_ms(spec, b, flush), "rows": b.capacity,
            "bytes": nbytes, "err": err,
            "ops": b.capacity * (2 * len(spec.cols) + 4 * len(spec.values) + 4),
            "widths": [b[c].data.element_size() for c in spec.cols],
            "instance": cuda_agg.instance(spec, [b[c].data for c in spec.cols], b.live)}


def device_ops(session, conn, sql: str):
    """(device busy ms, connector-scan s, device ops) of one more run of
    ``sql``: the device time of every kernel and copy in the profiler's
    CUDA trace, the host time spent inside ``conn.scan`` (generation,
    narrowing and the copy to the card; the scans run on the prefetch
    thread, so they overlap the rest), and every device op with its time,
    as (name, ms, calls), the most time first."""
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
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in ops)
    ops.sort(key=lambda e: -e.self_device_time_total)
    return busy_us / 1e3, scan_s[0], [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                                      for e in ops]


def wall_breakdown(session, conn, sql: str):
    """:func:`device_ops` with the five device ops with the most time."""
    busy_ms, scan_s, ops = device_ops(session, conn, sql)
    return busy_ms, scan_s, ops[:5]


def run_join_queries(flush: torch.Tensor, sf: float = 1, device: str = "cuda") -> dict:
    """Phase 6: Q3 and Q10 at SF1 through Session.sql, then the join
    probes timed at the inputs the first runs gave them."""
    conn = TpchConnector(sf=sf, device=device)
    t0 = time.perf_counter()
    want = {"q3": q3_expected(conn), "q10": q10_expected(conn)}
    log(f"phase 6: numpy recomputation of Q3 and Q10 at SF1 in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel_of = {"q3": "exists", "q10": "payload"}
    probe_batches = len(conn.splits("lineitem"))
    captured, launches, counts = {}, {}, {}
    for q, mode in kernel_of.items():
        session = Session({"tpch": conn}, device=device)
        # the first probe batch of the query's fused join, and its keep calls
        with first_probe(mode) as seen:
            COUNTERS.clear()
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = session.sql(QUERIES[q])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            n = _launch_counts()
            route = dict(COUNTERS)
        captured[mode] = seen
        n_exists, n_payload = n["exists"], n["payload"]
        check(seen["calls"] == n[mode],
              f"{q}: {seen['calls']} {mode}_keep calls for {n[mode]} {mode} launches")
        counts[q] = n
        check_vector_probes(q, n)
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
        busy_ms, scan_s, _ = wall_breakdown(session, conn, QUERIES[q])
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

    return {"launches": counts,
            "exists": time_probe("exists", captured["exists"], launches["exists"], flush),
            "payload": time_probe("payload", captured["payload"], launches["payload"], flush)}


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
        return torch.from_numpy(a).to(conn.device).repeat(factor)

    live = resident(np.ones(rows // factor, np.bool_))
    cols = {route.rename[c]: Column(resident(arrays[c].astype(phys[c].np_dtype)), live, phys[c])
            for c in route.src_cols}
    batch = Batch(cols, live)
    torch.cuda.synchronize()
    inst = cuda_agg.instance(spec, [batch[c].data for c in spec.cols], batch.live)
    check(inst == "staged", f"resident Q6 step: the {inst} instance, not the staged one")
    state = cuda_agg.agg_step(spec, batch)
    got = int(state["sum_0"][0])
    check(got == factor * want_rev and not bool(state["value_overflow"]),
          f"resident Q6 step: {got} != {factor} x {want_rev}")
    err = compare(state, cuda_agg.agg_step_plain(spec, batch), "agg_step resident Q6")
    nbytes = sum(c.data.numel() * c.data.element_size() for c in cols.values()) + rows + 3 * 8
    return {"rows": rows, "bytes": nbytes, "err": err, "spec": spec, "batch": batch,
            "ms": device_ms(lambda: cuda_agg.agg_step(spec, batch), 20, kernel="leaf_"),
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
    recomputation, and equal again in a second run and with
    ``narrow_storage`` off (the generic operators); then the leaf kernel
    timed at the first Q6 split and over a resident SF1 x10 lineitem."""
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
    captured = {}
    original = leaf_route.agg_step

    def capture(name):
        def first_split(spec, batch):
            captured.setdefault(name, (spec, batch))  # the query's first scan split
            return original(spec, batch)
        return first_split

    out = {"leaf_launches": 0, "walls": {}, "by_instance": {}, "by_shape": {}}
    narrow_before = os.environ.get("PRESTO_TPU_NARROW")
    try:
        for name, (sql, conn, table) in runs.items():
            # narrow_storage mirrors a process-wide switch: say it each time
            on = Session({"tpch": tconn, "ssb": sconn}, properties={"narrow_storage": True},
                         device=device)
            leaf_route.agg_step = capture(name) if name in ("q6", "ssb q1_1") else original
            COUNTERS.clear()
            cuda_q1.launches = 0
            cuda_agg.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = on.sql(sql)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            n_q1, n_leaf = cuda_q1.launches, cuda_agg.launches
            by_instance = {k: v for k, v in cuda_agg.launches_by_instance.items() if v}
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
                check(by_instance == {"staged": n_leaf},
                      f"{name}: leaf-kernel launches by instance {by_instance}")
                out["leaf_launches"] += n_leaf
                out["by_instance"][name] = by_instance
                cap = batch_capacity(max(sp.row_hint for sp in conn.splits(table)))
                out["by_shape"][cap] = out["by_shape"].get(cap, 0) + n_leaf
            t0 = time.perf_counter()
            again = on.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            same_result(again, want[name], f"{name} at SF1, second run")
            busy_ms, scan_s, _ = wall_breakdown(on, conn, sql)
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
                f"leaf-kernel launches {n_leaf} ({splits} splits, by instance "
                f"{by_instance}); routes "
                f"{ {k: v for k, v in route.items() if k.startswith(('exec.', 'agg.'))} }")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans (host generation + copy to the card) {scan_s:.3f} s")
    finally:
        leaf_route.agg_step = original
        if narrow_before is None:
            os.environ.pop("PRESTO_TPU_NARROW", None)
        else:
            os.environ["PRESTO_TPU_NARROW"] = narrow_before

    out["split"] = time_leaf(*captured["q6"], flush)
    out["small"] = time_leaf(*captured["ssb q1_1"], flush)
    out["captured"] = captured
    on = Session({"tpch": tconn}, properties={"narrow_storage": True}, device=device)
    out["resident"] = resident_q6(on, tconn, int(want["q6"]["revenue"][0]), FACTOR)
    return out


# ---------------------------------------------------------------------------
# phases 2 and 8: string predicates on byte columns
# ---------------------------------------------------------------------------

LIKE_ALPHABET = b"ab10"
PREFIXES = ["", "a", "ab", "1a0", "aaaaaaaa", "b" * 80]
#: prefix lengths phase 2 also takes from a row of each width (the
#: parameter words' edge: 64 and 65 bytes; and the whole row)
PREFIX_LENGTHS = (1, 3, 4, 5, 8, 63, 64, 65)
#: the prefix over SF1 o_comment: 6 bytes that about 2.7 % of rows start with
COMMENT_PREFIX = "specia"
# every LIKE pattern of the two query sets over its own SF1 column:
# (name, connector key, table, column, LIKE patterns, prefixes)
SF1_STRING_COLUMNS = [
    ("TPC-H p_name", "tpch", "part", "p_name", ["%green%", "forest%"], ["forest"]),
    ("TPC-H o_comment", "tpch", "orders", "o_comment", ["%special%requests%"],
     [COMMENT_PREFIX]),
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


def like_edge_patterns() -> list:
    """The LIKE kernel's edge set, over the rows' alphabet: interior
    segments of 31, 32, 33, 64 and 65 bytes (the 32- and 64-bit Shift-And
    tables' edges and past them), anchored ones of those lengths, the
    anchored segments' byte limit (256) and one past it, more interior
    segments than the tables hold, patterns whose first byte is common in
    the rows, ``Customer%1``-shaped anchors, and zero bytes in a literal
    and in a segment."""
    rng = np.random.default_rng(8)

    def seg(n: int) -> str:
        return "".join(chr(c) for c in rng.choice(list(LIKE_ALPHABET), n))

    s31, s32, s33, s64, s65 = (seg(n) for n in (31, 32, 33, 64, 65))
    return [f"%{s31}%", f"%{s32}%", f"%{s33}%", f"%{s64}%", f"%{s65}%",
            f"{s31}%", f"%{s32}", f"{s33}%{s64}", f"%{s65}", f"{s64}", f"%{s31}%{s33}%",
            f"a%{s32}%{s64}%b", "a" * 256 + "%", "a" * 257 + "%", "%" + "b" * 256,
            "%a%b%1%0%", "%a%b%1%0%a%", "a%b%1%0%a%b%1", "%aab%", "%a%a%a%a%",
            "%aaaab%bbba%", "a%1", "ab10%1", "b%0", "1a%a1", "a\0", "%a\0%", "%a\0b%"]


def edge_rows(width: int, cap: int, seed: int) -> np.ndarray:
    """``string_rows`` with the edge set planted in about a third of the
    rows, taking turns: a whole row made to match one of
    ``like_edge_patterns()`` that fits (its segments in order, each '%'
    a random filler of 0-3 bytes, the pattern's anchors kept),
    or one of their segments written over the row's bytes at a random
    offset; so the long segments both hit and miss, as infixes and as
    suffixes."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(LIKE_ALPHABET, np.uint8)
    out = string_rows(width, cap, seed)
    made = []
    for p in like_edge_patterns():
        parts = [np.frombuffer(t.encode("latin1"), np.uint8) for t in p.split("%")]
        row = [parts[0]]
        for t in parts[1:]:
            row += [rng.choice(alphabet, int(rng.integers(0, 4))), t]
        row = np.concatenate(row)
        if row.size <= width:
            made.append(row)
    segs = sorted({t.encode("latin1") for p in like_edge_patterns() for t in p.split("%")
                   if t and len(t) <= width})
    for k, r in enumerate(np.flatnonzero(rng.random(cap) < 0.35)):
        if k % 2 and made:
            out[r] = 0
            row = made[(k // 2) % len(made)]
            out[r, : row.size] = row
        elif segs:
            t = np.frombuffer(segs[(k // 2) % len(segs)], np.uint8)
            at = int(rng.integers(0, width - t.size + 1))
            out[r, at: at + t.size] = t
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


#: phase 2's LIKE widths: the main path's (22, 25, 55, 79, 101 are the
#: SF1 columns'), the 32- and 64-bit tables' edges and the widest
LIKE_WIDTHS = (1, 7, 22, 55, 79, 101, 199, 256)


def like_rows_view(rows: np.ndarray) -> torch.Tensor:
    """``rows`` on the card as a view one row and one byte (two where
    that lands 16-byte aligned) into its buffer: not 16-byte aligned, so
    the LIKE kernel takes its direct instance."""
    n, w = rows.shape
    at = w + 1 if (w + 1) % 16 else w + 2
    buf = torch.zeros((n + 2) * w + 2, dtype=torch.uint8, device="cuda")
    view = buf[at: at + n * w].view(n, w)
    view.copy_(_t(rows))
    return view


def rows_at(rows: np.ndarray, head: int) -> torch.Tensor:
    """``rows`` on the card as a view ``head`` bytes into its buffer."""
    n, w = rows.shape
    buf = torch.zeros(n * w + head + 8, dtype=torch.uint8, device="cuda")
    view = buf[head: head + n * w].view(n, w)
    view.copy_(_t(rows))
    return view


def check_prefix(data: torch.Tensor, prefix: str, what: str) -> int:
    """``starts_with_mask`` against its plain version, and the launch on
    the instance ``cuda_strings.prefix_instance`` names (none for the
    empty prefix, a prefix longer than W or no rows)."""
    before = dict(cuda_strings.prefix_launches_by_instance)
    got = cuda_strings.starts_with_mask(data, prefix)
    ran = [i for i, c in cuda_strings.prefix_launches_by_instance.items() if c != before[i]]
    length = len(prefix.encode("latin1"))
    launched = 0 < length <= data.shape[1] and data.shape[0] > 0
    want = [cuda_strings.prefix_instance(prefix)] if launched else []
    check(ran == want, f"starts_with_mask {what}: instance {ran}, expected {want}")
    check(got.numel() == 0 or int(got.view(torch.uint8).max()) <= 1,
          f"starts_with_mask {what}: a bool byte past 1")
    return _mask_err(got, cuda_strings.starts_with_mask_plain(data, prefix),
                     f"starts_with_mask {what}")


def check_string_kernels(connectors) -> tuple:
    """Phase 2 for the LIKE and prefix kernels: the pattern set and the
    LIKE edge set (``like_edge_patterns``, on ``edge_rows``) over
    ``LIKE_WIDTHS`` at capacities at the edges of a 256-row tile, a
    ragged last tile and 2^17 + 3, aligned (the staged instances) and as
    views one row and one byte into their buffers (the direct ones); every
    LIKE instance must run, each launch on the instance its inputs call
    for. Then every LIKE pattern of the query sets over its own SF1
    column, each against the plain version and, on the SF1 columns,
    Python's ``re``. Returns (LIKE max error, prefix max error, SF1
    columns on the card)."""
    like_err = prefix_err = 0
    cuda_strings.reset_launches()
    patterns = like_patterns() + like_edge_patterns()
    for width in LIKE_WIDTHS:
        for cap in (255, 256, 257, small_capacity(width), (1 << 17) + 3):
            rows = edge_rows(width, cap, width + cap)
            variants = [("aligned", _t(rows), "staged")]
            if cap != 256:
                variants.append(("view", like_rows_view(rows), "direct"))
            for what, data, how in variants:
                for p in patterns:
                    want = f"{how}_{cuda_strings.like_kernel_program(p)[0]}"
                    before = dict(cuda_strings.like_launches_by_instance)
                    got = cuda_strings.like_mask(data, p)
                    ran = [i for i, c in cuda_strings.like_launches_by_instance.items()
                           if c != before[i]]
                    check(ran == [want], f"like_mask {p!r} W={width} cap {cap} {what}: "
                          f"instance {ran}, expected {want}")
                    like_err = max(like_err, _mask_err(got, cuda_strings.like_mask_plain(data, p),
                                                       f"like_mask {p!r} W={width} cap {cap} "
                                                       f"{what}"))
                    check(int(got.view(torch.uint8).max()) <= 1,
                          f"like_mask {p!r} W={width}: a bool byte past 1")
            # the prefix kernel: the fixed prefixes and ones taken from a
            # row, at bases 0-3 bytes past an aligned word
            taken = [bytes(rows[7, :n]).decode("latin1") for n in PREFIX_LENGTHS + (width,)
                     if n <= width]
            for head in range(4):
                data = _t(rows) if head == 0 else rows_at(rows, head)
                for p in PREFIXES + taken:
                    prefix_err = max(prefix_err, check_prefix(
                        data, p, f"{p!r} W={width} cap {cap} base +{head}"))
            prefix_err = max(prefix_err, check_prefix(_t(rows[:0]), "ab", f"W={width} no rows"))
        torch.cuda.synchronize()
    idle = [i for i, c in cuda_strings.like_launches_by_instance.items() if c == 0]
    check(not idle, f"LIKE instances never held to plain: {idle}")
    idle = [i for i, c in cuda_strings.prefix_launches_by_instance.items() if c == 0]
    check(not idle, f"prefix instances never held to plain: {idle}")
    log(f"  like_mask: {len(like_patterns())} patterns and {len(like_edge_patterns())} edge "
        f"patterns, starts_with_mask: {len(PREFIXES)} prefixes and row prefixes of "
        f"{PREFIX_LENGTHS} and W bytes (bases 0-3 bytes past a word), widths {LIKE_WIDTHS} at "
        "capacities 255, 256, 257, a ragged one and 2^17 + 3, aligned and as views: equal to "
        f"plain; LIKE launches by instance {cuda_strings.like_launches_by_instance}, prefix "
        f"launches by instance {cuda_strings.prefix_launches_by_instance}")
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
            prefix_err = max(prefix_err, check_prefix(data, p, f"{name} {p!r}"))
            got = cuda_strings.starts_with_mask(data, p)
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
    year = year_of(o["o_orderdate"][oo][opos][hit])
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
    cuda_q1.launches = 0
    cuda_groupby.reset_launches()
    cuda_agg.reset_launches()
    cuda_join.reset_launches()
    cuda_strings.reset_launches()


def _summed(*counts: dict) -> dict:
    """Launch counts by key, added over several runs."""
    out: dict = {}
    for by in counts:
        for k, c in by.items():
            out[k] = out.get(k, 0) + c
    return out


def _launch_counts() -> dict:
    return {"q1": cuda_q1.launches, "lane_sums": cuda_groupby.launches,
            "leaf_agg": cuda_agg.launches, "exists": cuda_join.exists_launches,
            "payload": cuda_join.payload_launches, "sketch": cuda_join.sketch_launches,
            "q3": cuda_join.q3_launches, "like": cuda_strings.like_launches,
            "prefix": cuda_strings.prefix_launches,
            "prefix_by_instance": {k: v for k, v in
                                   cuda_strings.prefix_launches_by_instance.items() if v},
            "by_instance": {**{f"lane_sums {k}": v
                               for k, v in cuda_groupby.launches_by_instance.items() if v},
                            **{f"leaf_agg {k}": v
                               for k, v in cuda_agg.launches_by_instance.items() if v}},
            "probe_by_instance": {k: dict(v) for k, v in cuda_join.launches_by_instance.items()},
            "probe_by_shape": {k: dict(v) for k, v in cuda_join.launches_by_shape.items()},
            "like_by_instance": {k: v for k, v in cuda_strings.like_launches_by_instance.items()
                                 if v},
            "like_by_shape": dict(cuda_strings.like_launches_by_shape)}


def probe_launch_totals(*runs) -> dict:
    """The exists, sketch and payload kernels' launches over main-path
    runs (each ``runs`` item maps a run's name to its ``_launch_counts()``):
    per kernel, in all, by row count and by instance."""
    out = {k: {"launches": 0, "by_shape": {}, "by_instance": dict.fromkeys(names, 0)}
           for k, names in (("exists", cuda_join.INSTANCES), ("sketch", cuda_join.INSTANCES),
                            ("payload", cuda_join.PAYLOAD_INSTANCES))}
    for named in runs:
        for n in named.values():
            for k, t in out.items():
                t["launches"] += n[k]
                for rows, c in n["probe_by_shape"][k].items():
                    t["by_shape"][rows] = t["by_shape"].get(rows, 0) + c
                for inst, c in n["probe_by_instance"][k].items():
                    t["by_instance"][inst] += c
    return out


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
    captured = {"like": {}}
    original_like = cuda_strings.like_mask
    current = [None]

    def capture_like(data, pattern):
        # each query's first split of the table LIKE filters
        captured["like"].setdefault(current[0], (data, pattern))
        return original_like(data, pattern)

    original_lane = cuda_groupby.fused_lane_sums

    def capture_lane(*args):
        captured.setdefault("lane", args)  # q_like_phone's first lineorder split
        return original_lane(*args)

    out = {"like_launches": 0, "like_by_instance": {}, "like_by_shape": {}, "walls": {},
           "launches": {}}
    for name, (key, ftable, others) in STRING_QUERIES.items():
        conn = connectors[key]
        session = Session({key: conn}, device=device)
        current[0] = name
        cuda_strings.like_mask = capture_like
        if name == "ssb q_like_phone":
            cuda_groupby.fused_lane_sums = capture_lane
        try:
            # Q9's part join (exists) and nation join (payload): their
            # first lineitem probe batches and their keep calls
            with first_probe("exists") as seen, first_probe("payload") as pseen:
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
            cuda_groupby.fused_lane_sums = original_lane
        check(seen["calls"] == n["exists"] and pseen["calls"] == n["payload"],
              f"{name}: {seen['calls']} exists_keep and {pseen['calls']} payload_keep calls for "
              f"{n['exists']} exists and {n['payload']} payload launches")
        if name == "q9":
            captured["exists"], captured["payload"] = seen, pseen
        check(all(k.split()[1].startswith("staged") for k in n["by_instance"]),
              f"{name}: launches by instance {n['by_instance']}")
        check_vector_probes(name, n)
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
        # the filtered table's splits come from the connector aligned: the
        # staged instance of the pattern's matcher, every launch
        pattern = captured["like"][name][1]
        staged = f"staged_{cuda_strings.like_kernel_program(pattern)[0]}"
        check(n["like_by_instance"] == {staged: n["like"]},
              f"{name}: LIKE launches by instance {n['like_by_instance']}, expected {staged}")
        out["like_launches"] += n["like"]
        for key_, by in (("like_by_instance", n["like_by_instance"]),
                         ("like_by_shape", n["like_by_shape"])):
            out[key_] = _summed(out[key_], by)
        out["launches"][name] = n
        t0 = time.perf_counter()
        again = session.sql(sqls[name])
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        same_result(again, want[name], f"{name} at SF{sf:g}, second run")
        busy_ms, scan_s, _ = wall_breakdown(session, conn, sqls[name])
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
    check(n["prefix_by_instance"] == {"param": splits},
          f"starts_with pipeline: prefix launches by instance {n['prefix_by_instance']}")
    out["prefix_launches"] = n["prefix"]
    out["prefix_by_instance"] = n["prefix_by_instance"]
    log(f"  starts_with(p_name, 'forest') pipeline: {got.size} rows equal to str.startswith "
        f"and to p_name like 'forest%'; wall {wall:.3f} s; prefix launches {n['prefix']} "
        f"({splits} part splits), by instance {n['prefix_by_instance']}")
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
    b, by = bound(n * (w + 1), n * w)
    return {"ms": device_ms(fn, 50, flush, kernel="like_kernel"), "call_ms": call_ms(fn, 50),
            "plain_ms": device_ms(plain, 5, flush), "rows": n, "width": w,
            "pattern": pattern, "bytes": n * (w + 1), "ops": n * w, "err": err,
            "bound_ms": b, "bound_by": by,
            "instance": cuda_strings.like_instance(data.contiguous(), pattern)}


def prefix_sectors(data: torch.Tensor, length: int) -> int:
    """The 32-byte sectors of device memory that the first ``length``
    bytes of every row of ``data`` lie in (each counted once)."""
    n, w = data.shape
    start = data.data_ptr() + torch.arange(n, dtype=torch.int64, device=data.device) * w
    first, last = start // 32, (start + length - 1) // 32
    ids = torch.cat([first + k for k in range(int((last - first).max()) + 1)])
    return int(torch.unique(ids[ids <= last.repeat(ids.numel() // n)]).numel())


def time_prefix(data: torch.Tensor, prefix: str, flush) -> dict:
    """Phase 5 numbers of the prefix kernel on ``data``: its bound counts
    the L prefix bytes of each row read once, one bool written and L
    comparisons a row; its sector floor, the 32-byte sectors the rows'
    prefix windows lie in, read once at the memory rate."""
    fn = lambda: cuda_strings.starts_with_mask(data, prefix)  # noqa: E731
    plain = lambda: cuda_strings.starts_with_mask_plain(data, prefix)  # noqa: E731
    err = _mask_err(fn(), plain(), f"starts_with_mask {prefix!r} at phase 5")
    n, w = data.shape
    length = len(prefix.encode("latin1"))
    b, by = bound(n * (length + 1), n * length)
    sectors = prefix_sectors(data, length)
    return {"ms": device_ms(fn, 50, flush, kernel="prefix_kernel"), "call_ms": call_ms(fn, 50),
            "plain_ms": device_ms(plain, 10, flush), "rows": n, "width": w,
            "prefix": prefix, "bytes": n * (length + 1), "ops": n * length, "err": err,
            "bound_ms": b, "bound_by": by, "sectors": sectors,
            "sector_floor_ms": (sectors * 32 + n) / HBM_BYTES_PER_S * 1e3,
            "matches": int(fn().sum()), "instance": cuda_strings.prefix_instance(prefix)}


# ---------------------------------------------------------------------------
# phase 10: expansion joins and LEFT OUTER joins
# ---------------------------------------------------------------------------

Q5_SF = 0.05  # the largest round scale at which the JAX package's retry ladder answers Q5


def q5_expected(conn) -> dict:
    """TPC-H Q5 recomputed in int64 numpy: the orders of 1994, each of
    their lineitems whose supplier's nation is its customer's and lies in
    ASIA, revenue as the scaled int64 sum(ep * (100 - disc)) by nation
    name, largest first."""
    lo, hi = days("1994-01-01"), days("1995-01-01")
    r = conn.table_numpy("region", ["r_regionkey", "r_name"])
    asia = r["r_regionkey"][r["r_name"] == conn.dictionaries("region")["r_name"].code_of("ASIA")]
    n = conn.table_numpy("nation", ["n_nationkey", "n_name", "n_regionkey"])
    in_asia = np.zeros(int(n["n_nationkey"].max()) + 1, bool)
    in_asia[n["n_nationkey"][np.isin(n["n_regionkey"], asia)]] = True
    c = conn.table_numpy("customer", ["c_custkey", "c_nationkey"])
    cust_nation = np.full(int(c["c_custkey"].max()) + 1, -1, np.int64)
    cust_nation[c["c_custkey"]] = c["c_nationkey"]
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey"])
    supp_nation = np.full(int(s["s_suppkey"].max()) + 1, -1, np.int64)
    supp_nation[s["s_suppkey"]] = s["s_nationkey"]
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    om = (o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi)
    order = np.argsort(o["o_orderkey"][om])
    ok, onat = o["o_orderkey"][om][order], cust_nation[o["o_custkey"][om][order]]
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_suppkey", "l_extendedprice",
                                       "l_discount"])
    pos, hit = _lookup(ok, li["l_orderkey"])
    snat = supp_nation[li["l_suppkey"]]
    keep = hit & (onat[pos] == snat) & in_asia[snat]
    rev = li["l_extendedprice"][keep].astype(np.int64) * (100 - li["l_discount"][keep]
                                                           .astype(np.int64))
    sums = np.zeros(in_asia.size, np.int64)
    np.add.at(sums, snat[keep], rev)
    nations = np.unique(snat[keep])
    top = nations[np.argsort(-sums[nations], kind="stable")]
    names = conn.dictionaries("nation")["n_name"].values
    name_of = dict(zip(n["n_nationkey"].tolist(), n["n_name"].tolist()))
    return {"n_name": [names[name_of[k]] for k in top.tolist()], "revenue": sums[top]}


def q13_expected(conn) -> dict:
    """TPC-H Q13 recomputed in numpy: each customer's orders whose comment
    is not like '%special%requests%' (Python's ``re``), counted (0 for a
    customer with none); customers per count, most customers first, then
    the larger count."""
    c = conn.table_numpy("customer", ["c_custkey"])
    o = conn.table_numpy("orders", ["o_custkey", "o_comment"])
    keep = ~like_oracle(_text(o["o_comment"]), "%special%requests%")
    per = np.bincount(o["o_custkey"][keep].astype(np.int64),
                      minlength=int(c["c_custkey"].max()) + 1)[c["c_custkey"]]
    c_count, custdist = np.unique(per, return_counts=True)
    top = np.lexsort((-c_count, -custdist))
    return {"c_count": c_count[top], "custdist": custdist[top]}


@contextlib.contextmanager
def expand_capacities():
    """While in the block, the output capacity of every expansion-probe
    operator the executor makes is appended to the yielded list, in order
    (the capacities its retry ladder tried)."""
    from presto_tpu_torch.exec import local_planner

    caps = []
    original = local_planner.LookupJoinOperator

    def operator(*args, **kwargs):
        if not kwargs.get("unique", True):
            caps.append(kwargs["out_capacity"])
        return original(*args, **kwargs)

    local_planner.LookupJoinOperator = operator
    try:
        yield caps
    finally:
        local_planner.LookupJoinOperator = original


def run_outer_join_queries(sf13: float = 1, sf5: float = Q5_SF, device: str = "cuda") -> dict:
    """Phase 10: TPC-H Q13 (a LEFT expansion join whose build, orders, the
    LIKE kernel filters once per split) and Q5 (an inner expansion join on
    c_nationkey = s_nationkey) through Session.sql, each against its numpy
    recomputation, with the walls of a first and a second run, the device
    busy time of a third, the launches per kernel, the expansion joins'
    strategy counters and the output capacities their retry ladders
    reached."""
    conns = {"q13": TpchConnector(sf=sf13, device=device),
             "q5": TpchConnector(sf=sf5, device=device)}
    t0 = time.perf_counter()
    want = {"q13": q13_expected(conns["q13"]), "q5": q5_expected(conns["q5"])}
    log(f"phase 10: numpy recomputation of Q13 at SF{sf13:g} and Q5 at sf {sf5:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"walls": {}, "launches": {}, "like_launches": 0, "like_by_instance": {},
           "like_by_shape": {}, "lane_launches": 0, "lane_by_instance": {}}
    original_like = cuda_strings.like_mask

    def capture_like(data, pattern):
        out.setdefault("captured", (data, pattern))  # Q13's first orders split
        return original_like(data, pattern)

    for name, conn in conns.items():
        session = Session({"tpch": conn}, device=device)
        sql = QUERIES[name]
        cuda_strings.like_mask = capture_like
        try:
            with expand_capacities() as caps:
                COUNTERS.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = dict(COUNTERS)
        finally:
            cuda_strings.like_mask = original_like
        same_result(res, want[name], f"{name} at SF{conn.sf:g}")
        check("strategy=expand" in session.explain(sql), f"{name}: EXPLAIN has no expand join")
        check(route.get("join.strategy.expand", 0) >= 1, f"{name}: join routes {route}")
        check(len(caps) == route["join.strategy.expand"],
              f"{name}: {len(caps)} expansion capacities for {route['join.strategy.expand']} "
              "expand operators")
        check_vector_probes(name, n)
        check(route.get("join.pallas_fallback", 0) == 0,
              f"{name}: {route.get('join.pallas_fallback')} fused-probe fallbacks")
        if name == "q13":
            splits = len(conn.splits("orders"))
            check(n["like"] == splits and n["like_by_instance"] == {"staged_shift32": splits},
                  f"q13: LIKE launches {n['like_by_instance']} for {splits} orders splits")
        else:
            check(n["like"] == 0, f"q5: {n['like']} LIKE launches")
        out["like_launches"] += n["like"]
        out["lane_launches"] += n["lane_sums"]
        lane_by = {k.split()[1]: c for k, c in n["by_instance"].items()
                   if k.startswith("lane_sums ")}
        for key_, by in (("like_by_instance", n["like_by_instance"]),
                         ("like_by_shape", n["like_by_shape"]), ("lane_by_instance", lane_by)):
            out[key_] = _summed(out[key_], by)
        out["launches"][name] = n
        t0 = time.perf_counter()
        again = session.sql(sql)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        same_result(again, want[name], f"{name} at SF{conn.sf:g}, second run")
        busy_ms, scan_s, top = wall_breakdown(session, conn, sql)
        out["walls"][name] = (first, second, busy_ms, scan_s)
        log(f"  {name} at SF{conn.sf:g}: {len(res)} rows equal to numpy; wall first {first:.3f} "
            f"s, second {second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
            f"{ {k: v for k, v in route.items() if k.startswith(('exec.', 'agg.', 'join.'))} }; "
            f"expansion output capacities tried, in order: {caps}")
        log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
            f"connector scans (host generation + copy to the card) {scan_s:.3f} s; the "
            "device ops with the most of it (ms, calls): "
            + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in top))
    return out


# ---------------------------------------------------------------------------
# phase 11: the conditional expression library, DISTINCT and BYTES keys
# ---------------------------------------------------------------------------

#: the three statements phase 11 runs beside the queries: ORDER BY a
#: BYTES column under OR and unary minus; GROUP BY a BYTES key with
#: count(DISTINCT); CASE, IS NULL and COALESCE over null-extended rows
AD_HOC = {
    "order_bytes": "select c_name, c_acctbal from customer where c_acctbal > 9990 "
                   "or c_acctbal < -999 order by c_name desc",
    "group_bytes": "select substring(c_phone, 1, 2) as cc, count(distinct c_mktsegment) as nn, "
                   "sum(c_acctbal) as bal from customer group by substring(c_phone, 1, 2) "
                   "order by cc",
    "null_extended": "select count(*) as n, sum(case when o_orderkey is null then 1 else 0 end) "
                     "as unmatched, sum(coalesce(o_totalprice, 0)) as total from customer "
                     "left join orders on c_custkey = o_custkey and o_orderstatus = 'F'",
}

#: ``count(*)`` beside a DISTINCT aggregate: refused, as the JAX package
#: refuses it
DISTINCT_WITH_COUNT_STAR = ("select substring(c_phone, 1, 2) as cc, count(*) as n, "
                            "count(distinct c_mktsegment) as nn from customer "
                            "group by substring(c_phone, 1, 2)")

#: decimal -> DOUBLE: both packages multiply by this float32 reciprocal
INV_10K = np.float32(1) / np.float32(10**4)


def year_of(d: np.ndarray) -> np.ndarray:
    """Calendar year of each of ``d`` (days since 1970-01-01)."""
    return ((np.datetime64("1970-01-01", "D") + d.astype(np.int64)).astype("datetime64[Y]")
            .astype(np.int64) + 1970)


def _codes(conn, table: str, column: str, values) -> np.ndarray:
    """The dictionary codes of ``values`` (a value absent from the
    dictionary matches nothing)."""
    d = conn.dictionaries(table)[column]
    present = set(d.values.tolist())
    return np.array([d.code_of(v) for v in values if v in present], np.int64)


def _by_key(keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """A dense lookup: ``out[k]`` is the value of key ``k``."""
    out = np.zeros(int(keys.max()) + 1, np.asarray(values).dtype)
    out[keys] = values
    return out


def _volume(li: dict, m: np.ndarray) -> np.ndarray:
    """l_extendedprice * (1 - l_discount) at scale 4, int64, rows ``m``."""
    return (li["l_extendedprice"][m].astype(np.int64)
            * (100 - li["l_discount"][m].astype(np.int64)))


def _group_sums(keys: list, values: np.ndarray) -> tuple:
    """Sums of ``values`` by the tuple of ``keys``: (the key columns of
    each group, sums), groups in lexicographic key order."""
    rows = np.stack([k.astype(np.int64) for k in keys], axis=1)
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv.ravel(), values.astype(np.int64))
    return [uniq[:, i] for i in range(len(keys))], sums


def _as_double(scaled: np.ndarray) -> np.ndarray:
    """A scale-4 decimal in DOUBLE as both packages compute it: float32
    times the float32 reciprocal of 10^4."""
    return scaled.astype(np.int64).astype(np.float32) * INV_10K


def _nation_names(conn) -> np.ndarray:
    """n_name's code by nation key."""
    n = conn.table_numpy("nation", ["n_nationkey", "n_name"])
    return _by_key(n["n_nationkey"], n["n_name"].astype(np.int64))


def q7_expected(conn) -> dict:
    """TPC-H Q7 (``tpch_oracle.py`` q7's semantics in int64 numpy):
    revenue between FRANCE and GERMANY suppliers and customers, each
    way, by year of shipment."""
    names = conn.dictionaries("nation")["n_name"]
    fr, ge = names.code_of("FRANCE"), names.code_of("GERMANY")
    nat = _nation_names(conn)
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey"])
    c = conn.table_numpy("customer", ["c_custkey", "c_nationkey"])
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey"])
    cust_nat = _by_key(c["c_custkey"], nat[c["c_nationkey"]])
    order_nat = _by_key(o["o_orderkey"], cust_nat[o["o_custkey"]])
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_suppkey", "l_shipdate",
                                       "l_extendedprice", "l_discount"])
    sn = _by_key(s["s_suppkey"], nat[s["s_nationkey"]])[li["l_suppkey"]]
    cn = order_nat[li["l_orderkey"]]
    ship = li["l_shipdate"]
    m = (((sn == fr) & (cn == ge)) | ((sn == ge) & (cn == fr))) \
        & (ship >= days("1995-01-01")) & (ship <= days("1996-12-31"))
    (ks, kc, ky), rev = _group_sums([sn[m], cn[m], year_of(ship[m])], _volume(li, m))
    return {"supp_nation": list(names.values[ks]), "cust_nation": list(names.values[kc]),
            "l_year": ky, "revenue": rev}


def q8_expected(conn) -> dict:
    """TPC-H Q8: BRAZIL's share of the AMERICA market for ECONOMY
    ANODIZED STEEL by order year, the two scale-4 int64 sums divided in
    float32 as both packages divide them."""
    ptype = conn.dictionaries("part")["p_type"].code_of("ECONOMY ANODIZED STEEL")
    p = conn.table_numpy("part", ["p_partkey", "p_type"])
    part_ok = _by_key(p["p_partkey"], p["p_type"] == ptype)
    america = _codes(conn, "region", "r_name", ["AMERICA"])
    r = conn.table_numpy("region", ["r_regionkey", "r_name"])
    n = conn.table_numpy("nation", ["n_nationkey", "n_regionkey"])
    in_america = _by_key(n["n_nationkey"],
                         np.isin(n["n_regionkey"], r["r_regionkey"][np.isin(r["r_name"],
                                                                              america)]))
    c = conn.table_numpy("customer", ["c_custkey", "c_nationkey"])
    cust_ok = _by_key(c["c_custkey"], in_america[c["c_nationkey"]])
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    od = o["o_orderdate"]
    order_ok = _by_key(o["o_orderkey"], (od >= days("1995-01-01")) & (od <= days("1996-12-31"))
                       & cust_ok[o["o_custkey"]])
    order_year = _by_key(o["o_orderkey"], year_of(od))
    brazil = conn.dictionaries("nation")["n_name"].code_of("BRAZIL")
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey"])
    supp_br = _by_key(s["s_suppkey"], _nation_names(conn)[s["s_nationkey"]] == brazil)
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                                       "l_extendedprice", "l_discount"])
    m = part_ok[li["l_partkey"]] & order_ok[li["l_orderkey"]]
    vol = _volume(li, m)
    br = supp_br[li["l_suppkey"][m]]
    (years,), total = _group_sums([order_year[li["l_orderkey"][m]]], vol)
    _, from_brazil = _group_sums([order_year[li["l_orderkey"][m]]], np.where(br, vol, 0))
    return {"o_year": years, "mkt_share": _as_double(from_brazil) / _as_double(total)}


def q12_expected(conn) -> dict:
    """TPC-H Q12: late MAIL and SHIP lines received in 1994 by ship mode,
    counted for high (1-URGENT, 2-HIGH) and other order priorities."""
    modes = _codes(conn, "lineitem", "l_shipmode", ["MAIL", "SHIP"])
    high = _codes(conn, "orders", "o_orderpriority", ["1-URGENT", "2-HIGH"])
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderpriority"])
    prio = _by_key(o["o_orderkey"], o["o_orderpriority"].astype(np.int64))
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_shipmode", "l_commitdate",
                                       "l_receiptdate", "l_shipdate"])
    rc, cd = li["l_receiptdate"], li["l_commitdate"]
    m = (np.isin(li["l_shipmode"], modes) & (cd < rc) & (li["l_shipdate"] < cd)
         & (rc >= days("1994-01-01")) & (rc < days("1995-01-01")))
    hi = np.isin(prio[li["l_orderkey"][m]], high)
    (mode,), n_high = _group_sums([li["l_shipmode"][m]], hi)
    _, n_all = _group_sums([li["l_shipmode"][m]], np.ones(int(m.sum()), np.int64))
    names = conn.dictionaries("lineitem")["l_shipmode"].values
    return {"l_shipmode": list(names[mode]), "high_line_count": n_high,
            "low_line_count": n_all - n_high}


def q14_expected(conn) -> dict:
    """TPC-H Q14: 100.00 * the PROMO parts' revenue over all revenue
    shipped in September 1995; 100.00 * x at scale 4 is exactly 100 x,
    then the float32 division."""
    types = conn.dictionaries("part")["p_type"].values
    promo_type = np.array([t.startswith("PROMO") for t in types], bool)
    p = conn.table_numpy("part", ["p_partkey", "p_type"])
    promo = _by_key(p["p_partkey"], promo_type[p["p_type"]])
    li = conn.table_numpy("lineitem", ["l_partkey", "l_shipdate", "l_extendedprice",
                                       "l_discount"])
    ship = li["l_shipdate"]
    m = (ship >= days("1995-09-01")) & (ship < days("1995-10-01"))
    vol = _volume(li, m)
    num = np.array([100 * int(vol[promo[li["l_partkey"][m]]].sum())], np.int64)
    return {"promo_revenue": _as_double(num) / _as_double(np.array([int(vol.sum())]))}


def q16_expected(conn) -> dict:
    """TPC-H Q16: distinct suppliers without Customer...Complaints comments
    per (brand, type, size) of the parts that pass its filters, most
    suppliers first, then brand, type and size."""
    s = conn.table_numpy("supplier", ["s_suppkey", "s_comment"])
    bad = s["s_suppkey"][like_oracle(_text(s["s_comment"]), "%Customer%Complaints%")]
    types = conn.dictionaries("part")["p_type"].values
    type_ok = np.array([not t.startswith("MEDIUM POLISHED") for t in types], bool)
    p = conn.table_numpy("part", ["p_partkey", "p_brand", "p_type", "p_size"])
    pm = ((p["p_brand"] != conn.dictionaries("part")["p_brand"].code_of("Brand#45"))
          & type_ok[p["p_type"]] & np.isin(p["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    row = _by_key(p["p_partkey"], np.arange(len(pm)))
    ps = conn.table_numpy("partsupp", ["ps_partkey", "ps_suppkey"])
    r = row[ps["ps_partkey"]]
    keep = pm[r] & ~np.isin(ps["ps_suppkey"], bad)
    r, supp = r[keep], ps["ps_suppkey"][keep]
    pairs = np.unique(np.stack([p["p_brand"][r].astype(np.int64), p["p_type"][r],
                                p["p_size"][r], supp], axis=1), axis=0)
    (b, t, z), cnt = _group_sums([pairs[:, 0], pairs[:, 1], pairs[:, 2]],
                                 np.ones(len(pairs), np.int64))
    top = np.lexsort((z, t, b, -cnt))
    d = conn.dictionaries("part")
    return {"p_brand": list(d["p_brand"].values[b[top]]),
            "p_type": list(d["p_type"].values[t[top]]), "p_size": z[top],
            "supplier_cnt": cnt[top]}


def q19_expected(conn) -> dict:
    """TPC-H Q19: revenue of the lines matching one of its three
    brand / container / quantity / size branches, shipped by air and
    delivered in person."""
    d = conn.dictionaries("part")
    p = conn.table_numpy("part", ["p_partkey", "p_brand", "p_container", "p_size"])
    row = _by_key(p["p_partkey"], np.arange(len(p["p_partkey"])))
    li = conn.table_numpy("lineitem", ["l_partkey", "l_quantity", "l_shipmode",
                                       "l_shipinstruct", "l_extendedprice", "l_discount"])
    r = row[li["l_partkey"]]
    brand, cont, size = p["p_brand"][r], p["p_container"][r], p["p_size"][r]
    qty = li["l_quantity"]
    common = (np.isin(li["l_shipmode"], _codes(conn, "lineitem", "l_shipmode", ["AIR", "AIR REG"]))
              & (li["l_shipinstruct"] == conn.dictionaries("lineitem")["l_shipinstruct"]
                 .code_of("DELIVER IN PERSON")))
    m = np.zeros(len(qty), bool)
    for b, conts, q_lo, size_hi in (("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"], 1, 5),
                                    ("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
                                     10, 10),
                                    ("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"],
                                     20, 15)):
        m |= ((brand == d["p_brand"].code_of(b))
              & np.isin(cont, _codes(conn, "part", "p_container", conts))
              & (qty >= 100 * q_lo) & (qty <= 100 * (q_lo + 10))
              & (size >= 1) & (size <= size_hi))
    m &= common
    # a sum over no rows is NULL
    return {"revenue": [int(_volume(li, m).sum()) if m.any() else None]}


#: SSB flights 3.3-4.3: (customer, supplier, part, date) filters as
#: (column, values) pairs, the group keys and the measure
SSB_JOINS = {
    "q3_3": ({"c_city": ["UNITED KI1", "UNITED KI5"]}, {"s_city": ["UNITED KI1", "UNITED KI5"]},
             {}, ("d_year", range(1992, 1998)), ["c_city", "s_city", "d_year"], "revenue"),
    "q3_4": ({"c_city": ["UNITED KI1", "UNITED KI5"]}, {"s_city": ["UNITED KI1", "UNITED KI5"]},
             {}, ("d_yearmonth", ["Dec1997"]), ["c_city", "s_city", "d_year"], "revenue"),
    "q4_1": ({"c_region": ["AMERICA"]}, {"s_region": ["AMERICA"]},
             {"p_mfgr": ["MFGR#1", "MFGR#2"]}, None, ["d_year", "c_nation"], "profit"),
    "q4_2": ({"c_region": ["AMERICA"]}, {"s_region": ["AMERICA"]},
             {"p_mfgr": ["MFGR#1", "MFGR#2"]}, ("d_year", [1997, 1998]),
             ["d_year", "s_nation", "p_category"], "profit"),
    "q4_3": ({}, {"s_nation": ["UNITED STATES"]}, {"p_category": ["MFGR#14"]},
             ("d_year", [1997, 1998]), ["d_year", "s_city", "p_brand1"], "profit"),
}


def ssb_join_expected(conn, name: str) -> dict:
    """SSB ``q3_3``-``q4_3`` (``ssb_oracle.py``'s semantics in int64
    numpy): lineorder joined to its dimensions' filtered rows, the scale-2
    measure summed by the group keys; flight 3 ordered by year, then
    revenue descending (ties in group order: the keys in turn), flight 4
    by the keys."""
    cf, sf, pf, dfilter, keys, measure = SSB_JOINS[name]
    dims = {"customer": ("c_custkey", "lo_custkey", cf),
            "supplier": ("s_suppkey", "lo_suppkey", sf),
            "part": ("p_partkey", "lo_partkey", pf)}
    lo = conn.table_numpy("lineorder", ["lo_custkey", "lo_suppkey", "lo_partkey",
                                        "lo_orderdate", "lo_revenue", "lo_supplycost"])
    m = np.ones(len(lo["lo_custkey"]), bool)
    cols = {}
    for table, (pk, fk, filters) in dims.items():
        want_cols = [c for c in keys if c[0] == pk[0]] + list(filters)
        t = conn.table_numpy(table, [pk] + sorted(set(want_cols)))
        row = _by_key(t[pk], np.arange(len(t[pk])))
        ok = np.ones(len(t[pk]), bool)
        for c, values in filters.items():
            ok &= np.isin(t[c], _codes(conn, table, c, values))
        r = row[lo[fk]]
        m &= ok[r]
        for c in want_cols:
            cols[c] = t[c][r]
    d = conn.table_numpy("date", ["d_datekey", "d_year", "d_yearmonth"])
    order = np.argsort(d["d_datekey"])
    pos, hit = _lookup(d["d_datekey"][order], lo["lo_orderdate"])
    check(bool(hit.all()), f"{name} oracle: an order date is missing from date")
    cols["d_year"] = d["d_year"][order][pos]
    if dfilter is not None:
        c, values = dfilter
        v = d[c][order][pos]
        m &= np.isin(v, _codes(conn, "date", c, values) if c == "d_yearmonth" else list(values))
    value = lo["lo_revenue"].astype(np.int64)
    if measure == "profit":
        value = value - lo["lo_supplycost"].astype(np.int64)
    gk, sums = _group_sums([cols[k][m] for k in keys], value[m])
    if measure == "revenue":
        top = np.lexsort(tuple(gk[1::-1]) + (-sums, gk[2]))
    else:
        top = np.arange(len(sums))
    out = {}
    for k, g in zip(keys, gk):
        if k == "d_year":
            out[k] = g[top]
        else:
            table = {"c": "customer", "s": "supplier", "p": "part"}[k[0]]
            out[k] = list(conn.dictionaries(table)[k].values[g[top]])
    out[measure] = sums[top]
    return out


def _pad_space(rows: np.ndarray) -> list:
    """Each BYTES row as the bytes PAD SPACE compares (zero padding as
    spaces)."""
    return [bytes(r).replace(b"\x00", b" ") for r in rows]


def order_bytes_expected(conn) -> dict:
    """``AD_HOC["order_bytes"]``: customers with a balance over 9990.00
    or under -999.00, by name descending (PAD SPACE)."""
    c = conn.table_numpy("customer", ["c_name", "c_acctbal"])
    bal = c["c_acctbal"].astype(np.int64)
    idx = np.flatnonzero((bal > 999000) | (bal < -99900))
    keys = _pad_space(c["c_name"][idx])
    top = sorted(range(len(idx)), key=lambda i: keys[i], reverse=True)
    return {"c_name": _text(c["c_name"][idx[top]]), "c_acctbal": bal[idx[top]]}


def group_bytes_expected(conn) -> dict:
    """``AD_HOC["group_bytes"]``: per two-byte phone prefix, the distinct
    market segments and the summed balance, prefixes ascending."""
    c = conn.table_numpy("customer", ["c_phone", "c_mktsegment", "c_acctbal"])
    cc = c["c_phone"][:, :2].astype(np.int64)  # digits: no zero padding to compare
    code = cc[:, 0] * 256 + cc[:, 1]
    (k,), bal = _group_sums([code], c["c_acctbal"])
    seg = np.unique(np.stack([code, c["c_mktsegment"].astype(np.int64)], axis=1), axis=0)
    _, nn = _group_sums([seg[:, 0]], np.ones(len(seg), np.int64))
    return {"cc": [bytes([int(x) >> 8, int(x) & 255]).rstrip(b"\x00").decode("latin1")
                   for x in k], "nn": nn, "bal": bal}


def null_extended_expected(conn) -> dict:
    """``AD_HOC["null_extended"]``: the LEFT join's rows (a customer's F
    orders, or one NULL-extended row), the customers without one, and
    the F orders' summed total price."""
    c = conn.table_numpy("customer", ["c_custkey"])
    o = conn.table_numpy("orders", ["o_custkey", "o_orderstatus", "o_totalprice"])
    f = o["o_orderstatus"] == conn.dictionaries("orders")["o_orderstatus"].code_of("F")
    per = np.bincount(o["o_custkey"][f].astype(np.int64),
                      minlength=int(c["c_custkey"].max()) + 1)[c["c_custkey"]]
    matched = np.isin(o["o_custkey"][f], c["c_custkey"])
    return {"n": np.array([int(np.maximum(per, 1).sum())]),
            "unmatched": np.array([int((per == 0).sum())]),
            "total": np.array([int(o["o_totalprice"][f][matched].astype(np.int64).sum())])}


class ColumnCache:
    """A connector whose ``table_numpy`` generates each column once: phase
    11's oracles read the same SF1 columns many times."""

    def __init__(self, conn):
        self.conn, self.columns = conn, {}

    def table_numpy(self, table: str, columns) -> dict:
        missing = [c for c in columns if (table, c) not in self.columns]
        if missing:
            for c, a in self.conn.table_numpy(table, missing).items():
                self.columns[(table, c)] = a
        return {c: self.columns[(table, c)] for c in columns}

    def __getattr__(self, name):
        return getattr(self.conn, name)


def expression_runs() -> dict:
    """Phase 11's runs: name -> (connector key, statement, numpy oracle)."""
    from presto_tpu_torch.connectors.ssb.queries import QUERIES as SSB_QUERIES

    tpch = {"q7": q7_expected, "q8": q8_expected, "q12": q12_expected, "q14": q14_expected,
            "q16": q16_expected, "q19": q19_expected}
    runs = {q: ("tpch", QUERIES[q], fn) for q, fn in tpch.items()}
    for q in SSB_JOINS:
        runs[f"ssb {q}"] = ("ssb", SSB_QUERIES[q], lambda conn, q=q: ssb_join_expected(conn, q))
    ad_hoc = {"order_bytes": order_bytes_expected, "group_bytes": group_bytes_expected,
              "null_extended": null_extended_expected}
    for name, fn in ad_hoc.items():
        runs[name] = ("tpch", AD_HOC[name], fn)
    return runs


def planned_routes(session, sql: str) -> dict:
    """The strategy counters a statement's plan predicts: one
    ``join.strategy.<s>`` per join and semi join but a FULL join and a
    membership join the fused leaf step folds (``expand`` counts each
    output capacity its retry ladder tries, so the plan gives its least)
    and one ``agg.strategy.<s>`` per aggregate."""
    from presto_tpu_torch.exec.leaf_route import agg_strategy_for
    from presto_tpu_torch.exec.local_planner import planned_join_strategy
    from presto_tpu_torch.plan import nodes as N

    out: dict = {}
    folded: set = set()

    def walk(node):
        key = None
        if isinstance(node, N.Join) and node.kind == "full":
            pass  # a FULL probe counts no strategy, in either package
        elif isinstance(node, (N.Join, N.SemiJoin)):
            if id(node) not in folded:
                key = "join.strategy." + planned_join_strategy(node, session.catalog)
        elif isinstance(node, N.Aggregate):
            key = "agg.strategy." + agg_strategy_for(node, session.catalog)
            if key == "agg.strategy.fused":
                # the fused leaf step folds a membership join under it:
                # that join probes nothing (its build side still runs)
                member = node.child
                while isinstance(member, N.Filter):
                    member = member.child
                folded.add(id(member))
        if key is not None:
            out[key] = out.get(key, 0) + 1
        for child in node.children:
            walk(child)

    walk(session.plan(sql))
    return out


def run_expression_queries(connectors: dict, device: str = "cuda") -> dict:
    """Phase 11: TPC-H Q7, Q8, Q12, Q14, Q16 and Q19, SSB ``q3_3``-``q4_3``
    and the ``AD_HOC`` statements at SF1 through Session.sql, each equal
    to its numpy oracle and to the strategy counters its plan predicts,
    with the walls of a first and a second run, the device busy time of a
    third (and its five largest device ops) and the launches per kernel;
    ``count(*)`` beside a DISTINCT aggregate must be refused."""
    from presto_tpu_torch.sql.analyzer import AnalysisError

    runs = expression_runs()
    t0 = time.perf_counter()
    cached = {key: ColumnCache(conn) for key, conn in connectors.items()}
    want = {name: fn(cached[key]) for name, (key, _sql, fn) in runs.items()}
    del cached
    log(f"phase 11: numpy recomputation of {len(runs)} statements at SF1 in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  ssb q3_4's oracle holds {len(want['ssb q3_4']['revenue'])} rows at SF1")
    out = {"walls": {}, "launches": {}, "routes": {}}
    original_like = cuda_strings.like_mask

    def capture_like(data, pattern):
        out.setdefault("captured", (data, pattern))  # Q16's first supplier split
        return original_like(data, pattern)

    query = {"name": None}
    # the first exists and payload batch of each shape phase 11 probes
    with each_probe_shape(query) as probes:
        for name, (key, sql, _fn) in runs.items():
            conn = connectors[key]
            session = Session({key: conn}, device=device)
            predicted = planned_routes(session, sql)
            cuda_strings.like_mask = capture_like
            query["name"] = name
            try:
                with expand_capacities() as caps:
                    COUNTERS.clear()
                    _reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = session.sql(sql)
                    torch.cuda.synchronize()
                    first = time.perf_counter() - t0
                    n = _launch_counts()
                    route = dict(COUNTERS)
            finally:
                cuda_strings.like_mask = original_like
                query["name"] = None
            same_result(res, want[name], f"{name} at SF1")
            got = {k: v for k, v in route.items()
                   if k.startswith(("join.strategy.", "agg.strategy.")) and v}
            check(got.get("join.strategy.expand", 0) == len(caps)
                  and len(caps) >= predicted.get("join.strategy.expand", 0)
                  and {k: v for k, v in got.items() if k != "join.strategy.expand"}
                  == {k: v for k, v in predicted.items() if k != "join.strategy.expand"},
                  f"{name}: strategy counters {got}, the plan predicts {predicted} (expansion "
                  f"capacities tried: {caps})")
            check(route.get("exec.pallas_join_route", 0) == got.get("join.strategy.pallas", 0)
                  and route.get("join.pallas_fallback", 0) == 0,
                  f"{name}: fused-probe routes {route}")
            check_vector_probes(name, n)
            splits = len(conn.splits("supplier"))
            check(n["like"] == (splits if name == "q16" else 0)
                  and (name != "q16" or n["like_by_instance"] == {"staged_shift32": splits}),
                  f"{name}: LIKE launches {n['like_by_instance']} ({splits} supplier splits)")
            out["launches"][name] = n
            out["routes"][name] = got
            t0 = time.perf_counter()
            again = session.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            same_result(again, want[name], f"{name} at SF1, second run")
            busy_ms, scan_s, top = wall_breakdown(session, conn, sql)
            out["walls"][name] = (first, second, busy_ms, scan_s)
            log(f"  {name} at SF1: {len(res)} rows equal to numpy; wall first {first:.3f} s, "
                f"second {second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
                f"{got} (planned {predicted}); expansion capacities {caps}")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans {scan_s:.3f} s; the device ops with the most of it (ms, calls): "
                + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in top))
    out["probes"] = probes
    out["probe_err"] = hold_probe_shapes(probes)
    for mode in ("exists", "payload"):
        held = {rows for m, rows, _key in out["probes"] if m == mode}
        ran = {rows for n in out["launches"].values() for rows in n["probe_by_shape"][mode]}
        check(held == ran, f"phase 11's {mode} launches at rows {sorted(ran)}, held to the "
              f"plain version at {sorted(held)}")
    try:
        Session({"tpch": connectors["tpch"]}, device=device).sql(DISTINCT_WITH_COUNT_STAR)
        check(False, "count(*) beside count(DISTINCT ...) was answered")
    except AnalysisError as e:
        check("count_star cannot combine with DISTINCT" in str(e), f"refused as {e}")
    lane_by = {}
    for n in out["launches"].values():
        lane_by = _summed(lane_by, {k.split()[1]: c for k, c in n["by_instance"].items()
                                    if k.startswith("lane_sums ")})
    out["lane_by_instance"] = lane_by
    for k in ("lane_sums", "like"):
        out[f"{k}_launches"] = sum(n[k] for n in out["launches"].values())
    out["like_by_instance"] = _summed(*(n["like_by_instance"] for n in out["launches"].values()))
    out["like_by_shape"] = _summed(*(n["like_by_shape"] for n in out["launches"].values()))
    return out


# ---------------------------------------------------------------------------
# phase 12: scalar subqueries, WITH and the <>-correlated EXISTS
# ---------------------------------------------------------------------------

SUBQUERY_QUERIES = ("q2", "q11", "q15", "q17", "q20", "q21", "q22")

INV_100 = np.float32(1) / np.float32(100)
INV_10 = np.float32(1) / np.float32(10)


def _round_half_away(x: int, f: int) -> int:
    """Integer ``x`` over positive ``f``, rounded half away from zero."""
    q = (abs(x) + f // 2) // f
    return q if x >= 0 else -q


def scalar_round_trip(phys: int, scale: int) -> int:
    """A DECIMAL scalar subquery's value as the plan above reads it: out
    as ``int(value) / 10**scale`` (a float), back as the rounded
    ``float * 10**scale``, as both packages bind it."""
    return int(round(float(int(phys) / 10**scale) * 10**scale))


def _sums_by(keys: np.ndarray, values: np.ndarray) -> tuple:
    """(sorted distinct keys, int64 sums of ``values`` by key)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(uniq.size, np.int64)
    np.add.at(sums, inv, values.astype(np.int64))
    return uniq, sums


def _rows_by_key(keys: np.ndarray) -> np.ndarray:
    """``out[k]``: the row holding key ``k``."""
    return _by_key(keys, np.arange(len(keys)))


def _nation_keys(conn, name: str) -> np.ndarray:
    n = conn.table_numpy("nation", ["n_nationkey", "n_name"])
    return n["n_nationkey"][n["n_name"] == conn.dictionaries("nation")["n_name"].code_of(name)]


def q2_expected(conn) -> dict:
    """TPC-H Q2 (``tpch_oracle.py`` q2): the size-15 BRASS parts' European
    suppliers whose supply cost is the least among European suppliers of
    that part, by account balance descending, then nation, supplier and
    part; the first 100."""
    r = conn.table_numpy("region", ["r_regionkey", "r_name"])
    europe = r["r_regionkey"][r["r_name"] == conn.dictionaries("region")["r_name"]
                              .code_of("EUROPE")]
    n = conn.table_numpy("nation", ["n_nationkey", "n_name", "n_regionkey"])
    in_europe = _by_key(n["n_nationkey"], np.isin(n["n_regionkey"], europe))
    nation_name = _by_key(n["n_nationkey"], n["n_name"].astype(np.int64))
    scols = ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal",
             "s_comment"]
    s = conn.table_numpy("supplier", scols)
    ps = conn.table_numpy("partsupp", ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    srow = _rows_by_key(s["s_suppkey"])[ps["ps_suppkey"]]
    eu = in_europe[s["s_nationkey"][srow]]
    cost = ps["ps_supplycost"].astype(np.int64)
    least = np.full(int(ps["ps_partkey"].max()) + 1, np.iinfo(np.int64).max)
    np.minimum.at(least, ps["ps_partkey"][eu], cost[eu])
    d = conn.dictionaries("part")
    brass = np.array([t.endswith("BRASS") for t in d["p_type"].values], bool)
    p = conn.table_numpy("part", ["p_partkey", "p_mfgr", "p_type", "p_size"])
    part_ok = _by_key(p["p_partkey"], (p["p_size"] == 15) & brass[p["p_type"]])
    keep = eu & part_ok[ps["ps_partkey"]] & (cost == least[ps["ps_partkey"]])
    row, part = srow[keep], ps["ps_partkey"][keep]
    names = conn.dictionaries("nation")["n_name"].values
    nname = np.array([str(v) for v in names[nation_name[s["s_nationkey"][row]]]])
    sname = np.array(_text(s["s_name"][row]))
    acct = s["s_acctbal"][row].astype(np.int64)
    top = np.lexsort((part, sname, nname, -acct))[:100]
    prow = _rows_by_key(p["p_partkey"])[part[top]]
    row = row[top]
    return {"s_acctbal": acct[top], "s_name": list(sname[top]), "n_name": list(nname[top]),
            "p_partkey": part[top], "p_mfgr": _text(p["p_mfgr"][prow]),
            "s_address": _text(s["s_address"][row]), "s_phone": _text(s["s_phone"][row]),
            "s_comment": _text(s["s_comment"][row])}


def q11_expected(conn) -> dict:
    """TPC-H Q11: the value of each part's German stock, where it exceeds
    0.0001 of the whole (the scalar subquery's decimal(38,4) value, round
    trip included; compared at scale 4), largest first."""
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey"])
    german = s["s_suppkey"][np.isin(s["s_nationkey"], _nation_keys(conn, "GERMANY"))]
    ps = conn.table_numpy("partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty",
                                       "ps_supplycost"])
    m = np.isin(ps["ps_suppkey"], german)
    value = ps["ps_supplycost"][m].astype(np.int64) * ps["ps_availqty"][m].astype(np.int64)
    keys, sums = _sums_by(ps["ps_partkey"][m], value)
    # sum(...) * 0.0001: scale 2 x scale 4, narrowed to scale 4
    threshold = scalar_round_trip(_round_half_away(int(value.sum()), 100), 4)
    keep = sums * 100 > threshold
    keys, sums = keys[keep], sums[keep]
    top = np.lexsort((keys, -sums))
    return {"ps_partkey": keys[top], "value": sums[top]}


def q15_revenue(conn) -> tuple:
    """Q15's ``revenue`` view: (suppliers, scale-4 revenue of each)."""
    li = conn.table_numpy("lineitem", ["l_suppkey", "l_extendedprice", "l_discount",
                                       "l_shipdate"])
    ship = li["l_shipdate"]
    m = (ship >= days("1996-01-01")) & (ship < days("1996-04-01"))
    return _sums_by(li["l_suppkey"][m], _volume(li, m))


def q15_expected(conn) -> dict:
    """TPC-H Q15: the supplier(s) whose revenue in 1996's first quarter
    equals the largest (through the scalar round trip); never empty."""
    supp, rev = q15_revenue(conn)
    top = rev.max()
    check(scalar_round_trip(int(top), 4) == int(top),
          f"Q15 oracle: the largest revenue {top} does not survive the scalar round trip")
    win = rev == top
    s = conn.table_numpy("supplier", ["s_suppkey", "s_name", "s_address", "s_phone"])
    row = _rows_by_key(s["s_suppkey"])[supp[win]]
    return {"s_suppkey": supp[win], "s_name": _text(s["s_name"][row]),
            "s_address": _text(s["s_address"][row]), "s_phone": _text(s["s_phone"][row]),
            "total_revenue": rev[win]}


def q17_expected(conn) -> dict:
    """TPC-H Q17: the yearly revenue lost on small orders of Brand#23 MED
    BOX parts; the correlated ``0.2 * avg(l_quantity)`` per part and every
    DOUBLE step in float32 as the packages compute them (a decimal is
    float32 times the float32 reciprocal of 10^scale)."""
    d = conn.dictionaries("part")
    p = conn.table_numpy("part", ["p_partkey", "p_brand", "p_container"])
    chosen = p["p_partkey"][(p["p_brand"] == d["p_brand"].code_of("Brand#23"))
                            & (p["p_container"] == d["p_container"].code_of("MED BOX"))]
    li = conn.table_numpy("lineitem", ["l_partkey", "l_quantity", "l_extendedprice"])
    part, qty = li["l_partkey"], li["l_quantity"].astype(np.int64)
    keys, qsum = _sums_by(part, qty)
    count = np.bincount(part, minlength=int(keys.max()) + 1)[keys]
    avg = (qsum.astype(np.float32) * INV_100) / count.astype(np.float32)
    limit = _by_key(keys, (np.float32(2) * INV_10) * avg)
    m = np.isin(part, chosen)
    m[m] = qty[m].astype(np.float32) * INV_100 < limit[part[m]]
    total = np.float32(int(li["l_extendedprice"][m].astype(np.int64).sum())) * INV_100
    return {"avg_yearly": np.array([total / (np.float32(70) * INV_10)], np.float32)}


def q20_expected(conn) -> dict:
    """TPC-H Q20: Canadian suppliers of a forest part whose stock exceeds
    half of the part-supplier's 1994 shipments (scale 3, exact); a pair
    with no shipments drops out (the inner join)."""
    p = conn.table_numpy("part", ["p_partkey", "p_name"])
    forest = p["p_partkey"][np.array([t.startswith("forest") for t in _text(p["p_name"])],
                                     bool)]
    li = conn.table_numpy("lineitem", ["l_partkey", "l_suppkey", "l_quantity", "l_shipdate"])
    ship = li["l_shipdate"]
    m = (ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
    width = int(li["l_suppkey"].max()) + 1
    pairs, qsum = _sums_by(li["l_partkey"][m].astype(np.int64) * width
                           + li["l_suppkey"][m], li["l_quantity"][m])
    ps = conn.table_numpy("partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty"])
    pos, hit = _lookup(pairs, ps["ps_partkey"].astype(np.int64) * width + ps["ps_suppkey"])
    keep = (np.isin(ps["ps_partkey"], forest) & hit
            & (ps["ps_availqty"].astype(np.int64) * 1000 > 5 * qsum[pos]))
    good = np.unique(ps["ps_suppkey"][keep])
    s = conn.table_numpy("supplier", ["s_suppkey", "s_name", "s_address", "s_nationkey"])
    sm = np.isin(s["s_suppkey"], good) & np.isin(s["s_nationkey"], _nation_keys(conn, "CANADA"))
    names = np.array(_text(s["s_name"][sm]))
    order = np.argsort(names, kind="stable")
    return {"s_name": list(names[order]), "s_address": list(np.array(
        _text(s["s_address"][sm]), dtype=object)[order])}


def q21_expected(conn) -> dict:
    """TPC-H Q21 (``tpch_oracle.py`` q21): Saudi suppliers' late lines of
    finished orders where another supplier shipped a line and no other
    supplier's line was late, by the min and max supplier of each order's
    lines and of its late lines (no late line: NOT EXISTS holds)."""
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_suppkey", "l_commitdate",
                                       "l_receiptdate"])
    order, supp = li["l_orderkey"], li["l_suppkey"].astype(np.int64)
    late = li["l_receiptdate"] > li["l_commitdate"]
    size = int(order.max()) + 1
    lo_all, hi_all = np.full(size, 1 << 40), np.full(size, -1)
    np.minimum.at(lo_all, order, supp)
    np.maximum.at(hi_all, order, supp)
    lo_late, hi_late = np.full(size, 1 << 40), np.full(size, -1)
    np.minimum.at(lo_late, order[late], supp[late])
    np.maximum.at(hi_late, order[late], supp[late])
    any_late = hi_late >= 0
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderstatus"])
    finished = _by_key(o["o_orderkey"], o["o_orderstatus"] == conn.dictionaries("orders")
                       ["o_orderstatus"].code_of("F"))
    s = conn.table_numpy("supplier", ["s_suppkey", "s_name", "s_nationkey"])
    saudi = _by_key(s["s_suppkey"], np.isin(s["s_nationkey"], _nation_keys(conn,
                                                                          "SAUDI ARABIA")))
    sel = late & finished[order] & saudi[supp]
    o_, s_ = order[sel], supp[sel]
    other = (lo_all[o_] != s_) | (hi_all[o_] != s_)
    alone = ~any_late[o_] | ((lo_late[o_] == s_) & (hi_late[o_] == s_))
    keys, counts = np.unique(s_[other & alone], return_counts=True)
    names = np.array(_text(s["s_name"][_rows_by_key(s["s_suppkey"])[keys]]))
    top = np.lexsort((names, -counts))[:100]
    return {"s_name": list(names[top]), "numwait": counts[top]}


def q22_expected(conn) -> dict:
    """TPC-H Q22: customers of seven country codes with no orders and a
    balance above the codes' average positive balance (the scalar
    subquery's float32 ``avg``; the balance compared in float32), counted
    and summed by code."""
    c = conn.table_numpy("customer", ["c_custkey", "c_phone", "c_acctbal"])
    code = np.array([bytes(r[:2]).decode("latin1") for r in c["c_phone"]])
    listed = np.isin(code, ["13", "31", "23", "29", "30", "18", "17"])
    bal = c["c_acctbal"].astype(np.int64)
    positive = listed & (bal > 0)
    avg = (np.float32(int(bal[positive].sum())) * INV_100) / np.float32(int(positive.sum()))
    o = conn.table_numpy("orders", ["o_custkey"])
    sel = (listed & (bal.astype(np.float32) * INV_100 > avg)
           & ~np.isin(c["c_custkey"], o["o_custkey"]))
    codes, inv = np.unique(code[sel], return_inverse=True)
    sums = np.zeros(codes.size, np.int64)
    np.add.at(sums, inv, bal[sel])
    return {"cntrycode": list(codes), "numcust": np.bincount(inv, minlength=codes.size),
            "totacctbal": sums}


def subquery_runs() -> dict:
    """Phase 12's runs: query -> (statement, numpy oracle)."""
    oracles = {"q2": q2_expected, "q11": q11_expected, "q15": q15_expected,
               "q17": q17_expected, "q20": q20_expected, "q21": q21_expected,
               "q22": q22_expected}
    return {q: (QUERIES[q], oracles[q]) for q in SUBQUERY_QUERIES}


def run_subquery_queries(conn, device: str = "cuda") -> dict:
    """Phase 12: TPC-H Q2, Q11, Q15, Q17, Q20, Q21 and Q22 at SF1 through
    Session.sql, each equal to its numpy oracle and to the strategy
    counters its plan predicts, with the walls of a first and a second
    run, the device busy time of a third (and its five largest device
    ops) and the launches per kernel; the first exists and payload call
    of each probe shape, and Q20's first LIKE launch, held to their
    plain versions."""
    runs = subquery_runs()
    t0 = time.perf_counter()
    cached = ColumnCache(conn)
    want = {name: fn(cached) for name, (_sql, fn) in runs.items()}
    del cached
    rows = {name: len(next(iter(w.values()))) for name, w in want.items()}
    log(f"phase 12: numpy recomputation of {len(runs)} queries at SF1 in "
        f"{time.perf_counter() - t0:.1f} s; rows {rows}")
    for name, n in rows.items():
        check(n > 0, f"{name}'s oracle answers no row at SF1")
    out = {"walls": {}, "launches": {}, "routes": {}}
    original_like = cuda_strings.like_mask

    def capture_like(data, pattern):
        out.setdefault("captured", (data, pattern))  # Q20's first part split
        return original_like(data, pattern)

    query = {"name": None}
    splits = len(conn.splits("part"))
    with each_probe_shape(query) as probes:
        for name, (sql, _fn) in runs.items():
            session = Session({"tpch": conn}, device=device)
            predicted = planned_routes(session, sql)
            cuda_strings.like_mask = capture_like
            query["name"] = name
            try:
                COUNTERS.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = dict(COUNTERS)
            finally:
                cuda_strings.like_mask = original_like
                query["name"] = None
            same_result(res, want[name], f"{name} at SF1")
            got = {k: v for k, v in route.items()
                   if k.startswith(("join.strategy.", "agg.strategy.")) and v}
            check(got == predicted, f"{name}: strategy counters {got}, the plan predicts "
                  f"{predicted}")
            check(route.get("exec.pallas_join_route", 0) == got.get("join.strategy.pallas", 0)
                  and route.get("join.pallas_fallback", 0) == 0,
                  f"{name}: fused-probe routes {route}")
            check_vector_probes(name, n)
            # Q20's p_name like 'forest%' is a LIKE in both packages (no
            # prefix rewrite): the LIKE kernel once per part split
            check(n["like"] == (splits if name == "q20" else 0) and n["prefix"] == 0,
                  f"{name}: LIKE launches {n['like_by_instance']}, prefix launches "
                  f"{n['prefix']} ({splits} part splits)")
            out["launches"][name] = n
            out["routes"][name] = {**got, **{k: v for k, v in route.items()
                                             if k.startswith("exec.") and v}}
            t0 = time.perf_counter()
            again = session.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            same_result(again, want[name], f"{name} at SF1, second run")
            busy_ms, scan_s, top = wall_breakdown(session, conn, sql)
            out["walls"][name] = (first, second, busy_ms, scan_s)
            log(f"  {name} at SF1: {len(res)} rows equal to numpy; wall first {first:.3f} s, "
                f"second {second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
                f"{out['routes'][name]} (planned {predicted})")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans {scan_s:.3f} s; the device ops with the most of it (ms, calls): "
                + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in top))
    out["probes"] = probes
    out["probe_err"] = hold_probe_shapes(probes)
    for mode in ("exists", "payload"):
        held = {rows for m, rows, _key in probes if m == mode}
        ran = {rows for n in out["launches"].values() for rows in n["probe_by_shape"][mode]}
        check(held == ran, f"phase 12's {mode} launches at rows {sorted(ran)}, held to the "
              f"plain version at {sorted(held)}")
    data, pattern = out["captured"]
    out["like_err"] = _mask_err(cuda_strings.like_mask(data, pattern),
                                cuda_strings.like_mask_plain(data, pattern),
                                f"like_mask {pattern!r} at q20's first part split")
    log(f"  like_mask {pattern!r} at q20's first part split {tuple(data.shape)}: equal to its "
        "plain version")
    lane_by = {}
    for n in out["launches"].values():
        lane_by = _summed(lane_by, {k.split()[1]: c for k, c in n["by_instance"].items()
                                    if k.startswith("lane_sums ")})
    out["lane_by_instance"] = lane_by
    for k in ("lane_sums", "like", "leaf_agg", "q1", "q3", "prefix"):
        out[f"{k}_launches"] = sum(n[k] for n in out["launches"].values())
    out["leaf_by_instance"] = _summed(*({k.split()[1]: c for k, c in n["by_instance"].items()
                                         if k.startswith("leaf_agg ")}
                                        for n in out["launches"].values()))
    out["like_by_instance"] = _summed(*(n["like_by_instance"] for n in out["launches"].values()))
    out["like_by_shape"] = _summed(*(n["like_by_shape"] for n in out["launches"].values()))
    return out


# ---------------------------------------------------------------------------
# phase 13: the join features: BYTES and cross-dictionary keys, the 63-bit
# mix, FULL and RIGHT joins, runtime join filters
# ---------------------------------------------------------------------------

JOIN_FEATURE_SQL = {
    # two dictionaries ('O' and 'F' in both): dict_bytes, then bytes_pack
    "cross_dict": ("select l_linestatus, count(*) as n from lineitem join "
                   "(select distinct o_orderstatus from orders) s on l_linestatus = o_orderstatus "
                   "group by l_linestatus order by l_linestatus"),
    # a 15-byte BYTES key: bytes_hash and a verify pair (a unique build at SF1)
    "wide_bytes": ("select count(*) as n, sum(c) as c from orders join "
                   "(select o_clerk as k, count(*) as c from orders group by o_clerk) s "
                   "on o_clerk = k"),
    # a negative key component: hash63_mix and two verify pairs (expansion)
    "mix": ("select count(*) as n, sum(c_custkey) as sc, sum(s_suppkey) as ss from customer "
            "join supplier on c_nationkey = s_nationkey and c_acctbal = s_acctbal"),
    # FULL OUTER on both build kinds: orders (expansion) and customer (unique)
    "full": ("select count(*) as n, count(o_orderkey) as no, count(c_custkey) as nc "
             "from customer full join orders on c_custkey = o_custkey"),
    "full_swapped": ("select count(*) as n, count(o_orderkey) as no, count(c_custkey) as nc "
                     "from orders full join customer on c_custkey = o_custkey"),
    # RIGHT: planned as the LEFT join with its sides swapped
    "right_q13": QUERIES["q13"].replace("from customer left outer join orders",
                                        "from orders right outer join customer"),
    "right_nation": ("select n_name, r_name from region right join nation "
                     "on r_regionkey = n_nationkey order by n_name"),
    # the runtime join filters (and Q3 with them off)
    "q3": QUERIES["q3"],
    "q10": QUERIES["q10"],
    "q3 filters off": QUERIES["q3"],
}

#: the statements run once more, for their filter counters alone
FILTER_COUNT_ONLY = ("q9", "q21")

#: planned dense joins that run the sorted probe at SF1, in both packages:
#: the executor's dense cap, max(2^20, 16 x build rows) slots, refuses Q10's
#: lineitem-orders table (about 57,000 orders over a 6M-key domain), which
#: the stats-only plan does not see (ROADMAP A5's route helper)
RUNS_SORTED = {"q10": 1}


def np_filter_keep(build: np.ndarray, keys: np.ndarray, nbits: int) -> np.ndarray:
    """The runtime join filter's test of ``keys``, in numpy: inside the
    live build keys' [min, max] and passing their two-hash Bloom test of
    ``nbits`` bits."""
    if build.size == 0:
        return np.zeros(keys.shape, np.bool_)
    k = keys.astype(np.int64)
    return ((k >= int(build.min())) & (k <= int(build.max()))
            & np_bloom_member(build, keys, nbits))


def plan_filter_bits(session, sql: str):
    """The Bloom bits of the runtime join filter of ``sql``'s plan (the
    executor's sizing from the build's estimated rows), or None when the
    plan has none or the session turns them off. A plan with more than
    one filter is not what the oracles here describe."""
    from presto_tpu_torch.plan.joinfilters import filter_edges

    edges = filter_edges(session.plan(sql))
    if not edges or not session.prop("runtime_join_filters"):
        return None
    check(len(edges) == 1, f"{len(edges)} runtime filters in one plan")
    return session.executor()._filter_bits(edges[0][0].right)


def filter_counts(probe: np.ndarray, build: np.ndarray, nbits) -> dict:
    """``join.filter_rows_in`` and ``join.filter_rows_pruned`` of a probe
    scan whose every row is live, pruned by a filter of ``build``."""
    if nbits is None:
        return {}
    pruned = int((~np_filter_keep(build, probe, nbits)).sum())
    return {"join.filter_rows_in": int(probe.size), "join.filter_rows_pruned": pruned}


def cross_dict_expected(conn) -> dict:
    """lineitem rows whose line status is an order status, by status."""
    li = conn.table_numpy("lineitem", ["l_linestatus"])["l_linestatus"]
    o = conn.table_numpy("orders", ["o_orderstatus"])["o_orderstatus"]
    lvals = conn.dictionaries("lineitem")["l_linestatus"].values
    ovals = set(conn.dictionaries("orders")["o_orderstatus"].values[np.unique(o)].tolist())
    codes, n = np.unique(li, return_counts=True)
    keep = np.array([lvals[c] in ovals for c in codes], np.bool_)
    return {"l_linestatus": list(lvals[codes[keep]]), "n": n[keep].astype(np.int64)}


def wide_bytes_expected(conn) -> dict:
    """Every order joins its clerk's group: the orders, and the sum over
    orders of their clerk's order count."""
    clerks = _text(conn.table_numpy("orders", ["o_clerk"])["o_clerk"])
    _, inv, per = np.unique(np.array(clerks, dtype=object), return_inverse=True,
                            return_counts=True)
    return {"n": np.array([len(clerks)], np.int64),
            "c": np.array([int(per[inv].astype(np.int64).sum())], np.int64)}


def mix_expected(conn) -> dict:
    """Pairs of a customer and a supplier of one nation and one account
    balance: their count and the sums of their keys."""
    c = conn.table_numpy("customer", ["c_custkey", "c_nationkey", "c_acctbal"])
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey", "s_acctbal"])

    def groups(keys, nation, bal):
        """(group keys, rows, summed ``keys``) by (nation, balance)."""
        k = nation.astype(np.int64) * (1 << 32) + (bal.astype(np.int64) + (1 << 31))
        u, inv = np.unique(k, return_inverse=True)
        sums = np.zeros(len(u), np.int64)
        np.add.at(sums, inv, keys.astype(np.int64))
        return u, np.bincount(inv, minlength=len(u)), sums

    cu, cn, cs = groups(c["c_custkey"], c["c_nationkey"], c["c_acctbal"])
    su, sn, ss = groups(s["s_suppkey"], s["s_nationkey"], s["s_acctbal"])
    _common, ci, si = np.intersect1d(cu, su, return_indices=True)
    n = int((cn[ci] * sn[si]).sum())
    # a sum over no pair is NULL
    return {"n": np.array([n], np.int64),
            "sc": np.array([int((cs[ci] * sn[si]).sum()) if n else None]),
            "ss": np.array([int((ss[si] * cn[ci]).sum()) if n else None])}


def full_expected(conn) -> dict:
    """customer FULL JOIN orders: one row per order (every order has its
    customer) and one per customer without an order."""
    c = conn.table_numpy("customer", ["c_custkey"])["c_custkey"]
    o = conn.table_numpy("orders", ["o_custkey"])["o_custkey"]
    lone = int((~np.isin(c, o)).sum())
    orphans = int((~np.isin(o, c)).sum())
    n = o.size + lone
    return {"n": np.array([n], np.int64), "no": np.array([o.size], np.int64),
            "nc": np.array([n - orphans], np.int64)}


def right_nation_expected(conn) -> dict:
    """Every nation by name, with the region whose key equals its own key
    (NULL past the regions)."""
    n = conn.table_numpy("nation", ["n_nationkey", "n_name"])
    r = conn.table_numpy("region", ["r_regionkey", "r_name"])
    nnames = conn.dictionaries("nation")["n_name"].values
    rnames = conn.dictionaries("region")["r_name"].values
    rname = dict(zip(r["r_regionkey"].tolist(), rnames[r["r_name"]].tolist()))
    rows = sorted((nnames[code], rname.get(int(k))) for k, code in zip(n["n_nationkey"],
                                                                        n["n_name"]))
    return {"n_name": [a for a, _ in rows], "r_name": [b for _, b in rows]}


def join_feature_runs() -> dict:
    """Phase 13's runs: name -> (statement, session properties, numpy oracle)."""
    oracles = {"cross_dict": cross_dict_expected, "wide_bytes": wide_bytes_expected,
               "mix": mix_expected, "full": full_expected, "full_swapped": full_expected,
               "right_q13": q13_expected, "right_nation": right_nation_expected,
               "q3": q3_expected, "q10": q10_expected, "q3 filters off": q3_expected}
    return {name: (sql, {"runtime_join_filters": False} if name == "q3 filters off" else {},
                   oracles[name]) for name, sql in JOIN_FEATURE_SQL.items()}


def expected_filter_counts(conn, name: str, nbits) -> dict:
    """The filter counters a phase-13 statement must show: Q3's and Q10's
    lineitem scans pruned by their orders builds, Q9's and Q21's by their
    supplier builds; none elsewhere."""
    if name in ("q3", "q10"):
        o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate"])
        od = o["o_orderdate"]
        m = (od < days("1995-03-15") if name == "q3"
             else (od >= days("1993-10-01")) & (od < days("1994-01-01")))
        probe = conn.table_numpy("lineitem", ["l_orderkey"])["l_orderkey"]
        return filter_counts(probe, o["o_orderkey"][m], nbits)
    if name in FILTER_COUNT_ONLY:
        probe = conn.table_numpy("lineitem", ["l_suppkey"])["l_suppkey"]
        build = conn.table_numpy("supplier", ["s_suppkey"])["s_suppkey"]
        return filter_counts(probe, build, nbits)
    return {}


def run_join_feature_queries(conn, device: str = "cuda") -> dict:
    """Phase 13 at SF1 through Session.sql: each statement equal to its
    numpy oracle, to the strategy counters its plan predicts and to the
    runtime filter's counters recomputed in numpy (range and Bloom bits),
    with the walls of a first and a second run, the device busy time of a
    third and its five largest device ops, and the launches per kernel;
    Q9 and Q21 once more for their filter counters; every exists and
    payload launch shape held to the plain version."""
    runs = join_feature_runs()
    t0 = time.perf_counter()
    cached = ColumnCache(conn)
    want = {name: fn(cached) for name, (_sql, _props, fn) in runs.items()}
    rows = {name: len(next(iter(w.values()))) for name, w in want.items()}
    log(f"phase 13: numpy recomputation of {len(runs)} statements at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s; rows {rows}")
    out = {"walls": {}, "launches": {}, "routes": {}, "filters": {}}
    query = {"name": None}
    with each_probe_shape(query) as probes:
        for name, (sql, props, _fn) in runs.items():
            session = Session({"tpch": conn}, properties=props, device=device)
            predicted = planned_routes(session, sql)
            if conn.sf == 1 and name in RUNS_SORTED:
                k = RUNS_SORTED[name]
                predicted["join.strategy.dense"] -= k
                predicted["join.strategy.unique"] = predicted.get("join.strategy.unique", 0) + k
            want_filters = expected_filter_counts(cached, name, plan_filter_bits(session, sql))
            query["name"] = name
            try:
                COUNTERS.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = dict(COUNTERS)
            finally:
                query["name"] = None
            same_result(res, want[name], f"{name} at SF{conn.sf:g}")
            got = {k: v for k, v in route.items()
                   if k.startswith(("join.strategy.", "agg.strategy.")) and v}
            check(got == predicted, f"{name}: strategy counters {got}, the plan predicts "
                  f"{predicted}")
            filters = {k: v for k, v in route.items() if k.startswith("join.filter_rows_")}
            check(filters == want_filters, f"{name}: filter counters {filters}, numpy "
                  f"{want_filters}")
            check(route.get("exec.pallas_join_route", 0) == got.get("join.strategy.pallas", 0),
                  f"{name}: fused-probe routes {route}")
            check_vector_probes(name, n)
            out["launches"][name] = n
            out["routes"][name] = {**got, **{k: v for k, v in route.items()
                                             if k.startswith("exec.") and v}}
            out["filters"][name] = filters
            t0 = time.perf_counter()
            again = session.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            same_result(again, want[name], f"{name} at SF{conn.sf:g}, second run")
            busy_ms, scan_s, top = wall_breakdown(session, conn, sql)
            out["walls"][name] = (first, second, busy_ms, scan_s)
            log(f"  {name}: {len(res)} rows equal to numpy; wall first {first:.3f} s, second "
                f"{second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
                f"{out['routes'][name]} (planned {predicted}); filters {filters}")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans {scan_s:.3f} s; the device ops with the most of it (ms, "
                "calls): " + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in top))
    check(out["filters"]["q3 filters off"] == {}
          and out["filters"]["q3"]["join.filter_rows_pruned"] > 0,
          "q3: the runtime filter pruned nothing, or pruned with the filters off")
    for name in FILTER_COUNT_ONLY:
        session = Session({"tpch": conn}, device=device)
        sql = QUERIES[name]
        want_filters = expected_filter_counts(cached, name, plan_filter_bits(session, sql))
        COUNTERS.clear()
        session.sql(sql)
        filters = {k: v for k, v in COUNTERS.items() if k.startswith("join.filter_rows_")}
        check(filters == want_filters, f"{name}: filter counters {filters}, numpy "
              f"{want_filters}")
        out["filters"][name] = filters
        log(f"  {name}: filter counters {filters}, equal to numpy")
    del cached
    out["probes"] = probes
    out["probe_err"] = hold_probe_shapes(probes)
    for mode in ("exists", "payload"):
        held = {rows for m, rows, _key in probes if m == mode}
        ran = {rows for n in out["launches"].values() for rows in n["probe_by_shape"][mode]}
        check(held == ran, f"phase 13's {mode} launches at rows {sorted(ran)}, held to the "
              f"plain version at {sorted(held)}")
    check(all(n["sketch"] == 0 for n in out["launches"].values()),
          "phase 13 launched the sketch kernel")
    return out


# ---------------------------------------------------------------------------
# phase 14: the first half of the SQL surface: LIMIT, SELECT without FROM,
# set operations, the scalar function library, casts, stddev / variance
# ---------------------------------------------------------------------------

SURFACE_SQL = {
    # plain LIMIT: the first rows in split order (the scan runs to its end)
    "limit_lineitem": "select l_orderkey, l_linenumber, l_quantity from lineitem limit 10",
    "limit_orders": ("select count(*) as n, sum(o_totalprice) as s from (select o_totalprice "
                     "from orders where o_totalprice > 300000 limit 1000) t"),
    "values": ("select 1 + 2 as x, 'a' as y, date '1998-12-01' - interval '90' day as d"),
    # 'F' and 'O' in both dictionaries: one side re-encodes into the merge
    "union_dicts": ("select f, count(*) as n from (select l_linestatus as f from lineitem "
                    "where l_shipdate < date '1995-01-01' union all select o_orderstatus as f "
                    "from orders) t group by f order by f"),
    "union_distinct": ("select count(*) as n from (select o_custkey from orders union "
                       "select c_custkey from customer) t"),
    "intersect": ("select count(*) as n from (select c_custkey from customer where "
                  "c_mktsegment = 'BUILDING' intersect select o_custkey from orders) t"),
    "except": ("select count(*) as n from (select c_custkey from customer except "
               "select o_custkey from orders) t"),
    "in_union": ("select count(*) as n from orders where o_orderkey in (select l_orderkey "
                 "from lineitem where l_quantity > 49 union all select l_orderkey from "
                 "lineitem where l_discount = 0.10)"),
    "math": ("select l_returnflag, sum(abs(l_extendedprice - 50000)) as a, stddev(l_quantity) "
             "as s, variance(l_discount) as v, round(avg(l_tax) * 100, 2) as r, "
             "max(mod(l_orderkey, 97)) as m, min(sign(l_quantity - 25)) as g, "
             "sum(power(l_discount, 2)) as p from lineitem group by l_returnflag "
             "order by l_returnflag"),
    # count(c_custkey): count(*) beside a DISTINCT aggregate is refused by
    # both packages
    "bytes_strings": ("select count(c_custkey) as n, sum(length(trim(c_address))) as l, "
                      "count(distinct substr(reverse(c_phone), 1, 4)) as d from customer "
                      "where strpos(c_phone, '-') = 3"),
    "concat_like": ("select count(*) as n from customer where c_name || c_phone like "
                    "'Customer#0000001%-%'"),
    "dict_strings": ("select replace(p_type, 'BRASS', 'B') as r, split_part(p_type, ' ', 2) as sp, "
                     "substring(p_brand, 7, 2) as sb, length(p_container) as lc, "
                     "regexp_like(p_type, '^(LARGE|SMALL) ') as rl, count(*) as n from part "
                     "group by replace(p_type, 'BRASS', 'B'), split_part(p_type, ' ', 2), "
                     "substring(p_brand, 7, 2), length(p_container), "
                     "regexp_like(p_type, '^(LARGE|SMALL) ') order by 1, 2, 3, 4, 5"),
    "dates": ("select extract(quarter from o_orderdate) as q, date_trunc('month', o_orderdate) "
              "as m, count(*) as n, sum(date_diff('day', o_orderdate, l_shipdate)) as dd, "
              "max(date_add('month', 1, o_orderdate)) as da, max(last_day_of_month(o_orderdate)) "
              "as ld, sum(day_of_week(l_shipdate)) as dw from orders, lineitem "
              "where o_orderkey = l_orderkey group by extract(quarter from o_orderdate), "
              "date_trunc('month', o_orderdate) order by 1, 2"),
    # cast(cast(o_orderdate as varchar) as date) is refused by both packages
    # (a BYTES value does not cast to DATE): the string cast is of a literal
    "casts": ("select cast(o_orderkey as varchar) as a, cast(o_orderdate as varchar) as b, "
              "cast(o_totalprice as varchar) as c, cast(o_orderdate as timestamp) as t, "
              "hour(cast(o_orderdate as timestamp)) as h, "
              "date_diff('day', cast('1995-03-15' as date), o_orderdate) as dd "
              "from orders limit 20"),
}

#: the statements whose plans hold a set operation's Aggregate (the sort
#: strategy's fold is where their device time goes)
SET_OPERATIONS = ("union_distinct", "intersect", "except")

#: DOUBLE results against a float64 numpy oracle: the tolerance
#: tests/test_tpch_sql.py holds DOUBLE aggregates to
DOUBLE_TOL = {"rtol": 1e-3, "atol": 0.02}
DOUBLE_COLUMNS = {"math": ("s", "v", "r", "p")}


def _decoded(conn, table: str, column: str) -> np.ndarray:
    """A dictionary VARCHAR column of the whole table as Python strings."""
    codes = conn.table_numpy(table, [column])[column]
    return conn.dictionaries(table)[column].values[codes.astype(np.int64)]


def _counts_by(rows: list) -> dict:
    """{key: count} over hashable ``rows``, keys sorted."""
    out: dict = {}
    for r in rows:
        out[r] = out.get(r, 0) + 1
    return dict(sorted(out.items()))


def limit_lineitem_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_linenumber", "l_quantity"])
    return {k: li[k][:10] for k in ("l_orderkey", "l_linenumber", "l_quantity")}


def limit_orders_expected(conn) -> dict:
    tp = conn.table_numpy("orders", ["o_totalprice"])["o_totalprice"].astype(np.int64)
    first = tp[tp > 300000 * 100][:1000]
    return {"n": [len(first)], "s": [int(first.sum())]}


def values_expected(_conn) -> dict:
    return {"x": [3], "y": ["a"], "d": [days("1998-09-02")]}


def union_dicts_expected(conn) -> dict:
    ship = conn.table_numpy("lineitem", ["l_shipdate"])["l_shipdate"]
    flags = list(_decoded(conn, "lineitem", "l_linestatus")[ship < days("1995-01-01")])
    counts = _counts_by(flags + list(_decoded(conn, "orders", "o_orderstatus")))
    return {"f": list(counts), "n": list(counts.values())}


def union_distinct_expected(conn) -> dict:
    keys = np.concatenate([conn.table_numpy("orders", ["o_custkey"])["o_custkey"],
                           conn.table_numpy("customer", ["c_custkey"])["c_custkey"]])
    return {"n": [len(np.unique(keys))]}


def intersect_expected(conn) -> dict:
    c = conn.table_numpy("customer", ["c_custkey"])["c_custkey"]
    building = c[_decoded(conn, "customer", "c_mktsegment") == "BUILDING"]
    o = conn.table_numpy("orders", ["o_custkey"])["o_custkey"]
    return {"n": [len(np.intersect1d(building, o))]}


def except_expected(conn) -> dict:
    c = conn.table_numpy("customer", ["c_custkey"])["c_custkey"]
    o = conn.table_numpy("orders", ["o_custkey"])["o_custkey"]
    return {"n": [len(np.setdiff1d(c, o))]}


def in_union_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_quantity", "l_discount"])
    build = li["l_orderkey"][(li["l_quantity"] > 4900) | (li["l_discount"] == 10)]
    o = conn.table_numpy("orders", ["o_orderkey"])["o_orderkey"]
    return {"n": [int(np.isin(o, build).sum())]}


def math_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_returnflag", "l_extendedprice", "l_quantity",
                                       "l_discount", "l_tax", "l_orderkey"])
    names = conn.dictionaries("lineitem")["l_returnflag"].values
    out: dict = {k: [] for k in ("l_returnflag", "a", "s", "v", "r", "m", "g", "p")}
    for code in np.unique(li["l_returnflag"]):
        m = li["l_returnflag"] == code
        q = li["l_quantity"][m].astype(np.int64)
        disc = li["l_discount"][m].astype(np.float64) / 100
        out["l_returnflag"].append(names[code])
        out["a"].append(int(np.abs(li["l_extendedprice"][m].astype(np.int64) - 5_000_000).sum()))
        out["s"].append(float(np.std(q / 100, ddof=1)))
        out["v"].append(float(np.var(disc, ddof=1)))
        out["r"].append(round(float(np.mean(li["l_tax"][m] / 100)) * 100, 2))
        out["m"].append(int((li["l_orderkey"][m].astype(np.int64) % 97).max()))
        out["g"].append(int(np.sign(q - 2500).min()))
        out["p"].append(float((disc ** 2).sum()))
    return out


def bytes_strings_expected(conn) -> dict:
    addr = _text(column_rows(conn, "customer", "c_address"))
    phone = _text(column_rows(conn, "customer", "c_phone"))
    keep = [i for i, p in enumerate(phone) if p.find("-") + 1 == 3]
    return {"n": [len(keep)], "l": [sum(len(addr[i].strip(" ")) for i in keep)],
            "d": [len({phone[i][::-1][:4] for i in keep})]}


def concat_like_expected(conn) -> dict:
    rx = re.compile(r"^Customer#0000001.*-.*$", re.S)
    names = _text(column_rows(conn, "customer", "c_name"))
    phones = _text(column_rows(conn, "customer", "c_phone"))
    return {"n": [sum(rx.match(a + b) is not None for a, b in zip(names, phones))]}


def dict_strings_expected(conn) -> dict:
    ptype = _decoded(conn, "part", "p_type")
    brand = _decoded(conn, "part", "p_brand")
    cont = _decoded(conn, "part", "p_container")
    rx = re.compile("^(LARGE|SMALL) ")

    def split2(t):
        parts = t.split(" ")
        return parts[1] if len(parts) >= 2 else ""

    counts = _counts_by([(t.replace("BRASS", "B"), split2(t), b[6:8], len(c),
                          rx.search(t) is not None) for t, b, c in zip(ptype, brand, cont)])
    keys = list(counts)
    return {"r": [k[0] for k in keys], "sp": [k[1] for k in keys], "sb": [k[2] for k in keys],
            "lc": [k[3] for k in keys], "rl": [int(k[4]) for k in keys],
            "n": list(counts.values())}


def _civil(d: np.ndarray):
    """(month start, day of month - 1) of day numbers ``d``, as datetime64."""
    dd = np.datetime64("1970-01-01", "D") + d.astype(np.int64)
    month = dd.astype("datetime64[M]")
    return month, (dd - month.astype("datetime64[D]")).astype(np.int64)


def _day_number(dd) -> np.ndarray:
    return (dd - np.datetime64("1970-01-01", "D")).astype(np.int64)


def dates_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_shipdate"])
    order = np.argsort(o["o_orderkey"])
    pos, found = _lookup(o["o_orderkey"][order], li["l_orderkey"])
    check(bool(found.all()), "dates oracle: a lineitem without its order")
    od = o["o_orderdate"][order][pos].astype(np.int64)
    ship = li["l_shipdate"].astype(np.int64)
    month, dom = _civil(od)
    mstart = _day_number(month.astype("datetime64[D]"))
    nxt = month + 1
    days_in_next = _day_number((nxt + 1).astype("datetime64[D]")) - _day_number(
        nxt.astype("datetime64[D]"))
    added = _day_number(nxt.astype("datetime64[D]")) + np.minimum(dom, days_in_next - 1)
    last = _day_number(nxt.astype("datetime64[D]")) - 1
    quarter = (month.astype(np.int64) % 12) // 3 + 1
    keys = np.stack([quarter, mstart], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.ravel()
    g = len(uniq)

    def reduce(values, op, init):
        acc = np.full(g, init, np.int64)
        op.at(acc, inv, values)
        return [int(v) for v in acc]

    return {"q": [int(v) for v in uniq[:, 0]], "m": [int(v) for v in uniq[:, 1]],
            "n": reduce(np.ones_like(od), np.add, 0),
            "dd": reduce(ship - od, np.add, 0),
            "da": reduce(added, np.maximum, np.iinfo(np.int64).min),
            "ld": reduce(last, np.maximum, np.iinfo(np.int64).min),
            "dw": reduce((ship + 3) % 7 + 1, np.add, 0)}


def casts_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate", "o_totalprice"])
    k = o["o_orderkey"][:20].astype(np.int64)
    od = o["o_orderdate"][:20].astype(np.int64)
    tp = o["o_totalprice"][:20].astype(np.int64)
    return {"a": [str(v) for v in k],
            "b": [str(np.datetime64("1970-01-01", "D") + v) for v in od],
            "c": [f"{'-' if v < 0 else ''}{abs(v) // 100}.{abs(v) % 100:02d}" for v in tp],
            "t": [int(v) * 86_400_000_000 for v in od], "h": [0] * len(od),
            "dd": [int(v) - days("1995-03-15") for v in od]}


def surface_runs() -> dict:
    """Phase 14's runs: name -> (statement, numpy oracle)."""
    return {name: (sql, globals()[f"{name}_expected"]) for name, sql in SURFACE_SQL.items()}


def close_result(res, want: dict, what: str, doubles=()) -> None:
    """``res`` equals ``want`` column by column: exactly, but for the
    ``doubles`` columns, within ``DOUBLE_TOL``."""
    check(res.names == list(want), f"{what}: columns {res.names} != {list(want)}")
    for name, w in want.items():
        got = res.column(name)
        if name in doubles:
            ok = len(got) == len(w) and np.allclose(np.asarray(got, np.float64),
                                                    np.asarray(w, np.float64), **DOUBLE_TOL)
        else:
            ok = len(got) == len(w) and list(got) == list(w)
        check(ok, f"{what}: column {name} differs:\n{list(got)[:5]}\n{list(w)[:5]}")


@contextlib.contextmanager
def first_kernel_calls(query: dict):
    """While in the block, keep the first call of the lane-sums, leaf and
    LIKE kernels' wrappers for each launch shape (the exists and payload
    probes: :func:`each_probe_shape`): ``seen[(kernel, shape)] = {"args":
    ..., "query": query["name"]}``. Yields ``seen``."""
    from presto_tpu_torch.exec import leaf_route

    seen: dict = {}
    targets = {"lane_sums": (cuda_groupby, "fused_lane_sums",
                             lambda a: (a[3].numel(), len(a[0]), len(a[2]), a[4])),
               "leaf_agg": (leaf_route, "agg_step", lambda a: (a[1].capacity,)),
               "like": (cuda_strings, "like_mask", lambda a: (*a[0].shape, a[1]))}
    originals = {k: getattr(mod, attr) for k, (mod, attr, _s) in targets.items()}

    def wrap(kernel, shape):
        def call(*args):
            seen.setdefault((kernel, shape(args)), {"args": args, "query": query["name"]})
            return originals[kernel](*args)
        return call

    for k, (mod, attr, shape) in targets.items():
        setattr(mod, attr, wrap(k, shape))
    try:
        yield seen
    finally:
        for k, (mod, attr, _s) in targets.items():
            setattr(mod, attr, originals[k])


def hold_kernel_calls(seen: dict) -> dict:
    """Each call :func:`first_kernel_calls` kept, launched again and held
    to its plain version. Returns the largest difference per kernel."""
    err = {"lane_sums": 0, "leaf_agg": 0, "like": 0}
    for (kernel, shape), t in sorted(seen.items(), key=lambda kv: str(kv[0])):
        a = t["args"]
        what = f"{kernel} at {t['query']}'s first {shape} call"
        if kernel == "lane_sums":
            d = compare(lane_dict(cuda_groupby.fused_lane_sums(*a)),
                        lane_dict(cuda_groupby.fused_lane_sums_plain(*a)), what)
        elif kernel == "leaf_agg":
            d = compare(cuda_agg.agg_step(*a), cuda_agg.agg_step_plain(*a), what)
        else:
            d = _mask_err(cuda_strings.like_mask(*a), cuda_strings.like_mask_plain(*a), what)
        err[kernel] = max(err[kernel], d)
        log(f"  {what}: equal to its plain version")
    return err


def run_surface_queries(conn, device: str = "cuda") -> dict:
    """Phase 14 at SF1 through Session.sql: each statement equal to its
    numpy oracle (DOUBLE columns within ``DOUBLE_TOL``) and to the
    strategy counters its plan predicts, with the walls of a first and a
    second run, the device busy time of a third and its five largest
    device ops, and the launches per kernel; every lane-sums, leaf, LIKE,
    exists and payload launch shape held to the plain version; the share
    of the set operations' device busy time in ``index_add_`` (the sort
    strategy's fold)."""
    runs = surface_runs()
    t0 = time.perf_counter()
    cached = ColumnCache(conn)
    want = {name: fn(cached) for name, (_sql, fn) in runs.items()}
    del cached
    rows = {name: len(next(iter(w.values()))) for name, w in want.items()}
    log(f"phase 14: numpy recomputation of {len(runs)} statements at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s; rows {rows}")
    out = {"walls": {}, "launches": {}, "routes": {}, "index_add_ms": {}}
    query = {"name": None}
    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls:
        for name, (sql, _fn) in runs.items():
            session = Session({"tpch": conn}, device=device)
            predicted = planned_routes(session, sql)
            query["name"] = name
            try:
                COUNTERS.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = dict(COUNTERS)
            finally:
                query["name"] = None
            doubles = DOUBLE_COLUMNS.get(name, ())
            close_result(res, want[name], f"{name} at SF{conn.sf:g}", doubles)
            got = {k: v for k, v in route.items()
                   if k.startswith(("join.strategy.", "agg.strategy.")) and v}
            check(got == predicted, f"{name}: strategy counters {got}, the plan predicts "
                  f"{predicted}")
            check(route.get("exec.pallas_join_route", 0) == got.get("join.strategy.pallas", 0)
                  and route.get("join.pallas_fallback", 0) == 0,
                  f"{name}: fused-probe routes {route}")
            check_vector_probes(name, n)
            out["launches"][name] = n
            out["routes"][name] = {**got, **{k: v for k, v in route.items()
                                             if k.startswith("exec.") and v}}
            t0 = time.perf_counter()
            again = session.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            close_result(again, want[name], f"{name} at SF{conn.sf:g}, second run", doubles)
            busy_ms, scan_s, ops = device_ops(session, conn, sql)
            out["walls"][name] = (first, second, busy_ms, scan_s)
            # index_add_'s CUDA kernel is indexFuncLargeIndex (or SmallIndex)
            out["index_add_ms"][name] = sum(ms for k, ms, _c in ops if "indexFunc" in k)
            log(f"  {name}: {len(res)} rows equal to numpy; wall first {first:.3f} s, second "
                f"{second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
                f"{out['routes'][name]} (planned {predicted})")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms "
                f"({out['index_add_ms'][name]:.2f} in index_add_), connector scans "
                f"{scan_s:.3f} s; the device ops with the most of it (ms, calls): "
                + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in ops[:5]))
    out["probes"] = probes
    out["probe_err"] = hold_probe_shapes(probes)
    out["calls"] = calls
    out["call_err"] = hold_kernel_calls(calls)
    for mode in ("exists", "payload"):
        held = {rows for m, rows, _key in probes if m == mode}
        ran = {rows for n in out["launches"].values() for rows in n["probe_by_shape"][mode]}
        check(held == ran, f"phase 14's {mode} launches at rows {sorted(ran)}, held to the "
              f"plain version at {sorted(held)}")
    for kernel in ("lane_sums", "leaf_agg", "like"):
        ran = sum(n[kernel] for n in out["launches"].values())
        held = [shape for k, shape in calls if k == kernel]
        check((ran > 0) == bool(held), f"phase 14's {kernel}: {ran} launches, shapes held "
              f"{held}")
    check(all(n["sketch"] == 0 and n["q1"] == 0 and n["q3"] == 0 and n["prefix"] == 0
              for n in out["launches"].values()),
          "phase 14 launched a kernel its plans do not route to")
    busy = sum(w[2] for w in out["walls"].values())
    set_busy = sum(out["walls"][k][2] for k in SET_OPERATIONS)
    set_fold = sum(out["index_add_ms"][k] for k in SET_OPERATIONS)
    out["set_fold"] = (set_fold, set_busy, busy)
    log(f"  phase 14's device busy time {busy:.1f} ms; the set operations' "
        f"({', '.join(SET_OPERATIONS)}) {set_busy:.1f} ms, of which index_add_ (the sort "
        f"strategy's fold) {set_fold:.2f} ms = {100 * set_fold / max(busy, 1e-9):.1f} % of "
        "the phase")
    for k in ("lane_sums", "like", "leaf_agg", "exists", "payload"):
        out[f"{k}_launches"] = sum(n[k] for n in out["launches"].values())
    return out


# ---------------------------------------------------------------------------
# phase 15: window functions and GROUPING SETS / ROLLUP / CUBE
# ---------------------------------------------------------------------------

_RUN = "rows between unbounded preceding and current row"
_BY_ORDER = "partition by l_orderkey order by l_linenumber"

WINDOW_SQL = {
    "rank_supplier": ("select s_suppkey, s_nationkey, rank() over (partition by s_nationkey "
                      "order by s_acctbal desc) as r from supplier order by s_suppkey"),
    # the three largest orders of every customer: 1.5M rows in one sort
    "topn_orders": ("select count(*) as n, sum(o_totalprice) as s, sum(rn) as r from (select "
                    "o_totalprice, row_number() over (partition by o_custkey order by "
                    "o_totalprice desc, o_orderkey) as rn from orders) t where rn <= 3"),
    "running_rows": ("select count(*) as n, sum(run) as s, max(run) as m from (select "
                     "sum(o_totalprice) over (partition by o_custkey order by o_orderdate, "
                     f"o_orderkey {_RUN}) as run from orders) t"),
    # the default RANGE frame: about 125 peers on each (priority, date)
    "range_peers": ("select count(*) as n, sum(c) as sc, sum(mn) as smn from (select count(*) "
                    "over (partition by o_orderpriority order by o_orderdate) as c, "
                    "min(o_totalprice) over (partition by o_orderpriority order by "
                    "o_orderdate) as mn from orders) t"),
    # 6M lineitem rows in one Window
    "lag_lead_first": ("select count(*) as n, count(p) as cp, sum(p) as sp, sum(q) as sq, "
                       "sum(f) as sf from (select "
                       f"lag(l_extendedprice) over ({_BY_ORDER}) as p, "
                       f"lead(l_quantity, 2) over ({_BY_ORDER}) as q, "
                       f"first_value(l_discount) over ({_BY_ORDER}) as f from lineitem) t"),
    # float32 running sums that must not cross partitions: each
    # supplier's sums are integers below 2^24, so its maximum is exact
    "double_running": ("select max(s) as m, count(*) as n from (select "
                       "sum(cast(l_quantity as double)) over (partition by l_suppkey order by "
                       f"l_orderkey, l_linenumber {_RUN}) as s from lineitem) t"),
    "window_over_group": ("select l_returnflag, l_linestatus, sum(l_quantity) as s, rank() "
                          "over (order by sum(l_quantity) desc) as r from lineitem "
                          "group by l_returnflag, l_linestatus"),
    "avg_sum_over": ("select n_name, extract(year from o_orderdate) as y, sum(o_totalprice) "
                     "as s, avg(sum(o_totalprice)) over (partition by n_name) as a, "
                     "lag(sum(o_totalprice)) over (partition by n_name order by "
                     "extract(year from o_orderdate)) as p from orders, customer, nation "
                     "where o_custkey = c_custkey and c_nationkey = n_nationkey "
                     "group by n_name, extract(year from o_orderdate) order by n_name, y"),
    "cum_sum_sum": ("select o_orderdate, sum(sum(o_totalprice)) over (order by o_orderdate "
                    f"{_RUN}) as c from orders group by o_orderdate order by o_orderdate"),
    # max over a dictionary VARCHAR (ordered codes)
    "max_dict_wide": ("select mx, count(*) as n from (select max(c_mktsegment) over "
                      "(partition by c_nationkey) as mx from customer) t group by mx "
                      "order by mx"),
    # wide BYTES partition and order keys (18 and 15 bytes: 7-byte chunks)
    "max_dict_wide_bytes": ("select s_suppkey, count(*) over (partition by s_name) as c, "
                            "rank() over (order by s_phone) as r from supplier "
                            "order by s_suppkey"),
    "rollup": ("select l_returnflag, l_linestatus, sum(l_quantity) as s, count(*) as c, "
               "grouping(l_linestatus) as g from lineitem group by rollup(l_returnflag, "
               "l_linestatus) order by l_returnflag nulls last, l_linestatus nulls last"),
    "cube": ("select l_returnflag, l_linestatus, count(*) as c, avg(l_discount) as a "
             "from lineitem group by cube(l_returnflag, l_linestatus) "
             "order by l_returnflag nulls last, l_linestatus nulls last"),
    # the second key's column is named _col1 (the first set lacks it)
    "grouping_sets": ("select o_orderpriority, o_orderstatus, count(*) as c, "
                      "sum(o_totalprice) as s from orders group by grouping sets "
                      "((o_orderpriority), (o_orderstatus), ()) order by 1 nulls last, "
                      "2 nulls last"),
    # windows over the union of the sets (the q36 / q70 shape)
    "rollup_rank": ("select l_returnflag, l_linestatus, sum(l_extendedprice) as s, rank() over "
                    "(partition by grouping(l_returnflag) + grouping(l_linestatus), case when "
                    "grouping(l_linestatus) = 0 then l_returnflag end order by "
                    "sum(l_extendedprice) desc) as r from lineitem group by "
                    "rollup(l_returnflag, l_linestatus) order by l_returnflag nulls last, "
                    "l_linestatus nulls last"),
}

#: the statements whose Window's device time phase 15 reports apart
WINDOW_SHARE = ("topn_orders", "lag_lead_first")
#: phase 15's statements over grouping sets (the others are windows alone)
GROUPING_SET_RUNS = ("rollup", "cube", "grouping_sets", "rollup_rank")
WINDOW_DOUBLES = {"avg_sum_over": ("a",), "cube": ("a",)}


def _starts(part: np.ndarray) -> np.ndarray:
    """Per row of rows sorted by ``part``: the index of its partition's
    first row."""
    n = len(part)
    first = np.ones(n, bool)
    first[1:] = part[1:] != part[:-1]
    return np.maximum.accumulate(np.where(first, np.arange(n), 0))


def _run_sums(part: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Running int64 sums of ``vals`` restarting at each partition
    (rows sorted by ``part``)."""
    cs = np.cumsum(vals.astype(np.int64))
    st = _starts(part)
    return cs - cs[st] + vals.astype(np.int64)[st]


def _small_groups(codes: list, values: list) -> tuple:
    """Groups of small non-negative integer code columns, by counting
    (``np.unique`` over rows is too slow at SF1): (each group's codes, one
    array a column, in lexicographic order; the row counts; the int64 sum
    of each of ``values`` a group, exact below 2^53)."""
    sizes = [int(c.max()) + 1 for c in codes]
    key = np.zeros(len(codes[0]), np.int64)
    for c, size in zip(codes, sizes):
        key = key * size + c.astype(np.int64)
    total = int(np.prod(sizes))
    counts = np.bincount(key, minlength=total)
    present = np.flatnonzero(counts)
    sums = [np.rint(np.bincount(key, weights=v.astype(np.float64), minlength=total)[present])
            .astype(np.int64) for v in values]
    out, rest = [], present
    for size in reversed(sizes):
        out.append(rest % size)
        rest = rest // size
    return out[::-1], counts[present], sums


def _rank_desc(part: np.ndarray, key: np.ndarray) -> np.ndarray:
    """rank() over (partition by part order by key desc): 1 + the rows of
    the partition with a larger key (tie-invariant)."""
    out = np.zeros(len(key), np.int64)
    for p in np.unique(part):
        m = part == p
        k = np.sort(key[m])
        out[m] = 1 + len(k) - np.searchsorted(k, key[m], side="right")
    return out


def rank_supplier_expected(conn) -> dict:
    s = conn.table_numpy("supplier", ["s_suppkey", "s_nationkey", "s_acctbal"])
    order = np.argsort(s["s_suppkey"], kind="stable")
    r = _rank_desc(s["s_nationkey"], s["s_acctbal"].astype(np.int64))
    return {"s_suppkey": s["s_suppkey"][order], "s_nationkey": s["s_nationkey"][order],
            "r": r[order]}


def topn_orders_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_totalprice"])
    tp = o["o_totalprice"].astype(np.int64)
    order = np.lexsort((o["o_orderkey"], -tp, o["o_custkey"]))
    rn = np.arange(len(order)) - _starts(o["o_custkey"][order]) + 1
    keep = rn <= 3
    return {"n": [int(keep.sum())], "s": [int(tp[order][keep].sum())],
            "r": [int(rn[keep].sum())]}


def running_rows_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate"])
    order = np.lexsort((o["o_orderkey"], o["o_orderdate"], o["o_custkey"]))
    run = _run_sums(o["o_custkey"][order], o["o_totalprice"][order])
    return {"n": [len(run)], "s": [int(run.sum())], "m": [int(run.max())]}


def range_peers_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_orderpriority", "o_orderdate", "o_totalprice"])
    sc = smn = 0
    for p in np.unique(o["o_orderpriority"]):
        m = o["o_orderpriority"] == p
        d, tp = o["o_orderdate"][m], o["o_totalprice"][m].astype(np.int64)
        order = np.argsort(d, kind="stable")
        ds = d[order]
        last = np.searchsorted(ds, d, side="right")  # rows up to each row's last peer
        sc += int(last.sum())
        smn += int(np.minimum.accumulate(tp[order])[last - 1].sum())
    return {"n": [len(o["o_orderdate"])], "sc": [sc], "smn": [smn]}


def lag_lead_first_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_linenumber", "l_extendedprice",
                                       "l_quantity", "l_discount"])
    order = np.lexsort((li["l_linenumber"], li["l_orderkey"]))
    k = li["l_orderkey"][order]
    ep = li["l_extendedprice"][order].astype(np.int64)
    q = li["l_quantity"][order].astype(np.int64)
    disc = li["l_discount"][order].astype(np.int64)
    has_prev = np.zeros(len(k), bool)
    has_prev[1:] = k[1:] == k[:-1]
    has_next2 = np.zeros(len(k), bool)
    has_next2[:-2] = k[2:] == k[:-2]
    return {"n": [len(k)], "cp": [int(has_prev.sum())],
            "sp": [int(ep[np.flatnonzero(has_prev) - 1].sum())],
            "sq": [int(q[np.flatnonzero(has_next2) + 2].sum())],
            "sf": [int(disc[_starts(k)].sum())]}


def double_running_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_suppkey", "l_quantity"])
    _keys, totals = _sums_by(li["l_suppkey"], li["l_quantity"].astype(np.int64))
    return {"m": [float(np.max(totals) // 100)], "n": [len(li["l_suppkey"])]}


def window_over_group_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_returnflag", "l_linestatus", "l_quantity"])
    d = conn.dictionaries("lineitem")
    (f, st), _counts, (sums,) = _small_groups([li["l_returnflag"], li["l_linestatus"]],
                                              [li["l_quantity"]])
    order = np.argsort(-sums, kind="stable")
    return {"l_returnflag": list(d["l_returnflag"].values[f[order]]),
            "l_linestatus": list(d["l_linestatus"].values[st[order]]),
            "s": sums[order], "r": _rank_desc(np.zeros(len(sums)), sums)[order]}


def avg_sum_over_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_custkey", "o_totalprice", "o_orderdate"])
    c = conn.table_numpy("customer", ["c_custkey", "c_nationkey"])
    nation = _by_key(c["c_custkey"], c["c_nationkey"])[o["o_custkey"]]
    names = conn.dictionaries("nation")["n_name"].values[_nation_names(conn)[nation]]
    uniq, name_codes = np.unique(names, return_inverse=True)
    years = year_of(o["o_orderdate"])
    (name_ix, y), _counts, (s,) = _small_groups([name_codes.ravel(), years - years.min()],
                                                [o["o_totalprice"]])
    y = y + years.min()
    out: dict = {"n_name": [], "y": [], "s": [], "a": [], "p": []}
    for i in range(len(s)):  # groups come in (name, year) order, the ORDER BY's
        same = name_ix == name_ix[i]
        out["n_name"].append(uniq[name_ix[i]])
        out["y"].append(int(y[i]))
        out["s"].append(int(s[i]))
        out["a"].append(float(s[same].mean()) / 100)
        out["p"].append(int(s[i - 1]) if i > 0 and name_ix[i - 1] == name_ix[i] else None)
    return out


def cum_sum_sum_expected(conn) -> dict:
    o = conn.table_numpy("orders", ["o_totalprice", "o_orderdate"])
    dates, sums = _sums_by(o["o_orderdate"], o["o_totalprice"])
    return {"o_orderdate": dates, "c": np.cumsum(sums)}


def max_dict_wide_expected(conn) -> dict:
    c = conn.table_numpy("customer", ["c_nationkey", "c_mktsegment"])
    nk, seg = c["c_nationkey"], c["c_mktsegment"].astype(np.int64)
    top = np.zeros(int(nk.max()) + 1, np.int64)
    np.maximum.at(top, nk, seg)
    counts = _counts_by(conn.dictionaries("customer")["c_mktsegment"].values[top[nk]].tolist())
    return {"mx": list(counts), "n": list(counts.values())}


def max_dict_wide_bytes_expected(conn) -> dict:
    s = conn.table_numpy("supplier", ["s_suppkey"])["s_suppkey"]
    names = _text(column_rows(conn, "supplier", "s_name"))
    phones = np.array(_text(column_rows(conn, "supplier", "s_phone")), dtype=object)
    same = _counts_by(names)
    ranked = np.sort(phones)
    order = np.argsort(s, kind="stable")
    return {"s_suppkey": s[order], "c": [same[names[i]] for i in order],
            "r": (1 + np.searchsorted(ranked, phones, side="left"))[order]}


def _nulls_last(rows: list) -> list:
    """Rows sorted by their first two values, NULLs (None) last."""
    return sorted(rows, key=lambda r: (r[0] is None, r[0] or "", r[1] is None, r[1] or ""))


def _grouping_rows(conn, table: str, keys: list, values: list, sets) -> list:
    """One row per group of every grouping set over ``table``'s dictionary
    VARCHAR ``keys``: (the set's key strings with None for the keys it
    lacks, the row count, the int64 sum of each of ``values``)."""
    cols = conn.table_numpy(table, keys + values)
    dicts = conn.dictionaries(table)
    n = len(cols[keys[0]])
    rows = []
    for gs in sets:
        if not gs:
            rows.append((*[None] * len(keys), n,
                         *[int(cols[v].astype(np.int64).sum()) for v in values]))
            continue
        groups, counts, sums = _small_groups([cols[k] for k in gs], [cols[v] for v in values])
        for g in range(len(counts)):
            key = [dicts[k].values[groups[gs.index(k)][g]] if k in gs else None for k in keys]
            rows.append((*key, int(counts[g]), *[int(s_[g]) for s_ in sums]))
    return rows


def _rollup_sets(a: str, b: str) -> list:
    return [(a, b), (a,), ()]


def rollup_expected(conn) -> dict:
    rows = _nulls_last(_grouping_rows(conn, "lineitem", ["l_returnflag", "l_linestatus"],
                                      ["l_quantity"], _rollup_sets("l_returnflag",
                                                                   "l_linestatus")))
    return {"l_returnflag": [r[0] for r in rows], "l_linestatus": [r[1] for r in rows],
            "s": [r[3] for r in rows], "c": [r[2] for r in rows],
            "g": [int(r[1] is None) for r in rows]}


def cube_expected(conn) -> dict:
    sets = [("l_returnflag", "l_linestatus"), ("l_returnflag",), ("l_linestatus",), ()]
    rows = _nulls_last(_grouping_rows(conn, "lineitem", ["l_returnflag", "l_linestatus"],
                                      ["l_discount"], sets))
    return {"l_returnflag": [r[0] for r in rows], "l_linestatus": [r[1] for r in rows],
            "c": [r[2] for r in rows], "a": [r[3] / r[2] / 100 for r in rows]}


def grouping_sets_expected(conn) -> dict:
    sets = [("o_orderpriority",), ("o_orderstatus",), ()]
    rows = _nulls_last(_grouping_rows(conn, "orders", ["o_orderpriority", "o_orderstatus"],
                                      ["o_totalprice"], sets))
    return {"o_orderpriority": [r[0] for r in rows], "_col1": [r[1] for r in rows],
            "c": [r[2] for r in rows], "s": [r[3] for r in rows]}


def rollup_rank_expected(conn) -> dict:
    rows = _grouping_rows(conn, "lineitem", ["l_returnflag", "l_linestatus"],
                          ["l_extendedprice"], _rollup_sets("l_returnflag", "l_linestatus"))
    # partition: (grouping level, the flag where the status is grouped)
    part = np.array([f"{(r[0] is None) + (r[1] is None)} {r[0] if r[1] is not None else ''}"
                     for r in rows], dtype=object)
    ranks = _rank_desc(part, np.array([r[3] for r in rows], np.int64))
    rows = _nulls_last([(*r, int(k)) for r, k in zip(rows, ranks)])
    return {"l_returnflag": [r[0] for r in rows], "l_linestatus": [r[1] for r in rows],
            "s": [r[3] for r in rows], "r": [r[4] for r in rows]}


def window_runs() -> dict:
    """Phase 15's runs: name -> (statement, numpy oracle)."""
    return {name: (sql, globals()[f"{name}_expected"]) for name, sql in WINDOW_SQL.items()}


def window_device_ms(session, sql: str) -> tuple:
    """(kernel ms, device span ms, CUDA-event ms) of the Window operators
    in one more run of ``sql``: each ``WindowOperator.finish`` runs in a
    ``record_function`` span; the profiler sums the device time of the
    kernels launched inside it (its host-side event) and traces the span
    on the device (its device-side event), and two CUDA events after a
    synchronize bracket it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from presto_tpu_torch.exec.operators import WindowOperator

    original = WindowOperator.finish
    spans: list = []

    def timed(op):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with record_function("window_operator"):
            out = original(op)
        end.record()
        spans.append((start, end))
        return out

    WindowOperator.finish = timed
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            session.sql(sql)
            torch.cuda.synchronize()
    finally:
        WindowOperator.finish = original
    marks = [e for e in prof.events() if e.name == "window_operator"]
    kernels = sum(e.device_time_total for e in marks if e.device_type == DeviceType.CPU)
    span = sum(e.time_range.elapsed_us() for e in marks if e.device_type != DeviceType.CPU)
    return kernels / 1e3, span / 1e3, sum(s.elapsed_time(e) for s, e in spans)


def run_window_queries(conn, device: str = "cuda") -> dict:
    """Phase 15 at SF1 through Session.sql: each window and grouping-set
    statement equal to its numpy oracle (DOUBLE columns within
    ``DOUBLE_TOL``) and to the strategy counters its plan predicts, with
    the walls of a first and a second run, the device busy time of a
    third and its five largest device ops, and the launches per kernel;
    the first lane-sums, leaf, LIKE, exists and payload call of each
    launch shape held to the plain version; the Window operators' device
    time in ``WINDOW_SHARE``'s statements."""
    runs = window_runs()
    t0 = time.perf_counter()
    cached = ColumnCache(conn)
    want = {name: fn(cached) for name, (_sql, fn) in runs.items()}
    del cached
    rows = {name: len(next(iter(w.values()))) for name, w in want.items()}
    log(f"phase 15: numpy recomputation of {len(runs)} statements at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s; rows {rows}")
    out = {"walls": {}, "launches": {}, "routes": {}, "window_ms": {}}
    query = {"name": None}
    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls:
        for name, (sql, _fn) in runs.items():
            session = Session({"tpch": conn}, device=device)
            predicted = planned_routes(session, sql)
            query["name"] = name
            try:
                COUNTERS.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = dict(COUNTERS)
            finally:
                query["name"] = None
            doubles = WINDOW_DOUBLES.get(name, ())
            close_result(res, want[name], f"{name} at SF{conn.sf:g}", doubles)
            got = {k: v for k, v in route.items()
                   if k.startswith(("join.strategy.", "agg.strategy.")) and v}
            check(got == predicted, f"{name}: strategy counters {got}, the plan predicts "
                  f"{predicted}")
            check(route.get("exec.pallas_join_route", 0) == got.get("join.strategy.pallas", 0)
                  and route.get("join.pallas_fallback", 0) == 0,
                  f"{name}: fused-probe routes {route}")
            check_vector_probes(name, n)
            out["launches"][name] = n
            out["routes"][name] = {**got, **{k: v for k, v in route.items()
                                             if k.startswith("exec.") and v}}
            t0 = time.perf_counter()
            again = session.sql(sql)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
            close_result(again, want[name], f"{name} at SF{conn.sf:g}, second run", doubles)
            busy_ms, scan_s, ops = device_ops(session, conn, sql)
            out["walls"][name] = (first, second, busy_ms, scan_s)
            log(f"  {name}: {len(res)} rows equal to numpy; wall first {first:.3f} s, second "
                f"{second:.3f} s; launches { {k: v for k, v in n.items() if v} }; routes "
                f"{out['routes'][name]} (planned {predicted})")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans {scan_s:.3f} s; the device ops with the most of it (ms, "
                "calls): " + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in ops[:5]))
            if name in WINDOW_SHARE:
                kernels, span, evented = window_device_ms(session, sql)
                out["window_ms"][name] = (kernels, span, evented, busy_ms)
                log(f"  {name}: the Window operator's kernels {kernels:.1f} ms of the "
                    f"{busy_ms:.1f} ms busy ({100 * kernels / max(busy_ms, 1e-9):.1f} %); its "
                    f"span on the device {span:.1f} ms, {evented:.1f} ms between events")
    out["probes"] = probes
    out["probe_err"] = hold_probe_shapes(probes)
    out["calls"] = calls
    out["call_err"] = hold_kernel_calls(calls)
    for mode in ("exists", "payload"):
        held = {rows for m, rows, _key in probes if m == mode}
        ran = {rows for n in out["launches"].values() for rows in n["probe_by_shape"][mode]}
        check(held == ran, f"phase 15's {mode} launches at rows {sorted(ran)}, held to the "
              f"plain version at {sorted(held)}")
    for kernel in ("lane_sums", "leaf_agg", "like"):
        ran = sum(n[kernel] for n in out["launches"].values())
        held = [shape for k, shape in calls if k == kernel]
        check((ran > 0) == bool(held), f"phase 15's {kernel}: {ran} launches, shapes held "
              f"{held}")
    check(all(n["sketch"] == 0 and n["q1"] == 0 and n["q3"] == 0 and n["prefix"] == 0
              for n in out["launches"].values()),
          "phase 15 launched a kernel its plans do not route to")
    busy = sum(w[2] for w in out["walls"].values())
    log(f"  phase 15's device busy time {busy:.1f} ms")
    for k in ("lane_sums", "like", "leaf_agg", "exists", "payload"):
        out[f"{k}_launches"] = sum(n[k] for n in out["launches"].values())
    return out


# ---------------------------------------------------------------------------
# phase 9: semi and anti joins, the approximate sketch, the Q3 join step
# ---------------------------------------------------------------------------

SEMI_SQL = {
    "semi": ("select count(*) c from lineitem where l_orderkey in "
             "(select o_orderkey from orders where o_orderdate < date '1995-03-15')"),
    "anti": ("select count(*) c from lineitem where l_orderkey not in "
             "(select o_orderkey from orders where o_orderdate >= date '1998-01-01')"),
    "semi_anti_part": ("select p_partkey, p_size from part where p_partkey in "
                       "(select ps_partkey from partsupp where ps_availqty < 100) "
                       "and p_partkey not in (select l_partkey from lineitem "
                       "where l_quantity >= 50) order by p_partkey"),
}


def np_mix32(x: np.ndarray) -> np.ndarray:
    """The murmur3 finalizer on uint32 (numpy wraps uint32 products)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def np_bloom_member(build: np.ndarray, keys: np.ndarray,
                    nbits: int = cuda_join.SKETCH_BITS) -> np.ndarray:
    """The two-hash Bloom test of ``keys`` against the set ``build``,
    recomputed in numpy: each key's low 32 bits, mixed with and without
    the seed, two bits of an nbits bitmap; a key passes when both are
    set (every build key does; others may)."""
    mask = np.uint32(nbits - 1)

    def slots(k):
        u = (k.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
        return np_mix32(u) & mask, np_mix32(u ^ np.uint32(0x9E3779B9)) & mask

    bits = np.zeros(nbits, np.bool_)
    for s_ in slots(build):
        bits[s_] = True
    s1, s2 = slots(keys)
    return bits[s1] & bits[s2]


def q4_expected(conn, bloom: bool = False, filter_bits=None) -> dict:
    """TPC-H Q4 recomputed in numpy: orders of the quarter from
    1993-07-01 with a lineitem committed before its receipt, counted by
    priority in key order; with ``bloom`` the membership test is the
    sketch's (``np_bloom_member``) instead of the exact one, and with
    ``filter_bits`` also the runtime join filter's, which prunes some of
    the sketch's false positives at the scan (``np_filter_keep``)."""
    lo, hi = days("1993-07-01"), days("1993-10-01")
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate", "o_orderpriority"])
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_commitdate", "l_receiptdate"])
    build = li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]
    member = (np_bloom_member(build, o["o_orderkey"]) if bloom
              else np.isin(o["o_orderkey"], build))
    if bloom and filter_bits is not None:
        member &= np_filter_keep(build, o["o_orderkey"], filter_bits)
    m = (o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi) & member
    prio = conn.dictionaries("orders")["o_orderpriority"].values
    n = np.bincount(o["o_orderpriority"][m].astype(np.int64), minlength=len(prio))
    g = np.flatnonzero(n)
    return {"o_orderpriority": list(prio[g]), "order_count": n[g].astype(np.int64)}


def semi_expected(conn, name: str, bloom: bool = False, filter_bits=None) -> dict:
    """The ``semi``, ``anti`` and ``semi_anti_part`` statements recomputed
    in numpy (``bloom``: the semi join's sketch membership, and with
    ``filter_bits`` the runtime join filter's test too)."""
    if name == "semi_anti_part":
        p = conn.table_numpy("part", ["p_partkey", "p_size"])
        ps = conn.table_numpy("partsupp", ["ps_partkey", "ps_availqty"])
        li = conn.table_numpy("lineitem", ["l_partkey", "l_quantity"])
        m = (np.isin(p["p_partkey"], ps["ps_partkey"][ps["ps_availqty"] < 100])
             & ~np.isin(p["p_partkey"], li["l_partkey"][li["l_quantity"] >= 5000]))
        order = np.argsort(p["p_partkey"][m], kind="stable")
        return {"p_partkey": p["p_partkey"][m][order], "p_size": p["p_size"][m][order]}
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    keys = conn.table_numpy("lineitem", ["l_orderkey"])["l_orderkey"]
    if name == "semi":
        build = o["o_orderkey"][o["o_orderdate"] < days("1995-03-15")]
        m = np_bloom_member(build, keys) if bloom else np.isin(keys, build)
        if bloom and filter_bits is not None:
            m &= np_filter_keep(build, keys, filter_bits)
    else:
        m = ~np.isin(keys, o["o_orderkey"][o["o_orderdate"] >= days("1998-01-01")])
    return {"c": np.array([int(m.sum())], np.int64)}


def q3_join_expected(conn, cutoff: int = Q3_CUTOFF) -> tuple:
    """The benchmark's Q3 join oracle in int64 numpy: lineitem rows
    shipped after ``cutoff`` whose order was placed before it, counted,
    and their revenue sum ep * (100 - disc) at scale 4."""
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    li = conn.table_numpy("lineitem", Q3_COLS)
    m = (li["l_shipdate"] > cutoff) & np.isin(li["l_orderkey"],
                                              o["o_orderkey"][o["o_orderdate"] < cutoff])
    rev = li["l_extendedprice"][m].astype(np.int64) * (100 - li["l_discount"][m].astype(np.int64))
    return int(m.sum()), int(rev.sum())


def device_batch(arrays, phys, cols, factor: int = 1) -> Batch:
    """``cols`` of ``arrays`` on the card in their physical (narrow)
    types, tiled ``factor`` times, every row live."""
    live = torch.ones(len(arrays[cols[0]]) * factor, dtype=torch.bool, device="cuda")
    return Batch({c: Column(torch.from_numpy(arrays[c].astype(phys[c].np_dtype)).cuda()
                            .repeat(factor), live, phys[c]) for c in cols}, live)


# each statement of the SF1 runs: (name, SQL, approx_join, the kernels it
# must launch once per split of the named table, the kernels it must not
# launch)
SEMI_RUNS = [
    ("q4", QUERIES["q4"], False, {"lane_sums": "orders"}, ("sketch", "exists")),
    ("q4 approx", QUERIES["q4"], True, {"sketch": "orders", "lane_sums": "orders"}, ("exists",)),
    ("semi", SEMI_SQL["semi"], False, {}, ("sketch", "exists")),
    ("semi approx", SEMI_SQL["semi"], True, {"sketch": "lineitem"}, ("exists",)),
    ("anti", SEMI_SQL["anti"], False, {}, ("sketch", "exists")),
    ("anti approx", SEMI_SQL["anti"], True, {}, ("sketch", "exists")),
    ("semi_anti_part", SEMI_SQL["semi_anti_part"], False, {"exists": "part"}, ("sketch",)),
]


def run_semi_queries(sf: float = 1, device: str = "cuda") -> dict:
    """Phase 9: Q4, ``semi``, ``anti`` and ``semi_anti_part`` at SF1
    through Session.sql (exact and under ``approx_join``), Q4 at sf 0.01
    on the leaf route, then the resident Q3 join step at SF1 and SF1 x10.
    Returns the launch counts, walls and the kernels' inputs (for the
    timings)."""
    conn = TpchConnector(sf=sf, device=device)
    small = TpchConnector(sf=0.01, device=device)
    t0 = time.perf_counter()
    # the runtime join filter (on by default) prunes some of the sketch's
    # false positives at the probe scan: the approximate oracles test its
    # range and Bloom bits too
    bits = {name: plan_filter_bits(Session({"tpch": conn}, device=device), sql)
            for name, sql in (("q4", QUERIES["q4"]), ("semi", SEMI_SQL["semi"]))}
    want = {"q4": q4_expected(conn),
            "q4 approx": q4_expected(conn, bloom=True, filter_bits=bits["q4"]),
            "semi": semi_expected(conn, "semi"),
            "semi approx": semi_expected(conn, "semi", bloom=True, filter_bits=bits["semi"]),
            "anti": semi_expected(conn, "anti"), "anti approx": semi_expected(conn, "anti"),
            "semi_anti_part": semi_expected(conn, "semi_anti_part"),
            "q4 sf0.01 leaf": q4_expected(small)}
    log(f"phase 9: numpy recomputation (exact and Bloom) of Q4, semi, anti and "
        f"semi_anti_part at SF{sf:g} in {time.perf_counter() - t0:.1f} s")
    for g, e in zip(want["q4 approx"]["order_count"], want["q4"]["order_count"]):
        check(g >= e, "the Bloom oracle of Q4 counts fewer orders than the exact one")
    check(want["semi approx"]["c"][0] >= want["semi"]["c"][0],
          "the Bloom oracle of semi counts fewer rows than the exact one")
    captured = {}
    original_lane = cuda_groupby.fused_lane_sums
    # the probe batches phase 5 times: the first of each run's (route,
    # join kind)
    probes = {"q4 approx": ("sketch", None), "semi approx": ("sketch", None),
              "semi_anti_part": ("exists", True)}

    def capture_lane(*args):
        captured.setdefault("lane", args)  # Q4's first orders split
        return original_lane(*args)

    runs = [(n, q, a, k, no, conn) for n, q, a, k, no in SEMI_RUNS]
    runs.append(("q4 sf0.01 leaf", QUERIES["q4"], False, {"leaf_agg": "orders"},
                 ("sketch", "exists", "lane_sums"), small))
    out = {"walls": {}, "launches": {}, "sketch_launches": 0, "exists_launches": 0}
    for name, sql, approx, kernels, idle, c in runs:
        session = Session({"tpch": c}, properties={"approx_join": approx}, device=device)
        if name == "q4":
            cuda_groupby.fused_lane_sums = capture_lane
        try:
            with (first_probe(*probes[name]) if name in probes
                  else contextlib.nullcontext({})) as seen:
                COUNTERS.clear()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = dict(COUNTERS)
        finally:
            cuda_groupby.fused_lane_sums = original_lane
        if name in probes:
            captured[name] = seen
        check(all(k.split()[1].startswith("staged") for k in n["by_instance"]),
              f"{name}: launches by instance {n['by_instance']}")
        check_vector_probes(name, n)
        same_result(res, want[name], f"{name} at SF{c.sf:g}")
        check(res.approximate == (name in ("q4 approx", "semi approx")),
              f"{name}: QueryResult.approximate is {res.approximate}")
        for kernel, table in kernels.items():
            k = len(c.splits(table))
            if name == "semi_anti_part" and kernel == "exists":
                k *= 2  # its semi join and its anti join each probe every split
            check(n[kernel] == k, f"{name}: {n[kernel]} {kernel} launches for {k} "
                  f"{table} split probes")
        for kernel in idle:
            check(n[kernel] == 0, f"{name}: {n[kernel]} {kernel} launches, expected none")
        check(route.get("join.pallas_fallback", 0) == 0,
              f"{name}: {route.get('join.pallas_fallback')} fused-probe fallbacks")
        if name.startswith("q4") and c is conn:
            check(route.get("exec.leaf_route_fallback.membership", 0) == 1,
                  f"{name}: the leaf route did not decline the 6M-key membership fold")
            check(route.get("join.strategy.pallas" if approx else "join.strategy.dense", 0) == 1,
                  f"{name}: join routes {route}")
        if name == "q4 sf0.01 leaf":
            check(route.get("exec.leaf_fused_route", 0) == 1, f"{name}: routes {route}")
        if name == "semi_anti_part":
            check(route.get("exec.pallas_join_route", 0) == 2, f"{name}: routes {route}")
        if name == "q4 approx":
            plan = session.explain(sql)
            check("strategy=sketch(approx)" in plan, f"q4 approx: EXPLAIN says\n{plan}")
            for g, e in zip(res.column("order_count"), want["q4"]["order_count"]):
                check(g >= e, "q4 approx: a group counts fewer orders than the exact Q4")
        out["sketch_launches"] += n["sketch"]
        if name == "semi_anti_part":
            out["exists_launches"] = n["exists"]
        out["launches"][name] = n
        t0 = time.perf_counter()
        again = session.sql(sql)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        same_result(again, want[name], f"{name} at SF{c.sf:g}, second run")
        busy_ms, scan_s, _ = wall_breakdown(session, c, sql)
        out["walls"][name] = (first, second, busy_ms, scan_s)
        log(f"  {name}: {len(res)} rows equal to numpy{' (Bloom)' if approx else ''}, "
            f"approximate={res.approximate}; wall first {first:.3f} s, second {second:.3f} s; "
            f"launches { {k: v for k, v in n.items() if v} }; routes "
            f"{ {k: v for k, v in route.items() if k.startswith(('exec.', 'agg.', 'join.'))} }")
        log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
            f"connector scans (host generation + copy to the card) {scan_s:.3f} s")
    out["captured"] = captured

    # the resident Q3 join step
    t0 = time.perf_counter()
    n_want, rev_want = q3_join_expected(conn)
    o = conn.table_numpy("orders", ["o_orderkey", "o_orderdate"])
    li = conn.table_numpy("lineitem", Q3_COLS)
    orders = device_batch(o, conn.physical_schema("orders", ["o_orderkey", "o_orderdate"]),
                          ["o_orderkey", "o_orderdate"])
    lphys = conn.physical_schema("lineitem", Q3_COLS)
    domain = q3_domain(sf)
    table = q3_probe_table(orders, Q3_CUTOFF, domain)
    batches = {1: device_batch(li, lphys, Q3_COLS), FACTOR: device_batch(li, lphys, Q3_COLS,
                                                                        FACTOR)}
    torch.cuda.synchronize()
    log(f"  Q3 join step: oracle, {table.numel()} bitmask words over [1, {domain}] and "
        f"the resident batches in {time.perf_counter() - t0:.1f} s")
    _reset_launches()
    got = {f: q3_probe_step(table, Q3_KEY_MIN, domain, Q3_CUTOFF, b) for f, b in batches.items()}
    torch.cuda.synchronize()
    out["q3_launches"] = cuda_join.q3_launches
    check(out["q3_launches"] == len(batches), f"Q3 join step: {out['q3_launches']} launches")
    q3_err = 0
    for f, (cnt, rev) in got.items():
        check(cnt.dtype == torch.int64 and rev.dtype == torch.int64,
              "Q3 join step: results must be int64")
        check(int(cnt) == f * n_want and int(rev) == f * rev_want,
              f"Q3 join step x{f}: ({int(cnt)}, {int(rev)}) != {f} x ({n_want}, {rev_want})")
        b = batches[f]
        plain = cuda_join.q3_probe_step_plain(table, Q3_KEY_MIN, domain, Q3_CUTOFF,
                                              *[b[c].data for c in Q3_COLS], b.live)
        q3_err = max(q3_err, abs(int(cnt) - int(plain[0])), abs(int(rev) - int(plain[1])))
        check(q3_err == 0, f"Q3 join step x{f}: differs from its plain version")
        log(f"  Q3 join step over SF1 x{f} lineitem ({b.capacity} rows): {int(cnt)} matches, "
            f"revenue {int(rev)} = {f} x the benchmark's oracle, equal to plain")
    out["q3"] = {"table": table, "domain": domain, "batches": batches, "err": q3_err}
    return out


def time_q3(q3: dict, factor: int, flush) -> dict:
    """Phase 5 numbers of the Q3 kernel over the SF1 x ``factor`` batch:
    its bound counts each row's 4 columns and live byte once, the bitmask
    once, and 12 integer operations a row."""
    table, domain, b = q3["table"], q3["domain"], q3["batches"][factor]
    cols = [b[c].data for c in Q3_COLS]
    fn = lambda: cuda_join.q3_probe_step(table, Q3_KEY_MIN, domain, Q3_CUTOFF, *cols, b.live)  # noqa: E731
    plain = lambda: cuda_join.q3_probe_step_plain(  # noqa: E731
        table, Q3_KEY_MIN, domain, Q3_CUTOFF, *cols, b.live)
    n = b.capacity
    nbytes = sum(c.numel() * c.element_size() for c in cols) + n + table.numel() * 4 + 16
    return {"ms": device_ms(fn, 20, flush, kernel="q3_kernel"), "call_ms": call_ms(fn, 20),
            "plain_ms": device_ms(plain, 3, flush), "rows": n, "bytes": nbytes, "ops": 12 * n,
            "row_bytes": (nbytes - table.numel() * 4) / n}


def kernel_name(mangled: str) -> str:
    """``lane_sums_kernel<4,5,1>`` for the mangled name of a kernel
    function (its integer and bool template arguments in order)."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end(): m.end() + int(m.group())]
        if name.endswith("_kernel"):
            rest = mangled[m.end() + len(name):]
            t = re.match(r"I((?:L[a-z]n?\d+E)+)E", rest)
            args = re.findall(r"L[a-z](n?)(\d+)E", t.group(1)) if t else []
            return name + (f"<{','.join(('-' if neg else '') + d for neg, d in args)}>"
                           if args else "")
    return mangled


def log_ptxas(name: str, text: str) -> None:
    """Registers, shared memory and spills of each kernel function in
    ``nvcc -Xptxas -v`` output, one line each."""
    fn = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            log(f"  {name} {fn}: {line.split('info    :')[-1].strip()}")


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

    marks: list = []

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    # ---- phase 1: build ---------------------------------------------------
    mark("1 build")
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.sources():
        check(_build.library_path(name).exists(), f"kernel {name} was not built")
    log(f"phase 1: built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        log_ptxas(name, out)

    # ---- phase 2: kernels vs plain ----------------------------------------
    mark("2 kernels")
    rng = np.random.default_rng(20261016)
    log("phase 2: kernels against their plain versions (exact)")
    q1_err = check_q1_kernel(rng)
    lane_err = check_lane_kernel(rng)
    exists_err = check_exists_kernel(rng)
    payload_err = check_payload_kernel(rng)
    sketch_err = check_sketch_kernel(rng)
    keep_err = check_probe_keep_kernels(rng)
    q3_kernel_err = check_q3_kernel(rng)
    leaf_err = check_leaf_agg_kernel(rng)
    from presto_tpu_torch.connectors.ssb import SsbConnector

    string_conns = {"tpch": TpchConnector(sf=1, device="cuda"),
                    "ssb": SsbConnector(sf=1, device="cuda")}
    like_err, prefix_err, sf1_strings = check_string_kernels(string_conns)

    # ---- phase 3: resident Q1 at SF1 x10 ----------------------------------
    mark("3 resident Q1")
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
    mark("4 Q1 pipeline")
    cuda_q1.launches = 0
    cuda_groupby.reset_launches()
    t0 = time.perf_counter()
    pipe = q1_pipeline(TpchConnector(sf=1, device="cuda"))
    out = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane_launches = cuda_groupby.launches
    lane_by_instance = {k: v for k, v in cuda_groupby.launches_by_instance.items() if v}
    check(lane_launches > 0, "the Q1 pipeline never launched the lane-sums kernel")
    check(lane_by_instance == {"staged_k4m5": lane_launches},
          f"the Q1 pipeline's lane-sums launches by instance: {lane_by_instance}")
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
        f"lane-sums kernel launches {lane_launches}, by instance {lane_by_instance}")

    # ---- phase 5: kernel times at the main path's shapes ------------------
    mark("5 and 6 joins")
    flush = torch.empty(1 << 27, dtype=torch.int8, device="cuda")  # 128 MB > L2
    q1_bytes = sum(batch[c].data.numel() * batch[c].data.element_size()
                   for c in Q1_COLS) + n + (6 * 6 + 1) * 8
    contributing = int((batch["l_shipdate"].data <= CUTOFF).sum())
    q1_ops = 2 * n + 14 * contributing  # filter; gid, dp, charge, guard, 6 adds
    q1_ms = device_ms(lambda: cuda_q1.q1_step(batch), 20, kernel="q1_kernel")
    q1_call_ms = call_ms(lambda: cuda_q1.q1_step(batch), 20)
    q1_plain_ms = device_ms(lambda: cuda_q1.q1_step_plain(batch), 3)

    lane_args = q1_lane_inputs(conn, pipe.source.capacity)
    ln = time_lane(lane_args, flush)
    cap = ln["rows"]

    q1_bound, q1_by = bound(q1_bytes, q1_ops)
    lane_bound, lane_by = bound(ln["bytes"], ln["ops"])
    log(f"phase 5 (kernel device ms; call = wrapper, events; plain and index_add_ = "
        f"device ms of all their kernels): q1_step {q1_ms:.4f} (call {q1_call_ms:.4f}, "
        f"plain {q1_plain_ms:.4f}, bound {q1_bound:.4f}) at {n} rows; fused_lane_sums "
        f"{ln['ms']:.4f} (call {ln['call_ms']:.4f}, plain {ln['plain_ms']:.4f}, index_add_ "
        f"{ln['library_ms']:.4f}, bound {lane_bound:.4f}) at {cap} rows, "
        f"{len(lane_args[0])} values + {len(lane_args[2])} masks, {ln['instance']} instance")

    join = run_join_queries(flush)
    ex = join["exists"]
    exists_bound, exists_by = bound(ex["bytes"], ex["ops"])
    probe_shapes = {"exists": {"q3 first lineitem split": probe_shape(ex)}, "sketch": {},
                    "payload": {"q10 first lineitem split": probe_shape(join["payload"])}}
    log_probe("exists", "q3 first lineitem split", probe_shapes["exists"])
    log_probe("payload", "q10 first lineitem split", probe_shapes["payload"])
    pay = probe_shapes["payload"]["q10 first lineitem split"]

    mark("7 leaf route")
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
    sm_ = leaf["small"]
    small_bound, _ = bound(sm_["bytes"], sm_["ops"])
    log(f"  agg_step at phase 7's first SSB Q1.1 lineorder split: {sm_['ms']:.4f} (call "
        f"{sm_['call_ms']:.4f}, plain {sm_['plain_ms']:.4f}, index_add_ "
        f"{sm_['library_ms']:.4f}, bound {small_bound:.4f}) at {sm_['rows']} rows, column "
        f"widths {sm_['widths']} B + live, {sm_['instance']} instance; leaf-kernel launches "
        f"by split capacity {leaf['by_shape']}")
    for name, (first, second, busy, scan) in leaf["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")

    mark("8 strings")
    strings = run_string_queries(string_conns)
    ln_phone = time_lane(strings["captured"]["lane"], flush)
    phone_bound, _ = bound(ln_phone["bytes"], ln_phone["ops"])
    log(f"phase 5, fused_lane_sums at phase 8's first q_like_phone lineorder split: "
        f"{ln_phone['ms']:.4f} (call {ln_phone['call_ms']:.4f}, plain "
        f"{ln_phone['plain_ms']:.4f}, index_add_ {ln_phone['library_ms']:.4f}, bound "
        f"{phone_bound:.4f}) at {ln_phone['rows']} rows, (values, masks, groups) "
        f"{ln_phone['shape']}, {ln_phone['instance']} instance")
    probe_shapes["exists"]["q9 first lineitem split"] = probe_shape(time_probe(
        "exists", strings["captured"]["exists"], strings["launches"]["q9"]["exists"], flush))
    log_probe("exists", "q9 first lineitem split", probe_shapes["exists"])
    probe_shapes["payload"]["q9 first lineitem split"] = probe_shape(time_probe(
        "payload", strings["captured"]["payload"], strings["launches"]["q9"]["payload"], flush))
    log_probe("payload", "q9 first lineitem split", probe_shapes["payload"])
    # the LIKE kernel at the main path's four shapes: each query's first
    # split of the table it filters, and SF1 o_comment
    like_shapes = {f"{name} first {STRING_QUERIES[name][1]} split": time_like(*args, flush)
                   for name, args in strings["captured"]["like"].items()}
    like_shapes["SF1 o_comment"] = time_like(sf1_strings["TPC-H o_comment"],
                                             "%special%requests%", flush)
    lk = like_shapes["q9 first part split"]
    like_bound, like_by = lk["bound_ms"], lk["bound_by"]
    # the prefix kernel at the pipeline's first part split (the main
    # path) and over SF1 o_comment (how it scales)
    prefix_shapes = {"starts_with first part split": time_prefix(*strings["captured"]["prefix"],
                                                                 flush),
                     "SF1 o_comment": time_prefix(sf1_strings["TPC-H o_comment"],
                                                  COMMENT_PREFIX, flush)}
    px = prefix_shapes["starts_with first part split"]
    prefix_bound, prefix_by = px["bound_ms"], px["bound_by"]
    for label, t in like_shapes.items():
        log(f"phase 5, like_mask {t['pattern']!r} at {label} [{t['rows']}, {t['width']}], "
            f"{t['instance']} instance (kernel device ms; call = wrapper, events; plain = device "
            f"ms of all its kernels; no single PyTorch call computes it): {t['ms']:.4f} (call "
            f"{t['call_ms']:.4f}, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by "
            f"{t['bound_by']})")
    log(f"  LIKE launches on the main path (phase 8): {strings['like_launches']}, by instance "
        f"{strings['like_by_instance']}, by rows x width {strings['like_by_shape']}")
    for label, t in prefix_shapes.items():
        log(f"phase 5, starts_with_mask {t['prefix']!r} at {label} [{t['rows']}, {t['width']}], "
            f"{t['instance']} instance, {t['matches']} "
            f"rows match (kernel device ms; call = wrapper, events; plain = device ms of all "
            f"its kernels; no single PyTorch call computes it): {t['ms']:.4f} (call "
            f"{t['call_ms']:.4f}, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by "
            f"{t['bound_by']}, sector floor {t['sector_floor_ms']:.4f} from {t['sectors']} "
            "sectors)")
    for name, (first, second, busy, scan) in strings["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")

    mark("9 semi")
    semi = run_semi_queries()
    ln_q4 = time_lane(semi["captured"]["lane"], flush)
    q4_bound, _ = bound(ln_q4["bytes"], ln_q4["ops"])
    log(f"phase 5, fused_lane_sums at phase 9's first Q4 orders split: {ln_q4['ms']:.4f} "
        f"(call {ln_q4['call_ms']:.4f}, plain {ln_q4['plain_ms']:.4f}, index_add_ "
        f"{ln_q4['library_ms']:.4f}, bound {q4_bound:.4f}) at {ln_q4['rows']} rows, (values, "
        f"masks, groups) {ln_q4['shape']}, {ln_q4['instance']} instance")
    for kernel, run, label in (("exists", "semi_anti_part", "semi_anti_part anti join first "
                                "part split"),
                               ("sketch", "q4 approx", "q4 approx first orders split"),
                               ("sketch", "semi approx", "semi approx first lineitem split")):
        probe_shapes[kernel][label] = probe_shape(time_probe(
            kernel, semi["captured"][run], semi["launches"][run][kernel], flush))
        log_probe(kernel, label, probe_shapes[kernel])
    sk = probe_shapes["sketch"]["q4 approx first orders split"]
    sketch_bound, sketch_by = sk["bound_ms"], sk["bound_by"]
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"])
    log(f"  exists, sketch and payload launches on the main path (phases 6, 8, 9): {totals}")
    q3_one = time_q3(semi["q3"], 1, flush)
    q3_ten = time_q3(semi["q3"], FACTOR, flush)
    q3_bound, q3_by = bound(q3_one["bytes"], q3_one["ops"])
    q3_ten_bound, _ = bound(q3_ten["bytes"], q3_ten["ops"])
    log(f"phase 5, the Q3 kernel (kernel device ms; call = wrapper, events; plain = device "
        f"ms of all its kernels; no single PyTorch call computes it): "
        f"q3_probe_step over SF1 lineitem ({q3_one['rows']} rows, {q3_one['row_bytes']:.2f} "
        f"B/row) {q3_one['ms']:.4f} (call {q3_one['call_ms']:.4f}, plain "
        f"{q3_one['plain_ms']:.4f}, bound {q3_bound:.4f}); over SF1 x{FACTOR} "
        f"({q3_ten['rows']} rows) {q3_ten['ms']:.4f} (call {q3_ten['call_ms']:.4f}, plain "
        f"{q3_ten['plain_ms']:.4f}, bound {q3_ten_bound:.4f}) = "
        f"{q3_ten['rows'] / (q3_ten['ms'] / 1e3):.4e} rows/s")
    for name, (first, second, busy, scan) in semi["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")

    mark("10 outer")
    outer = run_outer_join_queries()
    for name, (first, second, busy, scan) in outer["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")
    t = like_shapes["q13 first orders split"] = time_like(*outer["captured"], flush)
    log(f"phase 5, like_mask {t['pattern']!r} at q13 first orders split [{t['rows']}, "
        f"{t['width']}], {t['instance']} instance: {t['ms']:.4f} (call {t['call_ms']:.4f}, "
        f"plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']})")
    log(f"  phase 10's LIKE launches {outer['like_launches']}, by instance "
        f"{outer['like_by_instance']}, by rows x width {outer['like_by_shape']}; lane-sums "
        f"launches {outer['lane_launches']}, by instance {outer['lane_by_instance']}")

    # ---- phase 11: conditional expressions, DISTINCT, BYTES keys ---------
    mark("11 expressions")
    expr = run_expression_queries(string_conns)
    for name, (first, second, busy, scan) in expr["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")
    t = like_shapes["q16 first supplier split"] = time_like(*expr["captured"], flush)
    log(f"phase 5, like_mask {t['pattern']!r} at q16 first supplier split [{t['rows']}, "
        f"{t['width']}], {t['instance']} instance: {t['ms']:.4f} (call {t['call_ms']:.4f}, "
        f"plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']})")
    timed = {1 << 20}  # phase 5 times 2^20 at Q10 and Q9; one key type a row count
    for (mode, rows, _key), seen in sorted(expr["probes"].items()):
        if mode != "payload" or rows in timed:
            continue
        timed.add(rows)
        label = f"{seen['query']} first {rows}-row batch"
        probe_shapes["payload"][label] = probe_shape(time_probe(
            "payload", seen, expr["launches"][seen["query"]]["payload"], flush))
        log_probe("payload", label, probe_shapes["payload"])
    p11 = probe_launch_totals(expr["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"])
    log(f"  exists, sketch and payload launches with phases 10 and 11: {totals}; phase 11's "
        f"alone: {p11}")
    log(f"  phase 11's LIKE launches {expr['like_launches']}, by instance "
        f"{expr['like_by_instance']}, by rows x width {expr['like_by_shape']}; lane-sums "
        f"launches {expr['lane_sums_launches']}, by instance {expr['lane_by_instance']}")
    p11_other = {k: sum(n[k] for n in expr["launches"].values())
                 for k in ("q1", "leaf_agg", "q3", "prefix")}
    log(f"  phase 11's launches of the other kernels: {p11_other}")

    # ---- phase 12: scalar subqueries, WITH, the <>-correlated EXISTS ------
    mark("12 subqueries")
    sub = run_subquery_queries(string_conns["tpch"])
    for name, (first, second, busy, scan) in sub["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")
    t = like_shapes["q20 first part split"] = time_like(*sub["captured"], flush)
    log(f"phase 5, like_mask {t['pattern']!r} at q20 first part split [{t['rows']}, "
        f"{t['width']}], {t['instance']} instance: {t['ms']:.4f} (call {t['call_ms']:.4f}, "
        f"plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} by {t['bound_by']})")
    p12 = probe_launch_totals(sub["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"])
    log(f"  exists, sketch and payload launches with phase 12: {totals}; phase 12's alone: "
        f"{p12}")
    p12_other = {k: sub[f"{k}_launches"] for k in ("q1", "lane_sums", "leaf_agg", "q3", "like",
                                                   "prefix")}
    log(f"  phase 12's launches of the other kernels: {p12_other}; lane-sums by instance "
        f"{sub['lane_by_instance']}, leaf by instance {sub['leaf_by_instance']}, LIKE by "
        f"instance {sub['like_by_instance']}, by rows x width {sub['like_by_shape']}")
    # ---- phase 13: the join features ----------------------------------------
    mark("13 join features")
    feat = run_join_feature_queries(string_conns["tpch"])
    for name, (first, second, busy, scan) in feat["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")
    p13 = probe_launch_totals(feat["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"])
    log(f"  exists, sketch and payload launches with phase 13: {totals}; phase 13's alone: "
        f"{p13}")
    p13_other = {k: sum(n[k] for n in feat["launches"].values())
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    p13_like_by_instance = _summed(*(n["like_by_instance"] for n in feat["launches"].values()))
    p13_like_by_shape = _summed(*(n["like_by_shape"] for n in feat["launches"].values()))
    log(f"  phase 13's launches of the other kernels: {p13_other}; LIKE by instance "
        f"{p13_like_by_instance}; filter counters {feat['filters']}")
    # ---- phase 14: LIMIT, VALUES, set operations, the function library ----
    mark("14 surface")
    surf = run_surface_queries(string_conns["tpch"])
    for name, (first, second, busy, scan) in surf["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")
    p14 = probe_launch_totals(surf["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"])
    log(f"  exists, sketch and payload launches with phase 14: {totals}; phase 14's alone: "
        f"{p14}")
    p14_other = {k: sum(n[k] for n in surf["launches"].values())
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    p14_by_instance = _summed(*(n["by_instance"] for n in surf["launches"].values()))
    p14_like_by_instance = _summed(*(n["like_by_instance"] for n in surf["launches"].values()))
    p14_like_by_shape = _summed(*(n["like_by_shape"] for n in surf["launches"].values()))
    log(f"  phase 14's launches of the other kernels: {p14_other}; lane-sums and leaf by "
        f"instance {p14_by_instance}; LIKE by instance {p14_like_by_instance}; shapes held to "
        f"plain: {sorted(str(k) for k in surf['calls'])}")
    # the LIKE kernel at phase 14's concat_like shape (two launches there)
    for (kernel, shape), seen in sorted(surf["calls"].items(), key=lambda kv: str(kv[0])):
        if kernel == "like":
            label = f"{seen['query']} first {shape[0]} x {shape[1]} call"
            t = like_shapes[label] = time_like(*seen["args"], flush)
            log(f"phase 5, like_mask {t['pattern']!r} at {label}, {t['instance']} instance: "
                f"{t['ms']:.4f} (call {t['call_ms']:.4f}, plain {t['plain_ms']:.4f}, bound "
                f"{t['bound_ms']:.4f} by {t['bound_by']})")
    # ---- phase 15: window functions and grouping sets -----------------------
    mark("15 windows")
    win = run_window_queries(string_conns["tpch"])
    for name, (first, second, busy, scan) in win["walls"].items():
        log(f"  wall {name}: first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy:.1f} ms, connector scans {scan:.3f} s")
    p15 = probe_launch_totals(win["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"])
    log(f"  exists, sketch and payload launches with phase 15: {totals}; phase 15's alone: "
        f"{p15}")
    p15_other = {k: sum(n[k] for n in win["launches"].values())
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    p15_by_instance = _summed(*(n["by_instance"] for n in win["launches"].values()))
    p15_like_by_instance = _summed(*(n["like_by_instance"] for n in win["launches"].values()))
    p15_like_by_shape = _summed(*(n["like_by_shape"] for n in win["launches"].values()))
    log(f"  phase 15's launches of the other kernels: {p15_other}; lane-sums and leaf by "
        f"instance {p15_by_instance}; per statement "
        f"{ {q: {k: n[k] for k in ('leaf_agg', 'lane_sums', 'exists', 'payload') if n[k]} for q, n in win['launches'].items()} }; "
        f"shapes held to plain: {sorted(str(k) for k in win['calls'])}")
    mark("json")
    log("phase seconds: " + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_b, t1)
                                      in zip(marks, marks[1:])))

    log(smi[0])
    kernels = [
        {"name": "q1_step", "route": "cuda", "source": "presto_tpu_torch/csrc/q1.cu",
         "replaces": "presto_tpu/ops/pallas_q1.py:114",
         "jax_function": "presto_tpu/ops/pallas_q1.py:174 q1_step",
         "launches": (q1_launches + p11_other["q1"] + p12_other["q1"] + p13_other["q1"]
                      + p14_other["q1"] + p15_other["q1"]),
         "phase11_launches": p11_other["q1"], "phase12_launches": p12_other["q1"],
         "phase13_launches": p13_other["q1"], "phase14_launches": p14_other["q1"], "phase15_launches": p15_other["q1"],
         "max_abs_err": q1_err, "ms": q1_ms, "kernel_ms": q1_ms,
         "call_ms": q1_call_ms,
         "plain_ms": q1_plain_ms, "bound_ms": q1_bound, "bound_by": q1_by,
         "library_ms": None, "rows": n, "bytes": q1_bytes, "ops": q1_ops},
        {"name": "fused_lane_sums", "route": "cuda",
         "source": "presto_tpu_torch/csrc/lane_sums.cu",
         "replaces": "presto_tpu/ops/pallas_groupby.py:138",
         "jax_function": "presto_tpu/ops/pallas_groupby.py:177 fused_lane_sums",
         "launches": (lane_launches + outer["lane_launches"] + expr["lane_sums_launches"]
                      + sub["lane_sums_launches"] + p13_other["lane_sums"]
                      + p14_other["lane_sums"] + p15_other["lane_sums"]),
         "phase13_launches": p13_other["lane_sums"], "phase14_launches": p14_other["lane_sums"],
         "phase15_launches": p15_other["lane_sums"],
         "phase14_launches_by_instance": {k.split()[1]: c for k, c in p14_by_instance.items()
                                          if k.startswith("lane_sums ")},
         "launches_by_instance": _summed(lane_by_instance, outer["lane_by_instance"],
                                         expr["lane_by_instance"], sub["lane_by_instance"]),
         "launches_from": "phase 4 (Q1 pipeline), phase 10 (Q13, Q5), phase 11 (the "
                          "expression queries) and phase 12 (the subquery queries)",
         "phase12_launches": sub["lane_sums_launches"],
         "phase12_launches_by_instance": sub["lane_by_instance"],
         "phase10_launches": outer["lane_launches"],
         "phase11_launches": expr["lane_sums_launches"],
         "phase11_launches_by_instance": expr["lane_by_instance"],
         "max_abs_err": max(lane_err, ln["err"], ln_phone["err"], ln_q4["err"],
                            surf["call_err"]["lane_sums"], win["call_err"]["lane_sums"]),
         "ms": ln["ms"], "kernel_ms": ln["ms"], "call_ms": ln["call_ms"],
         "plain_ms": ln["plain_ms"], "bound_ms": lane_bound, "bound_by": lane_by,
         "library_ms": ln["library_ms"], "rows": cap, "bytes": ln["bytes"], "ops": ln["ops"],
         "instance": ln["instance"], "small_ms": ln_phone["ms"],
         "small_call_ms": ln_phone["call_ms"], "small_plain_ms": ln_phone["plain_ms"],
         "small_library_ms": ln_phone["library_ms"], "small_bound_ms": phone_bound,
         "small_rows": ln_phone["rows"], "small_shape": ln_phone["shape"],
         "small_instance": ln_phone["instance"],
         "small_launches": strings["launches"]["ssb q_like_phone"]["lane_sums"],
         "q4_ms": ln_q4["ms"], "q4_call_ms": ln_q4["call_ms"], "q4_plain_ms": ln_q4["plain_ms"],
         "q4_library_ms": ln_q4["library_ms"], "q4_bound_ms": q4_bound,
         "q4_rows": ln_q4["rows"], "q4_shape": ln_q4["shape"], "q4_instance": ln_q4["instance"],
         "q4_launches": semi["launches"]["q4"]["lane_sums"]},
        {"name": "exists_probe", "route": "cuda", "source": "presto_tpu_torch/csrc/join_probe.cu",
         "replaces": "presto_tpu/ops/pallas_join.py:281",
         "jax_function": "presto_tpu/ops/pallas_join.py:329 exists_probe",
         "launches": totals["exists"]["launches"],
         "launches_by_shape": totals["exists"]["by_shape"],
         "launches_by_instance": totals["exists"]["by_instance"],
         "launches_from": "phases 6, 8, 9, 10, 11, 12, 13, 14 and 15",
         "phase15_launches": p15["exists"]["launches"],
         "phase15_launches_by_shape": p15["exists"]["by_shape"],
         "phase14_launches": p14["exists"]["launches"],
         "phase14_launches_by_shape": p14["exists"]["by_shape"],
         "phase13_launches": p13["exists"]["launches"],
         "phase13_launches_by_shape": p13["exists"]["by_shape"],
         "phase11_launches": p11["exists"]["launches"],
         "phase11_launches_by_shape": p11["exists"]["by_shape"],
         "phase12_launches": p12["exists"]["launches"],
         "phase12_launches_by_shape": p12["exists"]["by_shape"],
         "phase12_launches_by_instance": p12["exists"]["by_instance"],
         "max_abs_err": max([exists_err, keep_err["exists"], expr["probe_err"]["exists"],
                             sub["probe_err"]["exists"], feat["probe_err"]["exists"],
                             surf["probe_err"]["exists"], win["probe_err"]["exists"]]
                            + [t["err"] for t in probe_shapes["exists"].values()]),
         "ms": ex["ms"], "kernel_ms": ex["ms"], "call_ms": ex["call_ms"],
         "plain_ms": ex["plain_ms"], "bound_ms": exists_bound, "bound_by": exists_by,
         "library_ms": ex["library_ms"], "library_call": "torch.isin(keys, build_keys) & live",
         "rows": ex["rows"], "bytes": ex["bytes"], "ops": ex["ops"],
         "probe_ms": ex["probe_ms"], "instance": ex["instance"],
         "semi_anti_part_launches": semi["exists_launches"], "shapes": probe_shapes["exists"]},
        {"name": "sketch_probe", "route": "cuda",
         "source": "presto_tpu_torch/csrc/join_probe.cu",
         "replaces": "presto_tpu/ops/pallas_join.py:294",
         "jax_function": "presto_tpu/ops/pallas_join.py:350 sketch_probe",
         "launches": totals["sketch"]["launches"],
         "launches_by_shape": totals["sketch"]["by_shape"],
         "launches_by_instance": totals["sketch"]["by_instance"],
         "phase11_launches": p11["sketch"]["launches"],
         "phase12_launches": p12["sketch"]["launches"],
         "phase13_launches": p13["sketch"]["launches"],
         "phase14_launches": p14["sketch"]["launches"],
         "phase15_launches": p15["sketch"]["launches"],
         "max_abs_err": max([sketch_err, keep_err["sketch"]]
                            + [t["err"] for t in probe_shapes["sketch"].values()]),
         "ms": sk["ms"], "kernel_ms": sk["ms"], "call_ms": sk["call_ms"],
         "plain_ms": sk["plain_ms"], "bound_ms": sketch_bound, "bound_by": sketch_by,
         "library_ms": None, "rows": sk["rows"], "bytes": sk["bytes"], "ops": sk["ops"],
         "probe_ms": sk["probe_ms"], "instance": sk["instance"],
         "shapes": probe_shapes["sketch"]},
        {"name": "q3_probe_step", "route": "cuda",
         "source": "presto_tpu_torch/csrc/join_probe.cu",
         "replaces": "presto_tpu/ops/pallas_join.py:443",
         "jax_function": "presto_tpu/ops/pallas_join.py:464 q3_probe_step",
         "launches": (semi["q3_launches"] + p11_other["q3"] + p12_other["q3"] + p13_other["q3"]
                      + p14_other["q3"] + p15_other["q3"]),
         "phase11_launches": p11_other["q3"], "phase12_launches": p12_other["q3"],
         "phase13_launches": p13_other["q3"], "phase14_launches": p14_other["q3"], "phase15_launches": p15_other["q3"],
         "max_abs_err": max(q3_kernel_err, semi["q3"]["err"]),
         "ms": q3_one["ms"], "kernel_ms": q3_one["ms"], "call_ms": q3_one["call_ms"],
         "plain_ms": q3_one["plain_ms"], "bound_ms": q3_bound, "bound_by": q3_by,
         "library_ms": None, "rows": q3_one["rows"], "bytes": q3_one["bytes"],
         "ops": q3_one["ops"], "resident_ms": q3_ten["ms"], "resident_call_ms": q3_ten["call_ms"],
         "resident_plain_ms": q3_ten["plain_ms"], "resident_bound_ms": q3_ten_bound,
         "resident_rows": q3_ten["rows"]},
        {"name": "payload_probe", "route": "cuda",
         "source": "presto_tpu_torch/csrc/join_probe.cu",
         "replaces": "presto_tpu/ops/pallas_join.py:305",
         "jax_function": "presto_tpu/ops/pallas_join.py:372 payload_probe",
         "launches": totals["payload"]["launches"],
         "launches_by_shape": totals["payload"]["by_shape"],
         "launches_by_instance": totals["payload"]["by_instance"],
         "launches_from": "phases 6, 8, 9, 10, 11, 12, 13, 14 and 15",
         "phase15_launches": p15["payload"]["launches"],
         "phase15_launches_by_shape": p15["payload"]["by_shape"],
         "phase14_launches": p14["payload"]["launches"],
         "phase14_launches_by_shape": p14["payload"]["by_shape"],
         "phase13_launches": p13["payload"]["launches"],
         "phase13_launches_by_shape": p13["payload"]["by_shape"],
         "phase13_launches_by_instance": p13["payload"]["by_instance"],
         "phase11_launches": p11["payload"]["launches"],
         "phase11_launches_by_shape": p11["payload"]["by_shape"],
         "phase11_launches_by_instance": p11["payload"]["by_instance"],
         "phase12_launches": p12["payload"]["launches"],
         "phase12_launches_by_shape": p12["payload"]["by_shape"],
         "phase12_launches_by_instance": p12["payload"]["by_instance"],
         "max_abs_err": max([payload_err, expr["probe_err"]["payload"],
                             sub["probe_err"]["payload"], feat["probe_err"]["payload"],
                             surf["probe_err"]["payload"], win["probe_err"]["payload"]]
                            + [t["err"] for t in probe_shapes["payload"].values()]),
         "ms": pay["ms"], "kernel_ms": pay["ms"], "call_ms": pay["call_ms"],
         "plain_ms": pay["plain_ms"], "bound_ms": pay["bound_ms"], "bound_by": pay["bound_by"],
         "library_ms": None, "rows": pay["rows"], "bytes": pay["bytes"], "ops": pay["ops"],
         "probe_ms": pay["probe_ms"], "instance": pay["instance"],
         "contract_ms": pay["contract_ms"], "contract_bound_ms": pay["contract_bound_ms"],
         "shapes": probe_shapes["payload"]},
        {"name": "leaf_agg", "route": "cuda", "source": "presto_tpu_torch/csrc/leaf_agg.cu",
         "replaces": "presto_tpu/ops/pallas_agg.py:180",
         "jax_function": "presto_tpu/ops/pallas_agg.py:246 _pallas_step (via agg_step :346)",
         "launches": (leaf["leaf_launches"] + p11_other["leaf_agg"] + p12_other["leaf_agg"]
                      + p13_other["leaf_agg"] + p14_other["leaf_agg"]
                      + p15_other["leaf_agg"]),
         "phase11_launches": p11_other["leaf_agg"], "phase12_launches": p12_other["leaf_agg"],
         "phase13_launches": p13_other["leaf_agg"], "phase14_launches": p14_other["leaf_agg"],
         "phase15_launches": p15_other["leaf_agg"],
         "phase15_launches_by_instance": {k.split()[1]: c for k, c in p15_by_instance.items()
                                          if k.startswith("leaf_agg ")},
         "phase14_launches_by_instance": {k.split()[1]: c for k, c in p14_by_instance.items()
                                          if k.startswith("leaf_agg ")},
         "phase12_launches_by_instance": sub["leaf_by_instance"],
         "launches_from": "phase 7 (Q6, SSB Q1.1-1.3), phase 11, phase 12 (none at SF1: "
                          "Q15's revenue view is not fused there) and phase 15 (one a "
                          "split and grouping set)",
         "launches_by_shape": leaf["by_shape"],
         "launches_by_instance": leaf["by_instance"],
         "max_abs_err": max(leaf_err, sp["err"], sm_["err"], res_["err"],
                            surf["call_err"]["leaf_agg"], win["call_err"]["leaf_agg"]),
         "ms": sp["ms"], "kernel_ms": sp["ms"], "call_ms": sp["call_ms"],
         "plain_ms": sp["plain_ms"], "bound_ms": leaf_bound, "bound_by": leaf_by,
         "library_ms": sp["library_ms"], "rows": sp["rows"], "bytes": sp["bytes"],
         "ops": sp["ops"], "instance": sp["instance"], "resident_ms": res_["ms"],
         "resident_call_ms": res_["call_ms"], "resident_bound_ms": res_bound,
         "resident_rows": res_["rows"], "small_ms": sm_["ms"], "small_call_ms": sm_["call_ms"],
         "small_plain_ms": sm_["plain_ms"], "small_library_ms": sm_["library_ms"],
         "small_bound_ms": small_bound, "small_rows": sm_["rows"],
         "small_instance": sm_["instance"]},
        {"name": "like_mask", "route": "cuda", "source": "presto_tpu_torch/csrc/strings.cu",
         "replaces": "presto_tpu/ops/pallas_strings.py:118",
         "jax_function": "presto_tpu/ops/pallas_strings.py:190 like_mask_pallas",
         "launches": (strings["like_launches"] + outer["like_launches"] + expr["like_launches"]
                      + sub["like_launches"] + p13_other["like"] + p14_other["like"]
                      + p15_other["like"]),
         "launches_by_instance": _summed(strings["like_by_instance"],
                                         outer["like_by_instance"], expr["like_by_instance"],
                                         sub["like_by_instance"], p13_like_by_instance,
                                         p14_like_by_instance, p15_like_by_instance),
         "phase13_launches": p13_other["like"], "phase14_launches": p14_other["like"], "phase15_launches": p15_other["like"],
         "phase14_launches_by_instance": p14_like_by_instance,
         "phase13_launches_by_instance": p13_like_by_instance,
         "launches_from": "phase 8 (LIKE queries), phase 10 (Q13, Q5), phase 11 (Q16) and "
                          "phase 12 (Q20's p_name like 'forest%')",
         "phase10_launches": outer["like_launches"],
         "phase11_launches": expr["like_launches"],
         "phase12_launches": sub["like_launches"],
         "phase12_launches_by_instance": sub["like_by_instance"],
         "launches_by_shape": _summed(strings["like_by_shape"], outer["like_by_shape"],
                                      expr["like_by_shape"], sub["like_by_shape"],
                                      p13_like_by_shape, p14_like_by_shape, p15_like_by_shape),
         "max_abs_err": max([like_err, sub["like_err"], surf["call_err"]["like"],
                            win["call_err"]["like"]]
                            + [t["err"] for t in like_shapes.values()]),
         "ms": lk["ms"], "kernel_ms": lk["ms"], "call_ms": lk["call_ms"],
         "plain_ms": lk["plain_ms"], "bound_ms": like_bound, "bound_by": like_by,
         "library_ms": None, "rows": lk["rows"], "width": lk["width"], "bytes": lk["bytes"],
         "ops": lk["ops"], "pattern": lk["pattern"], "instance": lk["instance"],
         "shapes": like_shapes},
        {"name": "starts_with_mask", "route": "cuda",
         "source": "presto_tpu_torch/csrc/strings.cu",
         "replaces": "presto_tpu/ops/pallas_strings.py:246",
         "jax_function": "presto_tpu/ops/pallas_strings.py:251 starts_with_pallas",
         "launches": (strings["prefix_launches"] + p11_other["prefix"] + p12_other["prefix"]
                      + p13_other["prefix"] + p14_other["prefix"]
                      + p15_other["prefix"]),
         "phase11_launches": p11_other["prefix"], "phase12_launches": p12_other["prefix"],
         "phase13_launches": p13_other["prefix"], "phase14_launches": p14_other["prefix"],
         "phase15_launches": p15_other["prefix"],
         "launches_from": "phase 8 (the starts_with pipeline); phase 12's like 'forest%' "
                          "runs the LIKE kernel, as in the JAX package",
         "launches_by_instance": strings["prefix_by_instance"],
         "max_abs_err": max([prefix_err] + [t["err"] for t in prefix_shapes.values()]),
         "ms": px["ms"], "kernel_ms": px["ms"], "call_ms": px["call_ms"],
         "plain_ms": px["plain_ms"], "bound_ms": prefix_bound, "bound_by": prefix_by,
         "library_ms": None, "rows": px["rows"], "width": px["width"], "bytes": px["bytes"],
         "ops": px["ops"], "prefix": px["prefix"], "instance": px["instance"],
         "sector_floor_ms": px["sector_floor_ms"], "shapes": prefix_shapes},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
