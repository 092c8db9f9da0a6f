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
   payload launch shape held to the plain version;
16. all 99 TPC-DS queries at SF1 through ``Session.sql`` over
   ``TpcdsConnector`` (NULL foreign keys from the scans; every table
   generated once, as set-up, and scanned from the host), each equal to
   the strategy counters its plan predicts, from one run a query under
   the profiler's CUDA tracing: its wall, connector-scan seconds, peak
   device memory, device busy time and five largest device ops, and the
   launches per kernel; q3, q7, q97 and q98 equal to numpy
   recomputations; every lane-sums, leaf, LIKE, exists and payload
   launch shape held to the plain version; the share of the phase's
   device busy time in ``index_add_`` and in sorts; then every query on
   the card at sf 0.1 (``TPCDS_CHECK_SMALL`` and ``TPCDS_EMPTY_AT_CHECK_SF``
   at sf 0.02) equal, row for
   row, to the port's answer on the CPU, which ``TPCDS_WORKERS`` niced
   processes compute from the start of the run (ended on any exit), and
   to the numpy oracle (``presto_tpu_torch/oracle/tpcds_oracle.py`` over
   the connector's ``table_logical`` frames, computed by the same
   processes) under ``same_as_oracle``;
17. the statements over the memory connector at SF1
   (``run_statement_queries``, on the generated splits): CREATE TABLE AS
   of ``lineitem``'s integer columns (its stats and catalog version),
   their group-by on the leaf route, INSERT of a filtered copy, the
   group-by again (stats merged), DROP; TPC-DS q3's star join over CTAS
   copies of its integer columns (the memory connector's exact stats)
   beside phase 16's q3; EXPLAIN ANALYZE and ``Session.execute`` of Q3
   and a Q1-shaped group-by, each countable node's rows against numpy
   and ``strategy=partial`` where the recorder skipped the leaf route;
   PREPARE / EXECUTE of Q6 with ``?`` bounds under three bindings (and
   the literal statements) and of Q3 with its literals auto-slotted;
   every answer equal to a numpy recomputation, the ``prepare.*``
   counters reported, every lane-sums, leaf, exists and payload launch
   shape held to the plain version;
18. the observability core at SF1 (``run_observability_queries``): Q1,
   Q6 and Q3 through ``Session.sql`` and the Q1-shaped group-by through
   ``Session.execute``, traced with ``profile_annotations`` on, under
   the torch profiler: each answer against numpy, each ``QueryInfo.
   metrics`` strategy counter against its plan's, every Q1, leaf,
   exists and lane-sums launch inside a ``step:``, ``finish:``, ``node:``
   or ``fragment:`` span (on the host) and annotation (in the profiler's
   trace), ``export_trace``'s Chrome JSON parsed and its node spans
   against the plans, each launch shape held to the plain version; the
   JAX package's tracing-overhead rule on Q1, Q6 and Q3 (on <= off x
   1.05 + 5 ms, least of interleaved rounds); and Q3 answered after an
   injected scan fault under ``query_retries=1`` (``query.retried`` 1).
   Every earlier phase runs traced too (``trace_enabled`` is on by
   default);
19. the query lifecycle and the out-of-core tier at SF1
   (``run_lifecycle_queries``): TPC-H Q3, ``HICARD_AGG`` and the
   customer semi and anti joins resident and planned hybrid (each
   ``join_build_budget_bytes`` its largest build estimate / 4), and Q3
   fully grouped (/ 100), each equal to its numpy oracle and to the
   resident run, with each spill decision (estimate, budget, buckets,
   resident and streamed units, host bytes) and the transfer pipeline's
   overlap printed, and the memory pool and host spill budget at 0
   after every query; Q1 and Q6 under the lifecycle; every Q1, leaf and
   exists launch inside a ``fragment:`` span and each launch shape held
   to the plain version; a deadline (``query_max_run_time`` a tenth of
   Q1's warm wall: ``ExceededTimeLimit`` at ``scan``), a
   ``Session.cancel`` from a second thread while a scan is held at a
   gate (``QueryCancelled``, ``cancel.observed`` 1) and an admission
   rejection (``query_max_memory_bytes`` half of Q3's estimate, before
   any scan or launch), each session answering right after; then the
   allocator's own out-of-memory (``real_oom``): each candidate's
   resident and rung-1 peaks, twice each (``max_memory_allocated`` and
   ``max_memory_reserved``), the allocator capped at the geometric mean
   of the least resident and the most rung-1 peak over what it holds,
   with ``torch.cuda.set_per_process_memory_fraction`` after
   ``empty_cache()``, the card's ``torch.OutOfMemoryError`` mapped
   to ``DeviceOutOfMemory`` and walked by the OOM ladder to the uncapped
   answer at rung 1, the cap lifted in a ``finally`` (fraction 1.0,
   ``empty_cache()``) and the next query answering right;
20. the cache tier at SF1 (``run_cache_queries``), in sessions with the
   default properties: Q1, Q6 and Q3 twice, the second run a
   launch-free result-cache hit, bitwise equal to the first; an INSERT
   into a memory table invalidating a cached query's result; a 6.0M-row
   result held under the 256 MiB budget and evicted LRU-first by a wider
   one; with the result cache off, warm runs served by the executable
   cache (hits, no miss, the first run's launches) and a repeated
   multi-key join by the stats cache (no min/max read back); a
   misestimated aggregation's third recorded run steered by the adaptive
   controller (``system.adaptive``) and the decision replayed on the
   fourth; a deadline failure and a fragment retry in the flight
   recorder (``system.flight_recorder``, ``export_flight_record``); the
   ``system`` tables through ``select ... where ...`` against the
   session's stores; two Q6 at once coalesced onto one execution. Every
   answer against numpy, every launch inside a ``fragment:`` span, each
   launch shape held to the plain version;
21. the serving tier and the streams at SF1 (``run_serving_queries``):
   three tenants' threads sending Q1, Q6 and Q3 at once through a
   ``QueryServer`` (two fair slots, the batch gate, the health monitor)
   by ``submit`` and over HTTP on 127.0.0.1 (``system.tenants`` names
   them); a TopN and an aggregate template with 8 concurrent bindings
   fused into one batched dispatch each (``lineitem`` scanned once per
   batch, no ``batch.fallback.error``, every lane equal to numpy and to
   its serial run); a leaf-routed template falling back from the gate
   (``batch.fallback.leaf_route``) onto the leaf kernel; a
   ``StreamWriter`` appending 10 micro-batches under an exact
   subscription delivering at every epoch and an approximate one over
   half of lineitem's splits; a forced shed and a cancelled queued
   query, typed, every pool at 0. Every answer against numpy, every
   launch from the server's threads inside a ``fragment:`` span, each
   launch shape held to the plain version;
22. the CLI at SF1 (``run_cli_queries``, ``run_cli_serve``, at most
   120 s): ``presto_tpu_torch.__main__.main`` in this process with its
   output captured, the result cache off: ``metrics -f`` over Q1, Q6,
   Q3, a SET SESSION, SHOW SESSION, EXPLAIN ANALYZE of Q6 and Q1, Q6,
   Q3 again under ``profile_dir`` (each printed table against numpy,
   the OpenMetrics text against the registry, each query's profiler
   trace naming the Q1, leaf and exists kernels); a LIKE over ``part``
   after ``SET SESSION pallas_strings`` off (refused on the card,
   ROADMAP C25) and on, one LIKE launch a split and equal rows after
   both; ``health`` after Q6 and ``flightrec`` over a statement
   that fails at run time; then ``python -m presto_tpu_torch serve
   --port 0`` as a subprocess: Q1 POSTed over HTTP against numpy, SIGINT
   and its drain line (``pool_reserved_bytes=0``). Each launch shape
   held to the plain version;
23. a mesh session at SF1 (``run_mesh_queries``): ``Session(mesh=
   make_mesh(4, devices=["cuda:0"] * 4))``, the distributed executor
   over four shards on the one card: Q1 and Q6 on the distributed leaf
   route (the Q1 and leaf kernels once per shard at the shard's
   capacity), the top order groups (PARTIAL, the multi-round exchange,
   FINAL, TopN), orders range-sorted under a ``gather_row_limit`` below
   its rows, a LIKE over ``part``'s shards and a direct-strategy fold
   after a LIKE over ``orders``' shards; each answer against numpy where
   an oracle exists and against the one-device session, with its wall,
   its ``exchange.*`` counters and exchange walls and the host's reads
   of the round flag; EXPLAIN (TYPE DISTRIBUTED) of the group-by and
   ``python -m presto_tpu_torch --mesh 1 -e`` Q6. Each launch shape held
   to the plain version;
24. joins, semi joins and windows on that mesh (``run_mesh_join_queries``):
   Q3 at the default distribution and with every join repartitioned,
   the customer-orders FULL OUTER counts, a semi and an anti join on
   customer, each customer's first order by ``row_number()`` over a
   partitioned window, Q3 with its joins on the grouped tier, and Q3
   with a retryable fault at every ``exchange.join``, degraded to one
   device; each answer against numpy and the one-device session, with
   its wall, its ``join.distribution.*`` / ``exchange.*`` / ``spill.*``
   counters and exchange walls; no fused probe on the mesh, the exists
   kernel in the degraded run, each launch shape held to the plain
   version;
25. the 22 TPC-H queries (Q5 at ``Q5_SF``) and the 15 SSB queries at SF1
   through ``Session.sql`` (``run_oracle_queries``), each answer held to
   the numpy oracle of ``presto_tpu_torch/oracle/`` over the connector's
   ``table_logical`` frames (``same_as_oracle``: ``tests/test_tpch_sql``'s
   ``normalize`` and ``compare`` without pandas; an empty oracle answer
   fails), the oracles computed in the worker processes of phase 16 from
   the start of the run; each query's wall and its oracle's host seconds,
   the launches by kernel and shape, each launch shape held to the plain
   version.

Phases 3-19 open their sessions with ``MEASURED`` (the result cache and
adaptive execution off), so each timed or counted run executes its plan.

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

Every split a connector scans is generated once (``generated_once``):
TPC-H and SSB at SF1 before phase 2 and TPC-DS at SF1 at the start of
phase 16, as set-up, other scales when first scanned. So walls and
connector-scan seconds hold the narrowing and the copy to the card, not
the generation.

The card's name and power limit come first and again before the last
lines, which are one JSON line ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
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
from presto_tpu_torch.oracle import frame, ssb_oracle, tpcds_oracle, tpch_oracle
from presto_tpu_torch.runtime.metrics import REGISTRY
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


#: phases 3-19 measure execution: their sessions run every statement
#: (no result-cache hit) on the plan their properties pin (no adaptive
#: decision from an earlier run's history), as the JAX package's bench.py
#: measures; phase 20 opens its sessions with the defaults
MEASURED = {"result_cache_enabled": False, "adaptive_execution": False}


def measured_session(connectors, properties=None, **kwargs) -> Session:
    """A ``Session`` with ``MEASURED`` under the caller's properties."""
    return Session(connectors, properties={**MEASURED, **(properties or {})}, **kwargs)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def counters() -> dict:
    """The port's registry counters added since the last
    ``REGISTRY.reset()``, name -> total (0 for a name never added)."""
    return collections.Counter({c.name: int(c.total) if c.total == int(c.total)
                                else c.total
                                for c in list(REGISTRY.counters.values())})


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


@contextlib.contextmanager
def timed_scans(conn):
    """While in the block, the host seconds spent inside ``conn.scan``
    (narrowing and the copy to the card, on the prefetch thread; the data
    comes from :func:`generated_once`) add up in the yielded list's one
    item."""
    total = [0.0]
    original = conn.scan

    def scan(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            total[0] += time.perf_counter() - t0

    conn.scan = scan
    try:
        yield total
    finally:
        del conn.scan


def trace_device_ops(prof) -> tuple:
    """(device busy ms, device ops) from a finished profiler's raw events:
    every kernel, copy and set the card ran, summed by name as (name, ms,
    calls), the most time first. The busy ms equal ``key_averages``' sum
    of ``self_device_time_total``, which builds an event tree first and
    takes a minute or more on a query of 10^5 kernels."""
    from torch.autograd import DeviceType

    by: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t = by.setdefault(e.name(), [0, 0])
            t[0] += e.duration_ns()
            t[1] += 1
    ops = sorted(((k[:60], ns / 1e6, c) for k, (ns, c) in by.items()), key=lambda o: -o[1])
    return sum(o[1] for o in ops), ops


def device_ops(session, conn, sql: str):
    """(device busy ms, connector-scan s, device ops) of one more run of
    ``sql``: the device time of every kernel and copy in the profiler's
    CUDA trace, the host time spent inside ``conn.scan`` (narrowing and
    the copy to the card; the scans run on the prefetch
    thread, so they overlap the rest), and every device op with its time,
    as (name, ms, calls), the most time first."""
    from torch.profiler import ProfilerActivity, profile

    with timed_scans(conn) as scan_s, profile(activities=[ProfilerActivity.CUDA]) as prof:
        session.sql(sql)
        torch.cuda.synchronize()
    busy_ms, ops = trace_device_ops(prof)
    return busy_ms, scan_s[0], ops


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
        session = measured_session({"tpch": conn}, device=device)
        # the first probe batch of the query's fused join, and its keep calls
        with first_probe(mode) as seen:
            REGISTRY.reset()
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = session.sql(QUERIES[q])
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            n = _launch_counts()
            route = counters()
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
        REGISTRY.reset()
        cuda_join.exists_launches = cuda_join.payload_launches = 0
        off = measured_session({"tpch": conn}, properties={"pallas_join": False},
                      device=device).sql(QUERIES[q])
        check(counters()["exec.pallas_join_route"] == 0 and cuda_join.exists_launches == 0
              and cuda_join.payload_launches == 0, f"{q}: pallas_join off still probed fused")
        same_result(off, want[q], f"{q} at SF1 with pallas_join off")
        strategies = {k: v for k, v in route.items() if k.startswith(("join.", "agg."))}
        log(f"  {q}: {len(res)} rows equal to numpy, with pallas_join off too; wall first "
            f"{first:.3f} s, second {second:.3f} s; exists launches {n_exists}, payload "
            f"launches {n_payload}; routes {strategies}")
        log(f"  {q} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
            f"connector scans (narrowing + copy to the card) {scan_s:.3f} s")

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
            on = measured_session({"tpch": tconn, "ssb": sconn}, properties={"narrow_storage": True},
                         device=device)
            leaf_route.agg_step = capture(name) if name in ("q6", "ssb q1_1") else original
            REGISTRY.reset()
            cuda_q1.launches = 0
            cuda_agg.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = on.sql(sql)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            n_q1, n_leaf = cuda_q1.launches, cuda_agg.launches
            by_instance = {k: v for k, v in cuda_agg.launches_by_instance.items() if v}
            route = counters()
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
            REGISTRY.reset()
            cuda_q1.launches = cuda_agg.launches = 0
            off = measured_session({"tpch": tconn, "ssb": sconn}, properties={"narrow_storage": False},
                          device=device).sql(sql)
            check(counters()["exec.leaf_fused_route"] == 0 and cuda_q1.launches == 0
                  and cuda_agg.launches == 0, f"{name}: narrow_storage off still took the route")
            same_result(off, want[name], f"{name} at SF1 with narrow_storage off")
            out["walls"][name] = (first, second, busy_ms, scan_s)
            log(f"  {name}: {len(res)} rows equal to numpy, with narrow_storage off too; wall "
                f"first {first:.3f} s, second {second:.3f} s; Q1-kernel launches {n_q1}, "
                f"leaf-kernel launches {n_leaf} ({splits} splits, by instance "
                f"{by_instance}); routes "
                f"{ {k: v for k, v in route.items() if k.startswith(('exec.', 'agg.'))} }")
            log(f"  {name} breakdown (a third, profiled run): device busy {busy_ms:.1f} ms, "
                f"connector scans (narrowing + copy to the card) {scan_s:.3f} s")
    finally:
        leaf_route.agg_step = original
        if narrow_before is None:
            os.environ.pop("PRESTO_TPU_NARROW", None)
        else:
            os.environ["PRESTO_TPU_NARROW"] = narrow_before

    out["split"] = time_leaf(*captured["q6"], flush)
    out["small"] = time_leaf(*captured["ssb q1_1"], flush)
    out["captured"] = captured
    on = measured_session({"tpch": tconn}, properties={"narrow_storage": True}, device=device)
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
        session = measured_session({key: conn}, device=device)
        current[0] = name
        cuda_strings.like_mask = capture_like
        if name == "ssb q_like_phone":
            cuda_groupby.fused_lane_sums = capture_lane
        try:
            # Q9's part join (exists) and nation join (payload): their
            # first lineitem probe batches and their keep calls
            with first_probe("exists") as seen, first_probe("payload") as pseen:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sqls[name])
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
            f"connector scans (narrowing + copy to the card) {scan_s:.3f} s")

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
        session = measured_session({"tpch": conn}, device=device)
        sql = QUERIES[name]
        cuda_strings.like_mask = capture_like
        try:
            with expand_capacities() as caps:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
            f"connector scans (narrowing + copy to the card) {scan_s:.3f} s; the "
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
    11's oracles read the same SF1 columns many times. A column's NULL
    mask (``<col>$valid``, TPC-DS) comes with it."""

    def __init__(self, conn):
        self.conn, self.columns = conn, {}

    def table_numpy(self, table: str, columns) -> dict:
        missing = [c for c in columns if (table, c) not in self.columns]
        if missing:
            for c, a in self.conn.table_numpy(table, missing).items():
                self.columns[(table, c)] = a
        return {k: self.columns[(table, k)] for c in columns for k in (c, f"{c}$valid")
                if (table, k) in self.columns}

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


def planned_routes(session, sql: str, fused: bool = True) -> dict:
    """The strategy counters a statement's plan predicts: one
    ``join.strategy.<s>`` per join and semi join but a FULL join and a
    membership join the fused leaf step folds (``expand`` counts each
    output capacity its retry ladder tries, so the plan gives its least)
    and one ``agg.strategy.<s>`` per aggregate. ``fused=False``: a run
    that skips the leaf route (a stats recorder, ``Session.execute``)."""
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
            key = "agg.strategy." + agg_strategy_for(node, session.catalog,
                                                     fused_enabled=fused)
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
            session = measured_session({key: conn}, device=device)
            predicted = planned_routes(session, sql)
            cuda_strings.like_mask = capture_like
            query["name"] = name
            try:
                with expand_capacities() as caps:
                    REGISTRY.reset()
                    _reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = session.sql(sql)
                    torch.cuda.synchronize()
                    first = time.perf_counter() - t0
                    n = _launch_counts()
                    route = counters()
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
        measured_session({"tpch": connectors["tpch"]}, device=device).sql(DISTINCT_WITH_COUNT_STAR)
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
            session = measured_session({"tpch": conn}, device=device)
            predicted = planned_routes(session, sql)
            cuda_strings.like_mask = capture_like
            query["name"] = name
            try:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
            session = measured_session({"tpch": conn}, properties=props, device=device)
            predicted = planned_routes(session, sql)
            if conn.sf == 1 and name in RUNS_SORTED:
                k = RUNS_SORTED[name]
                predicted["join.strategy.dense"] -= k
                predicted["join.strategy.unique"] = predicted.get("join.strategy.unique", 0) + k
            want_filters = expected_filter_counts(cached, name, plan_filter_bits(session, sql))
            query["name"] = name
            try:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
        session = measured_session({"tpch": conn}, device=device)
        sql = QUERIES[name]
        want_filters = expected_filter_counts(cached, name, plan_filter_bits(session, sql))
        REGISTRY.reset()
        session.sql(sql)
        filters = {k: v for k, v in counters().items() if k.startswith("join.filter_rows_")}
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
            session = measured_session({"tpch": conn}, device=device)
            predicted = planned_routes(session, sql)
            query["name"] = name
            try:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
            session = measured_session({"tpch": conn}, device=device)
            predicted = planned_routes(session, sql)
            query["name"] = name
            try:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
# phase 16: the TPC-DS connector and its 99 queries
# ---------------------------------------------------------------------------

TPCDS_SF = 1
#: the scale at which every query's card answer is held to the port's CPU
#: answer (the kernels' plain versions)
TPCDS_CHECK_SF = 0.1
#: queries whose CPU run at ``TPCDS_CHECK_SF`` takes over 60 s (one
#: thread): checked at ``TPCDS_SMALL_SF`` instead
TPCDS_CHECK_SMALL = {"q14", "q22", "q64", "q82"}
#: queries that answer no rows at ``TPCDS_CHECK_SF`` (q83: no item is
#: returned through all three channels in its three weeks), checked at
#: ``TPCDS_SMALL_SF`` too, where their answers hold rows
TPCDS_EMPTY_AT_CHECK_SF = {"q83"}
TPCDS_SMALL_SF = 0.02
#: the CPU answers are computed in this many worker processes (niced, one
#: intra-op thread each), started before phase 1 so they overlap it
TPCDS_WORKERS = 4
#: queries phase 16 runs again without the trace, to show its cost on a wall
TPCDS_UNTRACED = ("q3", "q22")
TPCDS_DOUBLES = {"q7": ("agg1", "agg2", "agg3", "agg4"), "q98": ("revenueratio",)}


def _tpcds_queries() -> dict:
    from presto_tpu_torch.connectors.tpcds.queries import QUERIES as TPCDS_QUERIES

    return dict(sorted(TPCDS_QUERIES.items(), key=lambda kv: int(kv[0][1:])))


def _valid(cols: dict, name: str) -> np.ndarray:
    v = cols.get(f"{name}$valid")
    return np.ones(len(cols[name]), np.bool_) if v is None else v


def _rows_of(keys: np.ndarray, table_keys: np.ndarray):
    """(row of each key in ``table_keys``, found mask); ``table_keys``
    unique."""
    order = np.argsort(table_keys, kind="stable")
    pos = np.searchsorted(table_keys, keys, sorter=order)
    pos = np.minimum(pos, len(table_keys) - 1)
    rows = order[pos]
    return rows, table_keys[rows] == keys


def _bytes_str(rows: np.ndarray) -> list:
    return [bytes(r).rstrip(b"\x00").decode("latin1") for r in rows]


def _fact_dim(conn, fact: str, prefix: str, cols: list) -> dict:
    """The ``fact`` columns, with the rows whose sold date is NULL dropped
    and each row's ``date_dim`` and ``item`` row (an inner join drops a
    NULL key)."""
    f = conn.table_numpy(fact, [f"{prefix}_sold_date_sk", f"{prefix}_item_sk"] + cols)
    d = conn.table_numpy("date_dim", ["d_date_sk"])
    it = conn.table_numpy("item", ["i_item_sk"])
    drow, dok = _rows_of(f[f"{prefix}_sold_date_sk"], d["d_date_sk"])
    irow, iok = _rows_of(f[f"{prefix}_item_sk"], it["i_item_sk"])
    keep = _valid(f, f"{prefix}_sold_date_sk") & dok & iok
    out = {c: f[c][keep] for c in cols}
    for c in cols:
        if f"{c}$valid" in f:
            out[f"{c}$valid"] = f[f"{c}$valid"][keep]
    out["drow"], out["irow"] = drow[keep], irow[keep]
    return out


def tpcds_q3_expected(conn) -> dict:
    """TPC-DS q3: November store sales of the first 50 manufacturers by
    year and brand, the largest discounts first, 100 rows."""
    f = _fact_dim(conn, "store_sales", "ss", ["ss_ext_discount_amt"])
    d = conn.table_numpy("date_dim", ["d_year", "d_moy"])
    it = conn.table_numpy("item", ["i_brand_id", "i_brand", "i_manufact_id"])
    keep = (it["i_manufact_id"][f["irow"]] <= 50) & (d["d_moy"][f["drow"]] == 11)
    year = d["d_year"][f["drow"]][keep].astype(np.int64)
    brand = it["i_brand"][f["irow"]][keep].astype(np.int64)
    brand_id = it["i_brand_id"][f["irow"]][keep].astype(np.int64)
    groups, inv = np.unique(np.stack([year, brand, brand_id]), axis=1, return_inverse=True)
    sums = np.zeros(groups.shape[1], np.int64)
    np.add.at(sums, inv.ravel(), f["ss_ext_discount_amt"][keep])
    order = np.lexsort((groups[1], groups[2], -sums, groups[0]))[:100]
    names = conn.dictionaries("item")["i_brand"].values
    return {"d_year": groups[0][order].tolist(), "brand_id": groups[2][order].tolist(),
            "brand": [names[c] for c in groups[1][order]], "sum_agg": sums[order].tolist()}


def tpcds_q7_expected(conn) -> dict:
    """TPC-DS q7: averages of store sales in 2000 to single college-educated
    men under a promotion without e-mail or without an event, by item."""
    cols = ["ss_cdemo_sk", "ss_promo_sk", "ss_quantity", "ss_list_price", "ss_coupon_amt",
            "ss_sales_price"]
    f = _fact_dim(conn, "store_sales", "ss", cols)
    d = conn.table_numpy("date_dim", ["d_year"])
    cd = conn.table_numpy("customer_demographics", ["cd_demo_sk", "cd_gender",
                                                    "cd_marital_status", "cd_education_status"])
    p = conn.table_numpy("promotion", ["p_promo_sk", "p_channel_email", "p_channel_event"])
    code = {c: conn.dictionaries("customer_demographics")[c].code_of(v)
            for c, v in (("cd_gender", "M"), ("cd_marital_status", "S"),
                         ("cd_education_status", "College"))}
    cd_ok = np.ones(len(cd["cd_demo_sk"]), np.bool_)
    for c, v in code.items():
        cd_ok &= cd[c] == v
    pn = {c: conn.dictionaries("promotion")[c].code_of("N")
          for c in ("p_channel_email", "p_channel_event")}
    p_ok = (p["p_channel_email"] == pn["p_channel_email"]) | (
        p["p_channel_event"] == pn["p_channel_event"])
    crow, cfound = _rows_of(f["ss_cdemo_sk"], cd["cd_demo_sk"])
    prow, pfound = _rows_of(f["ss_promo_sk"], p["p_promo_sk"])
    keep = (f["ss_cdemo_sk$valid"] & cfound & f["ss_promo_sk$valid"] & pfound
            & (d["d_year"][f["drow"]] == 2000))
    keep &= cd_ok[crow] & p_ok[prow]
    it = conn.table_numpy("item", ["i_item_id"])
    ids = it["i_item_id"]
    item = f["irow"][keep]
    groups, inv = np.unique(item, return_inverse=True)
    counts = np.bincount(inv, minlength=len(groups)).astype(np.float64)
    out_ids = _bytes_str(ids[groups])
    order = sorted(range(len(groups)), key=lambda i: out_ids[i])[:100]
    out = {"i_item_id": [out_ids[i] for i in order]}
    for name, col, scale in (("agg1", "ss_quantity", 1), ("agg2", "ss_list_price", 100),
                             ("agg3", "ss_coupon_amt", 100), ("agg4", "ss_sales_price", 100)):
        sums = np.bincount(inv, weights=f[col][keep].astype(np.float64), minlength=len(groups))
        out[name] = (sums / counts / scale)[order].tolist()
    return out


def tpcds_q98_expected(conn) -> dict:
    """TPC-DS q98: each item's store revenue in three categories over two
    months and its share of its class's revenue (a window over the
    aggregate)."""
    f = _fact_dim(conn, "store_sales", "ss", ["ss_ext_sales_price"])
    d = conn.table_numpy("date_dim", ["d_date"])
    it = conn.table_numpy("item", ["i_item_id", "i_item_desc", "i_category", "i_class",
                                   "i_current_price"])
    cats = conn.dictionaries("item")["i_category"]
    wanted = [cats.code_of(c) for c in ("Children", "Shoes", "Electronics")]
    lo, hi = (int(np.datetime64(x, "D").astype(np.int64)) for x in ("2000-01-29", "2000-03-29"))
    day = d["d_date"][f["drow"]]
    keep = np.isin(it["i_category"][f["irow"]], wanted) & (day >= lo) & (day <= hi)
    item = f["irow"][keep]
    groups, inv = np.unique(item, return_inverse=True)
    revenue = np.zeros(len(groups), np.int64)
    np.add.at(revenue, inv, f["ss_ext_sales_price"][keep])
    klass = it["i_class"][groups]
    class_sum = np.zeros(int(klass.max()) + 1 if len(klass) else 1, np.int64)
    np.add.at(class_sum, klass, revenue)
    ratio = revenue.astype(np.float64) * 100 / class_sum[klass]
    ids = _bytes_str(it["i_item_id"][groups])
    descs = _bytes_str(it["i_item_desc"][groups])
    cat = it["i_category"][groups]
    order = sorted(range(len(groups)), key=lambda i: (cat[i], klass[i], ids[i], descs[i], ratio[i]))
    cat_names = cats.values
    class_names = conn.dictionaries("item")["i_class"].values
    return {"i_item_id": [ids[i] for i in order], "i_item_desc": [descs[i] for i in order],
            "i_category": [cat_names[cat[i]] for i in order],
            "i_class": [class_names[klass[i]] for i in order],
            "i_current_price": [int(it["i_current_price"][groups[i]]) for i in order],
            "itemrevenue": [int(revenue[i]) for i in order],
            "revenueratio": [float(ratio[i]) for i in order]}


def tpcds_q97_expected(conn) -> dict:
    """TPC-DS q97: (customer, item) pairs bought in one year in the store
    only, in the catalog only and in both (a FULL OUTER join of two
    DISTINCT sets)."""
    d = conn.table_numpy("date_dim", ["d_date_sk", "d_month_seq"])
    year = (d["d_month_seq"] >= 1200) & (d["d_month_seq"] <= 1211)

    def pairs(fact, date, cust, item):
        f = conn.table_numpy(fact, [date, cust, item])
        row, found = _rows_of(f[date], d["d_date_sk"])
        keep = _valid(f, date) & found & year[row] & _valid(f, cust) & _valid(f, item)
        return np.unique(f[cust][keep].astype(np.int64) * (1 << 32) + f[item][keep])

    ss = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk", "ss_item_sk")
    cs = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk")
    both = len(np.intersect1d(ss, cs, assume_unique=True))
    return {"store_only": [len(ss) - both], "catalog_only": [len(cs) - both],
            "store_and_catalog": [both]}


TPCDS_ORACLES = {"q3": tpcds_q3_expected, "q7": tpcds_q7_expected,
                 "q97": tpcds_q97_expected, "q98": tpcds_q98_expected}


def _cpu_worker_init() -> None:
    os.nice(19)
    torch.set_num_threads(1)


_CPU_CONNECTORS: dict = {}


def tpcds_cpu_answer(job: tuple) -> tuple:
    """One TPC-DS query through the port on the CPU at ``sf`` (the
    kernels' plain versions): (name, sf, seconds, answer)."""
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    name, sf = job
    if sf not in _CPU_CONNECTORS:
        _CPU_CONNECTORS[sf] = TpcdsConnector(sf=sf, device="cpu")
    t0 = time.perf_counter()
    res = measured_session({"tpcds": _CPU_CONNECTORS[sf]}, device="cpu").sql(_tpcds_queries()[name])
    return name, sf, time.perf_counter() - t0, answer_of(res)


def answer_of(res) -> dict:
    """A result on the host: its column names, which are DOUBLE, and each
    column's exact values (``QueryResult.column``), as lists."""
    from presto_tpu_torch.types import TypeKind

    return {"names": list(res.names),
            "doubles": [n for n in res.names
                        if res.types[n] is not None and res.types[n].kind is TypeKind.DOUBLE],
            "columns": {n: res.column(n).tolist() for n in res.names}}


def same_answer(got: dict, want: dict, what: str) -> None:
    """Equal answers in row order: exactly, but DOUBLE columns within
    ``DOUBLE_TOL`` (NULL where the other is NULL)."""
    check(got["names"] == want["names"], f"{what}: columns {got['names']} != {want['names']}")
    check(got["doubles"] == want["doubles"], f"{what}: DOUBLE columns {got['doubles']} != "
          f"{want['doubles']}")
    for name in want["names"]:
        g, w = got["columns"][name], want["columns"][name]
        check(len(g) == len(w), f"{what}: {len(g)} rows != {len(w)}")
        if name in want["doubles"]:
            gf = np.array([np.nan if v is None else float(v) for v in g])
            wf = np.array([np.nan if v is None else float(v) for v in w])
            ok = np.allclose(gf, wf, equal_nan=True, **DOUBLE_TOL)
        else:
            ok = g == w
        check(ok, f"{what}: column {name} differs:\n{g[:5]}\n{w[:5]}")


def _tpcds_check_sf(name: str) -> float:
    small = TPCDS_CHECK_SMALL | TPCDS_EMPTY_AT_CHECK_SF
    return TPCDS_SMALL_SF if name in small else TPCDS_CHECK_SF


def start_cpu_answers() -> dict:
    """Start, in ``TPCDS_WORKERS`` niced worker processes, phase 25's numpy
    oracles at SF1 (the longest jobs, first), the port's CPU answers of
    every TPC-DS query at its check scale (:func:`_tpcds_check_sf`) and
    the TPC-DS numpy oracles at the same scales. Returns the pool and the
    pending results (``oracle25``, ``tpcds``, ``tpcds_oracle``); phases
    16 and 25 read them."""
    import multiprocessing

    queries = _tpcds_queries()
    pool = multiprocessing.get_context("spawn").Pool(TPCDS_WORKERS, _cpu_worker_init)
    return {"pool": pool,
            "oracle25": pool.map_async(oracle_answers, oracle_jobs(1), chunksize=1),
            "tpcds": pool.map_async(tpcds_cpu_answer,
                                    [(q, _tpcds_check_sf(q)) for q in queries], chunksize=1),
            "tpcds_oracle": pool.map_async(
                oracle_answers, [("tpcds", _tpcds_check_sf(q), [q]) for q in queries],
                chunksize=1)}


#: every split the port's generators made in this process, under
#: :func:`generated_once`: (connector, sf, seed, table, chunk, lo, hi) ->
#: all its columns
GENERATED: dict = {}


def _connector_classes() -> tuple:
    from presto_tpu_torch.connectors.ssb import SsbConnector
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    return TpchConnector, SsbConnector, TpcdsConnector


@contextlib.contextmanager
def generated_once():
    """While in the block, the TPC-H, SSB and TPC-DS connectors generate
    each split once, all its columns, into ``GENERATED``, and answer every
    ``scan_numpy`` from it: the asked columns with their ``$valid`` masks.
    Generation is set-up, as loading data is: :func:`prefill` does it up
    front, so walls and connector-scan seconds hold narrowing and copies
    only."""
    originals = {cls: cls.scan_numpy for cls in _connector_classes()}

    def memo(cls, original):
        def scan_numpy(self, split, columns=None):
            key = (cls.__name__, self.sf, self.gen.seed, split.table, split.chunk, split.lo,
                   split.hi)
            full = GENERATED.get(key)
            if full is None:
                full = GENERATED[key] = original(self, split)
            if columns is None:
                return dict(full)
            return {k: full[k] for c in columns for k in (c, f"{c}$valid") if k in full}
        return scan_numpy

    for cls, original in originals.items():
        cls.scan_numpy = memo(cls, original)
    try:
        yield GENERATED
    finally:
        for cls, original in originals.items():
            cls.scan_numpy = original
        GENERATED.clear()


def prefill(*conns) -> tuple:
    """Generate every split of every table of ``conns`` (inside
    :func:`generated_once`). Returns (seconds, GiB held in ``GENERATED``)."""
    t0 = time.perf_counter()
    for conn in conns:
        for table in conn.tables():
            for split in conn.splits(table):
                conn.scan_numpy(split)
    held = sum(a.nbytes for arrays in GENERATED.values() for a in arrays.values())
    return time.perf_counter() - t0, held / 2**30


def _sort_or_fold(op: str) -> str | None:
    """'index_add_' for the sort strategy's fold (``indexFunc*``), 'sort'
    for a sort's kernels, else None."""
    if "indexFunc" in op:
        return "index_add_"
    if "sort" in op.lower():
        return "sort"
    return None


def tpcds_sf1_runs(conn, queries: dict, device: str) -> dict:
    """Phase 16's runs at SF1 (``conn``'s data generated as set-up): q3,
    q7, q97 and q98's numpy oracles, then one run of each query under the
    profiler's CUDA tracing: its wall, device busy ms and largest ops,
    counters against its plan, launches, peak memory and oracle.
    ``phase_s`` holds the host seconds of the oracles, the plans, the
    runs and the tracing's own work after each run (the profiler's exit
    and the reading of its events)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    cached = ColumnCache(conn)
    want = {q: fn(cached) for q, fn in TPCDS_ORACLES.items()}
    del cached
    phase_s = {"oracles": time.perf_counter() - t0, "plans": 0.0, "runs": 0.0,
               "tracing after the runs": 0.0}
    log(f"phase 16: numpy recomputation of {sorted(want)} at SF{TPCDS_SF:g} in "
        f"{phase_s['oracles']:.1f} s; rows "
        f"{ {q: len(next(iter(w.values()))) for q, w in want.items()} }")
    out = {"walls": {}, "launches": {}, "routes": {}, "peak_gib": {}, "fold_ms": {},
           "sort_ms": {}, "capacities": {}, "phase_s": phase_s}
    query = {"name": None}
    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls:
        for name, sql in queries.items():
            session = measured_session({"tpcds": conn}, device=device)
            t0 = time.perf_counter()
            predicted = planned_routes(session, sql)
            phase_s["plans"] += time.perf_counter() - t0
            query["name"] = name
            try:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                with expand_capacities() as caps, timed_scans(conn) as scans, \
                        profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    res = session.sql(sql)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                n = _launch_counts()
                route = counters()
            finally:
                query["name"] = None
            busy_ms, ops = trace_device_ops(prof)
            del prof
            phase_s["runs"] += wall
            phase_s["tracing after the runs"] += time.perf_counter() - t0 - wall
            if name in want:
                close_result(res, want[name], f"{name} at SF{TPCDS_SF:g}",
                             TPCDS_DOUBLES.get(name, ()))
            got = {k: v for k, v in route.items()
                   if k.startswith(("join.strategy.", "agg.strategy.")) and v}
            expand = "join.strategy.expand"
            check({k: v for k, v in got.items() if k != expand}
                  == {k: v for k, v in predicted.items() if k != expand}
                  and got.get(expand, 0) >= predicted.get(expand, 0),
                  f"{name}: strategy counters {got}, the plan predicts {predicted}")
            check(route.get("exec.pallas_join_route", 0) == got.get("join.strategy.pallas", 0)
                  and route.get("join.pallas_fallback", 0) == 0,
                  f"{name}: fused-probe routes {route}")
            check_vector_probes(name, n)
            out["launches"][name] = n
            out["capacities"][name] = list(caps)
            out["routes"][name] = {**got, **{k: v for k, v in route.items()
                                             if k.startswith("exec.") and v}}
            out["peak_gib"][name] = ((peak - held) / 2**30, held / 2**30)
            scan_s = scans[0]
            out["walls"][name] = (wall, busy_ms, scan_s, len(res))
            for kind, key in (("index_add_", "fold_ms"), ("sort", "sort_ms")):
                out[key][name] = sum(ms for k, ms, _c in ops if _sort_or_fold(k) == kind)
            log(f"  {name} at SF{TPCDS_SF:g}: {len(res)} rows"
                + (" equal to numpy" if name in want else "")
                + f"; wall {wall:.3f} s (traced); device busy {busy_ms:.1f} ms (index_add_ "
                f"{out['fold_ms'][name]:.1f}, sorts {out['sort_ms'][name]:.1f}), connector "
                f"scans {scan_s:.3f} s; peak device "
                f"memory {out['peak_gib'][name][0]:.3f} GiB over {held / 2**30:.3f} held; "
                f"launches { {k: v for k, v in n.items() if v and isinstance(v, int)} }; "
                f"routes {out['routes'][name]} (planned {predicted})"
                + (f"; expansion capacities {list(caps)}" if caps else ""))
            log(f"  {name} largest device ops (ms, calls): "
                + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in ops[:5]))
    # what the tracing adds to a wall: a light and a heavy query again,
    # untraced (outside the counts and launch shapes kept above)
    out["untraced"] = {}
    for name in TPCDS_UNTRACED:
        session = measured_session({"tpcds": conn}, device=device)
        t0 = time.perf_counter()
        session.sql(queries[name])
        torch.cuda.synchronize()
        out["untraced"][name] = time.perf_counter() - t0
    log("  the tracing's cost on a wall: " + "; ".join(
        f"{q} traced {out['walls'][q][0]:.3f} s, untraced {w:.3f} s"
        for q, w in out["untraced"].items()))
    out["probes"], out["calls"] = probes, calls
    return out


def run_tpcds_queries(cpu_answers, device: str = "cuda") -> dict:
    """Phase 16: the 99 TPC-DS queries through ``Session.sql`` on the
    card at SF1, every table generated once up front (:func:`prefill`),
    one run a query under the profiler's CUDA tracing: its strategy
    counters equal to its plan's (``expand`` at least the plan's: it
    counts each capacity the retry ladder tries), its wall and
    connector-scan seconds, device busy ms and five largest device ops,
    launches per kernel and peak device memory; q3, q7, q97 and q98 equal
    to numpy oracles; every lane-sums, leaf, LIKE, exists and payload
    launch shape held to the plain version; then every query at
    ``TPCDS_CHECK_SF`` (or ``TPCDS_SMALL_SF``) equal to the port's CPU
    answer (``cpu_answers``: the pool's pending results), rows in order,
    and to the numpy oracle (``same_as_oracle``), each computed by the
    pool."""
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    queries = _tpcds_queries()
    conn = TpcdsConnector(sf=TPCDS_SF, device=device)
    setup_s, held_gib = prefill(conn)
    log(f"phase 16: generated every split of the 23 tables at SF{TPCDS_SF:g} in {setup_s:.1f} "
        f"s (set-up; {held_gib:.3f} GiB of generated data on the host in all)")
    out = tpcds_sf1_runs(conn, queries, device)
    out["phase_s"]["generation"] = setup_s
    probes, calls = out["probes"], out["calls"]
    out["probe_err"] = hold_probe_shapes(probes)
    out["call_err"] = hold_kernel_calls(calls)
    for mode in ("exists", "payload"):
        held_rows = {rows for m, rows, _key in probes if m == mode}
        ran = {rows for n in out["launches"].values() for rows in n["probe_by_shape"][mode]}
        check(held_rows == ran, f"phase 16's {mode} launches at rows {sorted(ran)}, held to "
              f"the plain version at {sorted(held_rows)}")
    for kernel in ("lane_sums", "leaf_agg", "like"):
        ran = sum(n[kernel] for n in out["launches"].values())
        held_shapes = [shape for k, shape in calls if k == kernel]
        check((ran > 0) == bool(held_shapes), f"phase 16's {kernel}: {ran} launches, shapes "
              f"held {held_shapes}")
    check(all(n["sketch"] == 0 and n["q1"] == 0 and n["q3"] == 0 and n["prefix"] == 0
              for n in out["launches"].values()),
          "phase 16 launched a kernel its plans do not route to")
    busy = sum(w[1] for w in out["walls"].values())
    fold = sum(out["fold_ms"].values())
    sorts = sum(out["sort_ms"].values())
    out["busy_ms"] = busy
    log(f"  phase 16's device busy time {busy:.1f} ms over walls of "
        f"{sum(w[0] for w in out['walls'].values()):.1f} s: index_add_ (the sort strategy's "
        f"fold) {fold:.1f} ms = {100 * fold / max(busy, 1e-9):.1f} %, sorts {sorts:.1f} ms = "
        f"{100 * sorts / max(busy, 1e-9):.1f} %")
    for k in ("lane_sums", "like", "leaf_agg", "exists", "payload"):
        out[f"{k}_launches"] = sum(n[k] for n in out["launches"].values())
    # every query on the card against the port's CPU answer
    t0 = time.perf_counter()
    check_conns = {sf: TpcdsConnector(sf=sf, device=device)
                   for sf in (TPCDS_CHECK_SF, TPCDS_SMALL_SF)}
    card, logical = {}, {}
    for name, sql in queries.items():
        sf = _tpcds_check_sf(name)
        session = measured_session({"tpcds": check_conns[sf]}, device=device)
        res = session.sql(sql)
        card[name] = (sf, answer_of(res))
        logical[name] = [res.logical(n) for n in res.names]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers = cpu_answers["tpcds"].get()
    oracles = [a for job in cpu_answers["tpcds_oracle"].get() for a in job]
    wait_s = time.perf_counter() - t0
    cpu_s = {}
    for name, sf, seconds, answer in answers:
        check(card[name][0] == sf, f"{name}: card at sf {card[name][0]}, CPU at sf {sf}")
        same_answer(card[name][1], answer, f"{name} at sf {sf:g}, card against CPU")
        cpu_s[name] = seconds
    check(sorted(cpu_s) == sorted(queries), "phase 16: a CPU answer is missing")
    oracle_s = {}
    for name, sf, seconds, cols in oracles:
        check(card[name][0] == sf, f"{name}: card at sf {card[name][0]}, oracle at sf {sf}")
        check(len(cols[0]) > 0, f"phase 16 {name}: the numpy oracle's answer is empty")
        same_as_oracle(logical[name], cols, f"{name} at sf {sf:g}, card against the numpy "
                       "oracle")
        oracle_s[name] = seconds
    check(sorted(oracle_s) == sorted(queries), "phase 16: an oracle answer is missing")
    out["cpu_s"], out["oracle_s"] = cpu_s, oracle_s
    log(f"  phase 16: all {len(cpu_s)} queries on the card equal the port's CPU answers "
        f"(sf {TPCDS_CHECK_SF:g}; sf {TPCDS_SMALL_SF:g} for "
        f"{sorted(TPCDS_CHECK_SMALL | TPCDS_EMPTY_AT_CHECK_SF)}), rows "
        "in order, "
        f"DOUBLE columns within {DOUBLE_TOL}; card runs {card_s:.1f} s, waited {wait_s:.1f} s "
        f"for the CPU; CPU seconds by query "
        + ", ".join(f"{q} {s:.1f}" for q, s in sorted(cpu_s.items(), key=lambda kv: -kv[1])))
    log(f"  phase 16: all {len(oracle_s)} card answers equal the numpy oracle "
        f"(presto_tpu_torch/oracle/tpcds_oracle.py; same_as_oracle); oracle host seconds "
        f"{sum(oracle_s.values()):.1f} in all, by query "
        + ", ".join(f"{q} {s:.2f}" for q, s in sorted(oracle_s.items(), key=lambda kv: -kv[1])))
    out["phase_s"].update({"card runs at the check sf": card_s, "wait for the CPU": wait_s})
    log("  phase 16's host seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["phase_s"].items()))
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
    bits = {name: plan_filter_bits(measured_session({"tpch": conn}, device=device), sql)
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
        session = measured_session({"tpch": c}, properties={"approx_join": approx}, device=device)
        if name == "q4":
            cuda_groupby.fused_lane_sums = capture_lane
        try:
            with (first_probe(*probes[name]) if name in probes
                  else contextlib.nullcontext({})) as seen:
                REGISTRY.reset()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.sql(sql)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                n = _launch_counts()
                route = counters()
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
            # Q4's date bounds arrive as plan-template slots (the leaf
            # matcher declined the 6M-key membership fold when it chose
            # the slots), which the matcher then declines, as in the JAX
            # package
            check(route.get("exec.leaf_route_fallback.filter_shape", 0) == 1,
                  f"{name}: the leaf route did not decline Q4's slotted date filter")
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
            f"connector scans (narrowing + copy to the card) {scan_s:.3f} s")
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


# ---------------------------------------------------------------------------
# phase 17: CREATE TABLE AS / INSERT / DROP, EXPLAIN ANALYZE and execute,
# PREPARE / EXECUTE over the memory connector
# ---------------------------------------------------------------------------

LEAF_CTAS = ("create table leaf_t as select l_linenumber k, l_partkey v, l_suppkey p "
             "from lineitem")
LEAF_INSERT = ("insert into leaf_t select l_linenumber k, l_partkey v, l_suppkey p "
               "from lineitem where l_quantity < 10")
LEAF_GROUP = ("select k, sum(v) sv, count(*) c, min(p) mn, max(p) mx "
              "from leaf_t group by k order by k")
#: the integer columns TPC-DS q3 reads, copied into memory tables (whose
#: exact stats the generator tables do not declare)
STAR_CTAS = {
    "ss_t": "create table ss_t as select ss_sold_date_sk, ss_item_sk, ss_quantity "
            "from store_sales",
    "dd_t": "create table dd_t as select d_date_sk, d_year, d_moy from date_dim",
    "it_t": "create table it_t as select i_item_sk, i_brand_id, i_manufact_id from item",
}
#: q3's shape over the copies, with an integer measure (an exact oracle)
STAR_SQL = ("select d_year, i_brand_id as brand_id, sum(ss_quantity) as sum_agg "
            "from dd_t, ss_t, it_t "
            "where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk "
            "and i_manufact_id <= 50 and d_moy = 11 "
            "group by d_year, i_brand_id order by d_year, sum_agg desc, brand_id limit 100")
#: a Q1-shaped group-by: scan -> filter -> aggregate, every node's rows
#: countable in numpy
Q1_SHAPED = ("select l_returnflag, l_linestatus, sum(l_quantity) sq, count(*) c "
             "from lineitem where l_shipdate <= date '1998-09-02' "
             "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
Q6_PREPARE = ("prepare q6p from select sum(l_extendedprice * l_discount) as revenue "
              "from lineitem where l_shipdate >= ? and l_shipdate < ? "
              "and l_discount between ? and ? and l_quantity < ?")
Q6_LITERAL = ("select sum(l_extendedprice * l_discount) as revenue from lineitem "
              "where l_shipdate >= date '{0}' and l_shipdate < date '{1}' "
              "and l_discount between {2} and {3} and l_quantity < {4}")
#: (ship from, ship to, discount from, discount to, quantity below)
Q6_BINDINGS = (("1994-01-01", "1995-01-01", "0.05", "0.07", "24"),
               ("1995-01-01", "1996-01-01", "0.02", "0.04", "30"),
               ("1993-06-01", "1994-06-01", "0.06", "0.09", "12"))


def leaf_expected(cols: dict) -> dict:
    """``LEAF_GROUP`` in int64 numpy over the columns ``k``, ``v``, ``p``."""
    keys, inv = np.unique(cols["k"], return_inverse=True)
    # float64 sums are exact below 2^53 (at most 1.3e12 here)
    sv = np.bincount(inv, weights=cols["v"].astype(np.float64)).astype(np.int64)
    mn = np.full(len(keys), np.iinfo(np.int64).max)
    mx = np.full(len(keys), np.iinfo(np.int64).min)
    np.minimum.at(mn, inv, cols["p"].astype(np.int64))
    np.maximum.at(mx, inv, cols["p"].astype(np.int64))
    return {"k": keys, "sv": sv, "c": np.bincount(inv), "mn": mn, "mx": mx}


def leaf_columns(conn, insert: bool = False) -> dict:
    """``leaf_t``'s columns from the generator's arrays: after
    ``LEAF_CTAS``, or after ``LEAF_INSERT`` too."""
    li = conn.table_numpy("lineitem", ["l_linenumber", "l_partkey", "l_suppkey", "l_quantity"])
    cols = {"k": li["l_linenumber"].astype(np.int64), "v": li["l_partkey"].astype(np.int64),
            "p": li["l_suppkey"].astype(np.int64)}
    if insert:
        m = li["l_quantity"] < 1000  # decimal(12,2): 10.00
        cols = {c: np.concatenate([a, a[m]]) for c, a in cols.items()}
    return cols


def star_expected(conn) -> dict:
    """``STAR_SQL`` in int64 numpy from the TPC-DS generator's arrays: the
    inner joins drop NULL keys, the sum skips NULL quantities."""
    f = _fact_dim(conn, "store_sales", "ss", ["ss_quantity"])
    d = conn.table_numpy("date_dim", ["d_year", "d_moy"])
    it = conn.table_numpy("item", ["i_brand_id", "i_manufact_id"])
    keep = (it["i_manufact_id"][f["irow"]] <= 50) & (d["d_moy"][f["drow"]] == 11)
    year = d["d_year"][f["drow"]][keep].astype(np.int64)
    brand = it["i_brand_id"][f["irow"]][keep].astype(np.int64)
    qty = f["ss_quantity"][keep].astype(np.int64)
    ok = _valid(f, "ss_quantity")[keep]
    groups, inv = np.unique(np.stack([year, brand]), axis=1, return_inverse=True)
    inv = inv.ravel()
    sums = np.bincount(inv, weights=np.where(ok, qty, 0).astype(np.float64),
                       minlength=groups.shape[1]).astype(np.int64)
    check(bool((np.bincount(inv, weights=ok, minlength=groups.shape[1]) > 0).all()),
          "star join oracle: a group of NULL quantities only")
    order = np.lexsort((groups[1], -sums, groups[0]))[:100]
    return {"d_year": groups[0][order], "brand_id": groups[1][order], "sum_agg": sums[order]}


def q6_binding_expected(li: dict, binding) -> dict:
    """One ``Q6_BINDINGS`` row's revenue on physical values."""
    lo, hi, dlo, dhi, qty = binding
    ship, disc, q = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    m = ((ship >= days(lo)) & (ship < days(hi)) & (disc >= round(float(dlo) * 100))
         & (disc <= round(float(dhi) * 100)) & (q < int(qty) * 100))
    return revenue(li["l_extendedprice"], li["l_discount"], m)


def q1_shaped_counts(conn) -> dict:
    """Rows of ``Q1_SHAPED``'s scan, filter and aggregate in numpy."""
    li = conn.table_numpy("lineitem", ["l_shipdate", "l_returnflag", "l_linestatus"])
    m = li["l_shipdate"] <= CUTOFF
    groups = np.unique(li["l_returnflag"][m].astype(np.int64) * 2 + li["l_linestatus"][m])
    return {"TableScan": len(m), "Filter": int(m.sum()), "Aggregate": len(groups)}


def q3_node_counts(conn) -> dict:
    """Rows of Q3's orders and customer scans and filters in numpy (the
    build sides: no runtime filter prunes them)."""
    o = conn.table_numpy("orders", ["o_orderdate"])
    c = conn.table_numpy("customer", ["c_mktsegment"])
    building = conn.dictionaries("customer")["c_mktsegment"].code_of("BUILDING")
    return {"orders": (len(o["o_orderdate"]), int((o["o_orderdate"] < days("1995-03-15")).sum())),
            "customer": (len(c["c_mktsegment"]), int((c["c_mktsegment"] == building).sum()))}


_ANALYZED_LINE = re.compile(r"^(\s*)(\w+)  \[(?:wall ([\d.]+)ms, rows ([\d,?]+)->([\d,?]+)"
                            r"|not executed)")


def analyzed_nodes(text: str, plan) -> list:
    """EXPLAIN ANALYZE's node lines beside the plan's nodes in pre-order:
    (node, wall ms or None, rows in or None, rows out or None, line)."""
    nodes = []

    def walk(n):
        nodes.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    lines = [ln for ln in text.splitlines() if _ANALYZED_LINE.match(ln)]
    check(len(lines) == len(nodes), f"EXPLAIN ANALYZE: {len(lines)} node lines for "
          f"{len(nodes)} plan nodes:\n{text}")
    out = []
    for node, line in zip(nodes, lines):
        m = _ANALYZED_LINE.match(line)
        check(m.group(2) == type(node).__name__, f"EXPLAIN ANALYZE line {line!r} for a "
              f"{type(node).__name__}")

        def num(g):
            return None if g is None or g == "?" else int(g.replace(",", ""))

        out.append((node, None if m.group(3) is None else float(m.group(3)), num(m.group(4)),
                    num(m.group(5)), line))
    return out


#: earlier phases' statements whose literals now arrive as plan-template
#: slots (a slot has no static interval: Q12's and ``math``'s sums lose
#: their value bounds, so the lane-sums kernel, as in the JAX package);
#: Q1 and Q6 keep theirs baked (leaf-route fragments)
TEMPLATE_CHECKS = {"q1": QUERIES["q1"], "q6": QUERIES["q6"], "q3": QUERIES["q3"],
                   "q10": QUERIES["q10"], "q12": QUERIES["q12"], "q14": QUERIES["q14"],
                   "math": SURFACE_SQL["math"]}


def templates_on_off(conn, device: str, sync, query: dict) -> dict:
    """Each ``TEMPLATE_CHECKS`` statement with ``plan_templates`` on and
    off, in turns (on, off, on, off) within this run: each run's launches
    (under ``query["name"]``, so the callers' capture blocks hold their
    shapes), the device busy ms of one more, profiled run (on the card)
    and its three device ops with the most time. Both answers equal."""
    out = {"launches": {}}
    for name, sql in TEMPLATE_CHECKS.items():
        busy = {True: [], False: []}
        top = {}
        answers = {}
        for turn, on in enumerate((True, False, True, False)):
            session = measured_session({"tpch": conn}, properties={"plan_templates": on}, device=device)
            run = f"{name} templates {'on' if on else 'off'} {turn // 2}"
            query["name"] = run
            try:
                _reset_launches()
                res = session.sql(sql)
                sync()
                out["launches"][run] = _launch_counts()
                answers[on] = answer_of(res)
                busy_ms, _scan_s, ops = (device_ops(session, conn, sql) if device == "cuda"
                                         else (0.0, 0.0, []))
            finally:
                query["name"] = None
            busy[on].append(busy_ms)
            top[on] = ops[:3]
        same_answer(answers[True], answers[False], f"{name}, plan_templates on against off")
        lanes = {on: [out["launches"][f"{name} templates {'on' if on else 'off'} {i}"]
                      ["lane_sums"] for i in (0, 1)] for on in (True, False)}
        out[name] = {"on_ms": busy[True], "off_ms": busy[False], "lane_sums_on": lanes[True],
                     "lane_sums_off": lanes[False]}
        log(f"  {name}, plan_templates on / off: device busy {busy[True]} / {busy[False]} ms, "
            f"lane-sums launches {lanes[True]} / {lanes[False]}; the last runs' top device "
            f"ops (name ms calls): on "
            + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in top[True]) + "; off "
            + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in top[False]))
    return out


def run_statement_queries(tconn, dsconn, ds_walls: dict, device: str = "cuda") -> dict:
    """Phase 17 at SF1, on the splits ``prefill`` generated: CTAS of
    ``lineitem``'s integer columns, its group-by on the leaf route (the
    leaf kernel), INSERT of a filtered copy, the group-by again (stats
    merged), DROP, the catalog version at each step; the TPC-DS q3 star
    join over CTAS copies (the memory connector's exact stats) beside
    phase 16's q3; EXPLAIN ANALYZE and ``execute`` of Q3 and a Q1-shaped
    group-by, every countable node's rows against numpy; PREPARE /
    EXECUTE of Q6 under three bindings and of Q3 with its literals
    auto-slotted. Every answer equal to its numpy oracle; every launch
    shape of the lane-sums, leaf, exists and payload kernels held to the
    plain version. On the CPU (``device="cpu"``, the tests) it runs at any
    scale with no device profile."""
    from presto_tpu_torch.plan import nodes as PN

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    want = {"leaf": leaf_expected(leaf_columns(tconn)),
            "leaf after insert": leaf_expected(leaf_columns(tconn, insert=True)),
            "star": star_expected(dsconn), "q3": q3_expected(tconn),
            "q1 shaped": q1_shaped_counts(tconn), "q3 nodes": q3_node_counts(tconn)}
    li = tconn.table_numpy("lineitem", Q6_COLS)
    want.update({f"q6 binding {i}": q6_binding_expected(li, b)
                 for i, b in enumerate(Q6_BINDINGS)})
    del li
    log(f"phase 17: numpy recomputation at SF{tconn.sf:g} (TPC-DS SF{dsconn.sf:g}) in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"walls": {}, "launches": {}, "routes": {}, "steps": {}}
    query = {"name": None}

    def run(session, name: str, sql: str):
        """One statement: (result, wall s); its launches and counters."""
        query["name"] = name
        try:
            REGISTRY.reset()
            _reset_launches()
            sync()
            t0 = time.perf_counter()
            res = session.sql(sql)
            sync()
            wall = time.perf_counter() - t0
            out["launches"][name] = _launch_counts()
            out["routes"][name] = {k: v for k, v in counters().items() if v}
        finally:
            query["name"] = None
        n = out["launches"][name]
        out["steps"][name] = wall
        log(f"  {name}: wall {wall:.3f} s; launches "
            f"{ {k: n[k] for k in ('lane_sums', 'leaf_agg', 'exists', 'payload') if n[k]} }; "
            f"counters {out['routes'][name]}")
        return res, wall

    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls:
        # ---- CTAS, INSERT, DROP over lineitem's integer columns -------------
        session = measured_session({"tpch": tconn}, device=device)
        cat, mem = session.catalog, session.catalog.connector("memory")
        res, _ = run(session, "ctas leaf_t", LEAF_CTAS)
        check(list(res.column("rows")) == [int(want["leaf"]["c"].sum())],
              f"CTAS rows {list(res.column('rows'))}")
        check(cat.version("leaf_t") == 1, f"catalog version {cat.version('leaf_t')} after CTAS")
        for col, a in leaf_columns(tconn).items():
            st = mem.stats("leaf_t", col)
            check((st.min_value, st.max_value, st.ndv, st.null_fraction)
                  == (int(a.min()), int(a.max()), float(len(np.unique(a))), 0.0),
                  f"leaf_t.{col} stats {st}")
        log(f"  leaf_t physical storage {mem.physical_schema('leaf_t')}")
        res, _ = run(session, "leaf group-by", LEAF_GROUP)
        same_result(res, want["leaf"], "leaf_t group-by")
        check(out["routes"]["leaf group-by"].get("exec.leaf_fused_route", 0) == 1
              and (device != "cuda" or out["launches"]["leaf group-by"]["leaf_agg"] > 0),
              f"leaf_t group-by did not take the leaf route: {out['routes']['leaf group-by']}")
        res, _ = run(session, "insert leaf_t", LEAF_INSERT)
        inserted = int(want["leaf after insert"]["c"].sum() - want["leaf"]["c"].sum())
        check(list(res.column("rows")) == [inserted], f"INSERT rows {list(res.column('rows'))}")
        check(cat.version("leaf_t") == 2, f"catalog version {cat.version('leaf_t')} after INSERT")
        res, _ = run(session, "leaf group-by after insert", LEAF_GROUP)
        same_result(res, want["leaf after insert"], "leaf_t group-by after INSERT")
        check(out["routes"]["leaf group-by after insert"].get("exec.leaf_fused_route", 0) == 1,
              "leaf_t group-by after INSERT did not take the leaf route")
        res, _ = run(session, "drop leaf_t", "drop table leaf_t")
        check(list(res.column("dropped")) == ["leaf_t"] and "leaf_t" not in mem.tables()
              and cat.version("leaf_t") == 3, "DROP TABLE leaf_t")

        # ---- the star join over CTAS copies of TPC-DS columns ---------------
        ds = measured_session({"tpcds": dsconn}, device=device)
        ctas_s = 0.0
        for table, sql in STAR_CTAS.items():
            _res, wall = run(ds, f"ctas {table}", sql)
            ctas_s += wall
        dmem = ds.catalog.connector("memory")
        log(f"  star copies' physical storage: "
            f"{ {t: dmem.physical_schema(t) for t in STAR_CTAS} }")
        res, first = run(ds, "star join", STAR_SQL)
        same_result(res, want["star"], "star join over CTAS copies")
        t0 = time.perf_counter()
        again = ds.sql(STAR_SQL)
        sync()
        second = time.perf_counter() - t0
        same_result(again, want["star"], "star join over CTAS copies, second run")
        busy_ms, scan_s, ops = (device_ops(ds, dmem, STAR_SQL) if device == "cuda"
                                else (0.0, 0.0, []))
        out["walls"]["star join"] = (first, second, busy_ms, scan_s)
        q3w = ds_walls.get("q3")
        log(f"  star join: wall first {first:.3f} s, second {second:.3f} s, device busy "
            f"{busy_ms:.1f} ms, memory scans {scan_s:.3f} s; phase 16's q3 over the "
            f"generator tables: wall {q3w[0]:.3f} s (traced), busy {q3w[1]:.1f} ms; the CTAS "
            f"copies took {ctas_s:.3f} s; device ops: "
            + "; ".join(f"{k} {ms:.2f} ({c})" for k, ms, c in ops[:5]))

        # ---- EXPLAIN ANALYZE and execute ------------------------------------
        walls = {}
        for name, sql in (("q1 shaped", Q1_SHAPED), ("q3", QUERIES["q3"])):
            plan = session.plan(sql)
            query["name"] = f"explain analyze {name}"
            try:
                REGISTRY.reset()
                _reset_launches()
                t0 = time.perf_counter()
                text = session.explain_analyze(sql)
                sync()
                out["steps"][f"explain analyze {name}"] = time.perf_counter() - t0
                out["launches"][f"explain analyze {name}"] = _launch_counts()
            finally:
                query["name"] = None
            n = out["launches"][f"explain analyze {name}"]
            check(n["leaf_agg"] == 0 and n["q1"] == 0,
                  f"explain analyze {name} took the leaf route: {n}")
            nodes = analyzed_nodes(text, plan)
            walls[name] = [(type(nd).__name__, w) for nd, w, _i, _o, _l in nodes]
            for nd, _w, _rin, rout, line in nodes:
                kind = type(nd).__name__
                if name == "q1 shaped" and kind in want["q1 shaped"]:
                    check(rout == want["q1 shaped"][kind], f"{name}: {line}")
                if name == "q1 shaped" and kind == "Aggregate":
                    check("strategy=partial" in line, f"{name}: {line}")
                if name == "q3" and kind == "TableScan" and nd.table in want["q3 nodes"]:
                    check(rout == want["q3 nodes"][nd.table][0], f"q3: {line}")
                if (name == "q3" and kind == "Filter" and isinstance(nd.child, PN.TableScan)
                        and nd.child.table in want["q3 nodes"]):
                    check(rout == want["q3 nodes"][nd.child.table][1], f"q3: {line}")
                if kind == "TopN":
                    check(rout == 10, f"{name}: {line}")
            log(f"  explain analyze {name}:\n" + "\n".join(
                "    " + ln for ln in text.splitlines()))
        for name, sql in (("q1 shaped", Q1_SHAPED), ("q3", QUERIES["q3"])):
            query["name"] = f"execute {name}"
            try:
                REGISTRY.reset()
                _reset_launches()
                t0 = time.perf_counter()
                res, info = session.execute(sql)
                sync()
                out["steps"][f"execute {name}"] = time.perf_counter() - t0
                out["launches"][f"execute {name}"] = _launch_counts()
            finally:
                query["name"] = None
            plain, _ = run(session, f"{name} sql beside execute", sql)
            check(info.state == "FINISHED" and info.output_rows == len(res) == len(plain),
                  f"execute {name}: {info.state}, {info.output_rows} rows, sql {len(plain)}")
            for c in res.names:
                check(list(res.column(c)) == list(plain.column(c)),
                      f"execute {name}: column {c} differs from Session.sql")
            if name == "q3":
                same_result(res, want["q3"], "execute q3")
            log(f"  execute {name}: {info.output_rows} rows equal to Session.sql's; "
                f"{len(info.node_stats)} node stats; planning {info.planning_s:.4f} s, "
                f"execution {info.execution_s:.3f} s")
        out["node_walls"] = walls

        # ---- PREPARE / EXECUTE ------------------------------------------------
        run(session, "prepare q6p", Q6_PREPARE)
        prep = {}
        for i, b in enumerate(Q6_BINDINGS):
            using = f"date '{b[0]}', date '{b[1]}', {b[2]}, {b[3]}, {b[4]}"
            res, _ = run(session, f"execute q6p {i}", f"execute q6p using {using}")
            same_result(res, want[f"q6 binding {i}"], f"execute q6p binding {i}")
            lit, _ = run(session, f"q6 literal {i}", Q6_LITERAL.format(*b))
            same_result(lit, want[f"q6 binding {i}"], f"q6 literal statement {i}")
            prep[i] = out["routes"][f"execute q6p {i}"]
        res, _ = run(session, "prepare q3p", f"prepare q3p from {QUERIES['q3']}")
        check(list(res.column("prepared")) == ["q3p"], "PREPARE q3p")
        res, _ = run(session, "execute q3p", "execute q3p")
        same_result(res, want["q3"], "execute q3p (auto-slotted literals)")
        res, _ = run(session, "q3 sql", QUERIES["q3"])
        same_result(res, want["q3"], "Q3 through Session.sql (auto-parameterized)")
        handle = session._prepared["q3p"]
        log(f"  q3p: {len(handle.auto_slots)} auto slots "
            f"{[(str(s.dtype), s.value) for s in handle.auto_slots]}, Q3's counters "
            f"{out['routes']['prepare q3p']}")
        run(session, "deallocate q6p", "deallocate prepare q6p")
        out["prepared_q6_routes"] = prep
        out["q6_leaf_launches"] = {i: out["launches"][f"execute q6p {i}"]["leaf_agg"]
                                   for i in range(len(Q6_BINDINGS))}
        log(f"  prepared Q6 (user slots): counters {prep}; leaf-kernel launches "
            f"{out['q6_leaf_launches']}; literal Q6: leaf launches "
            f"{[out['launches'][f'q6 literal {i}']['leaf_agg'] for i in range(3)]}")

        # ---- earlier phases' statements, plan templates on and off ----------
        out["templates"] = templates_on_off(tconn, device, sync, query)
    out["probes"] = probes
    out["probe_err"] = hold_probe_shapes(probes)
    out["calls"] = calls
    out["call_err"] = hold_kernel_calls(calls)
    # every run of the phase, the on / off turns included: each launch
    # shape held to the plain version, each run that launched a kernel
    # among the queries whose calls were held
    every = {**out["launches"], **out["templates"]["launches"]}
    for mode in ("exists", "payload") if device == "cuda" else ():
        held = {rows for m, rows, _key in probes if m == mode}
        ran = {rows for n in every.values() for rows in n["probe_by_shape"][mode]}
        check(held == ran, f"phase 17's {mode} launches at rows {sorted(ran)}, held to the "
              f"plain version at {sorted(held)}")
    for kernel in ("lane_sums", "leaf_agg", "like") if device == "cuda" else ():
        ran = sum(n[kernel] for n in every.values())
        held = [shape for k, shape in calls if k == kernel]
        check((ran > 0) == bool(held), f"phase 17's {kernel}: {ran} launches, shapes held "
              f"{held}")
        log(f"  phase 17's {kernel} shapes held to plain: "
            f"{sorted((str(shape), t['query']) for (k, shape), t in calls.items() if k == kernel)}")
    check(all(n["sketch"] == 0 and n["q1"] == 0 and n["q3"] == 0 and n["prefix"] == 0
              for n in out["launches"].values()),
          "phase 17 launched a kernel its plans do not route to")
    for k in ("lane_sums", "like", "leaf_agg", "exists", "payload"):
        out[f"{k}_launches"] = sum(n[k] for n in out["launches"].values())
    log(f"  phase 17's steps (s): { {k: round(v, 3) for k, v in out['steps'].items()} }")
    return out


# ---------------------------------------------------------------------------
# phase 18: the observability core (metrics, span traces, fault points)
# ---------------------------------------------------------------------------

#: the trace token phase 18's sessions tag their spans (and, with
#: ``profile_annotations``, their profiler annotations) with
OBS_TOKEN = "phase18"
#: phase 18's traced statements: name -> (how it runs, SQL, the kernel
#: its plan routes to)
OBS_RUNS = {"q1": ("sql", QUERIES["q1"], "q1"), "q6": ("sql", QUERIES["q6"], "leaf_agg"),
            "q3": ("sql", QUERIES["q3"], "exists"),
            "q1 shaped": ("execute", Q1_SHAPED, "lane_sums")}
#: the statements of the tracing-overhead rule
OVERHEAD_RUNS = ("q1", "q6", "q3")
#: each traced kernel's device function names, as the profiler sees them
OBS_KERNELS = {"q1": ("q1_kernel",), "lane_sums": ("lane_sums_kernel",),
               "leaf_agg": ("leaf_agg_kernel", "leaf_staged_kernel"),
               "exists": ("exists_kernel",)}
#: the spans a kernel launch must lie in (a fused route launches inside
#: its aggregate's lifecycle dispatch, ``fragment:Aggregate``)
LAUNCH_SPANS = ("step:", "finish:", "node:", "fragment:")


def q1_shaped_expected(conn) -> dict:
    """``Q1_SHAPED`` in int64 numpy, groups in key order."""
    li = conn.table_numpy("lineitem", ["l_shipdate", "l_returnflag", "l_linestatus",
                                       "l_quantity"])
    m = li["l_shipdate"] <= CUTOFF
    gid = li["l_returnflag"][m].astype(np.int64) * 2 + li["l_linestatus"][m]
    sq = np.zeros(6, np.int64)
    np.add.at(sq, gid, li["l_quantity"][m].astype(np.int64))
    c = np.bincount(gid, minlength=6)
    g = np.flatnonzero(c > 0)
    d = conn.dictionaries("lineitem")
    return {"l_returnflag": list(d["l_returnflag"].values[g // 2]),
            "l_linestatus": list(d["l_linestatus"].values[g % 2]), "sq": sq[g], "c": c[g]}


@contextlib.contextmanager
def launch_spans():
    """While in the block, record for every call of the Q1, lane-sums,
    leaf and exists kernels' wrappers the innermost open trace span
    (``(kernel, span name or None)``), in ``seen["in_fragment"]`` whether a
    ``fragment:`` span is open around it, and keep each Q1-kernel launch
    shape's first batch (``seen["q1 batches"]``; the others:
    :func:`first_kernel_calls`, :func:`each_probe_shape`)."""
    from presto_tpu_torch.exec import leaf_route
    from presto_tpu_torch.runtime import trace

    seen = {"launches": [], "in_fragment": [], "q1 batches": {}}
    targets = {"q1": (cuda_q1, "q1_step"), "lane_sums": (cuda_groupby, "fused_lane_sums"),
               "leaf_agg": (leaf_route, "agg_step"), "exists": (cuda_join, "exists_keep")}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in targets.items()}

    def wrap(kernel):
        def call(*args):
            rec = trace.current()
            stack = [] if rec is None else [rec.spans[i].name for i in rec._stack]
            seen["launches"].append((kernel, stack[-1] if stack else None))
            seen["in_fragment"].append(any(n.startswith("fragment:") for n in stack))
            if kernel == "q1":
                seen["q1 batches"].setdefault(args[0].capacity, args[0])
            return originals[kernel](*args)
        return call

    for k, (mod, attr) in targets.items():
        setattr(mod, attr, wrap(k))
    try:
        yield seen
    finally:
        for k, (mod, attr) in targets.items():
            setattr(mod, attr, originals[k])


def annotated_launches(prof) -> dict:
    """{kernel: (device launches, launches made inside a ``step:``,
    ``finish:`` or ``node:`` annotation of phase 18)} from a profiler run
    with CPU and CUDA activities, read from its Chrome trace: each kernel
    event's launch (the ``cuda_runtime`` event of the same correlation
    id) must lie in the host time range of such a user annotation (the
    kernels launch from a plain C interface, so the profiler links them
    to no host-side op of its own)."""
    import tempfile

    def kernel_of(name: str):
        for k, fns in OBS_KERNELS.items():
            if any(fn in name for fn in fns):
                return k
        return None

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].endswith("#" + OBS_TOKEN)
                    and e["name"].startswith(LAUNCH_SPANS))
    out = {k: [0, 0] for k in OBS_KERNELS}
    for e in events:
        if e.get("cat") != "kernel" or (k := kernel_of(e["name"])) is None:
            continue
        out[k][0] += 1
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is not None and any(t0 <= ts <= t1 for t0, t1 in ranges):
            out[k][1] += 1
    log(f"  profiler trace: {len(ranges)} step/finish/node/fragment annotations, {len(launch_ts)} "
        f"runtime launch events")
    return {k: tuple(v) for k, v in out.items()}


def node_spans_match(spans: list, plan, executed: bool) -> None:
    """The exported ``node:`` spans against the plan: each names a plan
    node of its type; under a stats recorder (``executed``) every node
    ran once, under its pre-order id."""
    from presto_tpu_torch.runtime.stats import NodeIds

    nodes: list = []

    def walk(n):
        nodes.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    got = [(e["args"]["plan_node_id"], e["name"][len("node:"):]) for e in spans]
    ids = [i for i, _t in got]
    check(len(ids) == len(set(ids)), f"node spans repeat a plan node id: {got}")
    types = [type(n).__name__ for n in nodes]
    if executed:
        pre = NodeIds()
        pre.assign(plan)
        want = sorted((pre.get(n), type(n).__name__) for n in nodes)
        check(sorted(got) == want, f"node spans {sorted(got)}, the plan {want}")
    else:
        for _i, t in got:
            check(types.count(t) >= [x for _j, x in got].count(t),
                  f"node spans {got} name more {t} nodes than the plan has ({types})")
        check("Output" in [t for _i, t in got], f"no node:Output span in {got}")


def tracing_overhead(conn, device: str) -> dict:
    """The JAX package's rule (``tests/test_trace.py``): warm Q1, Q6 and
    Q3 through two sessions, ``trace_enabled`` on and off, interleaved;
    the least wall of 5 rounds each, then of 9 if the first set misses;
    holds when on <= off * 1.05 + 5 ms. Returns each statement's walls."""
    sessions = {on: measured_session({"tpch": conn}, properties={"trace_enabled": on}, device=device)
                for on in (True, False)}

    def wall(session, sql):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.sql(sql)
        if device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {}
    for name in OVERHEAD_RUNS:
        sql = OBS_RUNS[name][1]
        for session in sessions.values():
            session.sql(sql)  # warm
        for rounds in (5, 9):
            on, off = [], []
            for _ in range(rounds):
                off.append(wall(sessions[False], sql))
                on.append(wall(sessions[True], sql))
            best_on, best_off = min(on), min(off)
            if best_on <= best_off * 1.05 + 0.005:
                break
        out[name] = {"on_s": best_on, "off_s": best_off, "rounds": rounds,
                     "held": best_on <= best_off * 1.05 + 0.005}
        log(f"  tracing overhead, {name}: on {best_on:.6f} s, off {best_off:.6f} s "
            f"(least of {rounds} interleaved rounds; rule on <= off x 1.05 + 5 ms: "
            f"{'held' if out[name]['held'] else 'MISSED'})")
        check(out[name]["held"], f"{name}: tracing overhead on {best_on:.6f} s against off "
              f"{best_off:.6f} s")
    return out


def run_observability_queries(conn, device: str = "cuda") -> dict:
    """Phase 18 at SF1: Q1 (the Q1 kernel), Q6 (the leaf kernel) and Q3
    (the exists kernel) through ``Session.sql`` and the Q1-shaped
    group-by (the lane-sums kernel) through ``Session.execute``, traced
    with ``profile_annotations`` on, under the torch profiler (on the
    card): every answer equal to its numpy oracle, every ``QueryInfo.
    metrics`` strategy counter its plan's, every kernel launch inside a
    ``step:``, ``finish:`` or ``node:`` span (on the host, and by the
    profiler's annotations on the card), ``export_trace``'s JSON parsed
    and its node spans against the plans, every launch shape held to the
    plain version; then the tracing overhead rule on Q1, Q6 and Q3, and
    an injected scan fault on Q3 retried under ``query_retries``."""
    import tempfile

    from presto_tpu_torch.runtime import faults

    t0 = time.perf_counter()
    want = {"q1": q1_sql_expected(conn), "q3": q3_expected(conn),
            "q1 shaped": q1_shaped_expected(conn)}
    li = conn.table_numpy("lineitem", Q6_COLS)
    want["q6"] = revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li))
    del li
    log(f"phase 18: numpy recomputation of {list(OBS_RUNS)} at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    session = measured_session({"tpch": conn}, properties={"profile_annotations": True},
                      device=device, trace_token=OBS_TOKEN)
    check(session.prop("trace_enabled"), "trace_enabled is off by default")
    out = {"walls": {}, "routes": {}, "infos": {}}
    query = {"name": None}
    profiler = contextlib.nullcontext()
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    results = {}
    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls, \
            launch_spans() as spans:
        # the main path of the phase: launches counted from 0 to here
        _reset_launches()
        with profiler as prof:
            for name, (how, sql, _kernel) in OBS_RUNS.items():
                query["name"] = name
                try:
                    t0 = time.perf_counter()
                    if how == "sql":
                        res = session.sql(sql)
                        info = session.query_history[-1]
                    else:
                        res, info = session.execute(sql)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    out["walls"][name] = time.perf_counter() - t0
                finally:
                    query["name"] = None
                results[name] = (res, info)
        out["launches"] = _launch_counts()
    launches = out["launches"]
    log(f"  phase 18's launches: "
        f"{ {k: launches[k] for k in ('q1', 'lane_sums', 'leaf_agg', 'exists', 'payload')} }")
    for name, (how, sql, kernel) in OBS_RUNS.items():
        res, info = results[name]
        same_result(res, want[name], f"phase 18 {name}")
        predicted = planned_routes(session, sql, fused=how == "sql")
        got = {k: v for k, v in info.metrics.items()
               if k.startswith(("join.strategy.", "agg.strategy.")) and v}
        check(got == predicted, f"phase 18 {name}: QueryInfo.metrics strategies {got}, the "
              f"plan predicts {predicted}")
        check(info.metrics.get("post_run.query.completed") == 1.0
              and info.state == "FINISHED", f"phase 18 {name}: {info.state}, {info.metrics}")
        check(launches[kernel] > 0 or device != "cuda",
              f"phase 18 {name} launched no {kernel} kernel")
        out["routes"][name] = got
        out["infos"][name] = {"join_strategy": info.join_strategy,
                              "filter_selectivity": info.filter_selectivity,
                              "spans": len(session.traces.for_query(info.query_id).spans)}
        log(f"  {name} ({how}): wall {out['walls'][name]:.3f} s (traced, profiled), strategies "
            f"{got}, join_strategy {info.join_strategy!r}, filter_selectivity "
            f"{info.filter_selectivity:.6f}, {out['infos'][name]['spans']} spans")
    check(launches["sketch"] == launches["payload"] == launches["q3"] == launches["like"]
          == launches["prefix"] == 0, f"phase 18 launched a kernel its plans do not route "
          f"to: {launches}")
    # every launch in a step:, finish: or node: span, on the host
    outside = [(k, sp) for k, sp in spans["launches"]
               if sp is None or not sp.startswith(LAUNCH_SPANS)]
    check(not outside, f"phase 18: kernel launches outside a step/finish/node/fragment span: "
          f"{outside[:5]}")
    by_span = _summed(*({f"{k} in {sp}": 1} for k, sp in spans["launches"]))
    log(f"  kernel launches by innermost span: {by_span}")
    if device == "cuda":
        out["annotated"] = annotated_launches(prof)
        log(f"  profiler: kernel device launches, and those inside a step/finish/node/fragment "
            f"annotation: {out['annotated']}")
        # a profiler trace can come back without some device events (a
        # count can read short, never long): every traced launch must lie
        # in an annotation, and the trace must hold some of each kernel's
        for k, (ran, inside) in out["annotated"].items():
            check(0 < ran <= launches[k] and inside == ran,
                  f"phase 18's {k}: {launches[k]} launches counted, {ran} in the profiler's "
                  f"trace, {inside} of them inside a step/finish/node/fragment annotation")
    # export_trace: valid Chrome JSON, node spans against the plans
    with tempfile.TemporaryDirectory() as tmp:
        for name, (how, sql, _kernel) in OBS_RUNS.items():
            info = results[name][1]
            path = session.export_trace(os.path.join(tmp, "t.json"), query_id=info.query_id)
            with open(path) as f:
                data = json.load(f)
            check(data["otherData"]["queries"] == [info.query_id]
                  and data["otherData"]["trace_tokens"] == [OBS_TOKEN],
                  f"phase 18 {name}: export_trace's otherData {data['otherData']}")
            xs = [e for e in data["traceEvents"] if e.get("ph") == "X"]
            # a plan template has its plan's node types
            node_spans_match([e for e in xs if e["cat"] == "node"], session.plan(sql),
                             executed=how == "execute")
            check(xs[0]["name"] == "query" and all(e["dur"] >= 0 for e in xs),
                  f"phase 18 {name}: exported spans {xs[:2]}")
        everything = session.export_trace(os.path.join(tmp, "all.json"))
        with open(everything) as f:
            n_all = len(json.load(f)["otherData"]["queries"])
        check(n_all == len(OBS_RUNS), f"export_trace of every query: {n_all} queries")
    log(f"  export_trace: {len(OBS_RUNS)} queries' Chrome JSON parsed; node spans match "
        f"their plans")
    # each launch shape held to the plain version
    out["probe_err"] = hold_probe_shapes(probes)
    out["call_err"] = hold_kernel_calls(calls)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 18's first {cap}-row batch"))
        log(f"  q1_step at phase 18's first {cap}-row batch: equal to its plain version")
    out["q1_err"] = q1_err
    for kernel in ("lane_sums", "leaf_agg") if device == "cuda" else ():
        check((launches[kernel] > 0) == any(k == kernel for k, _s in calls),
              f"phase 18's {kernel}: {launches[kernel]} launches, shapes held "
              f"{[s for k, s in calls if k == kernel]}")
    if device == "cuda":
        check({rows for m, rows, _key in probes if m == "exists"}
              == set(launches["probe_by_shape"]["exists"]),
              f"phase 18's exists shapes {launches['probe_by_shape']['exists']}, held "
              f"{sorted(probes)}")
        check(bool(spans["q1 batches"]) == (launches["q1"] > 0),
              "phase 18's Q1 shapes not held")
    # the tracing overhead rule
    out["overhead"] = tracing_overhead(conn, device)
    # an injected scan fault, re-run from the top
    retry = measured_session({"tpch": conn}, properties={"query_retries": 1}, device=device)
    inj = faults.FaultInjector()
    inj.inject("scan", times=1)
    before = counters()["query.retried"]
    with faults.injected(inj):
        res = retry.sql(QUERIES["q3"])
    retried = counters()["query.retried"] - before
    same_result(res, want["q3"], "phase 18 q3 after an injected scan fault")
    check(inj.fired("scan") == 1 and retried == 1
          and [i.state for i in retry.query_history] == ["FAILED", "FINISHED"]
          and retry.query_history[0].error_code == "TRANSIENT_FAILURE",
          f"phase 18's retry: fired {inj.fired('scan')}, query.retried {retried}, states "
          f"{[(i.state, i.error_code) for i in retry.query_history]}")
    out["retried"] = retried
    log(f"  injected scan fault on q3: {inj.fired('scan')} fired, query.retried {retried}, "
        f"the retry's answer equal to numpy")
    return out


# ---------------------------------------------------------------------------
# phase 19: the query lifecycle and the out-of-core tier
# ---------------------------------------------------------------------------

#: the JAX package's out-of-core test statements (``tests/test_spill.py``)
HICARD_AGG = ("select l_orderkey, count(*) n, sum(l_extendedprice) s "
              "from lineitem join orders on l_orderkey = o_orderkey "
              "group by l_orderkey order by l_orderkey limit 100")
CUST_SEMI = ("select c_custkey from customer where c_custkey in "
             "(select o_custkey from orders) order by c_custkey")
CUST_ANTI = ("select c_custkey from customer where c_custkey not in "
             "(select o_custkey from orders) order by c_custkey")
SPILL_SQL = {"q3": QUERIES["q3"], "hicard_agg": HICARD_AGG, "semi": CUST_SEMI,
             "anti": CUST_ANTI}
#: each planned-hybrid run's budget: its largest join build estimate over
#: this; Q3's fully grouped run: its orders build over GROUPED_DIVISOR
#: (past the hybrid ratio cap of 64)
HYBRID_DIVISOR = 4
GROUPED_DIVISOR = 100
#: the kernels phase 19 runs under the lifecycle (Q3's exists launches
#: come from its resident and spilled runs)
LIFE_KERNEL_RUNS = {"q1": QUERIES["q1"], "q6": QUERIES["q6"]}
#: the real-OOM candidates, in order (the first whose rung-1 peak is
#: under its resident peak is capped between the two)
OOM_CANDIDATES = ("hicard_agg", "q3")


def hicard_expected(conn) -> dict:
    """``HICARD_AGG`` in int64 numpy: per l_orderkey with an order, the
    line count and the scaled sum of l_extendedprice, the first 100 keys."""
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_extendedprice"])
    keys = li["l_orderkey"].astype(np.int64)
    m = np.isin(keys, conn.table_numpy("orders", ["o_orderkey"])["o_orderkey"])
    keys, ep = keys[m], li["l_extendedprice"][m].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    first = np.flatnonzero(np.r_[True, np.diff(keys[order]) != 0])
    n = np.diff(np.r_[first, order.size])
    return {"l_orderkey": keys[order][first][:100], "n": n[:100],
            "s": np.add.reduceat(ep[order], first)[:100]}


def cust_semi_expected(conn, anti: bool) -> dict:
    """``CUST_SEMI`` / ``CUST_ANTI`` in numpy (no NULL keys on either side)."""
    c = conn.table_numpy("customer", ["c_custkey"])["c_custkey"].astype(np.int64)
    hit = np.isin(c, conn.table_numpy("orders", ["o_custkey"])["o_custkey"])
    return {"c_custkey": np.sort(c[~hit] if anti else c[hit])}


def result_dict(res) -> dict:
    return {name: res.column(name) for name in res.names}


def transfer_overlap(tracer) -> dict:
    """From a spilled query's trace: the seconds of its ``spill:transfer``
    spans, of its ``spill:unit`` spans, and of transfer time that ran
    while a unit computed (the two-slot pipeline's overlap)."""
    spans = tracer.spans
    xfer = [(s.t0, s.t1) for s in spans if s.name == "spill:transfer"]
    units = sorted((s.t0, s.t1) for s in spans if s.name == "spill:unit")
    overlap = sum(max(0.0, min(t1, u1) - max(t0, u0)) for t0, t1 in xfer for u0, u1 in units)
    return {"transfers": len(xfer), "transfer_s": sum(t1 - t0 for t0, t1 in xfer),
            "units": len(units), "unit_s": sum(u1 - u0 for u0, u1 in units),
            "overlap_s": overlap}


def largest_build(session, sql: str) -> int:
    """The largest join or semi-join build estimate of ``sql``'s plan."""
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.runtime.memory import estimate_node_bytes

    out = []

    def walk(node):
        if isinstance(node, (N.Join, N.SemiJoin)):
            out.append(estimate_node_bytes(node.right, session.catalog))
        for c in node.children:
            walk(c)

    walk(session.plan(sql))
    return max(out)


class GatedScans(TpchConnector):
    """A TPC-H connector whose scan of ``lineitem``'s second split sets
    ``reached`` and waits for ``go``: a query over it is mid-scan while
    the gate is shut."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.reached, self.go = threading.Event(), threading.Event()

    def scan(self, split, columns=None, capacity=None):
        if split.table == "lineitem" and split.chunk == 1:
            self.reached.set()
            check(self.go.wait(60), "phase 19: the cancel gate never opened")
        return super().scan(split, columns, capacity)


def _drained(session, what: str) -> None:
    from presto_tpu_torch.runtime.memory import global_host_spill_budget

    pool, host = session.pool().reserved_bytes, global_host_spill_budget().reserved_bytes
    check(pool == 0 and host == 0,
          f"phase 19 {what}: pool {pool} and host spill {host} bytes still reserved")


def _peak(fn):
    """(fn's result, its peak device bytes over the allocated bytes at
    the call, its peak reserved bytes over the reserved bytes at the
    call)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - a0, torch.cuda.max_memory_reserved() - r0


#: runs of each real-OOM candidate at rung 0 and at rung 1 before the cap
#: is set: a resident peak moves with how many scan batches the prefetch
#: worker holds at once (Q3 at SF1: 1.15-1.88 GB over six runs on the
#: H100, its rung-1 peak 57-68 MB), so the cap is set from the least
#: rung-0 and the most rung-1 peak seen
OOM_PEAK_RUNS = 2
#: a candidate recovers only where its least resident peak is this many
#: times its most rung-1 peak: the cap at their geometric mean then
#: leaves both runs a margin of at least its square root
OOM_PEAK_RATIO = 8


def _fill_slack() -> list:
    """Tensors that take up the free bytes inside the allocator's
    reserved segments, called with the allocator capped at what it
    reserves: blocks of 1 GiB down to 512 B, each size until the
    allocator refuses it. Earlier phases leave such free bytes behind (a
    segment that still holds a live tensor is not returned by
    ``empty_cache()``); held during a capped run, they keep the run to
    the new segments the cap allows."""
    held = []
    size = 1 << 30
    while size >= 512:
        try:
            while True:
                held.append(torch.empty(size, dtype=torch.uint8, device="cuda"))
        except torch.OutOfMemoryError:
            size //= 4
    return held


def real_oom(conn, want: dict, device: str) -> dict:
    """The allocator's own out-of-memory, walked by the ladder: each
    candidate's resident peak (rung 0) and its rung-1 peak (an executor
    at ``oom_rung`` 1, the plan the ladder re-runs), ``OOM_PEAK_RUNS``
    times each, in allocated bytes; then, with
    ``empty_cache()`` done and the free bytes left inside the allocator's
    segments held by ballast (:func:`_fill_slack`), the allocator capped
    (``set_per_process_memory_fraction``) at what it reserves plus the
    geometric mean of the candidate's least resident and most rung-1
    peak, the statement through ``Session.sql``: the card raises
    ``torch.OutOfMemoryError``, the lifecycle maps it to
    ``DeviceOutOfMemory`` and the ladder re-runs it on the card, which
    must answer as uncapped. Where no candidate's peaks are
    ``OOM_PEAK_RATIO`` apart, the cap is a quarter of the least peak
    seen and the run must raise the card's OOM and then either fail
    typed or answer right. The cap is lifted in a ``finally``
    (fraction 1.0, ballast freed, ``empty_cache()``), and the next query
    must answer."""
    from presto_tpu_torch.runtime import faults
    from presto_tpu_torch.runtime.errors import DeviceOutOfMemory

    check(faults.active() is None, "phase 19: a fault injector is installed")
    session = measured_session({"tpch": conn}, device=device)
    peaks = {}
    chosen = None
    for name in OOM_CANDIDATES:
        sql = SPILL_SQL[name]
        rung0, rung1, reserved = [], [], []
        for _ in range(OOM_PEAK_RUNS):
            _res, p0, r0 = _peak(lambda: session.sql(sql))
            ex = session.executor()
            ex.oom_rung = 1
            res1, p1, r1 = _peak(lambda: ex.run(session.plan(sql)))
            same_result(res1, want[name], f"phase 19 {name} at rung 1")
            rung0.append(p0)
            rung1.append(p1)
            reserved.append((r0, r1))
        low, high = max(rung1), min(rung0)
        peaks[name] = {"rung0": rung0, "rung1": rung1, "reserved": reserved,
                       "least_rung0": high, "most_rung1": low}
        log(f"  real OOM candidate {name}: resident peaks {rung0} B, rung-1 peaks {rung1} B "
            f"over the allocated bytes at each call (reserved segments grew by {reserved} B; "
            "free bytes inside earlier segments take part of a peak)")
        if chosen is None and high >= OOM_PEAK_RATIO * max(low, 1):
            chosen = name
    recover = chosen is not None
    chosen = chosen or OOM_CANDIDATES[0]
    high, low = peaks[chosen]["least_rung0"], peaks[chosen]["most_rung1"]
    room = int((high * low) ** 0.5) if recover else min(high, low) // 4
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    slack = base - torch.cuda.memory_allocated()
    limit = base + room
    before = counters()
    out = {"query": chosen, "peaks": peaks, "base_reserved": base, "slack": slack,
           "limit": limit, "expect_recovery": recover}
    ballast: list = []
    try:
        torch.cuda.set_per_process_memory_fraction(base / total)
        ballast = _fill_slack()
        out["ballast"] = sum(t.numel() for t in ballast)
        log(f"  capping the allocator at {limit} B ({limit / total:.6f} of {total} B; {base} B "
            f"reserved before the run, {slack} B of it free, {out['ballast']} B of that held "
            f"by ballast during the run) for {chosen}: {room} B of room against a least "
            f"resident peak of {high} B and a most rung-1 peak of {low} B")
        torch.cuda.set_per_process_memory_fraction(limit / total)
        try:
            res = session.sql(SPILL_SQL[chosen])
            out["outcome"] = "recovered"
        except DeviceOutOfMemory as e:
            out["outcome"] = f"failed typed: {str(e)[:200]}"
            res = None
        info = session.query_history[-1]
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        ballast.clear()
        torch.cuda.empty_cache()
    moved = counters()
    out["backend_oom"] = moved["query.backend_oom"] - before["query.backend_oom"]
    out["oom_rung"], out["rung_history"] = info.oom_rung, info.rung_history
    ladder = [e for e in info.rung_history if e["kind"] == "ladder"]
    check(out["backend_oom"] >= 1 and ladder and "OutOfMemoryError" in ladder[0]["error"]
          and "BackendOom" not in ladder[0]["error"],
          f"phase 19's real OOM: backend_oom {out['backend_oom']}, history {info.rung_history}, "
          f"peaks {peaks}, limit {limit}")
    if recover or res is not None:
        check(res is not None and info.oom_rung >= 1,
              f"phase 19's real OOM did not recover: {out['outcome']}, rung {info.oom_rung}, "
              f"peaks {peaks}, limit {limit}")
        same_result(res, want[chosen], f"phase 19 {chosen} after the ladder")
    else:
        check(info.error_code == "DEVICE_OUT_OF_MEMORY",
              f"phase 19's real OOM: {out['outcome']}, {info.error_code}")
    _drained(session, "after the real OOM")
    same_result(session.sql(SPILL_SQL[chosen]), want[chosen], "phase 19 after lifting the cap")
    log(f"  real OOM on {chosen}: {out['outcome']}, query.backend_oom {out['backend_oom']}, "
        f"oom_rung {info.oom_rung}, ladder entries {[e['error'][:120] for e in ladder]}; "
        f"the cap lifted and {chosen} answered right again")
    return out


def run_lifecycle_queries(conn, device: str = "cuda") -> dict:
    """Phase 19 at SF1: the lifecycle and the out-of-core tier through
    ``Session.sql``. Q3, ``HICARD_AGG`` and the customer semi and anti
    joins resident and planned hybrid (budget: the largest build estimate
    over ``HYBRID_DIVISOR``), Q3 fully grouped (over
    ``GROUPED_DIVISOR``), each equal to its numpy oracle and the resident
    run, with each spill decision, the transfer overlap, and the pool and
    host spill budget at 0 after every query; Q1 and Q6 under the
    lifecycle; every K1, K3 and K4 launch inside a ``fragment:`` span and
    each launch shape held to the plain version; a deadline, a cancel
    from a second thread and an admission rejection, typed, each session
    answering right after; then the allocator's own OOM walked by the
    ladder (:func:`real_oom`)."""
    from presto_tpu_torch.runtime import faults
    from presto_tpu_torch.runtime.errors import (
        ExceededTimeLimit, QueryCancelled, ResourceExhausted)
    from presto_tpu_torch.runtime.lifecycle import peak_estimate_bytes

    t0 = time.perf_counter()
    want = {"q3": q3_expected(conn), "hicard_agg": hicard_expected(conn),
            "semi": cust_semi_expected(conn, False), "anti": cust_semi_expected(conn, True),
            "q1": q1_sql_expected(conn)}
    li = conn.table_numpy("lineitem", Q6_COLS)
    want["q6"] = revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li))
    del li
    log(f"phase 19: numpy recomputation of {list(want)} at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"spill": {}, "walls": {}}
    query = {"name": None}
    probe = measured_session({"tpch": conn}, device=device)
    runs = [(f"{name} resident", name, None) for name in SPILL_SQL]
    for name in SPILL_SQL:
        est = largest_build(probe, SPILL_SQL[name])
        runs.append((f"{name} hybrid", name, max(est // HYBRID_DIVISOR, 1)))
    runs.append(("q3 grouped", "q3", max(largest_build(probe, QUERIES["q3"]) // GROUPED_DIVISOR,
                                         1)))
    results = {}
    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls, \
            launch_spans() as spans:
        # the main path of the phase: launches counted from 0 to here
        _reset_launches()
        for label, name, budget in runs:
            props = {} if budget is None else {"join_build_budget_bytes": budget}
            session = measured_session({"tpch": conn}, properties=props, device=device)
            query["name"] = label
            before = counters()
            try:
                t0 = time.perf_counter()
                res = session.sql(SPILL_SQL[name])
                if device == "cuda":
                    torch.cuda.synchronize()
                out["walls"][label] = time.perf_counter() - t0
            finally:
                query["name"] = None
            info = session.query_history[-1]
            moved = {k: v - before[k] for k, v in counters().items()
                     if k.startswith(("spill.", "join.strategy.", "agg.strategy.",
                                      "query.oom_degraded")) and v != before[k]}
            same_result(res, want[name], f"phase 19 {label}")
            if budget is not None:
                same_result(res, result_dict(results[f"{name} resident"]),
                            f"phase 19 {label} against the resident run")
                mode = "grouped" if label.endswith("grouped") else "hybrid"
                check(moved.get(f"spill.planned_{mode}", 0) >= 1
                      and moved.get("spill.partitions_streamed", 0) >= 1
                      and moved.get("query.oom_degraded", 0) == 0 and info.oom_rung == 0,
                      f"phase 19 {label}: counters {moved}, oom_rung {info.oom_rung}")
            else:
                check(not any(k.startswith("spill.") for k in moved),
                      f"phase 19 {label} spilled: {moved}")
            _drained(session, label)
            results[label] = res
            decisions = [{k: e[k] for k in ("node", "mode", "partitions", "resident",
                                            "streamed", "est_bytes", "budget_bytes",
                                            "host_bytes")}
                         for e in info.rung_history if e["kind"].startswith("planned_")]
            overlap = (transfer_overlap(session.traces.for_query(info.query_id))
                       if budget is not None else None)
            out["spill"][label] = {"budget": budget, "decisions": decisions, "counters": moved,
                                   "overlap": overlap}
            log(f"  {label}: wall {out['walls'][label]:.3f} s, budget {budget}, decisions "
                f"{decisions}, counters {moved}"
                + (f", transfers {overlap}" if overlap else ""))
        for name, sql in LIFE_KERNEL_RUNS.items():
            session = measured_session({"tpch": conn}, device=device)
            query["name"] = name
            try:
                t0 = time.perf_counter()
                res = session.sql(sql)
                if device == "cuda":
                    torch.cuda.synchronize()
                out["walls"][name] = time.perf_counter() - t0
            finally:
                query["name"] = None
            same_result(res, want[name], f"phase 19 {name}")
            _drained(session, name)
            log(f"  {name} under the lifecycle: wall {out['walls'][name]:.3f} s, "
                f"{session.query_history[-1].metrics.get('fragment.dispatch_s.count')} "
                "fragment dispatches")
        out["launches"] = _launch_counts()
    launches = out["launches"]
    log(f"  phase 19's launches: "
        f"{ {k: launches[k] for k in ('q1', 'lane_sums', 'leaf_agg', 'exists', 'payload')} }; "
        f"exists by rows {launches['probe_by_shape']['exists']}, leaf by instance "
        f"{launches['by_instance']}")
    if device == "cuda":
        for k in ("q1", "leaf_agg", "exists"):
            check(launches[k] > 0, f"phase 19 launched no {k} kernel")
    outside = [(k, sp) for (k, sp), inside in zip(spans["launches"], spans["in_fragment"])
               if not inside]
    check(not outside, f"phase 19: kernel launches outside a fragment span: {outside[:5]}")
    log(f"  kernel launches by innermost span: "
        f"{_summed(*({f'{k} in {sp}': 1} for k, sp in spans['launches']))}; all "
        f"{len(spans['launches'])} inside a fragment span")
    out["probe_err"] = hold_probe_shapes(probes)
    out["call_err"] = hold_kernel_calls(calls)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 19's first {cap}-row batch"))
        log(f"  q1_step at phase 19's first {cap}-row batch: equal to its plain version")
    out["q1_err"] = q1_err
    if device == "cuda":
        check({rows for m, rows, _key in probes if m == "exists"}
              == set(launches["probe_by_shape"]["exists"]),
              f"phase 19's exists shapes {launches['probe_by_shape']['exists']}, held "
              f"{sorted(probes)}")
        check(any(k == "leaf_agg" for k, _s in calls) and bool(spans["q1 batches"]),
              "phase 19's leaf and Q1 shapes not held")

    # ---- a deadline, a cancel and an admission rejection ---------------
    q6_want = want["q6"]

    def answers_after(session, what):
        _drained(session, what)
        same_result(session.sql(QUERIES["q6"]), q6_want, f"phase 19's next query after {what}")

    session = measured_session({"tpch": conn}, device=device)
    session.sql(QUERIES["q1"])
    t0 = time.perf_counter()
    session.sql(QUERIES["q1"])
    wall = time.perf_counter() - t0
    session.set_property("query_max_run_time", wall / 10)
    before = counters()["query.deadline_exceeded"]
    try:
        session.sql(QUERIES["q1"])
        check(False, "phase 19: the deadline did not fire")
    except ExceededTimeLimit as e:
        site = re.search(r"checked at (\S+)\)", str(e)).group(1)
    info = session.query_history[-1]
    check(site in ("scan", "driver-loop", "driver-finish")
          and info.error_code == "EXCEEDED_TIME_LIMIT"
          and counters()["query.deadline_exceeded"] == before + 1,
          f"phase 19's deadline: site {site}, {info.error_code}")
    session.set_property("query_max_run_time", None)
    answers_after(session, "the deadline")
    out["deadline"] = {"wall_s": wall, "limit_s": wall / 10, "site": site}
    log(f"  deadline: q1's warm wall {wall:.4f} s, query_max_run_time {wall / 10:.4f} s -> "
        f"ExceededTimeLimit at {site!r}; the session's next query right")

    gated = GatedScans(sf=conn.sf, units_per_split=conn.units_per_split, device=device)
    session = measured_session({"tpch": gated}, device=device)
    box = {}

    def run():
        try:
            box["res"] = session.sql(Q1_SHAPED)
        except Exception as e:  # noqa: BLE001 -- checked below
            box["err"] = e

    observed = counters()["cancel.observed"]
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    check(gated.reached.wait(60), "phase 19: the cancel query never reached its second split")
    qid = session.query_history[-1].query_id
    check(session.cancel(qid, "phase 19") and not session.cancel(qid),
          "phase 19: Session.cancel did not take")
    gated.go.set()
    thread.join(120)
    check(not thread.is_alive(), "phase 19: the cancelled query hung")
    err = box.get("err")
    info = session.query_history[-1]
    check(isinstance(err, QueryCancelled) and info.error_code == "QUERY_CANCELLED"
          and counters()["cancel.observed"] == observed + 1
          and info.metrics.get("cancel.observed") == 1,
          f"phase 19's cancel: {err!r}, {info.error_code}, {info.metrics}")
    answers_after(session, "the cancel")
    out["cancel"] = str(err)
    log(f"  cancel from a second thread: {err}; cancel.observed 1; the session's next query "
        f"right")

    session = measured_session({"tpch": conn}, device=device)
    peak, node = peak_estimate_bytes(session.plan(QUERIES["q3"]), session.catalog)
    session.set_property("query_max_memory_bytes", peak // 2)
    launched = _launch_counts()
    inj = faults.FaultInjector()
    inj.inject("scan", times=None)
    with faults.injected(inj):
        try:
            session.sql(QUERIES["q3"])
            check(False, "phase 19: admission did not reject")
        except ResourceExhausted as e:
            rejected = str(e)
    info = session.query_history[-1]
    after = _launch_counts()
    check(inj.fired() == 0 and info.error_code == "RESOURCE_EXHAUSTED"
          and all(after[k] == launched[k] for k in ("q1", "leaf_agg", "exists", "payload",
                                                     "lane_sums")),
          f"phase 19's admission: {inj.fired()} scans, {info.error_code}")
    session.set_property("query_max_memory_bytes", None)
    answers_after(session, "the admission rejection")
    out["admission"] = {"peak": peak, "node": node}
    log(f"  admission: q3's peak estimate {peak} B at {node}, limit {peak // 2} -> rejected "
        f"before any scan or launch ({rejected[:100]}...); the session's next query right")

    if device == "cuda":
        out["oom"] = real_oom(conn, want, device)
    return out


# ---------------------------------------------------------------------------
# phase 20: the cache tier, adaptivity, the flight recorder, the system
# catalog and the in-flight coalescer
# ---------------------------------------------------------------------------

#: the scalar launch counters of ``_launch_counts``
SCALAR_KERNELS = ("q1", "lane_sums", "leaf_agg", "exists", "payload", "sketch", "q3", "like",
                  "prefix")
#: the result-cache statements of phase 20 (K1, K3 and K4 on their first run)
CACHE_RUNS = {"q1": QUERIES["q1"], "q6": QUERIES["q6"], "q3": QUERIES["q3"]}
#: one large result at real size, and a wider one that must evict it
BIG_SQL = "select l_orderkey, l_partkey, l_suppkey, l_quantity from lineitem"
WIDE_SQL = ("select l_orderkey, l_partkey, l_suppkey, l_quantity, l_extendedprice, l_discount, "
            "l_tax, l_shipdate, l_commitdate, l_receiptdate from lineitem")
#: a repeated multi-key join whose pack widths need a runtime min/max (the
#: port's ``tests/test_torch_join_keys.py`` "mix with matches")
KEY_MIX_SQL = ("select count(*) as n from customer a join customer b "
               "on a.c_nationkey = b.c_nationkey and a.c_acctbal = b.c_acctbal")
#: an aggregation whose recorded actuals (3 groups) refute its estimate
#: by far more than ``MISEST_FACTOR``: its third recorded run gets the
#: adaptive controller's ``bucket`` decision
ADAPT_SQL = ("select l_returnflag, count(*) c, sum(l_quantity) q from lineitem "
             "group by l_returnflag order by l_returnflag")
#: the memory table an INSERT changes under a cached query
CACHED_MEM_SQL = "select count(*) n, sum(k) s from p20_keys"


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in SCALAR_KERNELS}


def key_mix_expected(conn) -> dict:
    """``KEY_MIX_SQL`` in numpy: the pairs of customers with equal
    (nationkey, acctbal), each group's size squared."""
    c = conn.table_numpy("customer", ["c_nationkey", "c_acctbal"])
    keys = c["c_nationkey"].astype(np.int64) * (1 << 40) + c["c_acctbal"].astype(np.int64)
    _u, n = np.unique(keys, return_counts=True)
    return {"n": np.array([int((n.astype(np.int64) ** 2).sum())])}


def adapt_expected(conn) -> dict:
    li = conn.table_numpy("lineitem", ["l_returnflag", "l_quantity"])
    flags = conn.dictionaries("lineitem")["l_returnflag"].decode(li["l_returnflag"])
    order = sorted(set(flags.tolist()))
    c = np.array([int((flags == f).sum()) for f in order])
    q = np.array([int(li["l_quantity"][flags == f].astype(np.int64).sum()) for f in order])
    return {"l_returnflag": np.array(order, dtype=object), "c": c, "q": q}


def _rows(frame) -> list:
    """A system-table result's rows, bytes decoded."""
    cols = [[v.rstrip(b"\x00").decode() if isinstance(v, bytes) else v
             for v in frame.column(n)] for n in frame.names]
    return list(zip(*cols))


def _bitwise_equal(a, b, what: str) -> None:
    """Two results hold the same columns, batch parts, dtypes and bytes."""
    check(a.names == b.names and len(a) == len(b), f"{what}: shapes differ")
    for name in a.names:
        for (da, va, ta, xa), (db, vb, tb, xb) in zip(a._cols[name], b._cols[name]):
            check(da.dtype == db.dtype and da.tobytes() == db.tobytes()
                  and va.tobytes() == vb.tobytes() and ta == tb and xa is xb,
                  f"{what}: column {name} is not bitwise equal")


def run_cache_queries(conn, device: str = "cuda", cache_budget: int | None = None) -> dict:
    """Phase 20 at SF1 (``run_cache_queries``), one session with default
    properties unless a step says otherwise:

    - result cache: Q1, Q6 and Q3 twice (the first run launches K1, K3
      and K4; the second is a ``cache_hit``, launches nothing and returns
      a bitwise-equal result); an INSERT into a memory table a cached
      query reads invalidates it, and the next run executes and equals
      numpy; ``BIG_SQL`` (about 6.0M rows) is held under the byte budget
      and ``WIDE_SQL`` evicts it LRU-first (``result_cache.evicted``);
    - executable and stats caches (result cache off): the second run of
      Q1, Q6 and Q3 counts ``exec_cache.hit`` and no miss and launches as
      the first; ``KEY_MIX_SQL`` twice: its second run hits the stats
      cache and reads no min/max back; both answers equal numpy;
    - plan stats and adaptivity (result cache off): ``ADAPT_SQL`` four
      times through ``Session.execute``: its third run applies a
      ``bucket`` decision (``system.adaptive``), the fourth replays it
      sticky, every answer equal to numpy;
    - the flight recorder: a deadline failure and a fragment retry leave
      one record each, listed by ``system.flight_recorder`` and
      round-tripped by ``export_flight_record``; no success is captured;
    - the ``system`` catalog through ``select ... where ...``, each row
      held to the session's own stores (``runtime_nodes`` names the card);
    - the coalescer: two threads issue Q6 at once (the leader held at a
      scan gate until the follower waits): one executes, one follows
      (``coalesced``), K3 launches once per split, not twice, and both
      results are equal.

    Every launch lies inside a ``fragment:`` span and each launch shape
    is held to its plain version. ``cache_budget`` replaces the default
    ``result_cache_max_bytes`` (the CPU rehearsal's small results)."""
    from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
    from presto_tpu_torch.runtime import faults
    from presto_tpu_torch.runtime.errors import ExceededTimeLimit

    t0 = time.perf_counter()
    li = conn.table_numpy("lineitem", Q6_COLS)
    want = {"q1": q1_sql_expected(conn), "q3": q3_expected(conn),
            "q6": revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li)),
            "key_mix": key_mix_expected(conn), "adapt": adapt_expected(conn)}
    del li
    n_splits = len(list(conn.splits("lineitem")))
    log(f"phase 20: numpy recomputation of {list(want)} at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s; lineitem has {n_splits} splits")
    out = {"walls": {}, "runs": {}}
    query = {"name": None}

    def run(session, label, sql, how="sql"):
        before_launch, before = _launch_counts(), counters()
        query["name"] = label
        try:
            t1 = time.perf_counter()
            res = session.sql(sql) if how == "sql" else session.execute(sql)[0]
            if device == "cuda":
                torch.cuda.synchronize()
            out["walls"][label] = time.perf_counter() - t1
        finally:
            query["name"] = None
        moved = {k: v - before[k] for k, v in counters().items()
                 if k.startswith(("result_cache.", "exec_cache.", "stats_cache.", "adaptive.",
                                  "plan_stats.", "prepare.coalesced", "flight."))
                 and v != before[k]}
        launched = _launch_delta(before_launch, _launch_counts())
        out["runs"][label] = {"counters": moved, "launches": launched,
                              "info": session.query_history[-1]}
        log(f"  {label}: wall {out['walls'][label]:.3f} s, cache_hit "
            f"{session.query_history[-1].cache_hit}, counters {moved}, launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        return res

    with each_probe_shape(query) as probes, first_kernel_calls(query) as calls, \
            launch_spans() as spans:
        _reset_launches()
        # ---- the result cache -------------------------------------------
        session = Session({"tpch": conn}, device=device)
        if cache_budget is not None:
            session.set_property("result_cache_max_bytes", cache_budget)
        for name, sql in CACHE_RUNS.items():
            first = run(session, f"{name} first", sql)
            second = run(session, f"{name} cached", sql)
            same_result(first, want[name], f"phase 20 {name}")
            _bitwise_equal(first, second, f"phase 20 {name} from the result cache")
            a, b = out["runs"][f"{name} first"], out["runs"][f"{name} cached"]
            check(not a["info"].cache_hit and b["info"].cache_hit
                  and b["counters"].get("result_cache.hit") == 1
                  and not any(b["launches"].values()),
                  f"phase 20 {name}: the second run was no launch-free cache hit: {b}")
        if device == "cuda":
            firsts = {k: out["runs"][f"{k} first"]["launches"] for k in CACHE_RUNS}
            check(firsts["q1"]["q1"] == n_splits and firsts["q6"]["leaf_agg"] == n_splits
                  and firsts["q3"]["exists"] > 0,
                  f"phase 20's first runs launched {firsts} over {n_splits} splits")
        session.sql("create table p20_keys as select l_orderkey k from lineitem "
                    "where l_orderkey < 1000")
        base = conn.table_numpy("lineitem", ["l_orderkey"])["l_orderkey"].astype(np.int64)
        keys = base[base < 1000]
        for label in ("mem first", "mem cached"):
            res = run(session, label, CACHED_MEM_SQL)
            same_result(res, {"n": np.array([keys.size]), "s": np.array([int(keys.sum())])},
                        f"phase 20 {label}")
        check(out["runs"]["mem cached"]["info"].cache_hit, "phase 20: the memory query missed")
        session.sql("insert into p20_keys select l_orderkey k from lineitem "
                    "where l_orderkey >= 1000 and l_orderkey < 2000")
        keys = base[base < 2000]
        res = run(session, "mem after insert", CACHED_MEM_SQL)
        check(not out["runs"]["mem after insert"]["info"].cache_hit,
              "phase 20: the INSERT did not invalidate the cached result")
        same_result(res, {"n": np.array([keys.size]), "s": np.array([int(keys.sum())])},
                    "phase 20 after the INSERT")
        budget = session.prop("result_cache_max_bytes")
        big = run(session, "big", BIG_SQL)
        big_key = session.result_cache.keys()[-1]
        check(big.nbytes <= budget and big_key in session.result_cache.keys(),
              f"phase 20: a {big.nbytes}-byte result was not held under {budget}")
        wide = run(session, "wide", WIDE_SQL)
        check(big.nbytes + wide.nbytes > budget
              and out["runs"]["wide"]["counters"].get("result_cache.evicted", 0) >= 1
              and big_key not in session.result_cache.keys()
              and session.result_cache.bytes_used <= budget,
              f"phase 20: {wide.nbytes} B did not evict {big.nbytes} B under {budget}: "
              f"{out['runs']['wide']['counters']}")
        out["big"] = {"rows": len(big), "bytes": big.nbytes, "wide_rows": len(wide),
                      "wide_bytes": wide.nbytes, "budget": budget,
                      "held": session.result_cache.bytes_used}
        del big, wide
        log(f"  the byte budget: {out['big']}")

        # ---- the executable and stats caches ------------------------------
        warm = Session({"tpch": conn}, properties={"result_cache_enabled": False},
                       device=device)
        for name, sql in CACHE_RUNS.items():
            same_result(run(warm, f"{name} exec first", sql), want[name], f"phase 20 {name}")
            same_result(run(warm, f"{name} exec warm", sql), want[name], f"phase 20 {name}")
            a, b = out["runs"][f"{name} exec first"], out["runs"][f"{name} exec warm"]
            check(b["counters"].get("exec_cache.hit", 0) > 0
                  and not b["counters"].get("exec_cache.miss") and a["launches"] == b["launches"],
                  f"phase 20 {name}: warm run {b} against the first {a}")
        for label in ("key mix first", "key mix warm"):
            same_result(run(warm, label, KEY_MIX_SQL), want["key_mix"], f"phase 20 {label}")
        km = out["runs"]["key mix warm"]["counters"]
        check(km.get("stats_cache.hit", 0) >= 1 and not km.get("stats_cache.miss"),
              f"phase 20: the repeated multi-key join read back again: {km}")

        # ---- plan stats and adaptivity ------------------------------------
        adapt = Session({"tpch": conn}, properties={"result_cache_enabled": False},
                        device=device)
        for i in range(4):
            same_result(run(adapt, f"adapt {i + 1}", ADAPT_SQL, how="execute"), want["adapt"],
                        f"phase 20 adaptive run {i + 1}")
        applied = [out["runs"][f"adapt {i + 1}"]["counters"].get("adaptive.bucket_override", 0)
                   + out["runs"][f"adapt {i + 1}"]["counters"].get("adaptive.join_flip", 0)
                   for i in range(4)]
        table = _rows(adapt.sql("select kind, node_id, trigger, applied from adaptive "
                                "where applied = 1"))
        check(applied == [0, 0, 1, 1] and table and table[0][0] in ("bucket", "join_flip"),
              f"phase 20: adaptive decisions {applied}, system.adaptive {table}")
        out["adaptive"] = {"applied": applied, "rows": table}

        # ---- the flight recorder -----------------------------------------
        fs = Session({"tpch": conn}, properties={"result_cache_enabled": False},
                     device=device)
        run(fs, "q1 flight warm-up", QUERIES["q1"])
        t1 = time.perf_counter()
        fs.sql(QUERIES["q1"])
        q1_wall = time.perf_counter() - t1
        fs.set_property("query_max_run_time", q1_wall / 10)
        try:
            fs.sql(QUERIES["q1"])
            check(False, "phase 20: the deadline did not fire")
        except ExceededTimeLimit:
            pass
        fs.set_property("query_max_run_time", None)
        fs.set_property("retry_count", 2)
        fs.set_property("retry_backoff_s", 0.0)
        inj = faults.FaultInjector()
        inj.inject("scan", times=1)
        with faults.injected(inj):
            same_result(fs.sql(QUERIES["q6"]), want["q6"], "phase 20 q6 after a retry")
        recs = fs.flight.records()
        check(len(recs) == 2 and "deadline" in recs[0].triggers
              and "retried" in recs[1].triggers and recs[1].state == "FINISHED",
              f"phase 20's flight records: {[(r.triggers, r.state) for r in recs]}")
        listed = _rows(fs.sql("select query_id, triggers, error_code from flight_recorder "
                              "where oom_rung = 0"))
        check([r[0] for r in listed] == [r.query_id for r in recs],
              f"phase 20: system.flight_recorder listed {listed}")
        exported = json.loads(fs.export_flight_record())
        check([d["queryId"] for d in exported] == [r.query_id for r in recs]
              and json.loads(fs.export_flight_record(query_id=recs[0].query_id))
              == recs[0].to_dict(), "phase 20: the flight export did not round-trip")
        out["flight"] = [(r.triggers, r.error_code, len(r.spans)) for r in recs]

        # ---- the system catalog ------------------------------------------
        hist = _rows(session.sql("select query_id, cache_hit from query_history "
                                 "where cache_hit = 1"))
        check([r[0] for r in hist] == [i.query_id for i in session.history.infos()
                                       if i.cache_hit], f"phase 20: query_history {hist}")
        # the registry and the ledger move while the scan runs: each row
        # lies between the store read before and after the statement
        snap = REGISTRY.snapshot()
        metric = dict(_rows(warm.sql("select name, value from runtime_metrics "
                                     "where value > 0")))
        after = REGISTRY.snapshot()
        check(snap["exec_cache.hit"] <= metric["exec_cache.hit"] <= after["exec_cache.hit"],
              f"phase 20: runtime_metrics exec_cache.hit {metric.get('exec_cache.hit')}")
        hits0 = {r["key"]: r["hits"] for r in EXEC_CACHE.stats_rows()}
        ledger = _rows(warm.sql("select key, kind, hits from exec_cache where hits > 0"))
        hits1 = {r["key"]: r["hits"] for r in EXEC_CACHE.stats_rows()}
        check(ledger and all(hits0.get(k, 0) <= h <= hits1.get(k, -1) and k.startswith(kind)
                             for k, kind, h in ledger),
              f"phase 20: system.exec_cache {ledger[:5]}")
        stats = _rows(adapt.sql("select node_type, actual_rows, runs from plan_stats "
                                "where runs >= 2"))
        check(stats == [(r["node_type"], r["actual_rows"], e.runs)
                        for e in adapt.plan_stats.entries() for r in e.records if e.runs >= 2]
              and stats, f"phase 20: system.plan_stats {stats[:5]}")
        pool = _rows(session.sql("select pool, capacity_bytes from memory_pool "
                                 "where capacity_bytes > 0"))
        check(pool and pool[0][1] == session.pool().snapshot()["capacity_bytes"],
              f"phase 20: system.memory_pool {pool}")
        devs = _rows(session.sql("select device_id, platform, bytes_limit from device_stats "
                                 "where platform = 'gpu'" if device == "cuda" else
                                 "select device_id, platform, bytes_limit from device_stats "
                                 "where platform = 'cpu'"))
        check(len(devs) == (torch.cuda.device_count() if device == "cuda" else 1),
              f"phase 20: system.device_stats {devs}")
        nodes = _rows(session.sql("select node_id, platform from runtime_nodes "
                                  "where platform <> 'none'"))
        name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        check(nodes and name in nodes[0][0], f"phase 20: system.runtime_nodes {nodes}")
        qid = out["runs"]["q1 first"]["info"].query_id
        spans_sql = ("select name, category, plan_node_id from trace_spans "
                     f"where query_id = '{qid}'")
        traced = _rows(session.sql(spans_sql))
        rec = session.traces.for_query(qid)
        check(traced == [(d["name"][:48], d["cat"][:12],
                          int(d["args"].get("plan_node_id", -1)))
                         for d in rec.to_span_dicts()] and traced,
              f"phase 20: system.trace_spans for {qid}: {traced[:5]}")
        out["system"] = {"query_history": len(hist), "exec_cache": len(ledger),
                         "plan_stats": len(stats), "runtime_nodes": nodes,
                         "trace_spans": len(traced)}
        log(f"  the system catalog: {out['system']}")

        # ---- the in-flight coalescer -------------------------------------
        gated = GatedScans(sf=conn.sf, units_per_split=conn.units_per_split, device=device)
        co = Session({"tpch": gated}, device=device)
        box: dict = {}
        before_launch = _launch_counts()

        def issue(tag):
            try:
                box[tag] = co.sql(QUERIES["q6"])
            except Exception as e:  # noqa: BLE001 -- checked below
                box[tag + " error"] = e

        lead = threading.Thread(target=issue, args=("lead",), daemon=True)
        lead.start()
        check(gated.reached.wait(60), "phase 20: the leader never reached its second split")
        follow = threading.Thread(target=issue, args=("follow",), daemon=True)
        follow.start()
        coalescer = co.query_manager.coalescer
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                coalescer.waiters(k) for k in list(coalescer._inflight)):
            time.sleep(0.005)
        gated.go.set()
        lead.join(120)
        follow.join(120)
        check(not lead.is_alive() and not follow.is_alive() and "lead" in box
              and "follow" in box, f"phase 20's coalescer: {box}")
        infos = co.query_history[-2:]
        launched = _launch_delta(before_launch, _launch_counts())
        check(sorted(i.coalesced for i in infos) == [False, True],
              f"phase 20: coalesced flags {[i.coalesced for i in infos]}")
        if device == "cuda":
            check(launched["leaf_agg"] == n_splits,
                  f"phase 20's coalesced Q6 launched {launched} over {n_splits} splits")
        _bitwise_equal(box["lead"], box["follow"], "phase 20's coalesced Q6")
        same_result(box["lead"], want["q6"], "phase 20's coalesced Q6")
        out["coalescer"] = {"launches": launched, "coalesced": [i.coalesced for i in infos]}
        log(f"  coalescer: two Q6 at once, coalesced {out['coalescer']['coalesced']}, "
            f"launches {launched}")
        out["launches"] = _launch_counts()
    launches = out["launches"]
    log(f"  phase 20's launches: "
        f"{ {k: launches[k] for k in ('q1', 'lane_sums', 'leaf_agg', 'exists', 'payload')} }")
    if device == "cuda":
        for k in ("q1", "leaf_agg", "exists"):
            check(launches[k] > 0, f"phase 20 launched no {k} kernel")
    outside = [(k, sp) for (k, sp), inside in zip(spans["launches"], spans["in_fragment"])
               if not inside]
    check(not outside, f"phase 20: kernel launches outside a fragment span: {outside[:5]}")
    out["probe_err"] = hold_probe_shapes(probes)
    out["call_err"] = hold_kernel_calls(calls)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 20's first {cap}-row batch"))
    out["q1_err"] = q1_err
    return out


# ---------------------------------------------------------------------------
# phase 21: the serving tier (fair scheduler, batch gate, QueryServer over
# HTTP) and the streams (StreamWriter, continuous queries, sampled scans)
# ---------------------------------------------------------------------------

#: the tenants of phase 21's ad hoc statements: (name, weight, concurrency cap)
SERVE_TENANTS = (("dash", 1.0, None), ("etl", 1.0, 1), ("gold", 4.0, None))
SERVE_RUNS = {"q1": QUERIES["q1"], "q6": QUERIES["q6"], "q3": QUERIES["q3"]}
#: the batched templates, prepared with ``?`` slots: the reference tests'
#: TopN and an aggregate the leaf matcher refuses (a slot inside the summed
#: value), 8 bindings each (``SERVE_BINDINGS``) behind one held binding
SERVE_TOPN = ("select l_orderkey, l_linenumber, l_quantity from lineitem"
              " where l_extendedprice < {} order by l_orderkey, l_linenumber limit 25")
SERVE_AGG = ("select sum(l_extendedprice + {}) s, count(*) c, max(l_quantity) m"
             " from lineitem where l_partkey < {}")
SERVE_BINDINGS = {"topn": [(v,) for v in (1000, 1500, 2000, 3000, 5000, 8000, 13000, 21000, 34000)],
                  "agg": [(a, p) for a, p in ((1, 500), (2, 1000), (3, 2000), (5, 4000),
                                              (8, 8000), (13, 16000), (21, 32000), (34, 64000),
                                              (55, 128000))]}
#: a template whose aggregate the leaf route takes (a membership fold): it
#: falls back from the gate with the reason ``leaf_route``
SERVE_LEAF = ("select sum(l_extendedprice) s, count(*) c from lineitem where l_suppkey in"
              " (select s_suppkey from supplier where s_acctbal < ?)")
SERVE_LEAF_BINDINGS = (0, 2000, 5000)
#: the streamed memory table: micro-batches of lineitem rows
STREAM_COLS = ["l_orderkey", "l_quantity", "l_extendedprice"]
STREAM_BATCHES = 10
STREAM_SQL = "select sum(l_extendedprice) s, count(*) c from p21_li where l_quantity < 2400"
#: the approximate subscription: TopN from the end of lineitem over half
#: its splits
APPROX_FRACTION = 0.5
APPROX_SQL = ("select l_orderkey, l_linenumber, l_quantity from lineitem"
              " where l_extendedprice < 2000 order by l_orderkey desc, l_linenumber desc limit 25")


def serve_topn_expected(li: dict, price: int, desc: bool = False) -> dict:
    m = li["l_extendedprice"] < price * 100
    k, ln, q = li["l_orderkey"][m], li["l_linenumber"][m], li["l_quantity"][m]
    order = np.lexsort((-ln, -k) if desc else (ln, k))[:25]
    return {"l_orderkey": k[order], "l_linenumber": ln[order], "l_quantity": q[order]}


def serve_agg_expected(li: dict, add: int, partkey: int) -> dict:
    m = li["l_partkey"] < partkey
    px = li["l_extendedprice"][m].astype(np.int64)
    return {"s": np.array([int((px + add * 100).sum())]), "c": np.array([int(m.sum())]),
            "m": np.array([int(li["l_quantity"][m].max())])}


def serve_leaf_expected(li: dict, supplier: dict, balance: int) -> dict:
    keys = np.sort(supplier["s_suppkey"][supplier["s_acctbal"] < balance * 100])
    hit = _lookup(keys, li["l_suppkey"])[1]
    return {"s": np.array([int(li["l_extendedprice"][hit].astype(np.int64).sum())]),
            "c": np.array([int(hit.sum())])}


def sampled_split_indices(n_all: int, fraction: float) -> list:
    """The splits a sampled scan keeps (``LocalExecutor.sampled_splits``'
    evenly strided rule), recomputed here."""
    keep = max(1, int(round(n_all * fraction)))
    if n_all <= 1 or keep >= n_all:
        return list(range(n_all))
    step = n_all / keep
    return [min(int(i * step), n_all - 1) for i in range(keep)]


@contextlib.contextmanager
def held_first_run():
    """Hold the first ``QueryManager.run_plan`` call in the block until
    ``release`` is set: bindings issued meanwhile queue at the batch gate.
    Yields ``(first, release)``."""
    from presto_tpu_torch.runtime.lifecycle import QueryManager

    first, release = threading.Event(), threading.Event()
    orig = QueryManager.run_plan

    def gated(self, executor, plan, info, recorder):
        if not first.is_set():
            first.set()
            release.wait(120)
        return orig(self, executor, plan, info, recorder)

    QueryManager.run_plan = gated
    try:
        yield first, release
    finally:
        release.set()
        QueryManager.run_plan = orig


@contextlib.contextmanager
def counted_scans(conn, table: str):
    """Count ``conn.scan`` calls of ``table``'s splits in the block."""
    seen = {"scans": 0}
    orig = conn.scan

    def scan(split, columns=None, capacity=None):
        if split.table == table:
            seen["scans"] += 1
        return orig(split, columns, capacity)

    conn.scan = scan
    try:
        yield seen
    finally:
        del conn.scan


def _threads(targets) -> list:
    threads = [threading.Thread(target=fn, daemon=True) for fn in targets]
    for t in threads:
        t.start()
    return threads


def _joined(threads, what: str) -> None:
    for t in threads:
        t.join(300)
    check(not any(t.is_alive() for t in threads), f"phase 21: {what} hung")


def _http(base: str, method: str, path: str, body: bytes | None = None, headers=None) -> dict:
    import urllib.request

    req = urllib.request.Request(base + path, data=body, headers=headers or {}, method=method)
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def run_serving_queries(conn, device: str = "cuda") -> dict:
    """Phase 21 at SF1 (``run_serving_queries``): the serving tier.

    - ad hoc statements from three tenants (weights 1, 1 and 4, one capped
      at one running query) through one ``QueryServer`` (two slots, the
      batch gate and the health monitor on): each tenant's threads send
      Q1, Q6 and Q3 at once, through ``submit`` / ``result`` and through
      the ``HttpFrontend`` on 127.0.0.1; every answer equals numpy (an
      HTTP page equals the JSON of the checked answer), ``QueryInfo.
      tenant`` and ``system.tenants`` name the three tenants;
    - a batched template: ``SERVE_TOPN`` and ``SERVE_AGG`` with 8
      concurrent bindings queued behind one held binding: one batched
      dispatch of 8 lanes each (``batch.fallback.error`` 0), ``lineitem``
      scanned once per batch, every lane equal to numpy and to its own
      serial run; the batch's wall beside the 8 serial walls;
    - ``SERVE_LEAF`` (the leaf route's membership fold) falls back with
      ``batch.fallback.leaf_route`` and launches the leaf kernel serially,
      once per split a binding;
    - streams: ``StreamWriter`` appends ``STREAM_BATCHES`` micro-batches
      of lineitem rows to a memory table; an exact subscription delivers
      at every epoch, equal to numpy over the rows at its epoch
      (``subscription.stale_blocked`` 0); an approximate subscription
      (``approx_scan_fraction`` 0.5) is flagged and equals numpy over
      exactly the sampled splits;
    - overload: a forced shed raises ``ServerOverloaded`` with its
      retry-after, a cancelled queued query fails ``QUERY_CANCELLED``,
      and every pool ends at 0.

    Every K1, K3 and K4 launch lies inside a ``fragment:`` span (the
    server's worker threads included) and each launch shape is held to
    its plain version."""
    from presto_tpu_torch.runtime.errors import ServerOverloaded
    from presto_tpu_torch.server.frontend import HttpFrontend, QueryServer, _df_payload
    from presto_tpu_torch.server.scheduler import TenantSpec
    from presto_tpu_torch.stream import StreamWriter

    t0 = time.perf_counter()
    li = conn.table_numpy("lineitem", ["l_orderkey", "l_linenumber", "l_partkey", "l_suppkey",
                                       "l_quantity", "l_extendedprice", "l_discount",
                                       "l_shipdate"])
    supplier = conn.table_numpy("supplier", ["s_suppkey", "s_acctbal"])
    want = {"q1": q1_sql_expected(conn), "q3": q3_expected(conn),
            "q6": revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li))}
    lanes = {("topn", b): serve_topn_expected(li, *b) for b in SERVE_BINDINGS["topn"]}
    lanes.update({("agg", b): serve_agg_expected(li, *b) for b in SERVE_BINDINGS["agg"]})
    leaf_want = {v: serve_leaf_expected(li, supplier, v) for v in SERVE_LEAF_BINDINGS}
    splits = list(conn.splits("lineitem"))
    n_splits = len(splits)
    log(f"phase 21: numpy recomputation at SF{conn.sf:g} in {time.perf_counter() - t0:.1f} s; "
        f"lineitem has {n_splits} splits")
    out = {"walls": {}, "batch": {}, "streams": {}}
    query = {"name": None}
    props = {**MEASURED, "batched_dispatch": True}
    servers = []

    def server(**kw):
        kw.setdefault("properties", dict(props, health_monitor=False))
        srv = QueryServer({"tpch": conn}, device=device, **kw)
        servers.append(srv)
        return srv

    try:
        with each_probe_shape(query) as probes, first_kernel_calls(query) as calls, \
                launch_spans() as spans:
            _reset_launches()
            # ---- ad hoc statements from three tenants ----------------------
            query["name"] = "phase 21 tenants"
            tenants = [TenantSpec(n, weight=w, max_concurrent=c) for n, w, c in SERVE_TENANTS]
            adhoc = server(tenants=tenants, total_slots=2,
                           properties=dict(props, health_monitor=True))
            check(adhoc.health is not None and adhoc.health.running(),
                  "phase 21: the health monitor is not armed")
            fe = HttpFrontend(adhoc, host="127.0.0.1", port=0).start_background()
            base = f"http://127.0.0.1:{fe.port}"
            answers, pages, errors = {}, {}, []

            def submit(tenant, name):
                def go():
                    try:
                        qid = adhoc.submit(SERVE_RUNS[name], tenant=tenant)
                        answers[(tenant, name)] = adhoc.result(qid, timeout_s=300)
                    except Exception as e:  # noqa: BLE001 -- checked below
                        errors.append(e)
                return go

            def over_http(tenant, name):
                def go():
                    try:
                        sub = _http(base, "POST", "/v1/statement", SERVE_RUNS[name].encode(),
                                    {"X-Presto-Tenant": tenant})
                        adhoc.result(sub["id"], timeout_s=300)
                        pages[(tenant, name)] = _http(base, "GET", sub["nextUri"])
                    except Exception as e:  # noqa: BLE001 -- checked below
                        errors.append(e)
                return go

            try:
                before = _launch_counts()
                t1 = time.perf_counter()
                work = [f(t, q) for t, _w, _c in SERVE_TENANTS for q in SERVE_RUNS
                        for f in (submit, over_http)]
                _joined(_threads(work), "the tenants' statements")
                if device == "cuda":
                    torch.cuda.synchronize()
                out["walls"]["tenants"] = time.perf_counter() - t1
            finally:
                fe.shutdown()
            check(not errors, f"phase 21: tenant statements failed: {errors[:3]}")
            for (tenant, name), res in answers.items():
                same_result(res, want[name], f"phase 21 {name} for {tenant}")
                page = pages[(tenant, name)]
                check(page["state"] == "FINISHED" and page["tenant"] == tenant
                      and {k: page[k] for k in ("columns", "data")} == json.loads(
                          json.dumps(_df_payload(res))),
                      f"phase 21: the HTTP page of {name} for {tenant} differs")
            launched = _launch_delta(before, _launch_counts())
            seen_tenants = {i.tenant for i in adhoc.session.query_history}
            table = _rows(adhoc.session.sql("select tenant, admitted, max_concurrent from tenants"
                                            " where admitted > 0"))
            check({n for n, _w, _c in SERVE_TENANTS} <= seen_tenants
                  and {r[0] for r in table} == {n for n, _w, _c in SERVE_TENANTS}
                  and all(r[1] == 2 * len(SERVE_RUNS) for r in table)
                  and dict((r[0], r[2]) for r in table)["etl"] == 1,
                  f"phase 21: tenants {seen_tenants}, system.tenants {table}")
            if device == "cuda":
                check(launched["q1"] > 0 and launched["q1"] % n_splits == 0
                      and launched["leaf_agg"] > 0 and launched["leaf_agg"] % n_splits == 0
                      and launched["exists"] > 0,
                      f"phase 21's tenants launched {launched} over {n_splits} splits")
            out["tenants"] = {"launches": {k: launched[k] for k in ("q1", "leaf_agg", "exists")},
                              "system_tenants": table,
                              "coalesced": sum(i.coalesced for i in adhoc.session.query_history),
                              "statements": len(work)}
            log(f"  tenants: {len(work)} statements in {out['walls']['tenants']:.3f} s, "
                f"{out['tenants']}")

            # ---- batched templates ------------------------------------------
            batcher = server()
            serial = measured_session({"tpch": conn}, device=device)
            for name, fmt in (("topn", SERVE_TOPN), ("agg", SERVE_AGG)):
                query["name"] = f"phase 21 batched {name}"
                binds = SERVE_BINDINGS[name]
                # prepared with ``?`` slots: the aggregate's literals would
                # stay baked (the leaf matcher takes it with literals)
                template = fmt.replace("{}", "?")
                batcher.prepare(template, name=name, tenant="batch")
                batcher.execute_prepared(name, list(binds[0]), tenant="batch")
                serial_handle = serial.prepare(template)
                results, errors = {}, []

                def run(b, name=name):
                    try:
                        results[b] = batcher.execute_prepared(name, list(b), tenant="batch")
                    except Exception as e:  # noqa: BLE001 -- checked below
                        errors.append(e)

                before, moves0 = _launch_counts(), counters()
                gate = batcher.session.query_manager.batch_gate
                with held_first_run() as (first, release), counted_scans(conn, "lineitem") as sc:
                    held = _threads([lambda: run(binds[0])])
                    check(first.wait(120), f"phase 21 {name}: the first binding never ran")
                    rest = _threads([lambda b=b: run(b) for b in binds[1:]])
                    deadline = time.monotonic() + 120
                    while sum(gate.queue_depth(fp) for fp in list(gate._templates)) < len(binds) - 1:
                        check(time.monotonic() < deadline, f"phase 21 {name}: bindings never queued")
                        time.sleep(0.002)
                    t1 = time.perf_counter()
                    release.set()
                    _joined(held + rest, f"the {name} bindings")
                    if device == "cuda":
                        torch.cuda.synchronize()
                    batch_wall = time.perf_counter() - t1
                check(not errors, f"phase 21 {name}: {errors[:3]}")
                moved = {k: v - moves0[k] for k, v in counters().items()
                         if k.startswith("batch.") and v != moves0[k]}
                infos = [i for i in batcher.session.query_history if i.tenant == "batch"][-len(binds):]
                check(moved.get("batch.dispatched") == 1
                      and moved.get("batch.queries") == len(binds) - 1
                      and not moved.get("batch.fallback.error")
                      and {i.batch_size for i in infos if i.batched} == {len(binds) - 1},
                      f"phase 21 {name}: batch counters {moved}")
                check(sc["scans"] == 2 * n_splits,
                      f"phase 21 {name}: lineitem scanned {sc['scans']} times for one held run "
                      f"and one batch over {n_splits} splits")
                serial_walls = []
                for b in binds:
                    same_result(results[b], lanes[(name, b)], f"phase 21 {name} lane {b}")
                    t1 = time.perf_counter()
                    alone, _info = serial.execute_prepared(serial_handle, list(b))
                    if device == "cuda":
                        torch.cuda.synchronize()
                    serial_walls.append(time.perf_counter() - t1)
                    _bitwise_equal(results[b], alone, f"phase 21 {name} lane {b} against its serial run")
                out["batch"][name] = {"counters": moved, "scans": sc["scans"],
                                      "lanes": len(binds) - 1, "batch_wall_s": batch_wall,
                                      "serial_walls_s": serial_walls[1:],
                                      "launches": _launch_delta(before, _launch_counts())}
                log(f"  batched {name}: {len(binds) - 1} lanes in one dispatch, counters {moved}, "
                    f"lineitem scans {sc['scans']} (held run + batch), held run and batch "
                    f"{batch_wall:.4f} s against the lanes' serial walls "
                    f"{sum(serial_walls[1:]):.4f} s ({[round(w, 4) for w in serial_walls[1:]]})")
            out["batch"]["dispatched"] = sum(out["batch"][n]["counters"].get("batch.dispatched", 0)
                                             for n in ("topn", "agg"))
            out["batch"]["fallback.error"] = sum(
                out["batch"][n]["counters"].get("batch.fallback.error", 0) for n in ("topn", "agg"))

            # ---- a template that falls back to the leaf kernel ---------------
            query["name"] = "phase 21 leaf fallback"
            handle = batcher.prepare(SERVE_LEAF, name="leaf", tenant="batch")
            batcher.execute_prepared(handle, [SERVE_LEAF_BINDINGS[0]], tenant="batch")
            results, errors = {}, []

            def run_leaf(v):
                try:
                    results[v] = batcher.execute_prepared(handle, [v], tenant="batch")
                except Exception as e:  # noqa: BLE001 -- checked below
                    errors.append(e)

            before, moves0 = _launch_counts(), counters()
            gate = batcher.session.query_manager.batch_gate
            with held_first_run() as (first, release):
                held = _threads([lambda: run_leaf(SERVE_LEAF_BINDINGS[0])])
                check(first.wait(120), "phase 21 leaf: the first binding never ran")
                rest = _threads([lambda v=v: run_leaf(v) for v in SERVE_LEAF_BINDINGS[1:]])
                deadline = time.monotonic() + 120
                while sum(gate.queue_depth(fp) for fp in list(gate._templates)) < 2:
                    check(time.monotonic() < deadline, "phase 21 leaf: bindings never queued")
                    time.sleep(0.002)
                release.set()
                _joined(held + rest, "the leaf bindings")
            check(not errors, f"phase 21 leaf: {errors[:3]}")
            moved = {k: v - moves0[k] for k, v in counters().items()
                     if k.startswith("batch.") and v != moves0[k]}
            launched = _launch_delta(before, _launch_counts())
            check(moved.get("batch.fallback.leaf_route", 0) >= 1 and not moved.get("batch.dispatched"),
                  f"phase 21 leaf: counters {moved}")
            if device == "cuda":
                check(launched["leaf_agg"] == len(SERVE_LEAF_BINDINGS) * n_splits,
                      f"phase 21 leaf: launched {launched} over {n_splits} splits")
            for v in SERVE_LEAF_BINDINGS:
                same_result(results[v], leaf_want[v], f"phase 21 leaf binding {v}")
            out["leaf_fallback"] = {"counters": moved, "leaf_launches": launched["leaf_agg"]}
            log(f"  leaf-route template: counters {moved}, leaf launches {launched['leaf_agg']}")

            # ---- streams ----------------------------------------------------
            query["name"] = "phase 21 streams"
            stream_srv = server(approx_properties={"approx_scan_fraction": APPROX_FRACTION})
            writer = StreamWriter(stream_srv.session)
            rows = len(li["l_orderkey"])
            chunk = -(-rows // STREAM_BATCHES)
            moves0 = counters()
            first_batch = {c: li[c][:chunk].astype(np.int64) for c in STREAM_COLS}
            r = writer.append("p21_li", first_batch)
            sub = stream_srv.subscribe(STREAM_SQL, tenant="dash")
            got = [sub.wait_for_seq(1, timeout_s=120)]
            t1 = time.perf_counter()
            for i in range(1, STREAM_BATCHES):
                r = writer.append("p21_li", {c: li[c][i * chunk:(i + 1) * chunk].astype(np.int64)
                                             for c in STREAM_COLS})
                got.append(sub.wait_for_epoch("p21_li", r.epoch, timeout_s=120))
            out["walls"]["stream deliveries"] = time.perf_counter() - t1
            for res in got:
                n = res.epochs["p21_li"] * chunk
                m = li["l_quantity"][:n] < 2400
                same_result(res.df, {"s": np.array([int(li["l_extendedprice"][:n][m].astype(
                    np.int64).sum())]), "c": np.array([int(m.sum())])},
                    f"phase 21 subscription at epoch {res.epochs['p21_li']}")
            check([res.epochs["p21_li"] for res in got] == list(range(1, STREAM_BATCHES + 1))
                  and not any(res.approximate for res in got),
                  f"phase 21: deliveries at epochs {[res.epochs for res in got]}")
            approx = stream_srv.subscribe(APPROX_SQL, tenant="dash", mode="approx")
            a = approx.wait_for_seq(1, timeout_s=120)
            kept = sampled_split_indices(n_splits, APPROX_FRACTION)
            parts = [conn.scan_numpy(splits[i], ["l_orderkey", "l_linenumber", "l_quantity",
                                                 "l_extendedprice"]) for i in kept]
            sampled = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
            same_result(a.df, serve_topn_expected(sampled, 2000, desc=True),
                        "phase 21 approximate subscription over the sampled splits")
            moved = {k: v - moves0[k] for k, v in counters().items()
                     if k.startswith(("subscription.", "stream.", "scan.splits_sampled_out"))
                     and v != moves0[k]}
            check(a.approximate and moved.get("subscription.stale_blocked", 0) == 0
                  and moved.get("stream.appends") == STREAM_BATCHES
                  and moved.get("scan.splits_sampled_out", 0) == n_splits - len(kept)
                  or n_splits == 1,
                  f"phase 21 streams: approximate {a.approximate}, counters {moved}")
            out["streams"] = {"counters": moved, "epochs": len(got), "sampled_splits": kept,
                              "stale_blocked": moved.get("subscription.stale_blocked", 0),
                              "refresh_s": [round(res.refresh_s, 6) for res in got]}
            log(f"  streams: {len(got)} deliveries, one an epoch, in "
                f"{out['walls']['stream deliveries']:.3f} s; approximate over splits {kept} of "
                f"{n_splits}; counters {moved}")

            # ---- overload ---------------------------------------------------
            query["name"] = "phase 21 overload"
            shed = server(total_slots=1, shed_tenant_queue_limit=0)
            try:
                shed.submit(QUERIES["q6"], tenant="dash")
                check(False, "phase 21: the forced shed admitted the query")
            except ServerOverloaded as e:
                check(e.retry_after_s > 0 and e.retryable, f"phase 21: shed {e!r}")
                out["shed_retry_after_s"] = e.retry_after_s
            queued = server(total_slots=1)
            hold = queued.scheduler.acquire("default")
            try:
                qid = queued.submit(QUERIES["q6"])
                check(queued.cancel(qid)["cancelled"], "phase 21: the cancel was refused")
            finally:
                queued.scheduler.release(hold)
            check(queued._queries[qid]["done"].wait(120), "phase 21: the cancelled query hung")
            page = queued.poll(qid)
            check(page["state"] == "FAILED" and page["errorCode"] == "QUERY_CANCELLED",
                  f"phase 21: the cancelled page {page}")
            out["cancelled"] = page["errorCode"]
            out["launches"] = _launch_counts()
    finally:
        for srv in servers:
            summary = srv.shutdown(drain_timeout_s=120)
            check(summary["drained"] and summary["pool_reserved_bytes"] == 0,
                  f"phase 21: a server did not drain: {summary}")
    launches = out["launches"]
    log(f"  phase 21's launches: "
        f"{ {k: launches[k] for k in ('q1', 'lane_sums', 'leaf_agg', 'exists', 'payload')} }")
    if device == "cuda":
        for k in ("q1", "leaf_agg", "exists"):
            check(launches[k] > 0, f"phase 21 launched no {k} kernel")
    outside = [(k, sp) for (k, sp), inside in zip(spans["launches"], spans["in_fragment"])
               if not inside]
    check(not outside, f"phase 21: kernel launches outside a fragment span: {outside[:5]}")
    log(f"  kernel launches by innermost span: "
        f"{_summed(*({f'{k} in {sp}': 1} for k, sp in spans['launches']))}; all "
        f"{len(spans['launches'])} inside a fragment span, from the server's threads")
    out["probe_err"] = hold_probe_shapes(probes)
    out["call_err"] = hold_kernel_calls(calls)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 21's first {cap}-row batch"))
    out["q1_err"] = q1_err
    return out



# ---------------------------------------------------------------------------
# phase 22: the CLI (python -m presto_tpu_torch) in process and as a server
# ---------------------------------------------------------------------------

#: the scale of each DECIMAL column the CLI prints in Q1, Q6 and Q3
CLI_SCALES = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4, "sum_charge": 4,
              "revenue": 4}
#: phase 22's LIKE statement: the LIKE kernel once per `part` split
CLI_LIKE = "select count(*) as n from part where p_name like '%green%'"
#: a statement that fails at run time (its semi-join keys are wide
#: strings), so the flight recorder captures it
CLI_FAILING = "select count(*) as n from customer where c_phone in (select s_phone from supplier)"
#: the kernels whose names a profiled CLI query's trace must hold
CLI_TRACED = {k: OBS_KERNELS[k] for k in ("q1", "leaf_agg", "exists")}


def _cli(argv: list) -> tuple:
    """``presto_tpu_torch.__main__.main(argv)`` in this process: (stdout,
    stderr) as text."""
    import io

    from presto_tpu_torch.__main__ import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli_main(argv)
    return out.getvalue(), err.getvalue()


def printed_tables(text: str) -> list:
    """The tables a CLI run printed, in order: ``(header, rows, wall_s)``,
    each row its whitespace-separated cells (phase 22's answers hold no
    blank inside a cell)."""
    lines = text.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.fullmatch(r"\((\d+) rows?\)", line)
        if m is None:
            continue
        n = int(m.group(1))
        wall = re.fullmatch(r"\[(\d+\.\d{3})s\]", lines[i + 1])
        check(wall is not None, f"phase 22: no wall line after {line!r}")
        out.append((lines[i - n - 1].split(), [r.split() for r in lines[i - n:i]],
                    float(wall.group(1))))
    return out


def _cli_cell(name: str, value) -> str:
    """The text the CLI prints for an oracle value of column ``name``."""
    if name in CLI_SCALES:
        return str(np.float64(np.int64(value)) / 10 ** CLI_SCALES[name])
    if name == "o_orderdate":
        return str(np.datetime64("1970-01-01", "D") + np.int64(value))
    return str(value)


def check_printed(table: tuple, want: dict, what: str) -> None:
    """A printed table equals an oracle cell for cell."""
    header, rows, _wall = table
    check(header == list(want), f"{what}: columns {header} != {list(want)}")
    cols = [[_cli_cell(n, v) for v in want[n]] for n in header]
    expect = [list(r) for r in zip(*cols)]
    check(rows == expect, f"{what}: printed rows differ:\n{rows[:3]}\n{expect[:3]}")


def like_count_expected(conn) -> int:
    """Rows of ``part`` whose name contains 'green' (``CLI_LIKE``)."""
    names = conn.table_numpy("part", ["p_name"])["p_name"]
    return int(sum(b"green" in bytes(r) for r in names))


def _metric(text: str, name: str) -> float:
    """A counter's value in OpenMetrics text (``presto_tpu_<name>_total``)."""
    key = "presto_tpu_" + name.replace(".", "_") + "_total "
    hits = [float(ln[len(key):]) for ln in text.splitlines() if ln.startswith(key)]
    check(len(hits) == 1, f"phase 22: the metrics text has {len(hits)} lines for {name}")
    return hits[0]


def trace_kernel_names(path: str) -> set:
    """The CUDA kernels a Chrome trace holds, by ``CLI_TRACED`` key."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {k for e in events if e.get("cat") == "kernel"
            for k, fns in CLI_TRACED.items() if any(fn in e["name"] for fn in fns)}


def run_cli_queries(sf: float, device: str = "cuda") -> dict:
    """Phase 22's in-process part: ``presto_tpu_torch.__main__.main``
    drives Q1, Q6 and Q3, a SET SESSION, SHOW SESSION, EXPLAIN ANALYZE of
    Q6 and the three again under ``profile_dir`` (``metrics``: the
    registry as OpenMetrics text after them), a LIKE statement after
    ``SET SESSION pallas_strings`` off and then on, ``health`` after Q6 and
    ``flightrec`` over a failing statement. Every printed answer against
    numpy, the metrics text against the registry, the profiler traces
    against the kernels (on the card). Each CLI session runs with the
    result cache off, so every printed statement executes."""
    import tempfile

    conn = TpchConnector(sf=sf, device=device)
    t0 = time.perf_counter()
    li = conn.table_numpy("lineitem", Q6_COLS)
    want = {"q1": q1_sql_expected(conn), "q3": q3_expected(conn),
            "q6": revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li)),
            "like": {"n": [like_count_expected(conn)]}}
    del li
    log(f"phase 22: numpy recomputation at SF{sf:g} in {time.perf_counter() - t0:.1f} s")
    base = ["--device", device, "--catalog", "tpch", "--sf", f"{sf:g}",
            "--session", "result_cache_enabled=false"]
    out = {"walls": {}, "parts": {}}
    query = {"name": "phase 22 CLI"}
    with tempfile.TemporaryDirectory() as tmp, each_probe_shape(query) as probes, \
            first_kernel_calls(query) as calls, launch_spans() as spans:
        _reset_launches()
        prof = os.path.join(tmp, "profiles")
        script = os.path.join(tmp, "phase22.sql")
        queries = [QUERIES["q1"], QUERIES["q6"], QUERIES["q3"]]
        with open(script, "w") as f:
            f.write(";\n".join(queries + [
                "set session direct_group_limit = 4096", "show session",
                "explain analyze " + QUERIES["q6"],
                f"set session profile_dir = '{prof}'"] + queries
                + ["set session profile_dir = ''"]) + ";\n")
        before, launched = REGISTRY.snapshot(), _launch_counts()
        text, err = _cli(base + ["metrics", "-f", script])
        after = REGISTRY.snapshot()
        out["parts"]["script"] = _launch_delta(launched, _launch_counts())
        check(err == "", f"phase 22: the script wrote to stderr: {err[:500]}")
        tables = printed_tables(text)
        check(len(tables) == 6, f"phase 22: {len(tables)} tables printed, 6 expected")
        for (name, _q), table in zip([("q1", 0), ("q6", 1), ("q3", 2)] * 2, tables):
            check_printed(table, want[name], f"phase 22 CLI {name}")
        out["walls"] = {f"{n} {turn}": t[2] for turn, part in (("first", tables[:3]),
                                                               ("profiled", tables[3:]))
                        for n, t in zip(("q1", "q6", "q3"), part)}
        lines = text.splitlines()
        check("SET direct_group_limit = 4096" in lines, "phase 22: no SET line")
        shown = [ln for ln in lines if re.fullmatch(r"[a-z_0-9]+ = .*", ln)]
        from presto_tpu_torch.runtime.properties import SESSION_PROPERTIES

        check([ln.split(" = ")[0] for ln in shown] == list(SESSION_PROPERTIES),
              "phase 22: SHOW SESSION's names differ from the property table")
        check("direct_group_limit = 4096" in shown and "pallas_strings = None" in shown,
              "phase 22: SHOW SESSION's values")
        check(any(re.match(r"\s*Aggregate  \[wall [0-9.]+ms, rows [0-9,]+->1,", ln)
                  for ln in lines), "phase 22: EXPLAIN ANALYZE printed no annotated plan")
        moved = {k: after.get(k, 0) - before.get(k, 0) for k in
                 ("exec.q1_fused_route", "exec.leaf_fused_route", "exec.pallas_join_route",
                  "query.completed")}
        for k in moved:
            check(_metric(text, k) == after.get(k, 0),
                  f"phase 22: the metrics text's {k} {_metric(text, k)} != {after.get(k, 0)}")
        # the fused leaf route counts Q1's (the Q1 kernel) and Q6's runs
        check(moved["exec.q1_fused_route"] == 2 and moved["exec.leaf_fused_route"] == 4
              and moved["exec.pallas_join_route"] >= 2,
              f"phase 22: route counters moved {moved}")
        traces = sorted(os.listdir(prof))
        check(len(traces) == 3, f"phase 22: {len(traces)} profiler traces, 3 expected")
        out["traced"] = sorted(set().union(*(trace_kernel_names(os.path.join(prof, t))
                                             for t in traces)))
        if device == "cuda":
            check(out["traced"] == sorted(CLI_TRACED),
                  f"phase 22: the profiled queries' traces name {out['traced']}")
        log(f"  script: walls {out['walls']}; route counters {moved}; traces name "
            f"{out['traced']}; launches "
            f"{ {k: v for k, v in out['parts']['script'].items() if v} }")
        # LIKE after SET SESSION pallas_strings off, then on: the setting
        # the card cannot take (off, C25) is refused and the session keeps
        # its route, the kernel; the CPU takes both, its one route the
        # plain version
        n_parts = len(list(conn.splits("part")))
        like_script = os.path.join(tmp, "like.sql")
        for setting in ("false", "true"):
            with open(like_script, "w") as f:
                f.write(f"set session pallas_strings = {setting};\n{CLI_LIKE};\n")
            launched = _launch_counts()
            text, err = _cli(base + ["-f", like_script])
            delta = _launch_delta(launched, _launch_counts())
            out["parts"][f"like {setting}"] = delta
            if setting == "false" and device == "cuda":
                check(err.strip() == "error: NotSupported: pallas_strings=false would run the "
                      "plain string predicates on the card; the port always launches its "
                      "CUDA string kernels there", f"phase 22: off on the card: {err!r}")
            else:
                check(err == "" and f"SET pallas_strings = {setting.title()}" in text,
                      f"phase 22 SET pallas_strings = {setting}: {err[:300]!r}")
            check_printed(printed_tables(text)[0], want["like"], f"phase 22 LIKE {setting}")
            check(delta["like"] == (n_parts if device == "cuda" else 0),
                  f"phase 22: LIKE after pallas_strings={setting} launched {delta['like']}")
        # health after a statement, flightrec over a failing one
        text, err = _cli(base + ["health", "-e", QUERIES["q6"]])
        check_printed(printed_tables(text)[0], want["q6"], "phase 22 health's Q6")
        for section in ("== devices ==", "== health ==", "== slo ==",
                        "== top queries (by execution_s) =="):
            check(section in text.splitlines(), f"phase 22: health lacks {section}")
        platform = "gpu" if device == "cuda" else "cpu"
        check(f"({platform}):" in text, f"phase 22: health's device rows: {text[:300]}")
        text, err = _cli(base + ["flightrec", "-e", CLI_FAILING])
        check(err.strip() == "error: NotImplementedError: wide string semi-join keys",
              f"phase 22: flightrec's statement: {err!r}")
        records = json.loads(text)
        check(len(records) == 1 and records[0]["state"] == "FAILED"
              and "wide string semi-join keys" in records[0]["error"]
              and records[0]["planRender"], f"phase 22: flight records {text[:300]}")
        out["launches"] = _launch_counts()
    out["probe_err"] = hold_probe_shapes(probes)
    out["call_err"] = hold_kernel_calls(calls)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 22's first {cap}-row batch"))
    out["q1_err"] = q1_err
    if device == "cuda":
        for k in ("q1", "leaf_agg", "exists", "like"):
            check(out["launches"][k] > 0, f"phase 22 launched no {k} kernel")
    return out


def run_cli_serve(sf: float, device: str = "cuda") -> dict:
    """Phase 22's subprocess: ``python -m presto_tpu_torch serve --port
    0``, its port read from its first line, Q1 POSTed over HTTP and its
    page held to numpy, then SIGINT and the drain line
    (``pool_reserved_bytes=0``). The process is killed on any failure."""
    import queue
    import signal

    conn = TpchConnector(sf=sf, device=device)
    want = q1_sql_expected(conn)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "presto_tpu_torch", "serve", "--port", "0",
                             "--sf", f"{sf:g}", "--device", device],
                            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    out = {}
    try:
        first = lines.get(timeout=300)
        m = re.search(r"http://127\.0\.0\.1:(\d+) ", first)
        check(m is not None, f"phase 22: the server's first line {first!r}")
        base = f"http://127.0.0.1:{m.group(1)}"
        out["start_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        page = _http(base, "POST", "/v1/statement", QUERIES["q1"].encode())
        uri = page["nextUri"]
        deadline = time.monotonic() + 300
        while page.get("state") not in ("FINISHED", "FAILED"):
            check(time.monotonic() < deadline, "phase 22: the served Q1 never finished")
            time.sleep(0.05)
            page = _http(base, "GET", uri)
        out["q1_s"] = time.perf_counter() - t1
        check(page["state"] == "FINISHED" and page["columns"] == list(want),
              f"phase 22: the served Q1's page {str(page)[:300]}")
        for i, name in enumerate(page["columns"]):
            got = [row[i] for row in page["data"]]
            w = want[name]
            if name in CLI_SCALES:
                ok = np.allclose(got, np.asarray(w, np.float64) / 10 ** CLI_SCALES[name],
                                 rtol=1e-12, atol=0)
            elif name.startswith("avg_"):
                ok = list(np.float32(got)) == list(w)
            else:
                ok = [str(g) for g in got] == [str(x) for x in w]
            check(ok, f"phase 22: the served Q1's {name}: {got} != {list(w)}")
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=120)
        reader.join(timeout=10)
        rest = []
        while not lines.empty():
            rest.append(lines.get())
        drain = [ln.strip() for ln in rest if ln.startswith("drained=")]
        check(len(drain) == 1 and "drained=True" in drain[0]
              and "pool_reserved_bytes=0 " in drain[0] and proc.returncode == 0,
              f"phase 22: the server's drain: rc {proc.returncode}, {rest[-5:]}")
        out["drain"] = drain[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"  serve: first line after {out['start_s']:.1f} s, Q1 over HTTP {out['q1_s']:.3f} s; "
        f"{out['drain']}")
    return out


# ---------------------------------------------------------------------------
# phase 23: a mesh session (the distributed executor over 4 shards)
# ---------------------------------------------------------------------------

#: shards of phase 23's mesh; on one card every shard lives on it
MESH_SHARDS = 4
#: phase 23's statements, each run on the mesh and on one device
MESH_SQL = {
    "q1": QUERIES["q1"],
    "q6": QUERIES["q6"],
    # PARTIAL, the exchange on hash(l_orderkey), FINAL, then TopN
    "top groups": "select l_orderkey, sum(l_quantity) as q from lineitem group by l_orderkey "
                  "order by q desc, l_orderkey limit 10",
    # the range sort: MESH_GATHER_LIMIT is below orders' rows
    "orders sort": "select o_orderkey, o_totalprice from orders "
                   "order by o_totalprice desc, o_orderkey",
    # LIKE over part's shards, then a global aggregation
    "part like": CLI_LIKE,
    # LIKE over orders' shards, then a direct-strategy fold per shard
    "direct": "select o_orderstatus, count(*) as c, sum(o_totalprice) as s from orders "
              "where o_comment like '%special%requests%' group by o_orderstatus",
}
#: phase 23's ``gather_row_limit``: below orders' rows at SF1, so only the
#: range-partition sort can order them
MESH_GATHER_LIMIT = 1 << 20


def mesh_expected(conn) -> dict:
    """Phase 23's numpy oracles: Q1, Q6, the top order groups, the sorted
    orders and the LIKE count (the direct statement is held to the
    one-device session only)."""
    li = conn.table_numpy("lineitem", Q6_COLS + ["l_orderkey"])
    want = {"q1": q1_sql_expected(conn),
            "q6": revenue(li["l_extendedprice"], li["l_discount"], q6_mask(li)),
            "part like": {"n": [like_count_expected(conn)]}}
    keys = li["l_orderkey"].astype(np.int64)
    sums = np.bincount(keys, weights=li["l_quantity"].astype(np.float64)).astype(np.int64)
    present = np.bincount(keys) > 0
    ks = np.flatnonzero(present)
    top = np.lexsort((ks, -sums[ks]))[:10]
    want["top groups"] = {"l_orderkey": ks[top], "q": sums[ks][top]}
    del li
    o = conn.table_numpy("orders", ["o_orderkey", "o_totalprice"])
    order = np.lexsort((o["o_orderkey"], -o["o_totalprice"].astype(np.int64)))
    want["orders sort"] = {"o_orderkey": o["o_orderkey"][order],
                           "o_totalprice": o["o_totalprice"][order]}
    return want


def run_mesh_queries(conn, device: str = "cuda") -> dict:
    """Phase 23: ``Session(mesh=make_mesh(4, devices=[cuda:0] * 4))`` over
    TPC-H at ``conn``'s scale: Q1 and Q6 on the distributed leaf route (K1
    and K3 once per shard at the shard's capacity), the top order groups
    (PARTIAL, the multi-round exchange, FINAL, TopN), orders range-sorted
    under a gather guard below its rows, a LIKE over part's shards and a
    direct-strategy fold (K2) after a LIKE over orders' shards; each answer
    equal to its numpy oracle (:func:`mesh_expected`) and to the
    one-device session's, with its wall, its ``exchange.*`` counter moves
    and exchange walls and the host's reads of the round flag. Then
    EXPLAIN (TYPE DISTRIBUTED) of the group-by and ``python -m
    presto_tpu_torch --mesh 1 -e`` Q6. Every kernel launch shape of the
    mesh runs is held to its plain version; the launches are counted from
    0 over the mesh runs alone."""
    from presto_tpu_torch.parallel import exchange as PX
    from presto_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    want = mesh_expected(conn)
    log(f"phase 23: numpy recomputation of {list(want)} at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    home = "cuda:0" if device == "cuda" else "cpu"
    mesh = make_mesh(MESH_SHARDS, devices=[home] * MESH_SHARDS)
    props = {"gather_row_limit": MESH_GATHER_LIMIT}
    out = {"walls": {}, "local_walls": {}, "exchange": {}, "flag_reads": {}}
    local = {}
    for name, sql in MESH_SQL.items():
        session = measured_session({"tpch": conn}, properties=props, device=device)
        t0 = time.perf_counter()
        local[name] = session.sql(sql)
        out["local_walls"][name] = time.perf_counter() - t0
    query = {"name": None}
    with first_kernel_calls(query) as calls, launch_spans() as spans:
        # the main path of the phase: launches counted from 0 to here
        _reset_launches()
        for name, sql in MESH_SQL.items():
            session = measured_session({"tpch": conn}, properties=props, device=device,
                                       mesh=mesh)
            query["name"] = f"phase 23 {name}"
            before, reads = REGISTRY.snapshot(), PX.flag_reads
            try:
                t0 = time.perf_counter()
                res = session.sql(sql)
                if device == "cuda":
                    torch.cuda.synchronize()
                out["walls"][name] = time.perf_counter() - t0
            finally:
                query["name"] = None
            after = REGISTRY.snapshot()
            info = session.query_history[-1]
            spans_ = session.traces.for_query(info.query_id).spans
            out["exchange"][name] = {
                "counters": {k: after[k] - before.get(k, 0) for k in after
                             if k.startswith("exchange.") and not k.endswith(
                                 (".p50", ".p95", ".p99", ".max"))
                             and after[k] != before.get(k, 0)},
                "walls_ms": [(sp.name, round((sp.t1 - sp.t0) * 1e3, 3)) for sp in spans_
                             if sp.name.startswith("exchange:")]}
            out["flag_reads"][name] = PX.flag_reads - reads
            if name in want:
                same_result(res, want[name], f"phase 23 {name}")
            same_result(res, result_dict(local[name]),
                        f"phase 23 {name} against the one-device session")
            log(f"  {name}: wall {out['walls'][name]:.3f} s (one device "
                f"{out['local_walls'][name]:.3f} s), exchange {out['exchange'][name]}, "
                f"round-flag reads {out['flag_reads'][name]}")
        out["launches"] = _launch_counts()
    launches = out["launches"]
    q1_caps = sorted(spans["q1 batches"])
    log(f"  phase 23's launches: "
        f"{ {k: launches[k] for k in ('q1', 'lane_sums', 'leaf_agg', 'like')} }; Q1 kernel by "
        f"capacity {q1_caps}; leaf by instance {launches['by_instance']}; LIKE by shape "
        f"{launches['like_by_shape']}")
    if device == "cuda":
        check(launches["q1"] == MESH_SHARDS and launches["leaf_agg"] >= MESH_SHARDS,
              f"phase 23: K1 {launches['q1']} and K3 {launches['leaf_agg']} launches, one a "
              f"shard expected")
        # a filter runs once over the shard-major batch (one LIKE launch a
        # statement); the direct fold once a shard
        check(launches["like"] >= 2 and launches["lane_sums"] >= MESH_SHARDS,
              f"phase 23: LIKE {launches['like']} and lane-sums {launches['lane_sums']} "
              f"launches")
    check(out["exchange"]["top groups"]["counters"].get("exchange.rounds", 0) >= 1
          and out["exchange"]["orders sort"]["counters"].get("exchange.rounds", 0) >= 1,
          f"phase 23: no partitioned exchange ran: {out['exchange']}")
    check(out["flag_reads"]["top groups"] >= 2 and out["flag_reads"]["orders sort"] >= 2,
          f"phase 23: round-flag reads {out['flag_reads']}")
    out["call_err"] = hold_kernel_calls(calls)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 23's first {cap}-row shard"))
        log(f"  q1_step at phase 23's first {cap}-row shard: equal to its plain version")
    out["q1_err"] = q1_err
    if device == "cuda":
        check(bool(spans["q1 batches"]) and any(k == "leaf_agg" for k, _s in calls)
              and any(k == "like" for k, _s in calls) and any(k == "lane_sums" for k, _s in calls),
              f"phase 23's shard shapes not held: {sorted(calls)}")
    # EXPLAIN (TYPE DISTRIBUTED), and the CLI on a 1-shard mesh
    session = measured_session({"tpch": conn}, device=device, mesh=mesh)
    text = session.explain_distributed(MESH_SQL["top groups"])
    check(text == measured_session({"tpch": conn}, device=device).explain_distributed(
        MESH_SQL["top groups"]) and "[hash(l_orderkey) <- fragment 2]" in text
          and text.startswith("Fragment 0 [single]"), f"phase 23: EXPLAIN (TYPE DISTRIBUTED):\n{text}")
    out["explain"] = text
    log("  EXPLAIN (TYPE DISTRIBUTED) of the top order groups:\n" + text)
    cli_out, cli_err = _cli(["--device", device, "--catalog", "tpch", "--sf", f"{conn.sf:g}",
                             "--session", "result_cache_enabled=false", "--mesh", "1",
                             "-e", QUERIES["q6"]])
    check(cli_err == "", f"phase 23: --mesh 1 wrote to stderr: {cli_err[:300]}")
    tables = printed_tables(cli_out)
    check(len(tables) == 1, f"phase 23: --mesh 1 printed {len(tables)} tables")
    check_printed(tables[0], want["q6"], "phase 23 --mesh 1 Q6")
    out["cli_wall"] = tables[0][2]
    log(f"  python -m presto_tpu_torch --mesh 1 -e Q6: {tables[0][1]} in {tables[0][2]:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 24: joins, semi joins and windows on the mesh, and degradation
# ---------------------------------------------------------------------------

#: phase 24's statements: name -> (SQL, mesh session properties beside
#: ``MEASURED``); ``q3 grouped``'s budget is set at run time
MESH_JOIN_SQL = {
    "q3": (QUERIES["q3"], {}),
    # every join exchanges both sides on the key's hash
    "q3 repartition": (QUERIES["q3"], {"broadcast_join_row_limit": 0}),
    "full": ("select count(*) as n, count(o_orderkey) as no, count(c_custkey) as nc "
             "from customer full join orders on c_custkey = o_custkey", {}),
    "semi": (CUST_SEMI, {}),
    "anti": (CUST_ANTI, {}),
    # the partitioned window: each customer's first order
    "window": ("select count(*) as n, sum(o_orderkey) as s from (select o_orderkey, "
               "row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) "
               "as rn from orders) t where rn = 1", {}),
    # both sides spill to host RAM and the repartition join replays
    # bucket by bucket (the budget: ``MESH_GROUPED_DIVISOR``)
    "q3 grouped": (QUERIES["q3"], {}),
    # a retryable fault at every repartition exchange: the mesh attempt
    # fails and the query degrades to one device, where the fused probes
    # (K4 among them) run
    "q3 degraded": (QUERIES["q3"], {"broadcast_join_row_limit": 0, "retry_count": 0}),
}
#: ``q3 grouped``'s ``join_build_budget_bytes``: Q3's largest build
#: estimate over this
MESH_GROUPED_DIVISOR = 8


def mesh_join_expected(conn) -> dict:
    """Phase 24's numpy oracles (the repartitioned, grouped and degraded
    Q3 share Q3's)."""
    q3 = q3_expected(conn)
    o = conn.table_numpy("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    first = np.lexsort((o["o_orderkey"], o["o_orderdate"], o["o_custkey"]))
    cust = o["o_custkey"][first]
    head = np.r_[True, cust[1:] != cust[:-1]]
    return {"q3": q3, "q3 repartition": q3, "q3 grouped": q3, "q3 degraded": q3,
            "full": full_expected(conn), "semi": cust_semi_expected(conn, anti=False),
            "anti": cust_semi_expected(conn, anti=True),
            "window": {"n": np.array([int(head.sum())], np.int64),
                       "s": np.array([int(o["o_orderkey"][first][head].astype(np.int64).sum())],
                                     np.int64)}}


def run_mesh_join_queries(conn, device: str = "cuda") -> dict:
    """Phase 24: the mesh of phase 23 (four shards on one card) over
    TPC-H at ``conn``'s scale: Q3 at the default distribution and with
    ``broadcast_join_row_limit=0`` (every join repartitioned), the
    customer-orders FULL OUTER counts, a semi and an anti join on
    customer, the first order of every customer by ``row_number()`` over
    a partitioned window, Q3 under a ``join_build_budget_bytes`` that
    sends its joins to the grouped tier, and Q3 with a retryable fault at
    every ``exchange.join``, degraded to one device. Each answer equal to
    its numpy oracle (:func:`mesh_join_expected`) and to the one-device
    session's, with its wall, its ``join.distribution.*`` / ``exchange.*``
    / ``spill.*`` counter moves and its ``exchange:`` walls. The launches
    are counted from 0 over phase 24 alone: the mesh runs build no fused
    probe (no K4), the degraded run probes customer through K4; every
    launch shape held to its plain version."""
    from presto_tpu_torch.runtime import faults

    t0 = time.perf_counter()
    want = mesh_join_expected(conn)
    log(f"phase 24: numpy recomputation of {list(want)} at SF{conn.sf:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    from presto_tpu_torch.parallel.mesh import make_mesh

    home = "cuda:0" if device == "cuda" else "cpu"
    mesh = make_mesh(MESH_SHARDS, devices=[home] * MESH_SHARDS)
    budget = largest_build(measured_session({"tpch": conn}, device=device),
                           QUERIES["q3"]) // MESH_GROUPED_DIVISOR
    props = {name: dict(p) for name, (_sql, p) in MESH_JOIN_SQL.items()}
    props["q3 grouped"]["join_build_budget_bytes"] = budget
    out = {"walls": {}, "local_walls": {}, "counters": {}, "exchange_ms": {}, "launches": {}}
    local = {}
    for name, (sql, _p) in MESH_JOIN_SQL.items():
        if name in ("q3 repartition", "q3 grouped", "q3 degraded"):
            continue  # one device: Q3's answer does not depend on these
        session = measured_session({"tpch": conn}, device=device)
        t0 = time.perf_counter()
        local[name] = result_dict(session.sql(sql))
        out["local_walls"][name] = time.perf_counter() - t0
    for name in ("q3 repartition", "q3 grouped", "q3 degraded"):
        local[name] = local["q3"]
    families = ("join.distribution.", "join.strategy.", "exchange.", "spill.", "query.degraded",
                "exec.pallas_join_route")
    query = {"name": None}
    with first_kernel_calls(query) as calls, each_probe_shape(query) as probes:
        # the main path of the phase: launches counted from 0 to here
        _reset_launches()
        for name, (sql, _p) in MESH_JOIN_SQL.items():
            session = measured_session({"tpch": conn}, properties=props[name], device=device,
                                       mesh=mesh)
            inj = faults.FaultInjector()
            if name == "q3 degraded":
                inj.inject("exchange.join", times=None)
            query["name"] = f"phase 24 {name}"
            before, n0 = REGISTRY.snapshot(), _launch_counts()
            try:
                with faults.injected(inj):
                    t0 = time.perf_counter()
                    res = session.sql(sql)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    out["walls"][name] = time.perf_counter() - t0
            finally:
                query["name"] = None
            after, n1 = REGISTRY.snapshot(), _launch_counts()
            info = session.query_history[-1]
            out["counters"][name] = {
                k: after[k] - before.get(k, 0) for k in after
                if k.startswith(families) and after[k] != before.get(k, 0)
                and not k.endswith((".p50", ".p95", ".p99", ".max"))}
            out["exchange_ms"][name] = [
                (sp.name, round((sp.t1 - sp.t0) * 1e3, 3))
                for sp in session.traces.for_query(info.query_id).spans
                if sp.name.startswith("exchange:")]
            out["launches"][name] = {k: n1[k] - n0[k] for k in
                                     ("q1", "lane_sums", "leaf_agg", "exists", "payload",
                                      "sketch", "q3", "like", "prefix") if n1[k] != n0[k]}
            same_result(res, want[name], f"phase 24 {name}")
            same_result(res, local[name], f"phase 24 {name} against the one-device session")
            check(info.degraded == (name == "q3 degraded"),
                  f"phase 24 {name}: degraded {info.degraded}")
            log(f"  {name}: wall {out['walls'][name]:.3f} s (one device "
                f"{out['local_walls'].get(name, out['local_walls']['q3']):.3f} s), counters "
                f"{out['counters'][name]}, exchange walls ms {out['exchange_ms'][name]}, "
                f"launches {out['launches'][name]}")
        out["all_launches"] = _launch_counts()
    c = out["counters"]
    check(c["q3 repartition"].get("join.distribution.repartition", 0) >= 1
          and c["q3 repartition"].get("exchange.rows.join.probe", 0) > 0,
          f"phase 24: the repartition Q3 exchanged no join: {c['q3 repartition']}")
    check(c["q3 grouped"].get("join.distribution.grouped", 0)
          + c["q3 grouped"].get("join.distribution.hybrid", 0) >= 1,
          f"phase 24: Q3 under {budget} bytes took no grouped join: {c['q3 grouped']}")
    check(c["window"].get("exchange.dispatches", 0) >= 1,
          f"phase 24: the window exchanged nothing: {c['window']}")
    check(c["q3 degraded"].get("query.degraded_to_local", 0) == 1,
          f"phase 24: the faulted Q3 did not degrade: {c['q3 degraded']}")
    mesh_probes = sum(n.get(k, 0) for name, n in out["launches"].items() if name != "q3 degraded"
                      for k in ("exists", "payload", "sketch"))
    check(mesh_probes == 0 and not any(c[n].get("exec.pallas_join_route", 0) for n in c
                                       if n != "q3 degraded"),
          f"phase 24: a mesh run launched a fused probe: {out['launches']}")
    if device == "cuda":
        check(out["launches"]["q3 degraded"].get("exists", 0) >= 1,
              f"phase 24: the degraded Q3 launched no exists probe: {out['launches']}")
    out["launches_by_statement"] = out["launches"]
    out["launches"] = out.pop("all_launches")
    out["call_err"] = hold_kernel_calls(calls)
    out["probe_err"] = hold_probe_shapes(probes)
    if device == "cuda":
        check(any(k[0] == "exists" for k in probes),
              f"phase 24's exists shapes not held: {sorted(probes)}")
    out["budget"] = budget
    return out



# ---------------------------------------------------------------------------
# phase 25: TPC-H and SSB at SF1 against the numpy oracle
# ---------------------------------------------------------------------------

#: the numpy oracles' input frames in this process, by (connector, sf)
_ORACLE_TABLES: dict = {}


def oracle_jobs(sf: float) -> list:
    """Phase 25's oracle jobs at ``sf``: (connector, sf, queries)."""
    return [("tpch", sf, [q for q in tpch_oracle.ORACLES if q != "q5"]),
            ("tpch", min(sf, Q5_SF), ["q5"]), ("ssb", sf, list(ssb_oracle.ORACLES))]


def oracle_answers(job: tuple) -> list:
    """The numpy oracle's answers (``presto_tpu_torch/oracle/``) of
    ``queries`` over the ``table_logical`` frames of ``connector`` at
    ``sf`` on the CPU: (query, sf, host seconds, columns) each. The
    frames are kept for this process's later jobs."""
    schema, sf, queries = job
    if (schema, sf) not in _ORACLE_TABLES:
        cls = dict(zip(("tpch", "ssb", "tpcds"), _connector_classes()))[schema]
        _ORACLE_TABLES[schema, sf] = frame.LazyTables(cls(sf=sf, device="cpu").table_logical)
    oracles = {"tpch": tpch_oracle, "ssb": ssb_oracle, "tpcds": tpcds_oracle}[schema].ORACLES
    out = []
    for name in queries:
        t0 = time.perf_counter()
        f = oracles[name](_ORACLE_TABLES[schema, sf])
        cols = [np.asarray(f[c].to_numpy()) for c in f.columns]
        out.append((name, sf, time.perf_counter() - t0, cols))
    return out


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def oracle_normalized(cols: list) -> tuple[list, list]:
    """``tests/test_tpch_sql.normalize`` without pandas: each column to
    rounded float64 (a float column, or an object one of numbers and
    NULLs), ``datetime64[s]``, right-stripped strings (NULL None) or
    int64; then the rows sorted by every column, NULL last. Returns (the
    columns, their kinds)."""
    out, kinds = [], []
    for v in cols:
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v, kind = np.round(v.astype(np.float64), 2), "float"
        elif v.dtype.kind == "M":
            v, kind = v.astype("datetime64[s]"), "date"
        elif v.dtype.kind in "OU":
            live = [x for x in v.tolist() if not _is_null(x)]
            if all(isinstance(x, (int, float, np.number)) and not isinstance(x, bool)
                   for x in live):
                v = np.array([np.nan if _is_null(x) else float(x) for x in v.tolist()])
                v, kind = np.round(v, 2), "float"
            else:
                v = np.array([None if _is_null(x) else str(x).rstrip() for x in v.tolist()],
                             dtype=object)
                kind = "str"
        else:
            v, kind = v.astype(np.int64), "int"
        out.append(v)
        kinds.append(kind)
    keys = []
    for v, kind in zip(out, kinds):
        if kind == "str":
            null = np.array([x is None for x in v.tolist()], bool)
            vals = np.array([x for x in v.tolist() if x is not None], dtype=str)
        else:
            null = np.isnan(v) if kind == "float" else np.isnat(v) if kind == "date" else \
                np.zeros(len(v), bool)
            vals = v[~null]
        uniq, inv = np.unique(vals, return_inverse=True)
        code = np.full(len(v), len(uniq), np.int64)
        code[~null] = inv.reshape(-1)
        keys.append(code)
    order = np.lexsort(keys[::-1]) if keys else np.arange(0)
    return [v[order] for v in out], kinds


def same_as_oracle(got: list, want: list, what: str) -> None:
    """A card answer (``got``: logical columns, ``QueryResult.logical``)
    equal to a numpy oracle's (``want``) as ``tests/test_tpch_sql.compare``
    holds an answer to the reference's pandas oracle: the same shape; then,
    after :func:`oracle_normalized`, a column the oracle gives as float
    within ``DOUBLE_TOL`` (NULL where the oracle is NaN), every other column
    exact."""
    n_got = len(got[0]) if got else 0
    n_want = len(want[0]) if want else 0
    check((len(got), n_got) == (len(want), n_want),
          f"{what}: shape {(n_got, len(got))} != oracle {(n_want, len(want))}")
    if n_want == 0:
        return
    g, _gk = oracle_normalized(got)
    w, wk = oracle_normalized(want)
    for i, (gv, wv, kind) in enumerate(zip(g, w, wk)):
        if kind == "float":
            gf = np.array([np.nan if _is_null(x) else float(x) for x in gv.tolist()])
            ok = np.allclose(gf, wv, equal_nan=True, **DOUBLE_TOL)
        else:
            ok = gv.tolist() == wv.tolist()
        check(ok, f"{what}: column {i} differs:\n{gv[:5]}\n{wv[:5]}")


def oracle_phase_runs(sf: float, device: str) -> dict:
    """Phase 25's runs on ``device``: the 22 TPC-H queries (Q5 at
    ``min(sf, Q5_SF)``) and the 15 SSB queries at ``sf`` through
    ``Session.sql`` with ``MEASURED``. ``out["got"]`` maps each query's
    label ("tpch q1") to its answer's logical columns. The launches are
    counted from 0 over the runs, by kernel and by shape, and every launch
    shape is held to its plain version."""
    from presto_tpu_torch.connectors.ssb import SsbConnector
    from presto_tpu_torch.connectors.ssb.queries import QUERIES as SSB_QUERIES

    tpch = TpchConnector(sf=sf, device=device)
    q5 = tpch if min(sf, Q5_SF) == sf else TpchConnector(sf=Q5_SF, device=device)
    runs = [(f"tpch {q}", {"tpch": q5 if q == "q5" else tpch}, QUERIES[q])
            for q in tpch_oracle.ORACLES]
    runs += [(f"ssb {q}", {"ssb": SsbConnector(sf=sf, device=device)}, SSB_QUERIES[q])
             for q in ssb_oracle.ORACLES]
    out = {"walls": {}, "launches_by_query": {}, "got": {}}
    query = {"name": None}
    with launch_spans() as spans, first_kernel_calls(query) as calls, \
            each_probe_shape(query) as probes:
        _reset_launches()  # the main path of the phase: launches counted from 0 here
        for label, conns, sql in runs:
            session = measured_session(conns, device=device)
            query["name"] = f"phase 25 {label}"
            n0 = _launch_counts()
            t0 = time.perf_counter()
            res = session.sql(sql)
            if device == "cuda":
                torch.cuda.synchronize()
            out["walls"][label] = time.perf_counter() - t0
            n1 = _launch_counts()
            query["name"] = None
            out["got"][label] = [res.logical(n) for n in res.names]
            out["launches_by_query"][label] = {k: n1[k] - n0[k] for k in SCALAR_KERNELS
                                               if n1[k] != n0[k]}
        out["launches"] = _launch_counts()
    launches = out["launches"]
    log(f"phase 25: {len(runs)} queries; walls {sum(out['walls'].values()):.1f} s in all; "
        f"launches { {k: launches[k] for k in SCALAR_KERNELS} }, by instance "
        f"{launches['by_instance']}, probes by shape {launches['probe_by_shape']}, LIKE by "
        f"rows x width {launches['like_by_shape']}")
    out["call_err"] = hold_kernel_calls(calls)
    out["probe_err"] = hold_probe_shapes(probes)
    q1_err = 0
    for cap, b in sorted(spans["q1 batches"].items()):
        q1_err = max(q1_err, compare(cuda_q1.q1_step(b), cuda_q1.q1_step_plain(b),
                                     f"q1_step at phase 25's first {cap}-row split"))
        log(f"  q1_step at phase 25's first {cap}-row split: equal to its plain version")
    out["q1_err"] = q1_err
    if device == "cuda":
        ran = [k for k in ("q1", "lane_sums", "leaf_agg", "exists", "payload", "like")
               if launches[k]]
        check(ran, f"phase 25 launched no kernel: {launches}")
        held = {k for k, _shape in calls} | {m for m, _rows, _key in probes}
        held |= {"q1"} if spans["q1 batches"] else set()
        check(set(ran) <= held, f"phase 25's launches of {ran}, shapes held for {sorted(held)}")
    return out


def oracle_by_label(sf: float, answers: list) -> dict:
    """The numpy oracle's answers of :func:`oracle_jobs` at ``sf``
    (``answers``: :func:`oracle_answers` of each job, in order) by query
    label: (the scale it ran at, host seconds, columns)."""
    want = {}
    for job, rows in zip(oracle_jobs(sf), answers):
        for name, at_sf, seconds, cols in rows:
            want[f"{job[0]} {name}"] = (at_sf, seconds, cols)
    return want


def run_oracle_queries(sf: float = 1, device: str = "cuda", pending=None) -> dict:
    """Phase 25: :func:`oracle_phase_runs`, each answer held to the numpy
    oracle (:func:`oracle_answers`; ``pending``: the worker processes'
    result, else computed here) under :func:`same_as_oracle`. An empty
    oracle answer fails. Logs each query's wall and its oracle's host
    seconds."""
    out = oracle_phase_runs(sf, device)
    got = out["got"]
    t0 = time.perf_counter()
    answers = pending.get() if pending is not None else [oracle_answers(j)
                                                         for j in oracle_jobs(sf)]
    out["oracle_wait_s"] = time.perf_counter() - t0
    want = oracle_by_label(sf, answers)
    check(sorted(want) == sorted(got), f"phase 25: oracle answers for {sorted(want)}, card "
          f"answers for {sorted(got)}")
    out["oracle_s"], out["rows"] = {}, {}
    for label in got:
        at_sf, seconds, cols = want[label]
        rows = len(cols[0]) if cols else 0
        check(rows > 0, f"phase 25 {label}: the numpy oracle's answer at sf {at_sf:g} is empty")
        same_as_oracle(got[label], cols,
                       f"phase 25 {label} at sf {at_sf:g}, card against the numpy oracle")
        out["oracle_s"][label], out["rows"][label] = seconds, rows
        log(f"  phase 25 {label} at sf {at_sf:g}: {rows} rows equal to the numpy oracle; wall "
            f"{out['walls'][label]:.3f} s, oracle host {seconds:.2f} s, launches "
            f"{out['launches_by_query'][label]}")
    log(f"phase 25: {len(want)} answers equal to the numpy oracle; oracle host seconds "
        f"{sum(out['oracle_s'].values()):.1f} in all (waited {out['oracle_wait_s']:.1f} s "
        f"for them)")
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
    cpu_answers = start_cpu_answers()
    try:
        with generated_once():
            return run_phases(dev_name, smi, cpu_answers)
    finally:
        cpu_answers["pool"].terminate()
        cpu_answers["pool"].join()


def run_phases(dev_name: str, smi: list, cpu_answers) -> int:
    """Phases 1-25 (``cpu_answers``: phase 16's CPU answers and the numpy
    oracles of phases 16 and 25, computing in worker processes
    meanwhile)."""
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
    from presto_tpu_torch.connectors.ssb import SsbConnector

    mark("data set-up")
    setup_s, held_gib = prefill(TpchConnector(sf=1, device="cuda"),
                                SsbConnector(sf=1, device="cuda"))
    log(f"set-up: generated every split of TPC-H and SSB at SF1 in {setup_s:.1f} s, "
        f"{held_gib:.3f} GiB on the host; every scan below reads it (other scales: "
        "generated when first scanned)")

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
    # ---- phase 16: the TPC-DS connector and its 99 queries ------------------
    mark("16 tpcds")
    ds = run_tpcds_queries(cpu_answers)
    p16 = probe_launch_totals(ds["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"])
    log(f"  exists, sketch and payload launches with phase 16: {totals}; phase 16's alone: "
        f"{p16}")
    p16_other = {k: sum(n[k] for n in ds["launches"].values())
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    p16_by_instance = _summed(*(n["by_instance"] for n in ds["launches"].values()))
    p16_like_by_instance = _summed(*(n["like_by_instance"] for n in ds["launches"].values()))
    p16_like_by_shape = _summed(*(n["like_by_shape"] for n in ds["launches"].values()))
    log(f"  phase 16's launches of the other kernels: {p16_other}; lane-sums and leaf by "
        f"instance {p16_by_instance}; per query "
        f"{ {q: {k: n[k] for k in ('leaf_agg', 'lane_sums', 'exists', 'payload', 'like') if n[k]} for q, n in ds['launches'].items() if any(n[k] for k in ('leaf_agg', 'lane_sums', 'exists', 'payload', 'like'))} }; "
        f"shapes held to plain: {sorted(str(k) for k in ds['calls'])}")
    # ---- phase 17: CTAS / INSERT / DROP, EXPLAIN ANALYZE, PREPARE ---------
    mark("17 statements")
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    st = run_statement_queries(TpchConnector(sf=1, device="cuda"),
                               TpcdsConnector(sf=TPCDS_SF, device="cuda"), ds["walls"])
    p17 = probe_launch_totals(st["launches"])
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"], st["launches"])
    log(f"  exists, sketch and payload launches with phase 17: {totals}; phase 17's alone: "
        f"{p17}")
    p17_other = {k: sum(n[k] for n in st["launches"].values())
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    p17_by_instance = _summed(*(n["by_instance"] for n in st["launches"].values()))
    p17_like_by_instance = _summed(*(n["like_by_instance"] for n in st["launches"].values()))
    p17_like_by_shape = _summed(*(n["like_by_shape"] for n in st["launches"].values()))
    log(f"  phase 17's launches of the other kernels: {p17_other}; lane-sums and leaf by "
        f"instance {p17_by_instance}; shapes held to plain: "
        f"{sorted(str(k) for k in st['calls'])}")
    tl = st["templates"]["launches"]
    log(f"  phase 17's plan-template on / off turns (not in its launch counts): "
        f"{ {k: sum(n[k] for n in tl.values()) for k in ('q1', 'lane_sums', 'leaf_agg')} }, "
        f"exists / payload {probe_launch_totals(tl)['exists']['launches']} / "
        f"{probe_launch_totals(tl)['payload']['launches']}")
    # ---- phase 18: the observability core ----------------------------------
    mark("18 observability")
    obs = run_observability_queries(TpchConnector(sf=1, device="cuda"))
    p18 = probe_launch_totals({"phase 18": obs["launches"]})
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"], st["launches"], {"phase 18": obs["launches"]})
    p18_other = {k: obs["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  exists, sketch and payload launches with phase 18: {totals}; phase 18's alone: "
        f"{p18}; its other kernels: {p18_other}")
    # ---- phase 19: the query lifecycle and the out-of-core tier ------------
    mark("19 lifecycle")
    life = run_lifecycle_queries(TpchConnector(sf=1, device="cuda"))
    p19 = probe_launch_totals({"phase 19": life["launches"]})
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"], st["launches"], {"phase 18": obs["launches"]},
                                 {"phase 19": life["launches"]})
    p19_other = {k: life["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  exists, sketch and payload launches with phase 19: {totals}; phase 19's alone: "
        f"{p19}; its other kernels: {p19_other}")
    # ---- phase 20: the cache tier, adaptivity, the flight recorder, the
    # system catalog and the coalescer ----------------------------------------
    mark("20 cache tier")
    cache = run_cache_queries(TpchConnector(sf=1, device="cuda"))
    p20 = probe_launch_totals({"phase 20": cache["launches"]})
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"], st["launches"], {"phase 18": obs["launches"]},
                                 {"phase 19": life["launches"]}, {"phase 20": cache["launches"]})
    p20_other = {k: cache["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  exists, sketch and payload launches with phase 20: {totals}; phase 20's alone: "
        f"{p20}; its other kernels: {p20_other}")
    # ---- phase 21: the serving tier and the streams ------------------------
    mark("21 serving tier")
    serve = run_serving_queries(TpchConnector(sf=1, device="cuda"))
    p21 = probe_launch_totals({"phase 21": serve["launches"]})
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"], st["launches"], {"phase 18": obs["launches"]},
                                 {"phase 19": life["launches"]}, {"phase 20": cache["launches"]},
                                 {"phase 21": serve["launches"]})
    p21_other = {k: serve["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  exists, sketch and payload launches with phase 21: {totals}; phase 21's alone: "
        f"{p21}; its other kernels: {p21_other}")
    # ---- phase 22: the CLI, in process and as a server ---------------------
    mark("22 CLI")
    t22 = time.perf_counter()
    cli = run_cli_queries(1.0)
    cli["serve"] = run_cli_serve(1.0)
    p22_s = time.perf_counter() - t22
    check(p22_s < 120, f"phase 22 took {p22_s:.1f} s, past its 120 s")
    p22 = probe_launch_totals({"phase 22": cli["launches"]})
    totals = probe_launch_totals(join["launches"], strings["launches"], semi["launches"],
                                 outer["launches"], expr["launches"], sub["launches"],
                                 feat["launches"], surf["launches"], win["launches"],
                                 ds["launches"], st["launches"], {"phase 18": obs["launches"]},
                                 {"phase 19": life["launches"]}, {"phase 20": cache["launches"]},
                                 {"phase 21": serve["launches"]}, {"phase 22": cli["launches"]})
    p22_other = {k: cli["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  exists, sketch and payload launches with phase 22: {totals}; phase 22's alone: "
        f"{p22}; its other kernels: {p22_other}")
    # ---- phase 23: a mesh session over 4 shards on the card ---------------
    mark("23 mesh")
    mesh = run_mesh_queries(TpchConnector(sf=1, device="cuda"))
    p23 = probe_launch_totals({"phase 23": mesh["launches"]})
    p23_other = {k: mesh["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  phase 23's probe launches: {p23}; its other kernels: {p23_other}")
    # ---- phase 24: joins, semi joins and windows on the mesh, degradation --
    mark("24 mesh joins")
    mj = run_mesh_join_queries(TpchConnector(sf=1, device="cuda"))
    p24 = probe_launch_totals({"phase 24": mj["launches"]})
    p24_other = {k: mj["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  phase 24's probe launches: {p24}; its other kernels: {p24_other}")
    # ---- phase 25: TPC-H and SSB at SF1 against the numpy oracle ----------
    mark("25 oracles")
    orc = run_oracle_queries(1, pending=cpu_answers["oracle25"])
    p25 = probe_launch_totals({"phase 25": orc["launches"]})
    p25_other = {k: orc["launches"][k]
                 for k in ("q1", "lane_sums", "leaf_agg", "q3", "like", "prefix")}
    log(f"  phase 25's probe launches: {p25}; its other kernels: {p25_other}")
    mark("json")
    log("phase seconds: " + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_b, t1)
                                      in zip(marks, marks[1:])))
    log(f"phases 1-25 in {marks[-1][1] - marks[0][1]:.1f} s")

    log(smi[0])
    # every phase from 11 on is one entry here: its run's result, its
    # probe-kernel launch totals and its launches of the kernels it counts
    # by name (phase 11 counts LIKE and lane sums apart)
    phases = {11: (expr, p11, {**p11_other, "lane_sums": expr["lane_sums_launches"],
                               "like": expr["like_launches"]}),
              12: (sub, p12, p12_other), 13: (feat, p13, p13_other),
              14: (surf, p14, p14_other), 15: (win, p15, p15_other), 16: (ds, p16, p16_other),
              17: (st, p17, p17_other), 18: (obs, p18, p18_other), 19: (life, p19, p19_other),
              20: (cache, p20, p20_other), 21: (serve, p21, p21_other),
              22: (cli, p22, p22_other), 23: (mesh, p23, p23_other),
              24: (mj, p24, p24_other), 25: (orc, p25, p25_other)}

    def named(kernel: str) -> dict:
        """``phaseNN_launches`` of a kernel the phases count by name."""
        return {f"phase{p}_launches": o[kernel] for p, (_r, _t, o) in phases.items()}

    def probed(kernel: str) -> dict:
        """``phaseNN_launches`` of a probe kernel."""
        return {f"phase{p}_launches": t[kernel]["launches"]
                for p, (_r, t, _o) in phases.items()}

    def held(what: str, kernel: str | None = None) -> list:
        """The largest differences from the plain version the phases that
        hold ``what`` (``probe_err``, ``call_err``, ``q1_err``) found."""
        return [r[what] if kernel is None else r[what][kernel]
                for r, _t, _o in phases.values() if what in r]

    kernels = [
        {"name": "q1_step", "route": "cuda", "source": "presto_tpu_torch/csrc/q1.cu",
         "replaces": "presto_tpu/ops/pallas_q1.py:114",
         "jax_function": "presto_tpu/ops/pallas_q1.py:174 q1_step",
         "launches": q1_launches + sum(named("q1").values()), **named("q1"),
         "max_abs_err": max([q1_err] + held("q1_err")), "ms": q1_ms, "kernel_ms": q1_ms,
         "call_ms": q1_call_ms,
         "plain_ms": q1_plain_ms, "bound_ms": q1_bound, "bound_by": q1_by,
         "library_ms": None, "rows": n, "bytes": q1_bytes, "ops": q1_ops},
        {"name": "fused_lane_sums", "route": "cuda",
         "source": "presto_tpu_torch/csrc/lane_sums.cu",
         "replaces": "presto_tpu/ops/pallas_groupby.py:138",
         "jax_function": "presto_tpu/ops/pallas_groupby.py:177 fused_lane_sums",
         "launches": (lane_launches + outer["lane_launches"]
                      + sum(named("lane_sums").values())), **named("lane_sums"),
         "phase16_launches_by_instance": {k.split()[1]: c for k, c in p16_by_instance.items()
                                          if k.startswith("lane_sums")},
         "phase14_launches_by_instance": {k.split()[1]: c for k, c in p14_by_instance.items()
                                          if k.startswith("lane_sums ")},
         "launches_by_instance": _summed(lane_by_instance, outer["lane_by_instance"],
                                         expr["lane_by_instance"], sub["lane_by_instance"]),
         "launches_from": "phase 4 (Q1 pipeline), phase 10 (Q13, Q5), phase 11 (the "
                          "expression queries) and phase 12 (the subquery queries)",
         "phase12_launches_by_instance": sub["lane_by_instance"],
         "phase10_launches": outer["lane_launches"],
         "phase11_launches_by_instance": expr["lane_by_instance"],
         "max_abs_err": max([lane_err, ln["err"], ln_phone["err"], ln_q4["err"]]
                            + held("call_err", "lane_sums")),
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
         **probed("exists"),
         "phase19_launches_by_shape": p19["exists"]["by_shape"],
         "phase17_launches_by_shape": p17["exists"]["by_shape"],
         "phase16_launches_by_shape": p16["exists"]["by_shape"],
         "phase15_launches_by_shape": p15["exists"]["by_shape"],
         "phase14_launches_by_shape": p14["exists"]["by_shape"],
         "phase13_launches_by_shape": p13["exists"]["by_shape"],
         "phase11_launches_by_shape": p11["exists"]["by_shape"],
         "phase12_launches_by_shape": p12["exists"]["by_shape"],
         "phase12_launches_by_instance": p12["exists"]["by_instance"],
         "max_abs_err": max([exists_err, keep_err["exists"]] + held("probe_err", "exists")
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
         **probed("sketch"),
         "phase19_launches_by_shape": p19["sketch"]["by_shape"],
         "phase17_launches_by_shape": p17["sketch"]["by_shape"],
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
         "launches": semi["q3_launches"] + sum(named("q3").values()), **named("q3"),
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
         **probed("payload"),
         "phase19_launches_by_shape": p19["payload"]["by_shape"],
         "phase17_launches_by_shape": p17["payload"]["by_shape"],
         "phase16_launches_by_shape": p16["payload"]["by_shape"],
         "phase15_launches_by_shape": p15["payload"]["by_shape"],
         "phase14_launches_by_shape": p14["payload"]["by_shape"],
         "phase13_launches_by_shape": p13["payload"]["by_shape"],
         "phase13_launches_by_instance": p13["payload"]["by_instance"],
         "phase11_launches_by_shape": p11["payload"]["by_shape"],
         "phase11_launches_by_instance": p11["payload"]["by_instance"],
         "phase12_launches_by_shape": p12["payload"]["by_shape"],
         "phase12_launches_by_instance": p12["payload"]["by_instance"],
         "max_abs_err": max([payload_err] + held("probe_err", "payload")
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
         "launches": leaf["leaf_launches"] + sum(named("leaf_agg").values()),
         **named("leaf_agg"),
         "phase16_launches_by_instance": {k.split()[1]: c for k, c in p16_by_instance.items()
                                          if k.startswith("leaf_agg")},
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
         "max_abs_err": max([leaf_err, sp["err"], sm_["err"], res_["err"]]
                            + held("call_err", "leaf_agg")),
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
         "launches": (strings["like_launches"] + outer["like_launches"]
                      + sum(named("like").values())), **named("like"),
         "launches_by_instance": _summed(strings["like_by_instance"],
                                         outer["like_by_instance"], expr["like_by_instance"],
                                         sub["like_by_instance"], p13_like_by_instance,
                                         p14_like_by_instance, p15_like_by_instance,
                                         p16_like_by_instance, p17_like_by_instance),
         "phase14_launches_by_instance": p14_like_by_instance,
         "phase13_launches_by_instance": p13_like_by_instance,
         "launches_from": "phase 8 (LIKE queries), phase 10 (Q13, Q5), phase 11 (Q16) and "
                          "phase 12 (Q20's p_name like 'forest%')",
         "phase10_launches": outer["like_launches"],
         "phase12_launches_by_instance": sub["like_by_instance"],
         "launches_by_shape": _summed(strings["like_by_shape"], outer["like_by_shape"],
                                      expr["like_by_shape"], sub["like_by_shape"],
                                      p13_like_by_shape, p14_like_by_shape, p15_like_by_shape,
                                      p16_like_by_shape, p17_like_by_shape),
         "max_abs_err": max([like_err, sub["like_err"]] + held("call_err", "like")
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
         "launches": strings["prefix_launches"] + sum(named("prefix").values()),
         **named("prefix"),
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
