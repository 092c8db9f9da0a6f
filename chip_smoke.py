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
   timed apart with CUDA events.

The last lines are the card's name and power limit, one JSON line
``{"kernels": [...]}``, and ``{"ok": true, "device": {...}}``.
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
from presto_tpu_torch.expr import evaluate, evaluate_predicate
from presto_tpu_torch.ops import _build, cuda_groupby, cuda_q1
from presto_tpu_torch.ops.groupby import group_ids_direct, lane_sum_inputs
from presto_tpu_torch.types import DATE, decimal, varchar
from presto_tpu_torch.workloads import (
    Q1_BITS, Q1_COLS, q1_aggs, q1_exprs, q1_fused_step, q1_pipeline)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (the fp32 figure)
FACTOR = 10  # resident batch = SF1 lineitem tiled this many times
CUTOFF = 10471  # date '1998-09-02'


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev_name = torch.cuda.get_device_name(0)
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

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
        return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")

    q1_bound, q1_by = bound(q1_bytes, q1_ops)
    lane_bound, lane_by = bound(lane_bytes, lane_ops)
    log(f"phase 5 (kernel device ms; call = wrapper, events; plain and index_add_ = "
        f"device ms of all their kernels): q1_step {q1_ms:.4f} (call {q1_call_ms:.4f}, "
        f"plain {q1_plain_ms:.4f}, bound {q1_bound:.4f}) at {n} rows; fused_lane_sums "
        f"{lane_ms:.4f} (call {lane_call_ms:.4f}, plain {lane_plain_ms:.4f}, index_add_ "
        f"{lane_lib_ms:.4f}, bound {lane_bound:.4f}) at {cap} rows, "
        f"{len(zeroed)} values + {len(masks)} masks")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
