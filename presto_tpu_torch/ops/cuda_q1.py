"""The fused TPC-H Q1 leaf fragment as one CUDA pass.

Replaces ``presto_tpu/ops/pallas_q1.py::q1_step`` (Pallas body
``_kernel``) with ``csrc/q1.cu``: shipdate filter, group id
``rf*2 + ls``, the decimals ``disc_price`` and ``charge``, and exact
per-group sums and counts, touching each input byte once.

What bounds it on the H100: the bytes read — the 7 narrow ``lineitem``
columns plus ``live``, 13 bytes a row for the connector's narrowed
schema, at 3.35 TB/s. Its design keeps several rows' loads in flight a
thread, has a fixed-width instantiation for the connector's narrow
layout, keeps each thread's 36 partial sums as int64 in shared memory,
and makes one atomic per slot and block (see the header of the CUDA
source).

``q1_step`` launches the kernel on a CUDA batch and computes
``q1_step_plain`` on a CPU batch; ``launches`` counts kernel launches.
``supported`` is the static eligibility ``workloads.q1_fused_step``
checks before taking this route.
"""

from __future__ import annotations

import ctypes

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.ops import _build
from presto_tpu_torch.runtime.errors import InternalError

G = 6  # |returnflag| x |linestatus|
CUTOFF = 10471  # l_shipdate <= date '1998-12-01' - interval '90' day
COLS = ("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax")
SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "sum_disc")
_INT_DTYPES = (torch.int8, torch.int16, torch.int32)

#: kernel launches since the last reset (a plain counter, set to 0 by
#: whoever reads it)
launches = 0


def supported(batch: Batch) -> bool:
    """Static eligibility: the 7 Q1 columns present as integers of at
    most 32 bits, each NULL-free over live rows — proven by having no
    validity mask or by SHARING the batch's live tensor as its validity
    (the kernel gates rows on ``live`` only). Any capacity is accepted."""
    if batch.live.dtype != torch.bool:
        return False
    for c in COLS:
        if c not in batch.columns:
            return False
        col = batch[c]
        if col.data.dtype not in _INT_DTYPES:
            return False
        if col.valid is not None and col.valid is not batch.live:
            return False
    return True


def _result(per_g: torch.Tensor, overflow: torch.Tensor) -> dict:
    """[G, 6] int64 (five sums + count) -> the q1_fused_step dict."""
    res = {name: per_g[:, j].contiguous() for j, name in enumerate(SUMS)}
    res["count_order"] = per_g[:, 5].contiguous()
    res["present"] = res["count_order"] > 0
    res["value_overflow"] = overflow
    return res


def q1_step(batch: Batch) -> dict:
    """One Q1 partial-aggregation pass; same contract as
    ``workloads.q1_fused_step`` (dict of [G] int64 sums/counts, bool
    ``present`` and a bool scalar ``value_overflow``)."""
    if not supported(batch):
        raise InternalError("q1_step: ineligible batch (see cuda_q1.supported)")
    dev = batch.device
    if dev.type == "cpu":
        return q1_step_plain(batch)
    if dev.type != "cuda":
        raise InternalError(f"q1_step: no kernel for {dev}")
    global launches
    cols = [batch[c].data.contiguous() for c in COLS] + [batch.live.contiguous()]
    for t in cols:
        if t.shape != (batch.capacity,) or t.device != dev:
            raise InternalError("q1_step: column shape/device mismatch")
    out = torch.zeros(G * 6 + 1, dtype=torch.int64, device=dev)
    if batch.capacity > 0:
        lib = _build.load("q1")
        fn = lib.q1_step_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        ptrs = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in cols])
        sizes = (ctypes.c_int * 8)(*[t.element_size() for t in cols])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(ctypes.addressof(ptrs), ctypes.addressof(sizes),
                      batch.capacity, out.data_ptr(), stream)
        _build.check_launch(lib, "q1", code)
        launches += 1
    return _result(out[: G * 6].view(G, 6), out[G * 6] != 0)


def q1_step_plain(batch: Batch) -> dict:
    """The plain PyTorch version of ``q1_step``: the same int64
    arithmetic, truncating division and guard, on any device."""
    if not supported(batch):
        raise InternalError("q1_step_plain: ineligible batch")
    ship, rf, ls, qty, ep, disc, tax = (batch[c].data.to(torch.int64) for c in COLS)
    live = batch.live & (ship <= CUTOFF)
    gid = rf * 2 + ls
    dp = ep * (100 - disc)
    ch = torch.div(dp * (100 + tax) + 50, 100, rounding_mode="trunc")
    bad = (((qty >> 13) != 0) | ((ep >> 24) != 0) | (disc < 0) | (disc > 100)
           | (tax < 0) | (tax > 27) | (rf < 0) | (rf > 2) | (ls < 0) | (ls > 1))
    overflow = torch.any(live & bad)
    g = torch.where(live & (gid >= 0) & (gid < G), gid, torch.full_like(gid, G))
    vals = torch.stack([qty, ep, dp, ch, disc, torch.ones_like(qty)], dim=1)
    acc = torch.zeros(G + 1, 6, dtype=torch.int64, device=batch.device)
    per_g = acc.index_add_(0, g, vals)[:G]
    return _result(per_g, overflow)
