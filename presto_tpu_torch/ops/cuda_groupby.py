"""Exact small-group integer sums + mask counts: the lane-sums kernel.

Replaces ``presto_tpu/ops/pallas_groupby.py::fused_lane_sums`` (Pallas
body ``_kernel``) with ``csrc/lane_sums.cu``. It is reached through
``ops/groupby.fused_small_sums``, which the direct-strategy hash
aggregation calls once per batch.

What bounds it on the H100: the bytes read — every value, mask and gid
element once (25 bytes a row at the Q1 pipeline's shapes: 4 int32
values, 5 byte masks, an int32 gid) at 3.35 TB/s. Its design reads each
column once in a grid-stride pass and keeps the partial sums in shared
memory as int64, so no lane split or one-hot matrix touches device
memory (see the header of the CUDA source).

``fused_lane_sums`` launches the kernel on CUDA tensors and computes
``fused_lane_sums_plain`` on CPU tensors; ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from presto_tpu_torch.ops import _build
from presto_tpu_torch.runtime.errors import InternalError, ResourceExhausted

#: per-group slots the kernel accepts: max_groups * (values + masks).
#: The JAX kernel's own limit is 1024 slots counting each value's 8-bit
#: lanes, so every call it accepts fits here.
SLOT_LIMIT = 1024
MAX_VALUES = 16
MAX_MASKS = 16
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)

#: kernel launches since the last reset (a plain counter, set to 0 by
#: whoever reads it)
launches = 0


def supported(nvalues: int, nmasks: int, max_groups: int) -> bool:
    """Static eligibility: the kernel's argument and slot limits."""
    return (nvalues <= MAX_VALUES and nmasks <= MAX_MASKS
            and 1 <= max_groups
            and max_groups * (nvalues + nmasks) <= SLOT_LIMIT)


def _check(values, bits_list, count_masks, gids, max_groups):
    if len(bits_list) != len(values):
        raise InternalError("fused_lane_sums: one bit bound per value")
    if not supported(len(values), len(count_masks), max_groups):
        raise ResourceExhausted(
            f"fused_lane_sums: {len(values)} values, {len(count_masks)} masks "
            f"x {max_groups} groups exceed the kernel's limits "
            f"({MAX_VALUES} values, {MAX_MASKS} masks, {SLOT_LIMIT} slots)")
    if gids.dtype != torch.int32 or gids.dim() != 1:
        raise InternalError("fused_lane_sums: gids must be int32 [cap]")
    cap, dev = gids.shape[0], gids.device
    for v, b in zip(values, bits_list):
        if v.dtype != torch.int32:
            raise InternalError(f"fused_lane_sums: value dtype {v.dtype} is not int32")
        if not 0 <= b <= 31:
            raise InternalError(f"fused_lane_sums: bit bound {b} not in [0, 31]")
        if v.shape != (cap,) or v.device != dev:
            raise InternalError("fused_lane_sums: value shape/device mismatch")
    for m in count_masks:
        if m.dtype not in _MASK_DTYPES:
            raise InternalError(f"fused_lane_sums: mask dtype {m.dtype}")
        if m.shape != (cap,) or m.device != dev:
            raise InternalError("fused_lane_sums: mask shape/device mismatch")


def _unpack(out: torch.Tensor, k: int, m: int, max_groups: int):
    slots = max_groups * (k + m)
    per_g = out[:slots].view(max_groups, k + m).t().contiguous()
    sums = list(per_g[:k].unbind(0))
    counts = list(per_g[k:].unbind(0))
    return sums, counts, out[slots] != 0


def fused_lane_sums(values, bits_list, count_masks, gids, max_groups: int):
    """Exact per-group integer sums + mask counts in one device pass.

    values: int32 [cap] tensors, dead rows ZEROED by the caller.
    bits_list: declared |value| bit bounds (<= 31 each).
    count_masks: bool (or byte) [cap] tensors counted per group.
    gids: int32 [cap]; ids outside [0, max_groups) are trash.

    Returns (sums, counts, overflow): int64 [max_groups] per value / mask
    and a bool scalar that is True when some |value| exceeded its bound.
    """
    _check(values, bits_list, count_masks, gids, max_groups)
    if gids.device.type == "cpu":
        return fused_lane_sums_plain(values, bits_list, count_masks, gids, max_groups)
    if gids.device.type != "cuda":
        raise InternalError(f"fused_lane_sums: no kernel for {gids.device}")
    global launches
    k, m, cap = len(values), len(count_masks), gids.shape[0]
    out = torch.zeros(max_groups * (k + m) + 1, dtype=torch.int64, device=gids.device)
    if cap == 0:
        return _unpack(out, k, m, max_groups)
    vals = [v.contiguous() for v in values]
    masks = [mk.contiguous() for mk in count_masks]
    g = gids.contiguous()
    lib = _build.load("lane_sums")
    fn = lib.lane_sums_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    vptr = (ctypes.c_void_p * max(k, 1))(*[v.data_ptr() for v in vals])
    vbits = (ctypes.c_int * max(k, 1))(*[int(b) for b in bits_list])
    mptr = (ctypes.c_void_p * max(m, 1))(*[mk.data_ptr() for mk in masks])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        code = fn(ctypes.addressof(vptr), ctypes.addressof(vbits), k,
                  ctypes.addressof(mptr), m, g.data_ptr(), max_groups, cap,
                  out.data_ptr(), stream)
    _build.check_launch(lib, "lane_sums", code)
    launches += 1
    return _unpack(out, k, m, max_groups)


def fused_lane_sums_plain(values, bits_list, count_masks, gids, max_groups: int):
    """The plain PyTorch version of ``fused_lane_sums`` (same contract,
    same results on every input: int64 sums of the values as given, mask
    counts, and the bound flag over all rows)."""
    _check(values, bits_list, count_masks, gids, max_groups)
    dev = gids.device
    trash = max_groups
    g = torch.where((gids >= 0) & (gids < max_groups), gids,
                    torch.full_like(gids, trash)).to(torch.int64)
    oflow = torch.zeros((), dtype=torch.bool, device=dev)
    sums = []
    for v, b in zip(values, bits_list):
        v64 = v.to(torch.int64)
        if b < 31:
            oflow = oflow | torch.any((torch.abs(v64) >> b) != 0)
        acc = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        sums.append(acc.index_add_(0, g, v64)[:max_groups])
    counts = []
    for mk in count_masks:
        acc = torch.zeros(max_groups + 1, dtype=torch.int64, device=dev)
        counts.append(acc.index_add_(0, g, (mk != 0).to(torch.int64))[:max_groups])
    return sums, counts, oflow
