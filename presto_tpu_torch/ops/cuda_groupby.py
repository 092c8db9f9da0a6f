"""Exact small-group integer sums + mask counts: the lane-sums kernel.

Replaces ``presto_tpu/ops/pallas_groupby.py::fused_lane_sums`` (Pallas
body ``_kernel``) with ``csrc/lane_sums.cu``. It is reached through
``ops/groupby.fused_small_sums``, which the direct-strategy hash
aggregation calls once per batch.

What bounds it on the H100: the bytes read — every value, mask and gid
element once (25 bytes a row at the Q1 pipeline's shapes: 4 int32
values, 5 byte masks, an int32 gid) at 3.35 TB/s. Its design brings
whole tiles of every column into shared memory with bulk copies, so all
of a tile's loads are in flight at once, and keeps the partial sums in
shared memory as int64, so no lane split or one-hot matrix touches
device memory (see the header of the CUDA source).

``fused_lane_sums`` launches the kernel on CUDA tensors and computes
``fused_lane_sums_plain`` on CPU tensors; ``launches`` counts kernel
launches and ``launches_by_instance`` which instance ran
(:func:`instance`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

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

#: the kernel's instances, in the launch entry's numbering (see
#: :func:`instance`): the staged ones with a per-thread table, compiled
#: for the main path's (values, masks) and for any; the staged one whose
#: table copies are shared; the direct one (plain loads)
INSTANCES = ("staged_k4m5", "staged_k0m1", "staged", "staged_shared", "direct")
_SHAPED = {(4, 5): "staged_k4m5", (0, 1): "staged_k0m1"}
#: the CUDA source's sizes (csrc/lane_sums.cu): rows a tile, slots of a
#: per-thread table, the bytes of the shared-memory ring's budget
TILE_ROWS = 2048
PRIVATE_SLOTS = 64
_TABLE_COPIES = 128
_SHARED_TABLE_BYTES = 64 * 1024
_SMEM_BUDGET = 220 * 1024 - 128

#: kernel launches since the last reset, in all and by instance (plain
#: counters, set to 0 by whoever reads them: see :func:`reset_launches`)
launches = 0
launches_by_instance = dict.fromkeys(INSTANCES, 0)


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_instance`` count to 0."""
    global launches
    launches = 0
    for k in launches_by_instance:
        launches_by_instance[k] = 0


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


def ring_stages(nvalues: int, nmasks: int, max_groups: int) -> int:
    """Stages of the shared-memory ring beside the table (at most 4; a
    staged instance needs 2): a stage holds a tile of the gid, every
    value and every mask."""
    slots = max_groups * (nvalues + nmasks)
    if slots <= PRIVATE_SLOTS:
        table = max(slots, 1) * 8 * _TABLE_COPIES
    else:
        copies = min(_TABLE_COPIES, max(1, _SHARED_TABLE_BYTES // (slots * 8)))
        table = slots * 8 * copies
    table = -(-table // 128) * 128
    return min(4, (_SMEM_BUDGET - table) // (TILE_ROWS * (4 + 4 * nvalues + nmasks)))


def instance(values, count_masks, gids, max_groups: int) -> str:
    """Which of ``INSTANCES`` runs this call: a staged one when every
    column starts 16-byte aligned and a ring of 2 stages fits beside the
    table (the per-thread table up to ``PRIVATE_SLOTS`` slots, compiled
    for the shape where it is one of the main path's), else ``direct``."""
    k, m = len(values), len(count_masks)
    aligned = all(t.data_ptr() % 16 == 0 for t in [gids, *values, *count_masks])
    if not aligned or ring_stages(k, m, max_groups) < 2:
        return "direct"
    if max_groups * (k + m) > PRIVATE_SLOTS:
        return "staged_shared"
    return _SHAPED.get((k, m), "staged")


@lru_cache(maxsize=None)
def _launcher():
    """The kernel library and its launch entry, with the ctypes signature
    set once."""
    lib = _build.load("lane_sums")
    fn = lib.lane_sums_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


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
    lib, fn = _launcher()
    which = instance(vals, masks, g, max_groups)
    vptr = (ctypes.c_void_p * max(k, 1))(*[v.data_ptr() for v in vals])
    vbits = (ctypes.c_int * max(k, 1))(*[int(b) for b in bits_list])
    mptr = (ctypes.c_void_p * max(m, 1))(*[mk.data_ptr() for mk in masks])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        code = fn(ctypes.addressof(vptr), ctypes.addressof(vbits), k,
                  ctypes.addressof(mptr), m, g.data_ptr(), max_groups, cap,
                  out.data_ptr(), INSTANCES.index(which), stream)
    _build.check_launch(lib, "lane_sums", code)
    launches += 1
    launches_by_instance[which] += 1
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
