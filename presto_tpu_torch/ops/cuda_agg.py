"""The fused leaf-aggregation kernel family: one pass per scan batch.

Counterpart of ``presto_tpu/ops/pallas_agg.py``. A scan -> filter ->
partial-aggregate fragment over narrow, NULL-free columns is described
by a static :class:`LeafAggSpec` (the JAX package's fields, unchanged):

- ``filters``: closed physical intervals per column (one-sided allowed);
- ``keys``: ``gid = sum_i (c_i - lo_i) * stride_i`` over small declared
  domains, at most ``MAX_GROUPS``; no keys and ``groups == 1`` is the
  keyless fragment (TPC-H Q6, the SSB Q1 flight);
- ``values``: per aggregate (sum, min or max) a product of at most two
  linear terms ``c0 + c1 * col`` with a declared |value| bit bound;
- ``guards``: the declared column intervals; a passing row outside one
  sets ``value_overflow`` and the caller falls back to the generic
  operators.

``agg_step`` launches ``csrc/leaf_agg.cu`` on a CUDA batch (any spec the
kernel's limits take: min/max values, bits above 31 and any capacity,
where the JAX package sends such specs to its XLA twin) and computes
``agg_step_plain`` on a CPU batch; ``launches`` counts kernel launches
and ``launches_by_instance`` which instance ran (:func:`instance`).
``agg_step_plain`` is the counterpart of the JAX package's ``_xla_step``
(``fused_small_sums`` and ``segment_agg``, exact int64 throughout).

What bounds the kernel on the H100: the bytes read (each spec column in
its stored width plus ``live``, about 10 bytes a row for Q6). Its
design is in the header of the CUDA source: the staged instance brings
whole tiles of each column into shared memory with bulk copies and
tests 16 rows a thread on packed lanes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.ops import _build
from presto_tpu_torch.ops.groupby import fused_small_sums, segment_agg
from presto_tpu_torch.runtime.errors import InternalError, ResourceExhausted

#: the largest packed group domain (the JAX package's slot budget)
MAX_GROUPS = 512
#: the kernel's limits: spec columns and value aggregates per launch
MAX_COLS = 32
MAX_VALUES = 32

_OPS = {"sum": 0, "min": 1, "max": 2}
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

#: the kernel's instances, in the launch entry's numbering (see
#: :func:`instance`)
INSTANCES = ("staged", "direct", "generic")
#: the staged and direct instances' shape: columns (each at most 4 bytes)
NARROW_COLS = 4

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


@dataclass(frozen=True)
class Term:
    """One linear term ``c0 + c1 * col`` over a column's physical
    values (``col == -1``: the constant ``c0``)."""

    col: int
    c0: int = 0
    c1: int = 1


@dataclass(frozen=True)
class ValueAgg:
    """One aggregate over a derived value: ``op`` in sum|min|max,
    value = ``a`` or ``a * b``, |value| < 2^bits proven by admission."""

    op: str
    a: Term
    b: Optional[Term] = None
    bits: int = 31


@dataclass(frozen=True)
class LeafAggSpec:
    """Static description of one scan->filter->partial-agg fragment."""

    cols: tuple[str, ...]
    #: (col index, lo|None, hi|None) closed physical bounds
    filters: tuple[tuple[int, Optional[int], Optional[int]], ...]
    #: (col index, domain lo, stride); gid = sum (c - lo) * stride
    keys: tuple[tuple[int, int, int], ...]
    groups: int
    values: tuple[ValueAgg, ...]
    #: (col index, declared lo, declared hi) — violation flags loudly
    guards: tuple[tuple[int, int, int], ...]


def state_keys(spec: LeafAggSpec) -> list[str]:
    """The value-state keys of :func:`agg_step`'s output, in
    ``spec.values`` order (``{op}_{i}``)."""
    return [f"{v.op}_{i}" for i, v in enumerate(spec.values)]


def supported(spec: LeafAggSpec) -> bool:
    """Whether one kernel launch takes ``spec``: at most ``MAX_COLS``
    columns, ``MAX_VALUES`` values and ``MAX_GROUPS`` groups."""
    return (len(spec.cols) <= MAX_COLS and len(spec.values) <= MAX_VALUES
            and 1 <= spec.groups <= MAX_GROUPS)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _wrap64(x: int) -> int:
    """``x`` as a two's-complement int64 (the kernel's arithmetic)."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


@lru_cache(maxsize=256)
def _kernel_params(spec: LeafAggSpec):
    """The spec laid out for ``leaf_agg_launch``: per column [filter lo,
    filter hi, guard lo, guard hi, key multiplier, gid base (row 0)],
    per value [op, has_b, bits, a.col, a.c0, a.c1, b.col, b.c0, b.c1]."""
    n = len(spec.cols)
    rows = [[_I64_MIN, _I64_MAX, _I64_MIN, _I64_MAX, 0, 0] for _ in range(n)]
    for ci, lo, hi in spec.filters:  # intersected per column
        if lo is not None:
            rows[ci][0] = max(rows[ci][0], lo)
        if hi is not None:
            rows[ci][1] = min(rows[ci][1], hi)
    for ci, lo, hi in spec.guards:  # outside any guard flags
        rows[ci][2] = max(rows[ci][2], lo)
        rows[ci][3] = min(rows[ci][3], hi)
    base = 0
    for ci, lo, stride in spec.keys:  # gid = base + sum c * multiplier
        rows[ci][4] = _wrap64(rows[ci][4] + stride)
        base = _wrap64(base - lo * stride)
    if n:
        rows[0][5] = base
    colp = (ctypes.c_longlong * max(6 * n, 1))(
        *[max(_I64_MIN, min(_I64_MAX, x)) for r in rows for x in r])
    vals = []
    for v in spec.values:
        b = v.b if v.b is not None else Term(-1, 0, 0)
        vals += [_OPS[v.op], int(v.b is not None), min(v.bits, 63),
                 v.a.col, v.a.c0, v.a.c1, b.col, b.c0, b.c1]
    valp = (ctypes.c_longlong * max(len(vals), 1))(*vals)
    return colp, valp


def _initial_output(spec: LeafAggSpec, dev) -> torch.Tensor:
    """The output of ``spec`` on ``dev`` with each slot at its identity:
    0 for sums, counts and the flag, the int64 extremes for min and max."""
    width = len(spec.values) + 1
    out = torch.zeros(spec.groups * width + 1, dtype=torch.int64, device=dev)
    for j, v in enumerate(spec.values):
        if v.op != "sum":
            out[j: spec.groups * width: width] = _I64_MAX if v.op == "min" else _I64_MIN
    return out


@lru_cache(maxsize=None)
def _launcher():
    """The kernel library and its launch entry, with the ctypes signature
    set once."""
    lib = _build.load("leaf_agg")
    fn = lib.leaf_agg_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def instance(spec: LeafAggSpec, cols, live: torch.Tensor) -> str:
    """Which of ``INSTANCES`` runs ``spec`` over these column tensors:
    ``staged`` for the narrow shape (at most ``NARROW_COLS`` columns of at
    most 4 bytes, at most 1 value) with every column and ``live``
    starting 16-byte aligned (bulk copies of whole tiles); ``direct`` for
    the narrow shape with a column that does not (a view: plain loads);
    ``generic`` for every other spec."""
    narrow = (len(spec.cols) <= NARROW_COLS and len(spec.values) <= 1
              and all(t.element_size() <= 4 for t in cols))
    if not narrow:
        return "generic"
    aligned = all(t.data_ptr() % 16 == 0 for t in [*cols, live])
    return "staged" if aligned else "direct"


def _unpack(spec: LeafAggSpec, out: torch.Tensor) -> dict:
    width = len(spec.values) + 1
    per_g = out[: spec.groups * width].view(spec.groups, width)
    res = {key: per_g[:, j].contiguous() for j, key in enumerate(state_keys(spec))}
    res["count"] = per_g[:, width - 1].contiguous()
    res["present"] = res["count"] > 0
    res["value_overflow"] = out[spec.groups * width] != 0
    return res


def agg_step(spec: LeafAggSpec, batch: Batch) -> dict:
    """One fused partial-aggregation step over ``batch``. Returns a dict
    of [groups] int64 states: one ``{op}_{i}`` per value aggregate,
    ``count`` (passing rows per group), bool ``present``, and the bool
    scalar ``value_overflow`` callers MUST honor by falling back.

    The kernel gates rows on ``live`` only: columns are taken as
    NULL-free (the caller checks with :func:`null_violation`)."""
    dev = batch.device
    if dev.type == "cpu":
        return agg_step_plain(spec, batch)
    if dev.type != "cuda":
        raise InternalError(f"agg_step: no kernel for {dev}")
    if not supported(spec):
        raise ResourceExhausted(
            f"agg_step: {len(spec.cols)} columns, {len(spec.values)} values, "
            f"{spec.groups} groups exceed the kernel's limits ({MAX_COLS}, "
            f"{MAX_VALUES}, {MAX_GROUPS})")
    global launches
    cols = [batch[c].data.contiguous() for c in spec.cols]
    live = batch.live.contiguous()
    for t in cols:
        if t.dtype not in _INT_DTYPES or t.shape != live.shape or t.device != dev:
            raise InternalError(f"agg_step: column {t.dtype}{tuple(t.shape)} on "
                                f"{t.device} does not fit the kernel")
    if live.dtype != torch.bool:
        raise InternalError("agg_step: live must be bool")
    colp, valp = _kernel_params(spec)
    out = _initial_output(spec, dev)
    if batch.capacity > 0:
        lib, fn = _launcher()
        which = instance(spec, cols, live)
        n = max(len(cols), 1)
        ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in cols])
        sizes = (ctypes.c_int * n)(*[t.element_size() for t in cols])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(ctypes.addressof(ptrs), ctypes.addressof(sizes), len(cols),
                      ctypes.addressof(colp), ctypes.addressof(valp), len(spec.values),
                      spec.groups, live.data_ptr(), batch.capacity, out.data_ptr(),
                      INSTANCES.index(which), stream)
        _build.check_launch(lib, "leaf_agg", code)
        launches += 1
        launches_by_instance[which] += 1
    return _unpack(spec, out)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def agg_step_plain(spec: LeafAggSpec, batch: Batch) -> dict:
    """The plain PyTorch version of :func:`agg_step` (the JAX package's
    ``_xla_step``): the same results on every input, in exact int64."""
    cap, dev = batch.capacity, batch.device
    cols = [batch[c].data.to(torch.int64) for c in spec.cols]
    live = batch.live
    for ci, lo, hi in spec.filters:
        if lo is not None:
            live = live & (cols[ci] >= lo)
        if hi is not None:
            live = live & (cols[ci] <= hi)
    oflow = torch.zeros((), dtype=torch.bool, device=dev)
    for ci, lo, hi in spec.guards:
        oflow = oflow | torch.any(live & ((cols[ci] < lo) | (cols[ci] > hi)))
    gid = torch.zeros(cap, dtype=torch.int64, device=dev)
    for ci, lo, stride in spec.keys:
        gid = gid + (cols[ci] - lo) * stride
    # rows of no group (dead, filtered, or a key outside its domain) go
    # to the trash group ``groups``
    inside = live & (gid >= 0) & (gid < spec.groups)
    gid = torch.where(inside, gid, torch.full_like(gid, spec.groups))

    def term(t: Term) -> torch.Tensor:
        if t.col < 0:
            return torch.full((cap,), t.c0, dtype=torch.int64, device=dev)
        return t.c0 + t.c1 * cols[t.col]

    def value(v: ValueAgg) -> torch.Tensor:
        val = term(v.a)
        return val if v.b is None else val * term(v.b)

    res: dict = {}
    keys = state_keys(spec)
    sums = [(i, v) for i, v in enumerate(spec.values) if v.op == "sum"]
    minmax = [(i, v) for i, v in enumerate(spec.values) if v.op != "sum"]
    if sums:
        svals, _counts, extra, s_oflow = fused_small_sums(
            [value(v) for _i, v in sums], [min(v.bits, 63) for _i, v in sums],
            [live] * len(sums), gid, spec.groups, extra_count_masks=[live],
            kernel=False)
        for (i, _v), s in zip(sums, svals):
            res[keys[i]] = s
        res["count"] = extra[0]
        oflow = oflow | s_oflow
    else:
        res["count"] = segment_agg(torch.ones(cap, dtype=torch.int64, device=dev), inside,
                                   gid, spec.groups, "count")
    for i, v in minmax:
        res[keys[i]] = segment_agg(value(v), inside, gid, spec.groups, v.op)
    res["present"] = res["count"] > 0
    res["value_overflow"] = oflow
    return res


# ---------------------------------------------------------------------------
# helpers of the streamed scan loop
# ---------------------------------------------------------------------------


def null_violation(batch: Batch) -> torch.Tensor:
    """Bool scalar: any live NULL in any column of ``batch`` — the
    runtime check of the DECLARED NULL-freedom every routed column
    admits on (the kernel never reads validity masks)."""
    bad = torch.zeros((), dtype=torch.bool, device=batch.device)
    for col in batch.columns.values():
        if col.valid is not None and col.valid is not batch.live:
            bad = bad | torch.any(batch.live & ~col.valid)
    return bad


def combine_states(spec: LeafAggSpec, a: dict, b: dict) -> dict:
    """Fold two split states (sums/counts add, min/max reduce, flags
    OR) — the cross-split merge of the streamed scan loop."""
    out = {}
    for key in state_keys(spec):
        if key.startswith("min"):
            out[key] = torch.minimum(a[key], b[key])
        elif key.startswith("max"):
            out[key] = torch.maximum(a[key], b[key])
        else:
            out[key] = a[key] + b[key]
    out["count"] = a["count"] + b["count"]
    out["present"] = a["present"] | b["present"]
    out["value_overflow"] = a["value_overflow"] | b["value_overflow"]
    return out
