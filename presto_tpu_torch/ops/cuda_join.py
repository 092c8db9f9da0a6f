"""Fused join probes over small lookup tables: the join-probe kernels.

Replaces ``presto_tpu/ops/pallas_join.py::exists_probe`` (Pallas body
``_exists_kernel``), ``::payload_probe`` (``_payload_kernel``),
``::sketch_probe`` (``_sketch_kernel``) and ``::q3_probe_step``
(``_q3_kernel``) with ``csrc/join_probe.cu``. When connector stats prove
a build key's domain ``[key_min, key_max]`` small, the join build
publishes a flat table over it and each probe row is one table lookup:

- **exists**: a bitmask, 32 keys per int32 word, at most
  ``EXISTS_WORD_LIMIT`` words. Duplicate-safe: serves semi and anti
  joins and inner joins that carry no build column (TPC-H Q3's customer
  join).
- **payload**: a present table plus one int32 value table per build
  output column, ``(1 + ncols) * rows`` at most ``PAYLOAD_SLOT_LIMIT``.
  The probe returns the match flag and each build value at the key's
  slot (TPC-H Q10's nation join, which projects ``n_name``). Unique
  builds only.
- **sketch**: a two-hash Bloom bitmask over ``SKETCH_BITS`` bits
  (``ops/hashing.py``), for any key domain. APPROXIMATE: false
  positives, never false negatives. Only semi joins under the
  ``approx_join`` session property take it (never anti: a false
  positive there would drop a row).

``q3_probe_step`` is the resident Q3 join step of the benchmark: an
exists bitmask over ``o_orderkey``, the ``l_shipdate`` filter and the
revenue sum ``ep * (100 - disc)`` in one pass (``workloads.py``).

The eligibility rules (``exists_words``, ``payload_rows``,
``interval_ok``, and ``probe_block`` for the sketch) are the JAX
package's, in the same numbers, so the same joins take the route at the
same stats. The exact kernels take any capacity. The table builders are
PyTorch scatters; a LIVE build key outside the advisory domain sets
``oob`` and the caller discards the tables (a counted fallback, never a
wrong answer).

What bounds the kernels on the H100: the bytes moved per probe row (the
key in its stored width, the live and validity bytes, one or two mask
bytes out, each payload value in its storage width); the tables are at
most 64 KB and stay cached (the payload kernel's small ones in shared
memory). See the header of
the CUDA source for the design.

The semi/anti join operator takes its new live mask straight from the
exists and sketch kernels: ``exists_keep`` and ``sketch_keep`` fold the
probe key's validity and the join's keep rule (semi: ``live && valid &&
hit``; anti: ``live && !(valid && hit)``) into the same launch, so a
probe batch costs one device launch. ``exists_probe`` and
``sketch_probe`` are the same kernels with no validity (the JAX
package's functions). The inner and left joins' payload probe does the
same through ``payload_keep``: the key's validity, each value narrowed to
its build column's storage type, and the inner join's new live mask come
from one launch; ``payload_probe`` is that kernel with int32 outputs and
no validity.

Each kernel's wrapper launches it on CUDA tensors and computes its plain
version (``*_plain``) on CPU tensors; ``exists_launches``,
``payload_launches``, ``sketch_launches`` and ``q3_launches`` count
launches, and ``launches_by_instance`` and ``launches_by_shape`` which
instance of the exists, sketch and payload kernels ran (:func:`instance`,
:func:`payload_instance`) and at how many rows. ``reset_launches()``
zeroes them all.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from presto_tpu_torch.ops import _build
from presto_tpu_torch.ops.hashing import bloom_build, bloom_test, pack_bits
from presto_tpu_torch.runtime.errors import InternalError

#: exists-table words: the JAX package's 8 MB replicated-table budget
#: over 128 lanes of 4 bytes (16384 words = 2^19 keys, 64 KB here)
EXISTS_WORD_LIMIT = 16384
#: payload table slots, present + values: the same budget
PAYLOAD_SLOT_LIMIT = 16384
#: value columns one payload probe carries (the planner routes wider
#: payloads to the dense or sorted probe)
MAX_VALUES = 16
#: sketch-mode Bloom bits (2^19 bits = 16384 words, the exists budget)
SKETCH_BITS = 1 << 19
#: the JAX package's probe-block lane width (the sketch route's
#: capacity rule, ``probe_block``)
_LANES = 128
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_KEY_DTYPES = (torch.int8, torch.int16, torch.int32)

#: the exists and sketch kernels' instances, in the launch entries'
#: numbering (see :func:`instance`): a thread a 16-byte group of rows, or
#: a row a thread
INSTANCES = ("vector", "scalar")
#: the payload kernel's instances, in its launch entry's numbering (see
#: :func:`payload_instance`): a group of rows or a row a thread, each
#: with the tables staged in shared memory or read through the read-only
#: path
PAYLOAD_INSTANCES = ("vector_staged", "vector", "scalar_staged", "scalar")
#: table slots (present + values) the payload kernel stages in shared
#: memory (8 KB); larger tables take the instances that do not
STAGED_SLOTS = 2048
#: rows a thread of the payload kernel's vector instances owns
PAYLOAD_GROUP_ROWS = 4
#: storage types ``payload_keep`` writes values in (the int32 table
#: values truncated or sign-extended, as ``.to(dtype)``)
_VALUE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
_INSTANCES_OF = {"exists": INSTANCES, "sketch": INSTANCES, "payload": PAYLOAD_INSTANCES}

#: kernel launches since the last reset (plain counters, set to 0 by
#: whoever reads them: see :func:`reset_launches`); the exists, sketch
#: and payload kernels also by instance and by row count
exists_launches = 0
payload_launches = 0
sketch_launches = 0
q3_launches = 0
launches_by_instance = {k: dict.fromkeys(v, 0) for k, v in _INSTANCES_OF.items()}
launches_by_shape: dict[str, dict[int, int]] = {k: {} for k in _INSTANCES_OF}


def reset_launches() -> None:
    """Set every launch counter of this module to 0."""
    global exists_launches, payload_launches, sketch_launches, q3_launches
    exists_launches = payload_launches = sketch_launches = q3_launches = 0
    for kernel, names in _INSTANCES_OF.items():
        launches_by_instance[kernel] = dict.fromkeys(names, 0)
        launches_by_shape[kernel] = {}


def _count(kernel: str, which: str, rows: int) -> None:
    launches_by_instance[kernel][which] += 1
    shape = launches_by_shape[kernel]
    shape[rows] = shape.get(rows, 0) + 1


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def exists_words(domain: int) -> int | None:
    """Bitmask words for an exists-mode table, or None when the domain
    is over the table budget."""
    if domain <= 0:
        return None
    w = _pad8(-(-domain // 32))
    return w if w <= EXISTS_WORD_LIMIT else None


def payload_rows(domain: int, ncols: int) -> int | None:
    """Padded table rows for payload mode (present + ncols values), or
    None when over budget."""
    if domain <= 0:
        return None
    d = _pad8(domain)
    return d if (1 + ncols) * d <= PAYLOAD_SLOT_LIMIT else None


def probe_block(cap: int) -> int | None:
    """The JAX package's probe sublanes per grid block: the largest of
    512..8 whose 128-lane block evenly divides the capacity, or None
    (a capacity that is not a multiple of 1024). The exact kernels here
    take any capacity (ROADMAP C4); the sketch route keeps this rule, so
    it approximates exactly the batches the JAX package's does."""
    for sp in (512, 256, 128, 64, 32, 16, 8):
        if cap % (sp * _LANES) == 0:
            return sp
    return None


def interval_ok(key_min: int, key_max: int) -> bool:
    """The domain ends must fit int32 (keys are at most 32-bit)."""
    return _INT32_MIN <= key_min <= key_max <= _INT32_MAX


def key_dtype_ok(dtype: torch.dtype) -> bool:
    """Key storage the kernels read: signed integers of at most 32 bits
    (the connector's narrow scan representation)."""
    return dtype in _KEY_DTYPES


@dataclass(frozen=True)
class PallasJoinSpec:
    """Planner-chosen fused-probe configuration, carried by the join
    build (the name is the JAX package's). ``payload`` names build-side
    source columns in projection order (payload mode); ``nbits`` > 0
    selects sketch mode (``approx_join``) and makes key_min/key_max
    irrelevant."""

    mode: str  # "exists" | "payload" | "sketch"
    key_min: int = 0
    key_max: int = 0
    payload: tuple[str, ...] = ()
    nbits: int = 0


# ---------------------------------------------------------------------------
# table builders (PyTorch scatters)
# ---------------------------------------------------------------------------


def _slots(keys: torch.Tensor, live: torch.Tensor, key_min: int, key_max: int, trash: int):
    """(slot per row with non-contributing rows at ``trash``, oob flag)."""
    k = keys.to(torch.int64)
    inr = (k >= key_min) & (k <= key_max)
    ok = live & inr
    return torch.where(ok, k - key_min, torch.full_like(k, trash)), (live & ~inr).any()


def build_exists_table(keys: torch.Tensor, live: torch.Tensor, key_min: int, key_max: int,
                       pad_words: int | None = None):
    """int32 [W] bitmask over the key domain (bit b of word w is key
    key_min + 32w + b). Returns (table, oob): ``oob`` is True when some
    LIVE key fell outside the domain. Duplicate keys are fine.
    ``pad_words`` sets W (bits past the domain stay 0), bypassing the
    exists budget, as the benchmark's Q3 table does."""
    w = exists_words(key_max - key_min + 1) if pad_words is None else pad_words
    if w is None or w * 32 < key_max - key_min + 1:
        raise InternalError(f"exists table over [{key_min}, {key_max}] is over budget "
                            f"or does not cover the domain")
    nbits = w * 32
    slot, oob = _slots(keys, live, key_min, key_max, nbits)
    present = torch.zeros(nbits + 1, dtype=torch.int64, device=keys.device)
    present.scatter_(0, slot, torch.ones_like(slot))
    return pack_bits(present, w), oob


def build_sketch_table(keys: torch.Tensor, live: torch.Tensor, nbits: int = SKETCH_BITS):
    """int32 [nbits / 32] two-hash Bloom words over the live keys
    (``hashing.bloom_build``: the layout the sketch kernel probes). No
    domain and no oob: every key hashes somewhere."""
    return bloom_build(keys, live, nbits)


def build_payload_tables(keys: torch.Tensor, live: torch.Tensor, key_min: int,
                         key_max: int, values):
    """Present + one int32 value table per payload column, each [d].
    Unique build keys required (the scatter keeps an arbitrary row per
    duplicate key). Returns (tables, oob) with tables[0] the present
    table."""
    d = payload_rows(key_max - key_min + 1, len(values))
    if d is None:
        raise InternalError(f"payload tables over [{key_min}, {key_max}] are over budget")
    slot, oob = _slots(keys, live, key_min, key_max, d)
    tables = []
    for v in [torch.ones_like(keys, dtype=torch.int32)] + list(values):
        t = torch.zeros(d + 1, dtype=torch.int32, device=keys.device)
        t.scatter_(0, slot, v.to(torch.int32))
        tables.append(t[:d])
    return tuple(tables), oob


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------


def _check(tables, key_min: int, key_max: int, keys, live, per_word: int):
    if not interval_ok(key_min, key_max):
        raise InternalError(f"probe domain [{key_min}, {key_max}] does not fit int32")
    if not key_dtype_ok(keys.dtype) or keys.dim() != 1:
        raise InternalError(f"probe keys must be int8/int16/int32 [cap], got {keys.dtype}")
    if live.dtype != torch.bool or live.shape != keys.shape or live.device != keys.device:
        raise InternalError("probe live mask must be bool [cap] beside the keys")
    need = -(-(key_max - key_min + 1) // per_word)
    for t in tables:
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != keys.device:
            raise InternalError("probe tables must be int32 [n] beside the keys")
        if t.shape[0] < need:
            raise InternalError(f"probe table of {t.shape[0]} entries does not cover "
                                f"the domain [{key_min}, {key_max}]")


def _in_domain(key_min: int, key_max: int, keys, live):
    k = keys.to(torch.int64)
    inr = live & (k >= key_min) & (k <= key_max)
    return inr, torch.where(inr, k - key_min, torch.zeros_like(k))


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each launch entry's ctypes signature
_ARGTYPES = {
    "exists_probe": [_P, _I, _P, _P, _LL, _P, _LL, _LL, _I, _I, _P, _P],
    "sketch_probe": [_P, _I, _P, _P, _LL, _P, _LL, _I, _P, _P],
    "payload_probe": [_P, _I, _P, _P, _LL, _P, _P, _P, _P, _I, _LL, _LL, _I, _P, _P, _P],
    "q3_probe": [_P, _I] * 4 + [_P, _LL, _P, _LL, _LL, _LL, _P, _P],
}


@lru_cache(maxsize=None)
def _launcher(name: str):
    """The kernel library and launch entry ``<name>_launch``, its ctypes
    signature set once a process."""
    lib = _build.load("join_probe")
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return lib, fn


def _check_valid(valid, keys):
    if valid is not None and (valid.dtype != torch.bool or valid.shape != keys.shape
                              or valid.device != keys.device):
        raise InternalError("probe validity must be bool [cap] beside the keys")


def group_rows(keys) -> int:
    """Rows in one 16-byte group of ``keys``: 4 int32, 8 int16, 16 int8."""
    return 16 // keys.element_size()


def instance(keys, live, valid=None) -> str:
    """Which of ``INSTANCES`` the exists or sketch kernel runs for these
    tensors: ``vector`` when the keys start 16-byte aligned and ``live``
    and ``valid`` (if any) at a multiple of the group's rows (the output
    is always allocated aligned), else ``scalar``."""
    r = group_rows(keys)
    aligned = keys.data_ptr() % 16 == 0 and all(
        t.data_ptr() % r == 0 for t in (live, valid) if t is not None)
    return INSTANCES[0] if aligned else INSTANCES[1]


def _launch_membership(kernel: str, keys, live, valid, table, args) -> torch.Tensor:
    """Launch the exists or sketch kernel: ``args`` are the entry's
    arguments between the table and the instance. Counts the launch."""
    global exists_launches, sketch_launches
    k, lv, t = keys.contiguous(), live.contiguous(), table.contiguous()
    vd = None if valid is None else valid.contiguous()
    out = torch.empty(k.shape, dtype=torch.bool, device=k.device)
    which = instance(k, lv, vd)
    lib, fn = _launcher(f"{kernel}_probe")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        code = fn(k.data_ptr(), k.element_size(), lv.data_ptr(),
                  None if vd is None else vd.data_ptr(), k.shape[0], t.data_ptr(), *args,
                  INSTANCES.index(which), out.data_ptr(), stream)
    _build.check_launch(lib, "join_probe", code)
    if kernel == "exists":
        exists_launches += 1
    else:
        sketch_launches += 1
    _count(kernel, which, k.shape[0])
    return out


def exists_probe(table, key_min: int, key_max: int, keys, live) -> torch.Tensor:
    """matched bool [cap]: live, in the domain, and its bit set."""
    return exists_keep(table, key_min, key_max, keys, live, None, False)


def exists_keep(table, key_min: int, key_max: int, keys, live, valid, anti: bool):
    """A semi or anti join's new live mask, bool [cap], in one launch:
    ``live && valid && hit`` (semi, and the payload-free inner join) or
    ``live && !(valid && hit)`` (``anti``: a NULL probe key is kept), hit
    being the key in the domain with its bit set. ``valid`` is the probe
    key's validity, None when every key is valid."""
    _check([table], key_min, key_max, keys, live, 32)
    _check_valid(valid, keys)
    if keys.device.type == "cpu":
        return exists_keep_plain(table, key_min, key_max, keys, live, valid, anti)
    if keys.device.type != "cuda":
        raise InternalError(f"exists_probe: no kernel for {keys.device}")
    return _launch_membership("exists", keys, live, valid, table,
                              (key_min, key_max, int(anti)))


def exists_probe_plain(table, key_min: int, key_max: int, keys, live) -> torch.Tensor:
    """The plain PyTorch version of ``exists_probe`` (same contract)."""
    _check([table], key_min, key_max, keys, live, 32)
    inr, slot = _in_domain(key_min, key_max, keys, live)
    words = table.to(torch.int64)[slot >> 5]
    return inr & (((words >> (slot & 31)) & 1) != 0)


def _keep_plain(matched, live, anti: bool):
    keep = ~matched if anti else matched
    return live & keep


def _probe_live(live, valid):
    return live & (torch.ones_like(live) if valid is None else valid)


def exists_keep_plain(table, key_min: int, key_max: int, keys, live, valid, anti: bool):
    """The plain PyTorch version of ``exists_keep``: the operator's
    composition around ``exists_probe_plain``."""
    _check_valid(valid, keys)
    matched = exists_probe_plain(table, key_min, key_max, keys, _probe_live(live, valid))
    return _keep_plain(matched, live, anti)


def payload_instance(tables, key_min: int, key_max: int, keys, live, valid=None) -> str:
    """Which of ``PAYLOAD_INSTANCES`` the payload kernel runs for these
    tensors: ``vector*`` when the keys start aligned to a group of
    ``PAYLOAD_GROUP_ROWS`` keys and ``live`` and ``valid`` (if any) to as
    many bytes (the outputs are always allocated aligned), else
    ``scalar*``; ``*_staged`` when the present and value tables together
    hold at most ``STAGED_SLOTS`` slots of the domain."""
    r = PAYLOAD_GROUP_ROWS
    staged = len(tables) * (key_max - key_min + 1) <= STAGED_SLOTS
    vector = keys.data_ptr() % (r * keys.element_size()) == 0 and all(
        t.data_ptr() % r == 0 for t in (live, valid) if t is not None)
    return PAYLOAD_INSTANCES[(0 if vector else 2) + (0 if staged else 1)]


def _check_payload(tables, key_min: int, key_max: int, keys, live, valid, out_dtypes):
    _check(tables, key_min, key_max, keys, live, 1)
    if len(tables) - 1 > MAX_VALUES:
        raise InternalError(f"payload probe of {len(tables) - 1} value columns; "
                            f"at most {MAX_VALUES}")
    _check_valid(valid, keys)
    if len(out_dtypes) != len(tables) - 1 or any(d not in _VALUE_DTYPES for d in out_dtypes):
        raise InternalError(f"payload output types {list(out_dtypes)} for {len(tables) - 1} "
                            "value columns: one signed integer type each")


def payload_probe(tables, key_min: int, key_max: int, keys, live):
    """(matched bool [cap], [int32 [cap] per value table]): the build
    value at each matched probe key's slot, 0 where unmatched (callers
    set validity from ``matched``)."""
    tables = list(tables)
    matched, values, _ = payload_keep(tables, key_min, key_max, keys, live, None,
                                      [torch.int32] * (len(tables) - 1), False)
    return matched, values


def payload_keep(tables, key_min: int, key_max: int, keys, live, valid, out_dtypes,
                 inner: bool):
    """An inner or left join's whole payload probe batch in one launch:
    (matched bool [cap], [one [cap] tensor per value table, in
    ``out_dtypes``], live). A row matches when ``live && valid`` and its
    key is in the domain with its present bit set; each value is the
    build value at the key's slot (0 where unmatched), written in its
    build column's storage type (the int32 table value truncated or
    sign-extended, as ``.to(dtype)``). ``matched`` is every value
    column's validity. ``live`` is the inner join's new live mask
    ``live && matched`` (a tensor of its own, equal to ``matched``), or
    for a left join the ``live`` passed in. ``valid`` is the probe key's
    validity, None when every key is valid."""
    tables = list(tables)
    _check_payload(tables, key_min, key_max, keys, live, valid, out_dtypes)
    if keys.device.type == "cpu":
        return payload_keep_plain(tables, key_min, key_max, keys, live, valid, out_dtypes,
                                  inner)
    if keys.device.type != "cuda":
        raise InternalError(f"payload_probe: no kernel for {keys.device}")
    global payload_launches
    k, lv = keys.contiguous(), live.contiguous()
    vd = None if valid is None else valid.contiguous()
    present, vtabs = tables[0].contiguous(), [t.contiguous() for t in tables[1:]]
    matched = torch.empty(k.shape, dtype=torch.bool, device=k.device)
    new_live = torch.empty(k.shape, dtype=torch.bool, device=k.device) if inner else None
    outs = [torch.empty(k.shape, dtype=d, device=k.device) for d in out_dtypes]
    which = payload_instance(tables, key_min, key_max, k, lv, vd)
    lib, fn = _launcher("payload_probe")
    tptr = (ctypes.c_void_p * MAX_VALUES)(*[t.data_ptr() for t in vtabs])
    optr = (ctypes.c_void_p * MAX_VALUES)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * MAX_VALUES)(*[o.element_size() for o in outs])
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        code = fn(k.data_ptr(), k.element_size(), lv.data_ptr(),
                  None if vd is None else vd.data_ptr(), k.shape[0], present.data_ptr(),
                  ctypes.addressof(tptr), ctypes.addressof(optr), ctypes.addressof(widths),
                  len(vtabs), key_min, key_max, PAYLOAD_INSTANCES.index(which),
                  matched.data_ptr(), None if new_live is None else new_live.data_ptr(), stream)
    _build.check_launch(lib, "join_probe", code)
    payload_launches += 1
    _count("payload", which, k.shape[0])
    return matched, outs, (new_live if inner else live)


def payload_probe_plain(tables, key_min: int, key_max: int, keys, live):
    """The plain PyTorch version of ``payload_probe`` (same contract)."""
    tables = list(tables)
    _check(tables, key_min, key_max, keys, live, 1)
    inr, slot = _in_domain(key_min, key_max, keys, live)
    hit = inr & (tables[0][slot] != 0)
    zero = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    return hit, [torch.where(hit, t[slot], zero) for t in tables[1:]]


def payload_keep_plain(tables, key_min: int, key_max: int, keys, live, valid, out_dtypes,
                       inner: bool):
    """The plain PyTorch version of ``payload_keep``: the operator's
    composition around ``payload_probe_plain`` (the probe live mask, the
    probe, each value cast to its type, the inner join's ``live &
    matched``)."""
    tables = list(tables)
    _check_payload(tables, key_min, key_max, keys, live, valid, out_dtypes)
    matched, values = payload_probe_plain(tables, key_min, key_max, keys,
                                          _probe_live(live, valid))
    values = [v.to(d) for v, d in zip(values, out_dtypes)]
    return matched, values, (live & matched if inner else live)


def _check_sketch(table, nbits: int, keys, live):
    if nbits <= 0 or nbits & (nbits - 1) or table.dim() != 1 or table.shape[0] * 32 != nbits:
        raise InternalError(f"sketch of {nbits} bits over a table of shape "
                            f"{tuple(table.shape)}: nbits must be a power of two, "
                            "32 per table word")
    if table.dtype != torch.int32 or table.device != keys.device:
        raise InternalError("the sketch table must be int32 beside the keys")
    if not key_dtype_ok(keys.dtype) or keys.dim() != 1:
        raise InternalError(f"probe keys must be int8/int16/int32 [cap], got {keys.dtype}")
    if live.dtype != torch.bool or live.shape != keys.shape or live.device != keys.device:
        raise InternalError("probe live mask must be bool [cap] beside the keys")


def sketch_probe(table, nbits: int, keys, live) -> torch.Tensor:
    """APPROXIMATE matched bool [cap]: live and both Bloom bits of the
    key set (false positives possible, never false negatives)."""
    return sketch_keep(table, nbits, keys, live, None)


def sketch_keep(table, nbits: int, keys, live, valid) -> torch.Tensor:
    """The approximate semi join's new live mask, bool [cap], in one
    launch: ``live && valid && both Bloom bits set``. ``valid`` is the
    probe key's validity, None when every key is valid. (The sketch never
    serves anti joins: a false positive there would drop a row.)"""
    _check_sketch(table, nbits, keys, live)
    _check_valid(valid, keys)
    if keys.device.type == "cpu":
        return sketch_keep_plain(table, nbits, keys, live, valid)
    if keys.device.type != "cuda":
        raise InternalError(f"sketch_probe: no kernel for {keys.device}")
    return _launch_membership("sketch", keys, live, valid, table, (nbits,))


def sketch_probe_plain(table, nbits: int, keys, live) -> torch.Tensor:
    """The plain PyTorch version of ``sketch_probe`` (same contract)."""
    _check_sketch(table, nbits, keys, live)
    return live & bloom_test(table, keys)


def sketch_keep_plain(table, nbits: int, keys, live, valid) -> torch.Tensor:
    """The plain PyTorch version of ``sketch_keep``: the operator's
    composition around ``sketch_probe_plain``."""
    _check_valid(valid, keys)
    matched = sketch_probe_plain(table, nbits, keys, _probe_live(live, valid))
    return _keep_plain(matched, live, False)


# ---------------------------------------------------------------------------
# the benchmark's resident Q3 join step
# ---------------------------------------------------------------------------

#: the JAX package's partition width: its 8 MB table budget over 128
#: lanes of 4 bytes
_Q3_WMAX = 16384


def q3_partitions(domain: int, wmax: int | None = None) -> tuple[int, int]:
    """(words per partition, partition count) covering ``domain``, as
    the JAX package computes them: ``pad_words = w * nparts`` sizes the
    Q3 bitmask (``build_exists_table``). The kernel here reads the table
    flat; partitions are a TPU means and change no result."""
    if wmax is None:
        wmax = _Q3_WMAX
    words = -(-domain // 32)
    return wmax, -(-words // wmax)


def _q3_columns(table, key_min: int, domain: int, keys, shipdate, extendedprice,
                discount, live):
    cols = (keys, shipdate, extendedprice, discount)
    if table.dtype != torch.int32 or table.dim() != 1 or table.shape[0] * 32 < domain:
        raise InternalError(f"the Q3 bitmask must be int32 [W] covering {domain} keys")
    if not interval_ok(key_min, key_min):
        raise InternalError(f"Q3 key_min {key_min} does not fit int32")
    for c in cols:
        if not key_dtype_ok(c.dtype) or c.shape != live.shape or c.device != live.device:
            raise InternalError("Q3 columns must be int8/int16/int32 [cap] beside the live "
                                f"mask, got {c.dtype}{tuple(c.shape)}")
    if live.dtype != torch.bool or live.dim() != 1 or table.device != live.device:
        raise InternalError("the Q3 live mask must be bool [cap] beside the table")


def q3_probe_step(table, key_min: int, domain: int, cutoff: int, keys, shipdate,
                  extendedprice, discount, live, wmax: int | None = None):
    """The fused Q3 join step over one batch: rows that are live, ship
    after ``cutoff`` and whose key's bit is set in the bitmask ``table``
    (bit ``key - key_min``; keys below key_min or past the table miss).
    Returns (matched count, revenue = sum ep * (100 - disc), at scale 4)
    as int64 0-d tensors. ``wmax`` is accepted for the JAX package's
    signature and changes nothing."""
    del wmax
    _q3_columns(table, key_min, domain, keys, shipdate, extendedprice, discount, live)
    if live.device.type == "cpu":
        return q3_probe_step_plain(table, key_min, domain, cutoff, keys, shipdate,
                                   extendedprice, discount, live)
    if live.device.type != "cuda":
        raise InternalError(f"q3_probe_step: no kernel for {live.device}")
    global q3_launches
    cols = [c.contiguous() for c in (keys, shipdate, extendedprice, discount)]
    lv, t = live.contiguous(), table.contiguous()
    out = torch.zeros(2, dtype=torch.int64, device=live.device)
    lib, fn = _launcher("q3_probe")
    args = []
    for c in cols:
        args += [c.data_ptr(), c.element_size()]
    with torch.cuda.device(lv.device):
        stream = torch.cuda.current_stream(lv.device).cuda_stream
        code = fn(*args, lv.data_ptr(), lv.shape[0], t.data_ptr(), t.shape[0], key_min,
                  cutoff, out.data_ptr(), stream)
    _build.check_launch(lib, "join_probe", code)
    q3_launches += 1
    return out[0], out[1]


def q3_probe_step_plain(table, key_min: int, domain: int, cutoff: int, keys, shipdate,
                        extendedprice, discount, live):
    """The plain PyTorch version of ``q3_probe_step`` (same contract)."""
    _q3_columns(table, key_min, domain, keys, shipdate, extendedprice, discount, live)
    slot = keys.to(torch.int64) - key_min
    inr = (live & (shipdate.to(torch.int64) > cutoff) & (slot >= 0)
           & ((slot >> 5) < table.shape[0]))
    s = torch.where(inr, slot, torch.zeros_like(slot))
    hit = inr & (((table.to(torch.int64)[s >> 5] >> (s & 31)) & 1) != 0)
    rev = extendedprice.to(torch.int64) * (100 - discount.to(torch.int64))
    return hit.sum(dtype=torch.int64), torch.where(hit, rev, torch.zeros_like(rev)).sum()
