"""Fused join probes over small lookup tables: the join-probe kernels.

Replaces ``presto_tpu/ops/pallas_join.py::exists_probe`` (Pallas body
``_exists_kernel``) and ``::payload_probe`` (``_payload_kernel``) with
``csrc/join_probe.cu``. When connector stats prove a unique build key's
domain ``[key_min, key_max]`` small, the join build publishes a flat
table over it and each probe row is one table lookup:

- **exists**: a bitmask, 32 keys per int32 word, at most
  ``EXISTS_WORD_LIMIT`` words. Serves inner joins that carry no build
  column (TPC-H Q3's customer join).
- **payload**: a present table plus one int32 value table per build
  output column, ``(1 + ncols) * rows`` at most ``PAYLOAD_SLOT_LIMIT``.
  The probe returns the match flag and each build value at the key's
  slot (TPC-H Q10's nation join, which projects ``n_name``).

The eligibility rules (``exists_words``, ``payload_rows``,
``interval_ok``) are the JAX package's, in the same numbers, so the same
joins take the route at the same stats. The kernels themselves take any
capacity. The table builders are PyTorch scatters; a LIVE build key
outside the advisory domain sets ``oob`` and the caller discards the
tables (a counted fallback, never a wrong answer).

What bounds the kernels on the H100: the bytes moved per probe row (the
key in its stored width, the live byte, a bool out, 4 bytes per payload
value); the tables are at most 64 KB and stay cached. See the header of
the CUDA source for the design.

``exists_probe`` / ``payload_probe`` launch the kernels on CUDA tensors
and compute ``exists_probe_plain`` / ``payload_probe_plain`` on CPU
tensors; ``exists_launches`` / ``payload_launches`` count launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from presto_tpu_torch.ops import _build
from presto_tpu_torch.runtime.errors import InternalError

#: exists-table words: the JAX package's 8 MB replicated-table budget
#: over 128 lanes of 4 bytes (16384 words = 2^19 keys, 64 KB here)
EXISTS_WORD_LIMIT = 16384
#: payload table slots, present + values: the same budget
PAYLOAD_SLOT_LIMIT = 16384
#: value columns one payload probe carries (the planner routes wider
#: payloads to the dense or sorted probe)
MAX_VALUES = 16
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_KEY_DTYPES = (torch.int8, torch.int16, torch.int32)

#: kernel launches since the last reset (plain counters, set to 0 by
#: whoever reads them)
exists_launches = 0
payload_launches = 0


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
    build. ``payload`` names build-side source columns in projection
    order (payload mode). The name is the JAX package's; the approximate
    sketch mode is not ported."""

    mode: str  # "exists" | "payload"
    key_min: int = 0
    key_max: int = 0
    payload: tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# table builders (PyTorch scatters)
# ---------------------------------------------------------------------------


def _slots(keys: torch.Tensor, live: torch.Tensor, key_min: int, key_max: int, trash: int):
    """(slot per row with non-contributing rows at ``trash``, oob flag)."""
    k = keys.to(torch.int64)
    inr = (k >= key_min) & (k <= key_max)
    ok = live & inr
    return torch.where(ok, k - key_min, torch.full_like(k, trash)), (live & ~inr).any()


def build_exists_table(keys: torch.Tensor, live: torch.Tensor, key_min: int, key_max: int):
    """int32 [W] bitmask over the key domain (bit b of word w is key
    key_min + 32w + b). Returns (table, oob): ``oob`` is True when some
    LIVE key fell outside the domain. Duplicate keys are fine."""
    w = exists_words(key_max - key_min + 1)
    if w is None:
        raise InternalError(f"exists table over [{key_min}, {key_max}] is over budget")
    nbits = w * 32
    slot, oob = _slots(keys, live, key_min, key_max, nbits)
    present = torch.zeros(nbits + 1, dtype=torch.int64, device=keys.device)
    present.scatter_(0, slot, torch.ones_like(slot))
    bits = present[:nbits].view(w, 32) << torch.arange(32, device=keys.device)
    words = bits.sum(dim=1)
    # the int64 word sum holds the unsigned bit pattern; wrap to int32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32), oob


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


def exists_probe(table, key_min: int, key_max: int, keys, live) -> torch.Tensor:
    """matched bool [cap]: live, in the domain, and its bit set."""
    _check([table], key_min, key_max, keys, live, 32)
    if keys.device.type == "cpu":
        return exists_probe_plain(table, key_min, key_max, keys, live)
    if keys.device.type != "cuda":
        raise InternalError(f"exists_probe: no kernel for {keys.device}")
    global exists_launches
    out = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    k, lv, t = keys.contiguous(), live.contiguous(), table.contiguous()
    lib = _build.load("join_probe")
    fn = lib.exists_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        code = fn(k.data_ptr(), k.element_size(), lv.data_ptr(), k.shape[0], t.data_ptr(),
                  key_min, key_max, out.data_ptr(), stream)
    _build.check_launch(lib, "join_probe", code)
    exists_launches += 1
    return out


def exists_probe_plain(table, key_min: int, key_max: int, keys, live) -> torch.Tensor:
    """The plain PyTorch version of ``exists_probe`` (same contract)."""
    _check([table], key_min, key_max, keys, live, 32)
    inr, slot = _in_domain(key_min, key_max, keys, live)
    words = table.to(torch.int64)[slot >> 5]
    return inr & (((words >> (slot & 31)) & 1) != 0)


def payload_probe(tables, key_min: int, key_max: int, keys, live):
    """(matched bool [cap], [int32 [cap] per value table]): the build
    value at each matched probe key's slot, 0 where unmatched (callers
    set validity from ``matched``)."""
    tables = list(tables)
    _check(tables, key_min, key_max, keys, live, 1)
    if len(tables) - 1 > MAX_VALUES:
        raise InternalError(f"payload probe of {len(tables) - 1} value columns; "
                            f"at most {MAX_VALUES}")
    if keys.device.type == "cpu":
        return payload_probe_plain(tables, key_min, key_max, keys, live)
    if keys.device.type != "cuda":
        raise InternalError(f"payload_probe: no kernel for {keys.device}")
    global payload_launches
    k, lv = keys.contiguous(), live.contiguous()
    present, vtabs = tables[0].contiguous(), [t.contiguous() for t in tables[1:]]
    matched = torch.empty(k.shape, dtype=torch.bool, device=k.device)
    outs = [torch.empty(k.shape, dtype=torch.int32, device=k.device) for _ in vtabs]
    lib = _build.load("join_probe")
    fn = lib.payload_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    tptr = (ctypes.c_void_p * MAX_VALUES)(*[t.data_ptr() for t in vtabs])
    optr = (ctypes.c_void_p * MAX_VALUES)(*[o.data_ptr() for o in outs])
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        code = fn(k.data_ptr(), k.element_size(), lv.data_ptr(), k.shape[0],
                  present.data_ptr(), ctypes.addressof(tptr), ctypes.addressof(optr),
                  len(vtabs), key_min, key_max, matched.data_ptr(), stream)
    _build.check_launch(lib, "join_probe", code)
    payload_launches += 1
    return matched, outs


def payload_probe_plain(tables, key_min: int, key_max: int, keys, live):
    """The plain PyTorch version of ``payload_probe`` (same contract)."""
    tables = list(tables)
    _check(tables, key_min, key_max, keys, live, 1)
    inr, slot = _in_domain(key_min, key_max, keys, live)
    hit = inr & (tables[0][slot] != 0)
    zero = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    return hit, [torch.where(hit, t[slot], zero) for t in tables[1:]]
