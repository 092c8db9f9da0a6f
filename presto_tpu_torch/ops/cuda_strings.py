"""String predicates on byte columns: the LIKE and prefix kernels.

Replaces ``presto_tpu/ops/pallas_strings.py::like_mask_pallas`` (Pallas
body ``_like_kernel``) and ``::starts_with_pallas`` (``_prefix_kernel``)
with ``csrc/strings.cu``. Both take ``[n, W]`` uint8 rows, zero-padded on
the right, and return a ``bool[n]`` over every row (dead rows are not
masked; the evaluator combines validity afterwards).

- ``like_mask``: SQL LIKE with ``%`` wildcards (``_`` raises
  ``NotImplementedError``, as in the JAX package). The pattern becomes a
  small program built once per pattern and device
  (:func:`like_kernel_program`): for the bit-parallel matchers, the
  anchored leading and trailing segments' bytes and one Shift-And table
  of byte masks per interior segment (32-bit masks for segments of up to
  32 bytes, 64-bit up to 64); for any other pattern the segment program
  of :func:`like_program`, which a byte-by-byte matcher of the same
  kernel runs. So one kernel library takes every pattern and width.
- ``starts_with_mask``: the prefix test. The empty prefix is true and a
  prefix longer than W false for every row, without a launch (the JAX
  wrapper's edge cases); otherwise the kernel compares the first L bytes
  as aligned 32-bit words shifted into each row's alignment, the prefix
  laid out by :func:`prefix_kernel_program`: in the launch's parameters
  up to ``PARAM_PREFIX_BYTES`` (instance ``param``), else staged in shared
  memory (``shared``).

Each launches its kernel on a CUDA tensor and computes its plain version
(``ops/strings.py``) on a CPU tensor; ``like_launches`` and
``prefix_launches`` count launches, ``like_launches_by_instance`` and
``like_launches_by_shape`` which LIKE instance ran (:func:`like_instance`)
and at which ``rows x width``, ``prefix_launches_by_instance`` which
prefix instance (:func:`prefix_instance`); ``reset_launches()`` zeroes
them all. What bounds the kernels on the H100 is the bytes they read:
see the header of the CUDA source for the design. The JAX package's compile probe, its
cache and its jnp fallback (``pallas_strings.py:201-243``) work around
its TPU compile helper and have no counterpart: a kernel that fails to
launch raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from presto_tpu_torch.ops import _build
from presto_tpu_torch.ops import strings as plain
from presto_tpu_torch.runtime.errors import InternalError

#: the LIKE kernel's matchers, in csrc/strings.cu's numbering: Shift-And
#: over 32- or 64-bit masks, and byte by byte (any other pattern)
MATCHERS = ("shift32", "shift64", "bytes")
#: the LIKE kernel's instances, in its launch entry's numbering: tiles
#: through the bulk-copy ring (a 16-byte-aligned base; the ragged last
#: tile is read directly in the same launch) or all read directly, each
#: with its matcher
LIKE_INSTANCES = tuple(f"{how}_{m}" for how in ("staged", "direct") for m in MATCHERS)
#: interior segments (neither anchored at the start nor at the end) the
#: Shift-And tables of one pattern hold, and the bytes of an anchored
#: segment it compares directly; a pattern past either takes the bytes
#: matcher
SHIFT_SEGMENTS = 4
ANCHOR_BYTES = 256
#: int32 words of a Shift-And program's header (see like_kernel_program)
HEADER_WORDS = 16
#: the prefix kernel's instances: the prefix's words in the launch's
#: parameters (at most PARAM_PREFIX_BYTES) or staged in shared memory
PREFIX_INSTANCES = ("param", "shared")
PARAM_PREFIX_BYTES = 64

#: kernel launches since the last reset (plain counters, set to 0 by
#: whoever reads them: see :func:`reset_launches`); the LIKE kernel's
#: also by instance and by ``"<rows>x<width>"``
like_launches = 0
prefix_launches = 0
like_launches_by_instance = dict.fromkeys(LIKE_INSTANCES, 0)
like_launches_by_shape: dict[str, int] = {}
prefix_launches_by_instance = dict.fromkeys(PREFIX_INSTANCES, 0)

# program modes of csrc/strings.cu's bytes matcher
_EMPTY, _ALL, _EQUAL, _SEGMENTS = 0, 1, 2, 3


def reset_launches() -> None:
    """Set every launch counter of this module to 0."""
    global like_launches, prefix_launches
    like_launches = prefix_launches = 0
    for k in LIKE_INSTANCES:
        like_launches_by_instance[k] = 0
    like_launches_by_shape.clear()
    for k in PREFIX_INSTANCES:
        prefix_launches_by_instance[k] = 0


def like_mask_plain(data: torch.Tensor, pattern: str) -> torch.Tensor:
    """The plain PyTorch version of ``like_mask`` (same contract)."""
    return plain.like_mask(data, pattern)


def starts_with_mask_plain(data: torch.Tensor, prefix: str) -> torch.Tensor:
    """The plain PyTorch version of ``starts_with_mask`` (same contract)."""
    return plain.starts_with_mask(data, prefix)


def like_program(pattern: str) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's program for ``pattern``: int32 ``[mode,
    anchored_start, anchored_end, nseg, len_0, ...]`` and the segment
    bytes one after another (at least one byte)."""
    segs = pattern.split("%")
    nonempty = [s.encode("latin1") for s in segs if s != ""]
    if not nonempty:
        mode = _EMPTY if pattern == "" else _ALL
    else:
        mode = _EQUAL if len(segs) == 1 else _SEGMENTS
    prog = np.array([mode, segs[0] != "", segs[-1] != "", len(nonempty)]
                    + [len(s) for s in nonempty], dtype=np.int32)
    data = np.frombuffer(b"".join(nonempty) or b"\0", dtype=np.uint8).copy()
    return prog, data


def _words(b: bytes) -> np.ndarray:
    """``b`` zero-padded to whole 4-byte words, as uint32 (little-endian)."""
    return np.frombuffer(b + b"\0" * (-len(b) % 4), dtype="<u4")


def _frozen(a: np.ndarray) -> np.ndarray:
    """``a`` made read-only: the cache hands one array to every caller."""
    a.setflags(write=False)
    return a


def _shift_masks(segments: list, bits: int) -> np.ndarray:
    """One Shift-And table per segment: entry c of segment s has bit j
    set where s[j] == c (uint32 or uint64 [len(segments), 256])."""
    out = np.zeros((len(segments), 256), dtype=np.uint32 if bits == 32 else np.uint64)
    for i, seg in enumerate(segments):
        for j, c in enumerate(seg):
            out[i, c] |= out.dtype.type(1) << out.dtype.type(j)
    return out


@lru_cache(maxsize=256)
def like_kernel_program(pattern: str) -> tuple[str, np.ndarray]:
    """(matcher, program) of the LIKE kernel for ``pattern``: the program
    is uint32 words, which the kernel copies into shared memory.

    The Shift-And matchers (``shift32``, ``shift64``) take a pattern whose
    anchored leading and trailing segments have at most ``ANCHOR_BYTES``
    bytes and whose interior segments are at most ``SHIFT_SEGMENTS`` of at
    most 32 (64) bytes, and a literal without '%' that holds no zero
    byte. Their program: a header of ``HEADER_WORDS`` words

    - 0: the logical length a row must have (mode 2: the literal's; the
      pattern '': 0), or -1 (any);
    - 1: 1 when every row matches (only '%');
    - 2, 3: the bytes of the leading segment (compared at offset 0) and of
      the trailing one (compared as the suffix at the logical length, at
      or after the running position), 0 when the pattern has none;
    - 4: the count of interior segments, each found at its earliest
      occurrence at or after the running position;
    - 5-8: their lengths;
    - 9, 10, 11: the word offsets of the leading bytes, the trailing bytes
      and the tables;

    then those bytes zero-padded to words, then one table of 256 masks
    per interior segment (``_shift_masks``; 64-bit masks as two words,
    low first, at an even word offset). Any other pattern takes the
    ``bytes`` matcher, whose program is :func:`like_program`'s int32
    words followed by its segment bytes. Either way the result is the
    plain ``like_mask``'s."""
    segs = pattern.split("%")
    nonempty = [s.encode("latin1") for s in segs if s != ""]

    def bytes_matcher():
        prog, pat = like_program(pattern)
        return "bytes", _frozen(np.concatenate([prog.view(np.uint32), _words(pat.tobytes())]))

    need_len, every, start, end, interior = -1, 0, b"", b"", []
    if not nonempty:
        if pattern == "":
            need_len = 0
        else:
            every = 1
    elif len(segs) == 1:
        # equal to the literal zero-padded to W: the literal at offset 0
        # and nothing after it (so no zero byte may be part of it)
        start = nonempty[0]
        if b"\0" in start:
            return bytes_matcher()
        need_len = len(start)
    else:
        start = nonempty[0] if segs[0] != "" else b""
        end = nonempty[-1] if segs[-1] != "" else b""
        interior = nonempty[(1 if start else 0): len(nonempty) - (1 if end else 0)]
    widest = max((len(s) for s in interior), default=0)
    if len(interior) > SHIFT_SEGMENTS or widest > 64 or max(len(start), len(end)) > ANCHOR_BYTES:
        return bytes_matcher()
    bits = 32 if widest <= 32 else 64
    start_at = HEADER_WORDS
    end_at = start_at + -(-len(start) // 4)
    tables_at = end_at + -(-len(end) // 4)
    tables_at += tables_at % 2
    head = np.zeros(HEADER_WORDS, dtype=np.int64)
    head[:5] = [need_len, every, len(start), len(end), len(interior)]
    head[5: 5 + len(interior)] = [len(s) for s in interior]
    head[9:12] = [start_at, end_at, tables_at]
    words = [head.astype(np.int32).view(np.uint32), _words(start), _words(end),
             np.zeros(tables_at - end_at - -(-len(end) // 4), np.uint32),
             _shift_masks(interior, bits).reshape(-1).view(np.uint32)]
    return f"shift{bits}", _frozen(np.concatenate(words))


def like_instance(data: torch.Tensor, pattern: str) -> str:
    """Which of ``LIKE_INSTANCES`` the LIKE kernel runs for ``data``
    (contiguous) and ``pattern``: ``staged_*`` when the rows start 16-byte
    aligned and are at least a byte wide, else ``direct_*``; the matcher
    is :func:`like_kernel_program`'s."""
    staged = data.shape[1] > 0 and data.data_ptr() % 16 == 0
    return f"{'staged' if staged else 'direct'}_{like_kernel_program(pattern)[0]}"


@lru_cache(maxsize=256)
def _like_buffer(pattern: str, device: str) -> torch.Tensor:
    """``like_kernel_program(pattern)``'s words on ``device``, copied
    there once."""
    words = like_kernel_program(pattern)[1]
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


@lru_cache(maxsize=256)
def prefix_kernel_program(prefix: str) -> tuple[str, np.ndarray]:
    """(instance, words) of the prefix kernel for a non-empty ``prefix``:
    its bytes as little-endian uint32 words, the last one zero-padded
    (the kernel masks it to the prefix's bytes). Up to
    ``PARAM_PREFIX_BYTES`` the words go into the launch's parameters
    (``param``), past it into shared memory (``shared``)."""
    needle = plain.encode_needle(prefix).tobytes()
    which = "param" if len(needle) <= PARAM_PREFIX_BYTES else "shared"
    return which, _frozen(_words(needle).copy())


def prefix_instance(prefix: str) -> str:
    """Which of ``PREFIX_INSTANCES`` the prefix kernel runs for a
    non-empty ``prefix``, whatever the rows' alignment."""
    return prefix_kernel_program(prefix)[0]


@lru_cache(maxsize=256)
def _prefix_buffer(prefix: str, device: str) -> torch.Tensor:
    """A ``shared`` prefix's words on ``device``, copied there once."""
    return torch.from_numpy(prefix_kernel_program(prefix)[1].view(np.int32).copy()).to(device)


def _check(data: torch.Tensor, what: str) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise InternalError(f"{what}: rows must be uint8 [n, W], got "
                            f"{data.dtype}{tuple(data.shape)}")
    if data.device.type not in ("cpu", "cuda"):
        raise InternalError(f"{what}: no kernel for {data.device}")


@lru_cache(maxsize=None)
def _launchers():
    """The kernel library and its two launch entries, with the ctypes
    signatures set once."""
    lib = _build.load("strings")
    like = lib.like_launch
    like.restype = ctypes.c_int
    like.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    prefix = lib.prefix_launch
    prefix.restype = ctypes.c_int
    prefix.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib, like, prefix


def like_mask(data: torch.Tensor, pattern: str) -> torch.Tensor:
    """SQL LIKE over [n, W] zero-padded byte rows: bool [n]."""
    if "_" in pattern:
        raise NotImplementedError("LIKE '_' wildcard on byte columns")
    _check(data, "like_mask")
    if data.device.type == "cpu":
        return like_mask_plain(data, pattern)
    global like_launches
    n, width = data.shape
    out = torch.empty(n, dtype=torch.bool, device=data.device)
    if n == 0:
        return out
    d = data.contiguous()
    prog = _like_buffer(pattern, str(d.device))
    which = like_instance(d, pattern)
    lib, fn, _ = _launchers()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        code = fn(d.data_ptr(), n, width, prog.data_ptr(), prog.numel(),
                  LIKE_INSTANCES.index(which), out.data_ptr(), stream)
    _build.check_launch(lib, "strings", code)
    like_launches += 1
    like_launches_by_instance[which] += 1
    shape = f"{n}x{width}"
    like_launches_by_shape[shape] = like_launches_by_shape.get(shape, 0) + 1
    return out


def starts_with_mask(data: torch.Tensor, prefix: str) -> torch.Tensor:
    """Rows of [n, W] zero-padded bytes that start with ``prefix``:
    bool [n]."""
    _check(data, "starts_with_mask")
    if data.device.type == "cpu":
        return starts_with_mask_plain(data, prefix)
    n, width = data.shape
    needle = plain.encode_needle(prefix)
    if needle.size == 0:
        return torch.ones(n, dtype=torch.bool, device=data.device)
    if needle.size > width:
        return torch.zeros(n, dtype=torch.bool, device=data.device)
    out = torch.empty(n, dtype=torch.bool, device=data.device)
    if n == 0:
        return out
    global prefix_launches
    d = data.contiguous()
    which, words = prefix_kernel_program(prefix)
    dev = _prefix_buffer(prefix, str(d.device)).data_ptr() if which == "shared" else None
    lib, _, fn = _launchers()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        code = fn(d.data_ptr(), n, width, words.ctypes.data, dev, needle.size,
                  out.data_ptr(), stream)
    _build.check_launch(lib, "strings", code)
    prefix_launches += 1
    prefix_launches_by_instance[which] += 1
    return out
