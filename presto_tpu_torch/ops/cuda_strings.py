"""String predicates on byte columns: the LIKE and prefix kernels.

Replaces ``presto_tpu/ops/pallas_strings.py::like_mask_pallas`` (Pallas
body ``_like_kernel``) and ``::starts_with_pallas`` (``_prefix_kernel``)
with ``csrc/strings.cu``. Both take ``[n, W]`` uint8 rows, zero-padded on
the right, and return a ``bool[n]`` over every row (dead rows are not
masked; the evaluator combines validity afterwards).

- ``like_mask``: SQL LIKE with ``%`` wildcards (``_`` raises
  ``NotImplementedError``, as in the JAX package). The pattern becomes a
  small device program (mode, anchor flags, segment lengths and bytes),
  built once per pattern and device, so one kernel takes every pattern
  and width.
- ``starts_with_mask``: the prefix test. The empty prefix is true and a
  prefix longer than W false for every row, without a launch (the JAX
  wrapper's edge cases); otherwise the kernel compares the first L bytes.

Each launches its kernel on a CUDA tensor and computes its plain version
(``ops/strings.py``) on a CPU tensor; ``like_launches`` and
``prefix_launches`` count launches. What bounds the kernels on the H100 is
the bytes they read: see the header of the CUDA source for the design.
The JAX package's compile probe, its cache and its jnp fallback
(``pallas_strings.py:201-243``) work around its TPU compile helper and
have no counterpart: a kernel that fails to launch raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from presto_tpu_torch.ops import _build
from presto_tpu_torch.ops import strings as plain
from presto_tpu_torch.runtime.errors import InternalError

#: kernel launches since the last reset (plain counters, set to 0 by
#: whoever reads them)
like_launches = 0
prefix_launches = 0

# program modes of csrc/strings.cu
_EMPTY, _ALL, _EQUAL, _SEGMENTS = 0, 1, 2, 3


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


@lru_cache(maxsize=256)
def _like_buffers(pattern: str, device: str):
    """``like_program(pattern)`` on ``device``, copied there once."""
    return tuple(torch.from_numpy(a).to(device) for a in like_program(pattern))


@lru_cache(maxsize=256)
def _prefix_buffer(prefix: str, device: str) -> torch.Tensor:
    return torch.from_numpy(plain.encode_needle(prefix).copy()).to(device)


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
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    prefix = lib.prefix_launch
    prefix.restype = ctypes.c_int
    prefix.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
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
    prog, pat = _like_buffers(pattern, str(d.device))
    lib, fn, _ = _launchers()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        code = fn(d.data_ptr(), n, width, prog.data_ptr(), pat.data_ptr(), out.data_ptr(),
                  stream)
    _build.check_launch(lib, "strings", code)
    like_launches += 1
    return out


def starts_with_mask(data: torch.Tensor, prefix: str) -> torch.Tensor:
    """Rows of [n, W] zero-padded bytes that start with ``prefix``:
    bool [n]."""
    _check(data, "starts_with_mask")
    if data.device.type == "cpu":
        return starts_with_mask_plain(data, prefix)
    global prefix_launches
    n, width = data.shape
    needle = plain.encode_needle(prefix)
    if needle.size == 0:
        return torch.ones(n, dtype=torch.bool, device=data.device)
    if needle.size > width:
        return torch.zeros(n, dtype=torch.bool, device=data.device)
    out = torch.empty(n, dtype=torch.bool, device=data.device)
    if n == 0:
        return out
    d = data.contiguous()
    pre = _prefix_buffer(prefix, str(d.device))
    lib, _, fn = _launchers()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        code = fn(d.data_ptr(), n, width, pre.data_ptr(), needle.size, out.data_ptr(), stream)
    _build.check_launch(lib, "strings", code)
    prefix_launches += 1
    return out
