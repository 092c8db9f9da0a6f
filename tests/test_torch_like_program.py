"""The LIKE kernel's matching algorithm, proven on the CPU, exactly.

A numpy rendering of what ``csrc/strings.cu``'s matchers do, driven by
the program words the wrapper hands the kernel
(``cuda_strings.like_kernel_program``):

- the Shift-And matchers: the leading segment compared at offset 0, the
  interior segments found one after another by one automaton over the
  row's bytes from the end of the leading segment (``D = ((D << 1) | 1)
  & mask[segment][byte]``; a segment is found when bit ``len - 1`` is
  set, the next one searched from the byte after it; once every one is
  found the automaton finds nothing more), the trailing segment compared
  as the suffix at the logical length (the count of nonzero bytes) at or
  after the running position, and the logical length required of a
  literal;
- the bytes matcher: ``like_program``'s segment program, each interior
  segment at its earliest occurrence, byte by byte.

Each must equal ``like_mask_plain`` (what the kernel is held to on the
card) on ``chip_smoke.like_patterns()`` and ``chip_smoke.like_edge_patterns()``
over widths from 1 to 256, on ``chip_smoke.edge_rows``; the program's
layout and the choice of matcher and instance are checked too.
Tolerance: exact (boolean data).
"""

import os
import sys

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import cuda_strings
from torch_bridge import assert_same

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PATTERNS = chip_smoke.like_patterns() + chip_smoke.like_edge_patterns()
# every width up to 17, then the main path's (22, 55, 79, 101) and the
# edges of the 32- and 64-bit tables and of 128 and 256
WIDTHS = list(range(1, 18)) + [22, 31, 32, 33, 55, 63, 64, 65, 79, 101, 127, 128, 199,
                               255, 256]


def _shift_render(words: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The Shift-And matchers over [n, W] rows."""
    h = words[: cuda_strings.HEADER_WORDS].view(np.int32)
    need_len, every, n_start, n_end, nint = (int(x) for x in h[:5])
    lens = [int(x) for x in h[5: 5 + nint]]
    start_at, end_at, tables_at = (int(x) for x in h[9:12])
    n, width = data.shape
    if every:
        return np.ones(n, bool)
    start = words[start_at:].view(np.uint8)[:n_start]
    end = words[end_at:].view(np.uint8)[:n_end]
    ok = np.ones(n, bool)
    length = (data != 0).sum(axis=1)
    if n_start:
        ok &= n_start <= width and (data[:, :n_start] == start).all(axis=1)
    pos = np.full(n, n_start)
    if nint:
        bits = np.uint32 if max(lens) <= 32 else np.uint64
        masks = words[tables_at:].view(bits)[: nint * 256].reshape(nint, 256)
        high = np.array([bits(1) << bits(x - 1) for x in lens] + [0], dtype=bits)
        state = np.zeros(n, bits)
        seg = np.zeros(n, np.int64)
        for c in range(n_start, width):
            m = masks[np.minimum(seg, nint - 1), data[:, c]]
            state = ((state << bits(1)) | bits(1)) & m
            found = (state & high[seg]) != 0
            pos = np.where(found, c + 1, pos)
            seg = seg + found
            state = np.where(found, bits(0), state)
        ok &= seg == nint
    if n_end:
        s = length - n_end
        fits = ok & (s >= pos) & (n_end <= width)
        idx = np.clip(s[:, None] + np.arange(n_end)[None, :], 0, width - 1)
        same = (np.take_along_axis(data, idx, axis=1) == end).all(axis=1)
        ok &= fits & same
    if need_len >= 0:
        ok &= length == need_len
    return ok


def _bytes_render(words: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The bytes matcher: ``like_program``'s segment program, row by row."""
    prog = words.view(np.int32)
    mode, anchored_start, anchored_end, nseg = (int(x) for x in prog[:4])
    lens = [int(x) for x in prog[4: 4 + nseg]]
    pat = words[4 + nseg:].view(np.uint8)
    segs, off = [], 0
    for n_seg in lens:
        segs.append(pat[off: off + n_seg].tobytes())
        off += n_seg
    out = np.zeros(data.shape[0], bool)
    width = data.shape[1]
    for r, row in enumerate(data):
        b = row.tobytes()
        length = int((row != 0).sum())
        if mode == 1:
            out[r] = True
        elif mode == 0:
            out[r] = length == 0
        elif mode == 2:
            out[r] = len(segs[0]) <= width and b == segs[0] + b"\0" * (width - len(segs[0]))
        else:
            ok, pos = True, 0
            inner = segs[:-1] if anchored_end else segs
            for i, t in enumerate(inner):
                if len(t) > width:
                    ok = False
                elif i == 0 and anchored_start:
                    ok = b[: len(t)] == t
                    pos = len(t)
                else:
                    at = b.find(t, pos)  # the earliest occurrence at or after pos
                    ok = at >= 0
                    pos = at + len(t)
                if not ok:
                    break
            if ok and anchored_end:
                t = segs[-1]
                s = length - len(t)
                ok = len(t) <= width and s >= pos and s >= 0 and b[s: s + len(t)] == t
            out[r] = ok
    return out


def _render(pattern: str, data: np.ndarray) -> np.ndarray:
    matcher, words = cuda_strings.like_kernel_program(pattern)
    return (_bytes_render if matcher == "bytes" else _shift_render)(words, data)


@pytest.mark.parametrize("width", WIDTHS)
def test_rendering_equals_the_plain_version(width):
    data = chip_smoke.edge_rows(width, chip_smoke.small_capacity(width), 3 * width + 1)
    t = torch.from_numpy(data)
    for p in PATTERNS:
        assert_same(_render(p, data), cuda_strings.like_mask_plain(t, p), f"{p!r} W={width}")


def test_edge_rows_hit_the_long_segments():
    """The edge set is not vacuous: its long segments match some rows."""
    hits = {p: 0 for p in chip_smoke.like_edge_patterns()}
    for width in (33, 64, 65, 101, 199, 256):
        t = torch.from_numpy(chip_smoke.edge_rows(width, chip_smoke.small_capacity(width),
                                                  3 * width + 1))
        for p in hits:
            hits[p] += int(cuda_strings.like_mask_plain(t, p).sum())
    missing = [p for p, n in hits.items() if n == 0 and p != "a" * 257 + "%"]
    assert not missing, missing


def test_matcher_choice_and_layout():
    def matcher(p):
        return cuda_strings.like_kernel_program(p)[0]

    s = lambda n: "ab10" * (n // 4) + "ab10"[: n % 4]  # noqa: E731
    assert matcher(f"%{s(32)}%") == matcher(f"%{s(31)}%{s(32)}%") == "shift32"
    assert matcher(f"%{s(33)}%") == matcher(f"%{s(64)}%a%") == "shift64"
    assert matcher(f"%{s(65)}%") == "bytes"
    # anchored segments are compared directly, up to ANCHOR_BYTES
    assert matcher(s(256) + "%" + s(256)) == matcher(s(256)) == "shift32"
    assert matcher(s(257) + "%") == matcher(s(257)) == "bytes"
    assert matcher("%a%b%1%0%") == matcher("a%a%b%1%0%b") == "shift32"
    assert matcher("%a%b%1%0%a%") == "bytes"
    assert matcher("a\0") == "bytes" and matcher("%a\0%") == "shift32"
    for p in ("", "%", "%%"):
        assert matcher(p) == "shift32"
    # the bytes matcher's program is like_program's words and bytes
    prog, pat = cuda_strings.like_program("%a%b%1%0%a%")
    words = cuda_strings.like_kernel_program("%a%b%1%0%a%")[1]
    assert words[: prog.size].view(np.int32).tolist() == prog.tolist()
    assert words[prog.size:].view(np.uint8)[: pat.size].tolist() == pat.tolist()
    # a Shift-And program: header, leading and trailing bytes, tables
    words = cuda_strings.like_kernel_program("Cu%ab%b1%1")[1]
    h = words[: cuda_strings.HEADER_WORDS].view(np.int32)
    assert h[:7].tolist() == [-1, 0, 2, 1, 2, 2, 2]
    assert h[9:12].tolist() == [16, 17, 18]
    assert words[16:17].view(np.uint8)[:2].tobytes() == b"Cu"
    assert words[17:18].view(np.uint8)[:1].tobytes() == b"1"
    tables = words[18:].reshape(2, 256)
    assert tables[0][ord("a")] == 1 and tables[0][ord("b")] == 2
    assert tables[1][ord("b")] == 1 and tables[1][ord("1")] == 2
    assert int(np.count_nonzero(tables)) == 4
    assert cuda_strings.like_kernel_program("ab")[1][:1].view(np.int32)[0] == 2


def test_instance_choice():
    """A 16-byte-aligned base takes the staged instance of the pattern's
    matcher, a view one row and one byte into its buffer (or a width of
    0) the direct one. The plain version does not care."""
    buf = torch.from_numpy(chip_smoke.edge_rows(55, 300, 5))
    flat = buf.reshape(-1)
    view = flat[56: 56 + 200 * 55].view(200, 55)
    for p, m in (("%green%", "shift32"), (f"%{'a' * 40}%", "shift64"), ("%a%b%a%b%a%", "bytes")):
        assert cuda_strings.like_instance(buf, p) == f"staged_{m}"
        assert cuda_strings.like_instance(view, p) == f"direct_{m}"
        assert cuda_strings.like_instance(buf[:, :0].contiguous(), p) == f"direct_{m}"
        assert_same(cuda_strings.like_mask(view, p),
                    cuda_strings.like_mask_plain(view.contiguous(), p), p)
    assert len(cuda_strings.LIKE_INSTANCES) == 6


def test_like_wrapper_counts_no_launch_on_the_cpu():
    data = torch.from_numpy(chip_smoke.edge_rows(22, 100, 1))
    before = (cuda_strings.like_launches, dict(cuda_strings.like_launches_by_instance),
              dict(cuda_strings.like_launches_by_shape))
    for p in PATTERNS:
        assert_same(cuda_strings.like_mask(data, p), cuda_strings.like_mask_plain(data, p), p)
    assert (cuda_strings.like_launches, cuda_strings.like_launches_by_instance,
            cuda_strings.like_launches_by_shape) == before
