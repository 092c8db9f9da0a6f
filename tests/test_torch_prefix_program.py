"""The prefix kernel's algorithm, proven on the CPU, exactly.

A numpy rendering of what ``csrc/strings.cu``'s ``prefix_kernel`` does,
driven by the words the wrapper hands the kernel
(``cuda_strings.prefix_kernel_program``): for row ``i`` the byte offset
``s = head + i * W`` from the base rounded down to 4 bytes; the aligned
32-bit words ``s >> 2 .. (s >> 2) + ceil(L / 4) - 1`` and the next one
only when the window ``[s, s + L)`` reaches into it; each row word a
funnel shift of two loaded words by ``8 * (s & 3)`` bits, XORed with the
prefix word, the last masked to the prefix's bytes in it, the
differences ORed; the row matches when nothing differs.

The rendering must equal ``starts_with_mask_plain`` (what the kernel is
held to on the card) over widths from 1 to 256 and every prefix length
from 1 to W (64, 65 and W bytes among them: the two instances' edge), on
rows with embedded zero bytes, at bases 0-3 bytes past an aligned word
(views into a buffer); and every word it reads must hold a byte of the
rows, the kernel's memory-safety rule. The wrapper's edge cases (the
empty prefix, a prefix longer than W, no rows) and its instance choice
are checked on CPU tensors. Tolerance: exact (boolean data).
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import cuda_strings
import torch_bridge  # noqa: F401  (pins one intra-op thread)

# every width up to 17, then the main path's (22, 55, 79) and the edges of
# the parameter words (16 words: 63-65 bytes), of 128 and of 256
WIDTHS = list(range(1, 18)) + [22, 31, 32, 33, 55, 63, 64, 65, 79, 101, 127, 128, 199,
                               255, 256]
ROWS = 37  # a ragged count: the grid's last pass is partial


def _tail_mask(length: int) -> int:
    r = length & 3
    return (1 << (8 * r)) - 1 if r else 0xFFFFFFFF


def render(buf: np.ndarray, head: int, n: int, width: int, prefix: str):
    """The kernel over ``n`` rows of ``width`` bytes at byte ``head`` of
    ``buf`` (whose byte 0 is 4-byte aligned): (the booleans, the word
    indices it read)."""
    _, words = cuda_strings.prefix_kernel_program(prefix)
    length = len(prefix.encode("latin1"))
    nw = -(-length // 4)
    mem = np.zeros(-(-buf.size // 4) + 1, dtype="<u4")
    mem.view(np.uint8)[: buf.size] = buf
    s = head + np.arange(n, dtype=np.int64) * width
    w0, off = s >> 2, s & 3
    idx = w0[:, None] + np.arange(nw + 1)[None, :]
    used = np.ones((n, nw + 1), dtype=bool)
    used[:, nw] = off + length > 4 * nw
    w = np.where(used, mem[np.where(used, idx, 0)], 0).astype(np.uint64)
    diff = np.zeros(n, dtype=np.uint64)
    for k in range(nw):
        row = ((w[:, k] | (w[:, k + 1] << np.uint64(32))) >> (8 * off).astype(np.uint64)) \
            & np.uint64(0xFFFFFFFF)
        x = row ^ np.uint64(words[k])
        if k == nw - 1:
            x &= np.uint64(_tail_mask(length))
        diff |= x
    return diff == 0, idx[used]


def rows_with_prefixes(width: int, head: int, seed: int):
    """A buffer with ``ROWS`` rows of ``width`` bytes at byte ``head``:
    bytes over 'ab', zeros inside and after them, and for each prefix
    length L a prefix taken from the first L bytes of one of the first 4
    rows (which stay as they are), written over the start of some of the
    other rows (so long prefixes hit as well as miss)."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.frombuffer(b"ab", np.uint8), size=(ROWS, width))
    rows[rng.random((ROWS, width)) < 0.1] = 0  # embedded zeros
    lens = rng.integers(0, width + 1, ROWS)
    rows[np.arange(width)[None, :] >= lens[:, None]] = 0
    prefixes = []
    for length in range(1, width + 1):
        src = rows[int(rng.integers(0, 4))]
        p = bytes(src[:length]).decode("latin1")
        prefixes.append(p)
        for r in 4 + np.flatnonzero(rng.random(ROWS - 4) < 0.25):
            if r % 5 == length % 5:
                rows[r, :length] = src[:length]
    buf = np.full(head + ROWS * width + 3, 0xEE, dtype=np.uint8)  # bytes around the rows
    buf[head: head + ROWS * width] = rows.reshape(-1)
    return buf, rows, prefixes


@pytest.mark.parametrize("width", WIDTHS)
def test_rendering_equals_the_plain_version(width):
    hits = 0
    for head in range(4):
        buf, rows, prefixes = rows_with_prefixes(width, head, width * 4 + head)
        data = torch.from_numpy(rows)
        lo, hi = head >> 2, (head + ROWS * width - 1) >> 2
        for p in prefixes:
            got, read = render(buf, head, ROWS, width, p)
            want = cuda_strings.starts_with_mask_plain(data, p).numpy()
            assert np.array_equal(got, want), (width, head, len(p))
            assert read.min() >= lo and read.max() <= hi, (width, head, len(p))
            hits += int(want.sum())
    assert hits > 4 * width  # each prefix matched at least its source row


def test_long_prefixes_hit_and_miss():
    """At the widest rows the prefixes of 64, 65 and 256 bytes each match
    some rows and miss others, on both instances."""
    buf, rows, prefixes = rows_with_prefixes(256, 3, 99)
    for length in (64, 65, 256):
        got, _ = render(buf, 3, ROWS, 256, prefixes[length - 1])
        assert 0 < int(got.sum()) < ROWS, length


def test_program_layout_and_instance():
    for p in ("a", "ab", "abc", "abcd", "forest", "b" * 64, "b" * 65, "x\0y" * 30):
        which, words = cuda_strings.prefix_kernel_program(p)
        raw = p.encode("latin1")
        assert words.dtype == np.uint32 and words.size == -(-len(raw) // 4)
        assert words.view(np.uint8).tobytes() == raw + b"\0" * (-len(raw) % 4)
        assert which == ("param" if len(raw) <= cuda_strings.PARAM_PREFIX_BYTES else "shared")
        assert cuda_strings.prefix_instance(p) == which
    assert cuda_strings.PREFIX_INSTANCES == ("param", "shared")


def _view(rows: np.ndarray, head: int) -> torch.Tensor:
    n, w = rows.shape
    buf = torch.zeros(n * w + head + 4, dtype=torch.uint8)
    view = buf[head: head + n * w].view(n, w)
    view.copy_(torch.from_numpy(rows))
    return view


@pytest.mark.parametrize("head", [0, 1, 2, 3])
def test_wrapper_edge_cases_on_cpu_tensors(head):
    """Views 0-3 bytes into their buffer; the empty prefix matches every
    row, a prefix longer than W none, no rows give an empty result; no
    launch is counted on the CPU."""
    _, rows, prefixes = rows_with_prefixes(9, 0, 7)
    data = _view(rows, head)
    cuda_strings.reset_launches()
    for p in prefixes:
        got = cuda_strings.starts_with_mask(data, p)
        want = torch.tensor([bytes(r[: len(p)]) == p.encode("latin1") for r in rows])
        assert torch.equal(got, want), p
    assert torch.equal(cuda_strings.starts_with_mask(data, ""), torch.ones(ROWS, dtype=torch.bool))
    assert torch.equal(cuda_strings.starts_with_mask(data, "a" * 10),
                       torch.zeros(ROWS, dtype=torch.bool))
    empty = cuda_strings.starts_with_mask(data[:0], "ab")
    assert empty.dtype == torch.bool and empty.shape == (0,)
    assert cuda_strings.prefix_launches == 0
    assert sum(cuda_strings.prefix_launches_by_instance.values()) == 0
