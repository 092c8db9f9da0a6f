"""Window-function primitives over sorted rows.

Counterpart of ``presto_tpu/ops/window.py``: a window computation is a
handful of data-parallel passes over the whole sorted batch at once, no
per-partition loop:

- partition and peer boundaries -> adjacent-difference flags;
- partition starts, peer-group ends -> the reference's cummax of
  flagged positions and reversed cummin, computed by integer counting
  (a running count of the flags numbers each segment; a table the
  flagged rows fill maps the number to a position): exact, and far
  cheaper on the card than ``torch.cummax`` with its indices;
- running aggregates -> a segmented inclusive scan that restarts at each
  reset (log-step passes whose combine keeps the right operand wherever
  a reset lies between them), so a partition's running value never
  holds another partition's rows;
- the RANGE frame's peer semantics -> a gather of the running value at
  each row's last peer.

Plain PyTorch: the JAX package computes these with ``jax.lax`` scans
outside Pallas, so no kernel stands behind them. Every function takes
its device from its inputs.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.runtime.errors import InternalError

_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def change_flags(cols, valids=None) -> torch.Tensor:
    """True where row i differs from row i-1 on any column (row 0 is
    always True). ``valids`` compares null flags as part of the value."""
    if not cols:
        raise InternalError("change_flags needs at least one column")
    n = cols[0].shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    if n == 0:
        return out
    diff = torch.zeros(n - 1, dtype=torch.bool, device=out.device)
    for i, c in enumerate(cols):
        diff = diff | (c[1:] != c[:-1])
        if valids is not None and valids[i] is not None:
            v = valids[i]
            diff = diff | (v[1:] != v[:-1])
    out[0] = True
    out[1:] = diff
    return out


def segment_starts(flags: torch.Tensor) -> torch.Tensor:
    """Per row: index of the most recent True flag at or before it (-1
    before the first). The reference's cummax of flagged positions, as
    integer counting: the running count of flags numbers each segment,
    and a table filled by the flagged rows maps that number to its
    start."""
    n = flags.shape[0]
    pos = torch.arange(n, device=flags.device)
    seg = torch.cumsum(flags.to(torch.int64), dim=0)
    table = torch.empty(n + 1, dtype=torch.int64, device=flags.device)
    table.scatter_(0, torch.where(flags, seg, torch.zeros_like(seg)), pos)
    table[0] = -1  # the rows before any flag (unflagged rows wrote here too)
    return table[seg]


def segment_ends(next_flags: torch.Tensor) -> torch.Tensor:
    """Per row i: the smallest j >= i that is the LAST row of i's
    segment, i.e. j == n-1 or ``next_flags[j+1]`` is True. The
    reference's reversed cummin, as integer counting: row i's end is the
    segment end numbered by the ends strictly before it."""
    n = next_flags.shape[0]
    pos = torch.arange(n, device=next_flags.device)
    is_end = torch.cat([next_flags[1:], torch.ones(1, dtype=torch.bool, device=pos.device)])
    ends = torch.cumsum(is_end.to(torch.int64), dim=0)
    table = torch.empty(n + 1, dtype=torch.int64, device=pos.device)
    table.scatter_(0, torch.where(is_end, ends - 1, torch.full_like(ends, n)), pos)
    return table[ends - is_end.to(torch.int64)]


def seg_scan(vals: torch.Tensor, reset: torch.Tensor, kind: str) -> torch.Tensor:
    """Inclusive segmented scan that restarts wherever ``reset`` is True.
    kind: 'sum' | 'min' | 'max'.

    Log-step (Hillis-Steele) passes over the reference's combine
    ``(a, b) -> (b if b.reset else op(a, b), a.reset | b.reset)``: after
    pass k each row holds the combine of the 2^k rows ending at it, so a
    value reaches a row only from inside its own segment."""
    op = _OPS.get(kind)
    if op is None:
        raise InternalError(f"unknown scan kind {kind!r}")
    v, f = vals, reset
    n = vals.shape[0]
    d = 1
    while d < n:
        nv = op(v[:-d], v[d:])
        nv = torch.where(f[d:], v[d:], nv)
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d *= 2
    return v


def scan_identity(kind: str, dtype: torch.dtype):
    """The identity of ``kind`` for ``dtype``, as a Python number."""
    if kind == "min":
        return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max
    if kind == "max":
        return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
    return 0


def rank_values(part_change: torch.Tensor, peer_change: torch.Tensor):
    """(row_number, rank, dense_rank), all int64, over sorted rows."""
    n = part_change.shape[0]
    pos = torch.arange(n, device=part_change.device)
    pstart = segment_starts(part_change)
    fpeer = segment_starts(peer_change)
    row_number = pos - pstart + 1
    rank = fpeer - pstart + 1
    cpeer = torch.cumsum(peer_change.to(torch.int64), dim=0)
    dense = cpeer - cpeer[pstart] + 1
    return row_number.to(torch.int64), rank.to(torch.int64), dense.to(torch.int64)


def windowed_agg(vals, contrib, part_change, peer_change, kind: str, frame: str):
    """One windowed aggregate over sorted rows.

    frame: 'rows'  -> the running value at this row (ROWS UNBOUNDED
                      PRECEDING .. CURRENT ROW);
           'range' -> the running value at the last peer (the SQL default
                      RANGE frame: peers share the frame end);
           'full'  -> the value at the partition end (whole partition).
    Returns (value, count), count being the contributing rows in the
    frame (count == 0 -> NULL)."""
    ident = torch.full_like(vals, scan_identity(kind, vals.dtype))
    masked = torch.where(contrib, vals, ident)
    running = seg_scan(masked, part_change, kind)
    counts = seg_scan(contrib.to(torch.int64), part_change, "sum")
    if frame == "rows":
        return running, counts
    boundary = part_change if frame == "full" else peer_change
    last = segment_ends(boundary)
    return running[last], counts[last]
