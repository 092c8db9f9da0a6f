"""Ordering: the multi-key sort order behind ORDER BY and Top-N.

Counterpart of ``presto_tpu/ops/sort.py``'s ``sort_indices``: a chain
of stable argsorts, least significant key first, so ties keep their
input order exactly as in the JAX package (ORDER BY ... LIMIT results
that tie on every key come out in the same rows). A BYTES key sorts as
its big-endian 7-byte int64 chunks (``bytes_sort_chunks``), most
significant first.
"""

from __future__ import annotations

from typing import Sequence

import torch

from presto_tpu_torch.ops.groupby import stable_argsort


def _desc_transform(k: torch.Tensor) -> torch.Tensor:
    """Order-reversing transform so one ascending sort handles mixed
    ASC/DESC keys."""
    if k.dtype.is_floating_point:
        return -k
    return ~k.to(torch.int64)  # bitwise-not reverses int order, no overflow


def bytes_sort_chunks(data: torch.Tensor) -> list[torch.Tensor]:
    """[n, W] bytes -> big-endian int64 chunks of 7 bytes, most
    significant first: comparing the chunk tuples is comparing the bytes
    under PAD SPACE collation (zero padding compares as a space, as in
    the expression comparisons)."""
    data = torch.where(data == 0, torch.full_like(data, 32), data)
    out = []
    for c0 in range(0, data.shape[1], 7):
        chunk = data[:, c0:c0 + 7].to(torch.int64)
        v = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
        for i in range(chunk.shape[1]):
            v = (v << 8) | chunk[:, i]
        out.append(v)
    return out


def _expand_keys(key_cols, descending, nulls_first, valids):
    """Expand 2-D BYTES keys into their int64 chunk keys; a key's NULL
    flag rides its most significant chunk only."""
    ks, ds, nf, vs = [], [], [], []
    for i, k in enumerate(key_cols):
        d = descending[i]
        f = nulls_first[i] if nulls_first else False
        v = valids[i] if valids else None
        parts = bytes_sort_chunks(k) if k.dim() == 2 else [k]
        for j, c in enumerate(parts):
            ks.append(c)
            ds.append(d)
            nf.append(f)
            vs.append(v if j == 0 else None)
    return ks, ds, nf, vs


def sort_indices(
    key_cols: Sequence[torch.Tensor],
    descending: Sequence[bool],
    live: torch.Tensor,
    nulls_first: Sequence[bool] | None = None,
    valids: Sequence[torch.Tensor | None] | None = None,
) -> torch.Tensor:
    """Row order: stable multi-key argsort; dead rows sort last.
    Returns order[cap] (original row indices, dead rows at the tail)."""
    key_cols, descending, nulls_first, valids = _expand_keys(
        list(key_cols), list(descending), nulls_first, valids)
    order = torch.arange(live.shape[0], device=live.device)
    for i in range(len(key_cols) - 1, -1, -1):
        k = key_cols[i]
        kk = _desc_transform(k) if descending[i] else k
        order = order[stable_argsort(kk[order])]
        if valids is not None and valids[i] is not None:
            # null placement is more significant than the key value: a
            # second stable sort on the null flag (False sorts first)
            is_null = ~valids[i]
            nf = bool(nulls_first[i]) if nulls_first else False
            flag = ~is_null if nf else is_null
            order = order[stable_argsort(flag[order])]
    return order[stable_argsort(~live[order])]

