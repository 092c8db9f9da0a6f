"""Ordering: the multi-key sort order behind ORDER BY and Top-N.

Counterpart of ``presto_tpu/ops/sort.py``'s ``sort_indices``: a chain
of stable argsorts, least significant key first, so ties keep their
input order exactly as in the JAX package (ORDER BY ... LIMIT results
that tie on every key come out in the same rows). BYTES sort keys are
not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from presto_tpu_torch.ops.groupby import stable_argsort
from presto_tpu_torch.runtime.errors import NotSupported


def _desc_transform(k: torch.Tensor) -> torch.Tensor:
    """Order-reversing transform so one ascending sort handles mixed
    ASC/DESC keys."""
    if k.dtype.is_floating_point:
        return -k
    return ~k.to(torch.int64)  # bitwise-not reverses int order, no overflow


def sort_indices(
    key_cols: Sequence[torch.Tensor],
    descending: Sequence[bool],
    live: torch.Tensor,
    nulls_first: Sequence[bool] | None = None,
    valids: Sequence[torch.Tensor | None] | None = None,
) -> torch.Tensor:
    """Row order: stable multi-key argsort; dead rows sort last.
    Returns order[cap] (original row indices, dead rows at the tail)."""
    if any(k.dim() != 1 for k in key_cols):
        raise NotSupported("sorting on BYTES keys is not ported yet")
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

