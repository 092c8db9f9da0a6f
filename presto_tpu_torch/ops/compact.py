"""Row compaction: mask -> packed row indices.

Counterpart of ``presto_tpu/ops/compact.py``: rows physically move only
at shuffle, build and output boundaries, through one nonzero + gather
with a static output capacity.
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, out_capacity: int):
    """Packed indices of the True positions, padded with ``cap`` (an
    out-of-range sentinel that gathers as the fill value).

    Returns ``(indices[out_capacity], n_selected, overflowed)``:
    ``overflowed`` is a bool scalar, True when more rows were selected
    than ``out_capacity`` (the caller retries at a larger bucket)."""
    cap = mask.shape[0]
    n = torch.sum(mask.to(torch.int32))
    idx = torch.nonzero(mask).reshape(-1)[:out_capacity]
    if idx.shape[0] < out_capacity:
        idx = torch.cat([idx, torch.full((out_capacity - idx.shape[0],), cap,
                                         dtype=idx.dtype, device=idx.device)])
    return idx, n, n > out_capacity


def compact_mask_overflow(mask: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """Just the overflow flag of a planned compaction."""
    return torch.sum(mask.to(torch.int32)) > out_capacity
