"""Helpers for the port's differential tests (``test_torch_*.py``).

Carry types and batches from the JAX package (the reference) to the
PyTorch port as numpy arrays, so both packages see the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

import presto_tpu_torch.types as PT
from presto_tpu_torch.batch import Batch as PBatch
from presto_tpu_torch.batch import Dictionary as PDictionary


def port_type(t) -> PT.DataType:
    """The port's DataType equal to a JAX-package DataType."""
    return PT.DataType(PT.TypeKind(t.kind.value), t.precision, t.scale, t.width, t.phys)


def port_dictionary(d):
    return None if d is None else PDictionary(list(d.values))


def port_batch(jb, device="cpu") -> PBatch:
    """A JAX-package Batch rebuilt in the port through ``Batch.from_arrays``:
    a column whose validity WAS the JAX batch's live array gets the port
    batch's live tensor object."""
    live = np.asarray(jb.live)
    columns, types, dicts = {}, {}, {}
    for name, c in jb.columns.items():
        if c.valid is jb.live:
            valid = live
        elif c.valid is None:
            valid = None
        else:
            valid = np.asarray(c.valid)
        columns[name] = (np.asarray(c.data), valid)
        types[name] = port_type(c.dtype)
        dicts[name] = port_dictionary(c.dictionary)
    return PBatch.from_arrays(columns, live, types, dicts, device=device)


def to_numpy(x) -> np.ndarray:
    """Host copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what: str = "") -> None:
    """Exact equality of values AND dtypes (by numpy name)."""
    g, w = to_numpy(got), to_numpy(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=what)
