"""Helpers for the port's differential tests (``test_torch_*.py``).

Carry types and batches from the JAX package (the reference) to the
PyTorch port as numpy arrays, so both packages see the same inputs; run
one statement through each package's ``Session.sql`` with the route
counters it bumps (``jax_run``, ``port_run``).
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


def port_frame(res):
    """The port's ``QueryResult`` as the JAX package's ``Session.sql``
    builds its frame: one frame per result batch, concatenated (pandas
    infers each batch's column dtypes apart, so a UNION branch with NULL
    keys makes its column ``object`` there)."""
    import pandas as pd

    parts = {name: res.parts(name) for name in res.names}
    n = len(parts[res.names[0]]) if res.names else 0
    frames = [pd.DataFrame({name: p[i] for name, p in parts.items()}) for i in range(n)]
    if not frames:
        return pd.DataFrame(columns=res.names)
    return pd.concat(frames, ignore_index=True)[list(res.names)]


#: the route counters the SQL differential tests compare; the runtime
#: join filters' scanned and pruned row counts among them
ROUTES = ("join.strategy.", "exec.pallas_join_route", "join.pallas_fallback", "agg.strategy.",
          "exec.leaf_", "exec.q1_", "join.filter_rows_")


def jax_run(conn, sql, key="tpch"):
    """(frame, route counters) of ``sql`` through the JAX package's
    ``Session.sql`` over ``conn`` alone (result cache off)."""
    from presto_tpu.runtime.metrics import REGISTRY
    from presto_tpu.runtime.session import Session as JSession

    before = REGISTRY.snapshot()
    df = JSession({key: conn}, properties={"result_cache_enabled": False}).sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after.get(k, 0) - before.get(k, 0) for k in after if k.startswith(ROUTES)}
    return df, {k: int(v) for k, v in routes.items() if v}


def port_run(conn, sql, key="tpch"):
    """(QueryResult, route counters, session) of ``sql`` through the
    port's ``Session.sql`` over ``conn`` alone, on the CPU."""
    from presto_tpu_torch.runtime.metrics import COUNTERS
    from presto_tpu_torch.runtime.session import Session as PSession

    COUNTERS.clear()
    session = PSession({key: conn}, device="cpu")
    res = session.sql(sql)
    return res, {k: v for k, v in COUNTERS.items() if k.startswith(ROUTES) and v}, session
