"""The port's data model against the JAX package's: narrow storage
choice, the narrow range guard, and the validity-shares-live identity
through ``Batch.from_arrays`` and device moves. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.types as JT
import presto_tpu_torch.types as PT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.spi import batch_capacity, narrowed_schema
from torch_bridge import port_batch, port_type

TYPES = {
    "integer": (JT.INTEGER, PT.INTEGER),
    "bigint": (JT.BIGINT, PT.BIGINT),
    "decimal": (JT.decimal(12, 2), PT.decimal(12, 2)),
    "date": (JT.DATE, PT.DATE),
    "timestamp": (JT.TIMESTAMP, PT.TIMESTAMP),
    "varchar": (JT.varchar(), PT.varchar()),
    "double": (JT.DOUBLE, PT.DOUBLE),
    "boolean": (JT.BOOLEAN, PT.BOOLEAN),
}
INTERVALS = [(0, 0), (0, 126), (-127, 127), (-128, 0), (0, 127), (0, 128),
             (-32767, 32767), (0, 32768), (-(2**31) + 1, 2**31 - 1), (0, 2**31),
             (-(2**40), 2**40), (0, 2**63 - 1), (5, 3), (8035, 10591),
             (90000, 10_495_000)]


@pytest.mark.parametrize("name", sorted(TYPES))
def test_narrow_physical_matches_reference(name):
    jt, pt = TYPES[name]
    assert port_type(jt) == pt
    for lo, hi in INTERVALS:
        want = JT.narrow_physical(jt, lo, hi)
        got = PT.narrow_physical(pt, lo, hi)
        assert got == port_type(want), (name, lo, hi, got, want)
        assert got.np_dtype == want.np_dtype
        assert got.torch_dtype == PT.torch_dtype_of(want.np_dtype)


@pytest.mark.parametrize("np_dtype,bad", [(np.int8, 200), (np.int16, -40000),
                                          (np.int32, 2**31)])
def test_from_numpy_raises_on_out_of_range_narrow_value(np_dtype, bad):
    jt = JT.BIGINT.with_physical(np_dtype)
    pt = PT.BIGINT.with_physical(np_dtype)
    arr = np.array([1, 2, bad], dtype=np.int64)
    with pytest.raises(ValueError, match="narrowed physical storage"):
        JBatch.from_numpy({"x": arr}, {"x": jt})
    with pytest.raises(ValueError, match="narrowed physical storage"):
        Batch.from_numpy({"x": arr}, {"x": pt}, device="cpu")
    ok = Batch.from_numpy({"x": arr[:2]}, {"x": pt}, capacity=8, device="cpu")
    assert ok["x"].data.dtype == PT.torch_dtype_of(np_dtype)
    assert ok.capacity == 8 and int(ok.count()) == 2


def test_from_numpy_matches_reference_layout():
    arrays = {"a": np.arange(5, dtype=np.int64), "b": np.array([3, 1, 4, 1, 5])}
    valids = {"b": np.array([True, False, True, True, False])}
    jtypes = {"a": JT.BIGINT.with_physical(np.int8), "b": JT.INTEGER}
    ptypes = {k: port_type(t) for k, t in jtypes.items()}
    jb = JBatch.from_numpy(arrays, jtypes, valids=valids, capacity=8)
    pb = Batch.from_numpy(arrays, ptypes, valids=valids, capacity=8, device="cpu")
    for n in arrays:
        assert pb[n].data.numpy().dtype == np.asarray(jb[n].data).dtype
        np.testing.assert_array_equal(pb[n].data.numpy(), np.asarray(jb[n].data))
        np.testing.assert_array_equal(pb[n].valid.numpy(), np.asarray(jb[n].valid))
    np.testing.assert_array_equal(pb.live.numpy(), np.asarray(jb.live))
    assert pb["a"].valid is pb.live and jb["a"].valid is jb.live
    assert pb["b"].valid is not pb.live


def _jax_batch():
    live = jnp.asarray(np.array([1, 1, 1, 0], np.bool_))
    cols = {
        "shared": JColumn(jnp.asarray(np.arange(4, dtype=np.int16)), live,
                          JT.BIGINT.with_physical(np.int16)),
        "own": JColumn(jnp.asarray(np.arange(4, dtype=np.int32)),
                       jnp.asarray(np.array([1, 0, 1, 0], np.bool_)), JT.INTEGER),
        "none": JColumn(jnp.asarray(np.arange(4, dtype=np.int8)), None,
                        JT.INTEGER.with_physical(np.int8)),
    }
    return JBatch(cols, live)


def test_from_arrays_keeps_live_identity():
    jb = _jax_batch()
    pb = port_batch(jb)
    assert pb["shared"].valid is pb.live
    assert pb["own"].valid is not pb.live
    assert pb["none"].valid is None
    for n, c in jb.columns.items():
        assert pb[n].data.numpy().dtype == np.asarray(c.data).dtype
        np.testing.assert_array_equal(pb[n].data.numpy(), np.asarray(c.data))
    np.testing.assert_array_equal(pb["own"].valid.numpy(), np.asarray(jb["own"].valid))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_device_move_keeps_live_identity(device):
    pb = port_batch(_jax_batch())
    moved = pb.to(device)
    assert moved.device.type == device
    assert moved["shared"].valid is moved.live
    assert moved["own"].valid is not moved.live
    assert moved["none"].valid is None
    assert moved["own"].valid.device.type == device


def test_resolve_device_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Batch.from_numpy({"x": np.arange(3)}, {"x": PT.BIGINT})
    assert resolve_device("cpu") == torch.device("cpu")


def test_spi_helpers_match_reference():
    from presto_tpu.connectors.tpch import schema as JS
    from presto_tpu.spi import batch_capacity as j_capacity
    from presto_tpu.spi import narrowed_schema as j_narrowed
    from presto_tpu_torch.connectors.tpch import schema as PS

    for n in (0, 1, 1023, 1024, 1025, 917504, 6_000_000):
        assert batch_capacity(n) == j_capacity(n)
    for table in ("lineitem", "orders"):
        want = j_narrowed(JS.TABLES[table], lambda c: JS.column_stats(table, c, 1.0),
                          JS.table_dicts(table))
        got = narrowed_schema(PS.TABLES[table], lambda c: PS.column_stats(table, c, 1.0),
                              PS.table_dicts(table))
        assert got == {k: port_type(v) for k, v in want.items()}


def test_column_and_batch_structure():
    live = torch.tensor([True, False, True])
    c = Column(torch.arange(3, dtype=torch.int16), live, PT.INTEGER.with_physical(np.int16))
    b = Batch({"c": c}, live)
    assert b.capacity == 3 and b.names == ("c",) and "c" in b
    assert int(b.count()) == 2
    assert b.select(["c"])["c"] is c
    assert b.with_live(~live).live is not live
