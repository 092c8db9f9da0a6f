"""The port's TPC-H connector against the JAX package's, at sf 0.01:
bit-identical generated data, the same narrowed physical dtypes (by
name), capacity and live mask, and NULL-free columns sharing ``live``."""

import numpy as np
import pytest

from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.connectors.tpch import schema as PS
from torch_bridge import port_type

SF = 0.01
UNITS = 1 << 12  # 4 order-ranges at sf 0.01, so several splits are compared


@pytest.fixture(scope="module")
def connectors():
    return (TpchConnector(sf=SF, units_per_split=UNITS, device="cpu"),
            JConnector(sf=SF, units_per_split=UNITS))


@pytest.mark.parametrize("table", ["lineitem", "orders"])
@pytest.mark.parametrize("split", [0, 1, 3])
def test_scan_matches_reference(connectors, table, split):
    port, ref = connectors
    ps, js = port.splits(table), ref.splits(table)
    assert ps == [type(ps[0])(*vars(s).values()) for s in js]
    pb, jb = port.scan(ps[split]), ref.scan(js[split])
    assert pb.capacity == jb.capacity
    np.testing.assert_array_equal(pb.live.numpy(), np.asarray(jb.live))
    assert pb.names == jb.names
    for name in jb.names:
        pc, jc = pb[name], jb[name]
        want = np.asarray(jc.data)
        got = pc.data.numpy()
        assert got.dtype.name == want.dtype.name, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert pc.dtype == port_type(jc.dtype), name
        assert (pc.valid is pb.live) == (jc.valid is jb.live), name
        if jc.dictionary is not None:
            assert list(pc.dictionary.values) == list(jc.dictionary.values)


@pytest.mark.parametrize("table", sorted(PS.TABLES))
def test_generator_is_bit_identical(connectors, table):
    port, ref = connectors
    split = ref.splits(table)[0]
    got = port.scan_numpy(port.splits(table)[0])
    want = ref.scan_numpy(split)
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=f"{table}.{c}")


def test_physical_schema_matches_reference(connectors):
    port, ref = connectors
    for table in ("lineitem", "orders", "part"):
        want = ref.physical_schema(table)
        assert port.physical_schema(table) == {k: port_type(v) for k, v in want.items()}


def test_row_counts_and_stats_match_reference(connectors):
    port, ref = connectors
    for table in PS.TABLES:
        assert port.row_count(table) == ref.row_count(table)
        for c in PS.TABLES[table]:
            p, j = port.stats(table, c), ref.stats(table, c)
            assert (p.ndv, p.min_value, p.max_value) == (j.ndv, j.min_value, j.max_value)
