"""The port's SSB connector and the SSB queries against the JAX
package's, at sf 0.01:

- bit-identical generated data for every table, across several splits;
  the same narrowed physical dtypes, capacity, live mask, dictionaries,
  column statistics and unique keys, and NULL-free columns sharing
  ``live``;
- every SSB query outside the Q1 flight (which ``test_torch_leaf_route``
  compares): flights Q2, Q3 and Q4 (``q3_3`` onward filter with OR) and
  the LIKE queries ``q_like_part``/``q_like_phone`` run through the
  port's joins, string kernels' plain versions and keyed aggregation and
  equal the JAX package's frames (``q3_4`` is empty at sf 0.01 in both:
  its frame is compared all the same, columns and dtypes included).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

from presto_tpu.connectors.ssb import SsbConnector as JConnector
from presto_tpu.connectors.ssb import schema as JS
from presto_tpu.connectors.ssb.queries import QUERIES
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.ssb import SsbConnector
from presto_tpu_torch.connectors.ssb import schema as PS
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import port_type

SF = 0.01
UNITS = 1 << 14  # several lineorder splits at sf 0.01


@pytest.fixture(scope="module")
def connectors():
    return (SsbConnector(sf=SF, units_per_split=UNITS, device="cpu"),
            JConnector(sf=SF, units_per_split=UNITS))


@pytest.mark.parametrize("table", sorted(PS.TABLES))
def test_generator_is_bit_identical(connectors, table):
    port, ref = connectors
    assert [vars(s) for s in port.splits(table)] == [vars(s) for s in ref.splits(table)]
    for ps, js in zip(port.splits(table), ref.splits(table)):
        got, want = port.scan_numpy(ps), ref.scan_numpy(js)
        assert list(got) == list(want)
        for c in want:
            assert got[c].dtype == want[c].dtype, c
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"{table}.{c}")


@pytest.mark.parametrize("split", [0, 2])
@pytest.mark.parametrize("table", ["lineorder", "date"])
def test_scan_matches_reference(connectors, table, split):
    port, ref = connectors
    ps, js = port.splits(table), ref.splits(table)
    split = min(split, len(js) - 1)
    pb, jb = port.scan(ps[split]), ref.scan(js[split])
    assert pb.capacity == jb.capacity
    np.testing.assert_array_equal(pb.live.numpy(), np.asarray(jb.live))
    assert pb.names == jb.names
    for name in jb.names:
        pc, jc = pb[name], jb[name]
        assert pc.data.numpy().dtype.name == np.asarray(jc.data).dtype.name, name
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data), err_msg=name)
        assert pc.dtype == port_type(jc.dtype), name
        assert (pc.valid is pb.live) == (jc.valid is jb.live), name
        if jc.dictionary is not None:
            assert list(pc.dictionary.values) == list(jc.dictionary.values)


@pytest.mark.parametrize("sf", [0.01, 1])
def test_metadata_matches_reference(sf):
    port, ref = SsbConnector(sf=sf, device="cpu"), JConnector(sf=sf)
    assert port.tables() == ref.tables()
    for t in ref.tables():
        assert port.row_count(t) == ref.row_count(t)
        assert port.unique_keys(t) == ref.unique_keys(t)
        assert {c: port_type(d) for c, d in ref.schema(t).items()} == dict(port.schema(t))
        assert ({c: port_type(d) for c, d in ref.physical_schema(t).items()}
                == port.physical_schema(t))
        for c in ref.schema(t):
            assert dataclasses.asdict(port.stats(t, c)) == dataclasses.asdict(ref.stats(t, c))
        assert ({c: list(d.values) for c, d in port.dictionaries(t).items()}
                == {c: list(d.values) for c, d in ref.dictionaries(t).items()})
    assert PS.DATE_ROWS == JS.DATE_ROWS


RUN = ["q2_1", "q2_2", "q2_3", "q3_1", "q3_2", "q3_3", "q3_4", "q4_1", "q4_2", "q4_3",
       "q_like_part", "q_like_phone"]
#: empty at sf 0.01 in the JAX package too (December 1997 between the two
#: UNITED KINGDOM cities)
EMPTY = {"q3_4"}


def test_every_ssb_query_is_classified():
    assert sorted(RUN + ["q1_1", "q1_2", "q1_3"]) == sorted(QUERIES)


@pytest.fixture(scope="module")
def sessions():
    return (JSession({"ssb": JConnector(sf=SF)}, properties={"result_cache_enabled": False}),
            PSession({"ssb": SsbConnector(sf=SF, device="cpu")}, device="cpu"))


@pytest.mark.parametrize("q", RUN)
def test_query_equals_jax_session(sessions, q):
    js, ps = sessions
    want = js.sql(QUERIES[q])
    got = pd.DataFrame(ps.sql(QUERIES[q]).to_dict())
    assert (len(want) == 0) == (q in EMPTY)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
