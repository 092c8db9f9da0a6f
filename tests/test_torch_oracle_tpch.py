"""The port's numpy TPC-H oracle (``presto_tpu_torch/oracle/tpch_oracle.py``)
against the JAX package's pandas oracle.

Every query's port oracle, over the port connector's ``table_logical``
frames, equals the reference oracle over the reference connector's
``table_pandas`` frames, on the same generated data at the reference
test's scale (sf 0.005, 2^14 units a split), under
``torch_bridge.assert_oracle_equal``: the same column names and row
count, the rows in the reference's order, float64 within 1e-9, every
other column exact. Every reference answer but Q18's rests on rows at
this scale; Q18 is held to the reference on data edited so that it
selects orders.
"""

import numpy as np
import pytest

from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.oracle.tpch_oracle import ORACLES as JORACLES
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.oracle import frame
from presto_tpu_torch.oracle.tpch_oracle import ORACLES
from torch_bridge import LazyTables, assert_oracle_equal, edited_tables, selects_rows

SF = 0.005
UNITS = 1 << 14
#: no order's quantity passes 300 at this scale: no rows
NO_ROWS_HERE = {"q18"}


@pytest.fixture(scope="module")
def tables():
    conn = TpchConnector(sf=SF, units_per_split=UNITS, device="cpu")
    return (LazyTables(JConnector(sf=SF, units_per_split=UNITS)),
            frame.LazyTables(conn.table_logical))


def test_the_port_has_every_reference_oracle():
    assert list(ORACLES) == list(JORACLES) == [f"q{i}" for i in range(1, 23)]


@pytest.mark.parametrize("name", list(JORACLES))
def test_tpch_oracle_matches_reference(tables, name):
    jt, pt = tables
    want = JORACLES[name](jt)
    assert selects_rows(want) == (name not in NO_ROWS_HERE), f"{name}: {len(want)} rows"
    assert_oracle_equal(ORACLES[name](pt), want, name)


def test_q18_on_orders_over_300(tables):
    """Three orders of seven lineitems, each of quantity 50 (350), pass
    Q18's HAVING; one of six (exactly 300) does not."""
    jt, pt = tables
    keys, counts = np.unique(jt["lineitem"].l_orderkey.to_numpy(), return_counts=True)
    big, edge = keys[counts == 7][:3], keys[counts == 6][:1]
    rows = np.flatnonzero(np.isin(jt["lineitem"].l_orderkey.to_numpy(),
                                  np.concatenate([big, edge])))
    jt, pt = edited_tables(tables, [("lineitem", "l_quantity", rows, 50.0)])
    want = JORACLES["q18"](jt)
    assert sorted(want.o_orderkey) == sorted(big) and set(want.l_quantity) == {350.0}
    assert_oracle_equal(ORACLES["q18"](pt), want, "q18")
