"""The port's numpy TPC-DS oracle (``presto_tpu_torch/oracle/tpcds_oracle.py``)
against the JAX package's pandas oracle: q1-q50, on the same generated
data at the reference test's scale (``torch_bridge.TPCDS_SF`` /
``TPCDS_UNITS``), under ``torch_bridge.assert_oracle_equal`` (a column
the reference rounds may differ by one unit of its last place:
``TPCDS_ROUNDED``). The 99 queries are split over two files by number,
so ``--dist loadfile`` spreads them over the workers.
"""

import pytest

from torch_bridge import check_tpcds_oracle, tpcds_oracle_tables


@pytest.fixture(scope="module")
def tables():
    return tpcds_oracle_tables()


@pytest.mark.parametrize("name", [f"q{i}" for i in range(1, 50 + 1)])
def test_tpcds_oracle_matches_reference(tables, name):
    check_tpcds_oracle(tables, name)


def test_the_port_has_every_reference_oracle():
    from presto_tpu.oracle.tpcds_oracle import ORACLES as JORACLES
    from presto_tpu_torch.oracle.tpcds_oracle import ORACLES

    assert list(ORACLES) == list(JORACLES) and len(ORACLES) == 99
