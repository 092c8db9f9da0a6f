"""TPC-DS q26-q50 through the port's ``Session.sql`` on the CPU against the
reference's pandas oracle (``presto_tpu/oracle/tpcds_oracle.py``), at the
reference test's settings (sf 0.02, 2^15 units a split), compared by
``tests/test_tpch_sql.compare``: the contract of the reference's own
``test_tpcds_query_matches_oracle``. The 99 queries are split over four
files by number, so ``--dist loadfile`` spreads them over the workers;
each file decodes only the tables its queries' oracles read.
"""

import pytest

from torch_bridge import check_tpcds_query, one_thread, tpcds_oracle_env, tpcds_params


@pytest.fixture(scope="module")
def env():
    with one_thread():
        yield tpcds_oracle_env()


@pytest.mark.parametrize("name", tpcds_params(26, 50))
def test_tpcds_query_matches_oracle(env, name):
    check_tpcds_query(env, name)
