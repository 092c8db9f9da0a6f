"""TPC-DS queries through both packages' ``Session.sql`` at sf 0.01:
frames (rows in order, dtypes; DOUBLE columns within rtol 1e-3, atol
0.02: ``test_torch_window_sql.same_frame``) and route counters (``torch_bridge.ROUTES``: the join and
aggregation strategies, the fused routes and the runtime join filters'
rows) equal.

The reference's engine takes seconds a query on the CPU (q38 about 20
s) and some queries run for minutes (q10 over six), so this file takes
the reference's distributed list that answers in seconds (q3, q7, q28,
q33, q36, q38, q76, q97, q98) and five star joins (q42, q43, q52, q55,
q96). The other queries are held to the reference's pandas oracle
(``test_torch_tpcds_sql_*.py``) and their plans to its ``Session.plan``
(``test_torch_tpcds_plans.py``). Every reference run happens once, in
the module fixture ``ref``.
"""

import pandas as pd
import pytest

from presto_tpu.connectors.tpcds import TpcdsConnector as JConnector
from presto_tpu_torch.connectors.tpcds import TpcdsConnector as PConnector
from presto_tpu_torch.connectors.tpcds.queries import QUERIES
from test_torch_window_sql import same_frame
from torch_bridge import jax_run, port_frame, port_run

SF = 0.01
NAMES = ["q3", "q7", "q28", "q33", "q36", "q38", "q42", "q43", "q52", "q55", "q76", "q96",
         "q97", "q98"]


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture(scope="module")
def ref(conns):
    out = {}
    for name in NAMES:
        try:
            out[name] = jax_run(conns[0], QUERIES[name], key="tpcds")
        except Exception as e:  # noqa: BLE001 -- the test reports it
            out[name] = e
    return out


@pytest.mark.parametrize("name", NAMES)
def test_query_equals_jax_session(conns, ref, name):
    want = ref[name]
    assert not isinstance(want, Exception), f"the JAX package raised {want!r}"
    want, want_routes = want
    res, routes, _ = port_run(conns[1], QUERIES[name], key="tpcds")
    assert len(want) > 0
    same_frame(port_frame(res), want,
               [c for c in want.columns if pd.api.types.is_float_dtype(want[c])])
    assert routes == want_routes
