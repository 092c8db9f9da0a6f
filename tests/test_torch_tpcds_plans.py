"""The port's plans of the 99 TPC-DS queries against the JAX package's
``Session.plan`` at sf 0.01 and SF1 (plans only: no data is
generated): node kinds, every planning decision, the planned join and
aggregation strategies and the runtime join filters' placement
(``test_torch_sql.plan_shape``).

TPC-DS declares no numeric column stats, so the keys stay BIGINT and no
join plans the fused probe kernels; the strategies come from row counts
and unique keys alone.
"""

import pytest

from presto_tpu.connectors.tpcds import TpcdsConnector as JConnector
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpcds import TpcdsConnector as PConnector
from presto_tpu_torch.connectors.tpcds.queries import QUERIES
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.session import Session as PSession
from test_torch_sql import plan_shape
import torch_bridge  # noqa: F401  (pins one intra-op thread)

NAMES = sorted(QUERIES, key=lambda x: int(x[1:]))


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpcds": JConnector(sf=sf)}),
            PSession({"tpcds": PConnector(sf=sf, device="cpu")}, device="cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_analyzer_builds_the_same_plan(plan_sessions, name):
    js, ps = plan_sessions
    want = plan_shape(js.plan(QUERIES[name]), js.catalog, j_join_strategy, j_agg_strategy,
                      j_value_bits)
    got = plan_shape(ps.plan(QUERIES[name]), ps.catalog, p_join_strategy, p_agg_strategy,
                     p_value_bits)
    assert got == want
