"""The queries the conditional expression library, DISTINCT and BYTES keys
bring to the port, against the JAX package:

- TPC-H Q7, Q8, Q12, Q14, Q16 and Q19 through both ``Session.sql``s at sf
  0.01: frames exact (values and dtypes; Q8's and Q14's DOUBLE ratios
  too, both packages dividing in float32 the same way) and the route
  counters (``join.strategy.*``, ``agg.strategy.*``, the fused-probe and
  leaf-route counters); Q19 answers NULL there in both (no line passes
  its filters at sf 0.01), so Q19 and its count and revenue by brand are
  also compared at sf 0.1, where every one of its three OR branches
  matches lines;
- their plans and SSB ``q3_3``-``q4_3``'s at sf 0.01 and SF1 (plans
  only: no data is generated), as ``test_torch_sql`` compares them;
- ``chip_smoke.py`` phase 11's numpy oracles against the port at sf
  0.01, and its ``planned_routes`` against the counters the port's run
  bumps, for every statement phase 11 runs on the card.
"""

import os
import sys

import pandas as pd
import pytest

from presto_tpu.connectors.ssb import SsbConnector as JSsb
from presto_tpu.connectors.ssb.queries import QUERIES as SSB
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.ssb import SsbConnector as PSsb
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.session import Session as PSession
from test_torch_sql import plan_shape
from torch_bridge import jax_run, port_run

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TPCH = ["q7", "q8", "q12", "q14", "q16", "q19"]
SSB_QUERIES = ["q3_3", "q3_4", "q4_1", "q4_2", "q4_3"]


@pytest.fixture(scope="module")
def conns():
    return {"tpch": (JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")),
            "ssb": (JSsb(sf=0.01), PSsb(sf=0.01, device="cpu"))}


@pytest.mark.parametrize("q", TPCH)
def test_session_sql_equals_jax_session(conns, q):
    want, want_routes = jax_run(conns["tpch"][0], QUERIES[q])
    res, routes, _ = port_run(conns["tpch"][1], QUERIES[q])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert len(want) > 0


#: Q19 with its revenue and matched lines by brand: one group per OR branch
Q19_BY_BRAND = (QUERIES["q19"].replace(
    "select sum(l_extendedprice * (1 - l_discount)) as revenue",
    "select p_brand, count(*) as n, sum(l_extendedprice * (1 - l_discount)) as revenue")
    .rstrip().rstrip(";") + "\ngroup by p_brand\norder by p_brand")


@pytest.fixture(scope="module")
def q19_conns():
    return JConnector(sf=0.1), PConnector(sf=0.1, device="cpu")


@pytest.mark.parametrize("sql", [QUERIES["q19"], Q19_BY_BRAND], ids=["q19", "q19 by brand"])
def test_q19_equals_jax_session_where_every_branch_matches(q19_conns, sql):
    """At sf 0.1 lines pass each of Q19's three OR branches (the factored
    join key, IN over dictionary ``p_container`` and ``l_shipmode``, the
    revenue sum): frames exact, the revenue not NULL, and the port's
    answer equal to ``chip_smoke.q19_expected`` too."""
    jconn, pconn = q19_conns
    want, want_routes = jax_run(jconn, sql)
    res, routes, _ = port_run(pconn, sql)
    got = pd.DataFrame(res.to_dict())
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes
    assert got["revenue"].notna().all() and (got["revenue"] > 0).all()
    if sql is Q19_BY_BRAND:
        assert list(got["p_brand"]) == ["Brand#12", "Brand#23", "Brand#34"]
    else:
        chip_smoke.same_result(res, chip_smoke.q19_expected(pconn), "q19 at sf 0.1")


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return {"tpch": (JSession({"tpch": JConnector(sf=sf)}),
                     PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu")),
            "ssb": (JSession({"ssb": JSsb(sf=sf)}),
                    PSession({"ssb": PSsb(sf=sf, device="cpu")}, device="cpu"))}


@pytest.mark.parametrize("q", TPCH + [f"ssb {q}" for q in SSB_QUERIES])
def test_analyzer_builds_the_same_plan(plan_sessions, q):
    key, sql = ("ssb", SSB[q[4:]]) if q.startswith("ssb ") else ("tpch", QUERIES[q])
    js, ps = plan_sessions[key]
    want = plan_shape(js.plan(sql), js.catalog, j_join_strategy, j_agg_strategy, j_value_bits)
    got = plan_shape(ps.plan(sql), ps.catalog, p_join_strategy, p_agg_strategy, p_value_bits)
    assert got == want


RUNS = chip_smoke.expression_runs()


@pytest.fixture(scope="module")
def cached(conns):
    """The oracles read through one ``ColumnCache`` per connector, as
    phase 11 reads them."""
    return {key: chip_smoke.ColumnCache(pair[1]) for key, pair in conns.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_chip_oracle_and_planned_routes_equal_the_port(conns, cached, name):
    """What phase 11 holds each statement to on the card, held here at
    sf 0.01: its numpy oracle, and the strategy counters its plan
    predicts (an expansion join counts once per capacity tried: one
    here)."""
    key, sql, oracle = RUNS[name]
    conn = conns[key][1]
    res, routes, session = port_run(conn, sql, key)
    chip_smoke.same_result(res, oracle(cached[key]), name)
    got = {k: v for k, v in routes.items() if k.startswith(("join.strategy.", "agg.strategy."))}
    assert got == chip_smoke.planned_routes(session, sql)
