"""The port's fused leaf route (``exec/leaf_route``, ``exec/q1_route``)
against the JAX package's, through both ``Session.sql``s on the CPU.

- the matcher: ``match_leaf_fragment`` builds the same route — the same
  ``LeafAggSpec`` (columns, filters, keys, groups, values with their
  bits, guards), the same membership fold and outputs, or the same Q1
  specialization — and the same miss reason, for every aggregate of TPC-H
  Q1, Q3, Q6 and Q10 and the SSB Q1 flight, at sf 0.01 and at SF1 stats;
- end to end at sf 0.01: Q1, Q6 and SSB Q1.1-1.3 give the JAX package's
  values and dtypes (Q1's DOUBLE averages bit-identical too), the same
  route counters, and the same rows with ``narrow_storage`` off (the
  generic operators, ``GlobalAggregationOperator`` for the keyless ones);
- fallbacks: lying stats on a value column and on the membership key
  fall back (counted) with correct rows; an empty membership build gives
  one NULL row; inadmissible fragments count their reason;
- ``chip_smoke.py``'s numpy recomputations equal the port here, so the
  card compares against a checked oracle.
``narrow_storage`` mirrors the process-wide ``PRESTO_TPU_NARROW`` switch
(in both packages): every test restores it.
"""

import dataclasses
import os
import sys

import pandas as pd
import pytest

from presto_tpu.connectors.ssb import SsbConnector as JSsb
from presto_tpu.connectors.ssb.queries import QUERIES as SSB
from presto_tpu.connectors.tpch import TpchConnector as JTpch
from presto_tpu.connectors.tpch.queries import QUERIES as TPCH
from presto_tpu.exec import leaf_route as JLR
from presto_tpu.plan import nodes as JN
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.ssb import SsbConnector as PSsb
from presto_tpu_torch.connectors.tpch import TpchConnector as PTpch
from presto_tpu_torch.exec import leaf_route as PLR
from presto_tpu_torch.ops import cuda_agg, cuda_q1
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import counters, mark_counters, port_type

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SF = 0.01
ROUTED = {"q1": TPCH["q1"], "q6": TPCH["q6"], "ssb_q1_1": SSB["q1_1"],
          "ssb_q1_2": SSB["q1_2"], "ssb_q1_3": SSB["q1_3"]}
_ROUTE_PREFIXES = ("exec.leaf_", "exec.q1_", "agg.strategy.")


@pytest.fixture(autouse=True)
def narrow_env():
    before = os.environ.get("PRESTO_TPU_NARROW")
    yield
    if before is None:
        os.environ.pop("PRESTO_TPU_NARROW", None)
    else:
        os.environ["PRESTO_TPU_NARROW"] = before


@pytest.fixture(scope="module")
def conns():
    return (JTpch(sf=SF), JSsb(sf=SF), PTpch(sf=SF, device="cpu"), PSsb(sf=SF, device="cpu"))


def jsession(conns, **props):
    return JSession({"tpch": conns[0], "ssb": conns[1]},
                    properties={"result_cache_enabled": False, **props})


def psession(conns, **props):
    return PSession({"tpch": conns[2], "ssb": conns[3]}, properties=props, device="cpu")


def jrun(session, sql):
    """The JAX package's frame and its route-counter deltas."""
    before = REGISTRY.snapshot()
    df = session.sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after[k] - before.get(k, 0) for k in after if k.startswith(_ROUTE_PREFIXES)}
    return df, {k: int(v) for k, v in routes.items() if v}


def prun(session, sql):
    """The port's result as a frame and its route counters."""
    mark_counters()
    res = session.sql(sql)
    routes = {k: v for k, v in counters().items() if k.startswith(_ROUTE_PREFIXES) and v}
    return pd.DataFrame(res.to_dict()), routes


@pytest.fixture(scope="module")
def jax_results(conns):
    """Each routed query through the JAX package, in a fresh session."""
    return {name: jrun(jsession(conns), sql) for name, sql in ROUTED.items()}


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------


def _shape(x):
    """A package-independent structure of a route value."""
    if hasattr(x, "kind") and hasattr(x, "phys"):  # a DataType
        return ("type", str(port_type(x)) if x.__module__.startswith("presto_tpu.") else str(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if type(x).__name__ == "Membership":
            return ("Membership", _shape(x.build_key), x.probe_col, x.lo, x.hi)
        return (type(x).__name__,) + tuple((f.name, _shape(getattr(x, f.name)))
                                           for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_shape(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _shape(v)) for k, v in x.items()))
    return x


def route_shape(route):
    if route is None:
        return None
    if route.kind == "q1":
        q = route.q1
        return ("q1", _shape(q.rename), _shape(q.outputs), q.key_names, _shape(q.key_dtypes))
    return ("generic", _shape(route.spec), tuple(route.src_cols), _shape(route.rename),
            _shape(route.outputs), _shape(route.key_out), _shape(route.member))


def aggregates(node, cls):
    out = [node] if isinstance(node, cls) else []
    for c in node.children:
        out += aggregates(c, cls)
    return out


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    """Sessions over connectors at sf 0.01 and SF1 (plans only: the
    matcher reads stats and dictionaries, no data is generated)."""
    sf = request.param
    return (JSession({"tpch": JTpch(sf=sf), "ssb": JSsb(sf=sf)}),
            PSession({"tpch": PTpch(sf=sf, device="cpu"), "ssb": PSsb(sf=sf, device="cpu")},
                     device="cpu"))


@pytest.mark.parametrize("q", sorted(ROUTED) + ["q3", "q10"])
def test_matcher_builds_the_same_route(plan_sessions, q):
    js, ps = plan_sessions
    sql = ROUTED.get(q) or TPCH[q]
    jaggs = aggregates(js.plan(sql), JN.Aggregate)
    paggs = aggregates(ps.plan(sql), PN.Aggregate)
    assert len(jaggs) == len(paggs) >= 1
    for ja, pa in zip(jaggs, paggs):
        jroute, jreason = JLR.match_leaf_fragment(ja, js.catalog)
        proute, preason = PLR.match_leaf_fragment(pa, ps.catalog)
        assert preason == jreason
        assert route_shape(proute) == route_shape(jroute)
        assert (proute is not None) == (q in ROUTED)
        if proute is not None:
            assert proute.kind == ("q1" if q == "q1" else "generic")
            assert (proute.member is not None) == q.startswith("ssb")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_session_sql_equals_jax_session(conns, jax_results, name):
    want, want_routes = jax_results[name]
    got, routes = prun(psession(conns), ROUTED[name])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes
    assert routes["exec.leaf_fused_route"] == 1 and routes["agg.strategy.fused"] == 1


@pytest.mark.parametrize("name", sorted(ROUTED))
def test_narrow_storage_off_gives_the_same_rows(conns, jax_results, name):
    """The generic operators (no route): the same rows as the routed run
    and the same counters as the JAX package's generic run."""
    _want_on, want_off_routes = jrun(jsession(conns, narrow_storage=False), ROUTED[name])
    got, routes = prun(psession(conns, narrow_storage=False), ROUTED[name])
    pd.testing.assert_frame_equal(got, jax_results[name][0], check_exact=True)
    assert routes == want_off_routes
    assert "exec.leaf_fused_route" not in routes
    if name != "q1":
        assert routes["agg.strategy.single"] == 1


@pytest.mark.parametrize("name", ["q1", "q6"])
def test_route_runs_one_step_per_split(name):
    """Several splits: the route folds one fused step per split (the Q1
    step or the leaf step) and equals the generic operators; on the CPU
    the wrappers compute their plain versions and launch nothing."""
    conn = PTpch(sf=SF, units_per_split=1 << 12, device="cpu")
    splits = len(conn.splits("lineitem"))
    assert splits > 1
    calls = []
    step = PLR.agg_step

    def spy(spec, batch):
        calls.append(batch.capacity)
        return step(spec, batch)

    launches = (cuda_q1.launches, cuda_agg.launches)
    PLR.agg_step = spy
    try:
        got, routes = prun(PSession({"tpch": conn}, device="cpu"), ROUTED[name])
    finally:
        PLR.agg_step = step
    assert routes["exec.leaf_fused_route"] == 1
    assert len(calls) == (0 if name == "q1" else splits)
    assert (cuda_q1.launches, cuda_agg.launches) == launches
    want, off_routes = prun(PSession({"tpch": conn}, properties={"narrow_storage": False},
                                     device="cpu"), ROUTED[name])
    assert "exec.leaf_fused_route" not in off_routes
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_explain_renders_the_fused_strategy(conns):
    ps = psession(conns)
    for sql in ROUTED.values():
        assert "agg_strategy=fused" in ps.explain(sql)
    q = "select o_orderdate, count(*) c from orders group by o_orderdate"
    assert "agg_strategy=partial" in ps.explain(q)


# ---------------------------------------------------------------------------
# fallbacks
# ---------------------------------------------------------------------------


def _lie(session, table, column, **fields):
    real = session.catalog.stats

    def lying(connector, t, c):
        st = real(connector, t, c)
        return dataclasses.replace(st, **fields) if (t, c) == (table, column) else st

    session.catalog.stats = lying


@pytest.mark.parametrize("name,table,column,fields", [
    ("q6", "lineitem", "l_extendedprice", {"max_value": 1.0}),
    ("ssb_q1_1", "lineorder", "lo_orderdate", {"max_value": 19930601}),
])
def test_lying_stats_fall_back_with_correct_rows(conns, jax_results, name, table, column,
                                                 fields):
    """Declared bounds tighter than the data: the step's guard (a value
    column) or the membership's domain check (the probe key) trips, the
    route falls back to the generic operators, counted, and the rows are
    right — as in the JAX package."""
    js, ps = jsession(conns), psession(conns)
    _lie(js, table, column, **fields)
    _lie(ps, table, column, **fields)
    want, want_routes = jrun(js, ROUTED[name])
    got, routes = prun(ps, ROUTED[name])
    assert routes == want_routes
    assert routes["exec.leaf_route_fallback"] == 1
    assert routes["exec.leaf_route_fallback.value_overflow"] == 1
    assert "exec.leaf_fused_route" not in routes
    pd.testing.assert_frame_equal(got, jax_results[name][0], check_exact=True)
    pd.testing.assert_frame_equal(want, jax_results[name][0], check_exact=True)


def test_empty_membership_build_gives_one_null_row(conns):
    q = SSB["q1_1"].replace("1993", "2099")
    want, want_routes = jrun(jsession(conns), q)
    got, routes = prun(psession(conns), q)
    assert routes == want_routes and routes["exec.leaf_fused_route"] == 1
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert len(got) == 1 and got["revenue"].isna().all()
    off, _ = prun(psession(conns, narrow_storage=False), q)
    pd.testing.assert_frame_equal(off, want, check_exact=True)


@pytest.mark.parametrize("sql,reason", [
    ("select sum(l_quantity / 2) from lineitem where l_quantity < 10", "value_shape"),
    ("select sum(l_quantity) from lineitem where l_linenumber + l_linenumber < 4",
     "filter_shape"),
])
def test_inadmissible_fragment_counts_its_reason(conns, sql, reason):
    _df, want_routes = jrun(jsession(conns), sql)
    _got, routes = prun(psession(conns), sql)
    assert routes == want_routes
    assert routes[f"exec.leaf_route_fallback.{reason}"] == 1


@pytest.mark.parametrize("sql", [
    "select sum(l_quantity) s from lineitem where l_orderkey < 5000000000",
    "select sum(l_quantity) s from lineitem where l_orderkey > 5000000000",
    "select l_linestatus, sum(l_quantity) s, min(l_discount) mn, max(l_tax) mx, count(*) c "
    "from lineitem where l_shipdate between date '1995-01-01' and date '1995-12-31' "
    "group by l_linestatus order by l_linestatus",
    "select min(l_extendedprice) mn, max(l_quantity * (1 - l_discount)) mx, "
    "avg(l_quantity) aq, count(l_orderkey) c from lineitem where l_discount >= 0.1",
])
def test_more_routed_statements_equal_jax_session(conns, sql):
    """Clamped out-of-int32 literals (always-true and unsatisfiable),
    a keyed fragment, keyless min/max/avg: routed as in the JAX package,
    with its rows, and the same rows through the generic operators."""
    want, want_routes = jrun(jsession(conns), sql)
    got, routes = prun(psession(conns), sql)
    assert routes == want_routes and routes["exec.leaf_fused_route"] == 1
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    off, off_routes = prun(psession(conns, narrow_storage=False), sql)
    assert "exec.leaf_fused_route" not in off_routes
    pd.testing.assert_frame_equal(off, want, check_exact=True)


def test_spec_beyond_the_kernel_limits_falls_back(conns):
    """ROADMAP C9 (deliberate divergence): a matched fragment with more
    values than one leaf kernel launch takes (33 sums) falls back to the
    generic operators, counted as ``kernel_limits``, where the JAX
    package routes it. The matcher says so, so the planned strategy
    (EXPLAIN's ``agg_strategy``) is the executed one. The rows are the
    JAX package's."""
    sums = ", ".join(f"sum(l_quantity + {k}) s{k}" for k in range(cuda_agg.MAX_VALUES + 1))
    sql = f"select {sums} from lineitem where l_discount < 0.05"
    want, want_routes = jrun(jsession(conns), sql)
    got, routes = prun(psession(conns), sql)
    assert want_routes["exec.leaf_fused_route"] == 1
    assert routes == {"exec.leaf_route_fallback": 1,
                      "exec.leaf_route_fallback.kernel_limits": 1, "agg.strategy.single": 1}
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    ps = psession(conns)
    (agg,) = aggregates(ps.plan(sql), PN.Aggregate)
    assert PLR.match_leaf_fragment(agg, ps.catalog) == (None, "kernel_limits")
    assert PLR.agg_strategy_for(agg, ps.catalog) == "single"


def test_global_aggregation_over_zero_rows(conns):
    """GlobalAggregationOperator (routing off): one row, NULL sum/min and
    a 0 count over an empty input, as in the JAX package."""
    sql = ("select sum(l_quantity) s, count(*) c, min(l_tax) m, count(l_discount) cd "
           "from lineitem where l_quantity > 100")
    want, want_routes = jrun(jsession(conns, narrow_storage=False), sql)
    got, routes = prun(psession(conns, narrow_storage=False), sql)
    assert routes == want_routes == {"agg.strategy.single": 1}
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert len(got) == 1 and got["c"].iloc[0] == 0


# ---------------------------------------------------------------------------
# the card's oracle
# ---------------------------------------------------------------------------


def test_chip_oracles_equal_the_port(conns):
    ps = psession(conns)
    res = ps.sql(TPCH["q1"])
    chip_smoke.same_result(res, chip_smoke.q1_sql_expected(conns[2]), "q1")
    li = conns[2].table_numpy("lineitem", chip_smoke.Q6_COLS)
    want = chip_smoke.revenue(li["l_extendedprice"], li["l_discount"], chip_smoke.q6_mask(li))
    chip_smoke.same_result(ps.sql(TPCH["q6"]), want, "q6")
    for q, w in chip_smoke.ssb_expected(conns[3]).items():
        chip_smoke.same_result(ps.sql(SSB[q]), w, q)
        assert w["revenue"][0] > 0
