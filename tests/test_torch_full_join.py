"""FULL OUTER and RIGHT joins in the port against the JAX package:

- the reference's FULL OUTER operator tests (``tests/test_joins.py``),
  mirrored on the port's operators and run through both packages on the
  same batches: unique and expansion builds, never-matched build rows
  emitted by the tail, matched flags accumulated over several probe
  batches, and the tail of a probe stream that yields no batch (the
  probe schema built from the plan);
- RIGHT joins equal to the LEFT join with the operands swapped, and a
  FULL join against a pandas oracle, through both ``Session.sql``s;
- every ``chip_smoke`` phase-13 statement through both ``Session.sql``s
  at sf 0.01 (frames, dtypes, route and filter counters), the plans of
  the FULL and RIGHT ones at sf 0.01 and SF1, and phase 13's numpy
  oracles, planned strategy counters and filter counts against the port.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from presto_tpu.batch import Batch as JBatch
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.exec.local_planner import LocalExecutor as JExecutor
from presto_tpu.exec.pipeline import BatchSource, Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import LocalExecutor as PExecutor
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline
from presto_tpu_torch.expr import col as pcol
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.metrics import REGISTRY as PREGISTRY
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.types import BIGINT
from test_torch_sql import plan_shape
from torch_bridge import counters, jax_run, mark_counters, port_batch, port_run, to_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# ---------------------------------------------------------------------------
# the operators, on the reference's FULL OUTER test batches
# ---------------------------------------------------------------------------


def _jbatch(arrays, cap):
    return JBatch.from_numpy(arrays, {k: JBIGINT for k in arrays}, capacity=cap)


def build_batch():
    return _jbatch({"bk": np.array([1, 3, 5, 7], np.int64),
                    "bval": np.array([10, 30, 50, 70], np.int64)}, 8)


def probe_batch():
    return _jbatch({"pk": np.array([5, 2, 3, 7, 9, 1], np.int64),
                    "pval": np.array([100, 200, 300, 400, 500, 600], np.int64)}, 8)


def _records(batches):
    recs = []
    for out in batches:
        live = to_numpy(out.live)
        cols = {n: (to_numpy(out[n].data), to_numpy(out[n].valid)) for n in out.names}
        for i in np.flatnonzero(live):
            recs.append({n: (None if not v[i] else int(d[i])) for n, (d, v) in cols.items()})
    return recs


def _run_full(pkg, unique: bool, probe_batches):
    """A FULL OUTER probe pass over ``probe_batches`` (JAX batches) in one
    package: every probe output, then the tail."""
    if pkg == "j":
        b = JJ.JoinBuildOperator(jcol("bk", JBIGINT))
        JPipeline(BatchSource([build_batch()]), [b]).run()
        outs = [JJ.BuildOutput("bval", "bval"), JJ.BuildOutput("bk", "bk")]
        j = JJ.LookupJoinOperator(b, jcol("pk", JBIGINT), outs, "full", unique=unique,
                                  out_capacity=None if unique else 32)
        init, tail = JJ.full_init_flags, JJ.full_tail
    else:
        b = PJ.JoinBuildOperator(pcol("bk", BIGINT))
        Pipeline(BatchStream.of([port_batch(build_batch())]), [b]).run()
        outs = [PJ.BuildOutput("bval", "bval"), PJ.BuildOutput("bk", "bk")]
        j = PJ.LookupJoinOperator(b, pcol("pk", BIGINT), outs, "full", unique=unique,
                                  out_capacity=None if unique else 32)
        init, tail = PJ.full_init_flags, PJ.full_tail
        probe_batches = [port_batch(pb) for pb in probe_batches]
    flags = init(b)
    rows = []
    for pb in probe_batches:
        out, flags = j.process_full(pb, flags)
        rows.append(out)
    rows.append(tail(b, outs, flags, probe_batches[-1]))
    return _records(rows)


@pytest.mark.parametrize("unique", [True, False])
def test_full_outer_join(unique):
    """Probe keys [5,2,3,7,9,1], build keys [1,3,5,7]: every build row
    matches, so the tail is empty."""
    recs = _run_full("p", unique, [probe_batch()])
    got = sorted((r["pk"], r["bk"], r["bval"]) for r in recs)
    assert got == [(1, 1, 10), (2, None, None), (3, 3, 30), (5, 5, 50), (7, 7, 70),
                   (9, None, None)]
    assert recs == _run_full("j", unique, [probe_batch()])


@pytest.mark.parametrize("unique", [True, False])
def test_full_outer_join_unmatched_build(unique):
    pb = _jbatch({"pk": np.array([3, 8], np.int64), "pval": np.array([300, 800], np.int64)}, 4)
    recs = _run_full("p", unique, [pb])
    got = sorted(((r["pk"] or -1), (r["bk"] or -1), (r["bval"] or -1)) for r in recs)
    assert got == [(-1, 1, 10), (-1, 5, 50), (-1, 7, 70), (3, 3, 30), (8, -1, -1)]
    assert recs == _run_full("j", unique, [pb])


@pytest.mark.parametrize("unique", [True, False])
def test_full_outer_multi_probe_batches_accumulate_flags(unique):
    pb1 = _jbatch({"pk": np.array([1, 3], np.int64), "pval": np.array([1, 3], np.int64)}, 4)
    pb2 = _jbatch({"pk": np.array([5, 4], np.int64), "pval": np.array([5, 4], np.int64)}, 4)
    recs = _run_full("p", unique, [pb1, pb2])
    tails = [r for r in recs if r["pk"] is None]
    assert [(r["bk"], r["bval"]) for r in tails] == [(7, 70)]
    assert recs == _run_full("j", unique, [pb1, pb2])


def test_full_join_counts_no_strategy():
    """A FULL probe counts no ``join.strategy.*``, as in the reference."""
    mark_counters()
    _run_full("p", True, [probe_batch()])
    _run_full("p", False, [probe_batch()])
    assert not any(k.startswith("join.strategy.") for k in counters())


def test_tail_of_an_empty_probe_stream():
    """A FULL join whose probe side yields no batch: every build row is
    emitted, with all-NULL probe columns built from the plan's fields
    (a BYTES column at its width)."""
    sql = ("select c_custkey, c_name, o_orderkey, o_clerk from orders full join customer "
           "on c_custkey = o_custkey")
    jconn, pconn = JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")
    js, ps = JSession({"tpch": jconn}), PSession({"tpch": pconn}, device="cpu")
    jplan, pplan = js.plan(sql), ps.plan(sql)

    def find(n):
        if type(n).__name__ == "Join":
            return n
        return next(x for x in map(find, n.children) if x is not None) if n.children else None

    jnode, pnode = find(jplan.child), find(pplan.child)
    jx = JExecutor(js.catalog, join_build_budget=1 << 40)
    px = PExecutor(ps.catalog, device="cpu")
    out = {}
    for pkg, x, node in (("j", jx, jnode), ("p", px, pnode)):
        right = x._exec(node.right, {}).materialize()
        mod = JJ if pkg == "j" else PJ
        keys = x._join_key_exprs(node.left_keys, node.right_keys, None, right, {}, node.left,
                                 node.right) if pkg == "j" else x._join_keys(node, None, right, {})
        build = mod.JoinBuildOperator(keys[1])
        if pkg == "j":
            JPipeline(BatchSource(right), [build]).run()
            empty = __import__("presto_tpu.exec.pipeline", fromlist=["x"]).BatchStream.of([])
        else:
            Pipeline(BatchStream.of(right), [build]).run()
            empty = BatchStream.of([])
        outs = [mod.BuildOutput(n, n) for n in node.output_right]
        out[pkg] = list(x._exec_full_join(node, empty, build, keys[0], outs, right, keys[2]))
    assert len(out["p"]) == len(out["j"]) == 1
    jt, pt = out["j"][0], out["p"][0]
    assert list(pt.names) == list(jt.names)
    assert int(pt.live.sum()) == int(jt.live.sum()) == 1500
    for name in jt.names:
        assert tuple(pt[name].data.shape[1:]) == tuple(jt[name].data.shape[1:]), name
        pv = to_numpy(pt[name].valid) & to_numpy(pt.live)
        jv = to_numpy(jt[name].valid) & to_numpy(jt.live)
        np.testing.assert_array_equal(pv, jv, err_msg=name)
    assert not (to_numpy(pt["o_orderkey"].valid) & to_numpy(pt.live)).any()
    assert pt["o_clerk"].data.shape[1] == 15


# ---------------------------------------------------------------------------
# SQL at sf 0.01
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


def test_right_join_sql_matches_left_swapped(conns):
    right = ("select n_name, r_name from region right join nation "
             "on r_regionkey = n_nationkey order by n_name")
    left = ("select n_name, r_name from nation left join region "
            "on r_regionkey = n_nationkey order by n_name")
    got, routes, _ = port_run(conns[1], right)
    same, _, _ = port_run(conns[1], left)
    want, want_routes = jax_run(conns[0], right)
    pd.testing.assert_frame_equal(pd.DataFrame(got.to_dict()), pd.DataFrame(same.to_dict()))
    pd.testing.assert_frame_equal(pd.DataFrame(got.to_dict()), want, check_exact=True)
    assert routes == want_routes


def test_full_outer_sql_vs_pandas_oracle(conns):
    sql = ("select r_regionkey, n_nationkey from region full outer join nation "
           "on r_regionkey = n_nationkey order by n_nationkey")
    res, routes, _ = port_run(conns[1], sql)
    got = pd.DataFrame(res.to_dict())
    want, want_routes = jax_run(conns[0], sql)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes
    c = conns[1]
    r = pd.DataFrame({"r_regionkey": c.table_numpy("region", ["r_regionkey"])["r_regionkey"]})
    n = pd.DataFrame({"n_nationkey": c.table_numpy("nation", ["n_nationkey"])["n_nationkey"]})
    oracle = r.merge(n, left_on="r_regionkey", right_on="n_nationkey",
                     how="outer").sort_values("n_nationkey")
    assert len(got) == len(oracle)
    np.testing.assert_array_equal(got["n_nationkey"].to_numpy(dtype=float),
                                  oracle["n_nationkey"].to_numpy(dtype=float))
    np.testing.assert_array_equal(got["r_regionkey"].isna().to_numpy(),
                                  oracle["r_regionkey"].isna().to_numpy())


OUTER_STATEMENTS = {
    # a WHERE over the NULL-extended side of a RIGHT join stays after it
    "right, where on the null side": (
        "select count(*) as n from orders right join customer on c_custkey = o_custkey "
        "where o_orderkey is null"),
    # and over FULL joins' both sides
    "full, where on both sides": (
        "select count(*) as n, count(o_orderkey) as no from customer full join orders "
        "on c_custkey = o_custkey where c_nationkey < 10 or o_totalprice > 100000"),
    "full with a build-side ON residual": (
        "select count(*) as n, count(o_orderkey) as no, count(c_custkey) as nc from customer "
        "full join orders on c_custkey = o_custkey and o_orderstatus = 'F'"),
    "full over a BYTES column": (
        "select c_name, o_orderkey from orders full join customer on c_custkey = o_custkey "
        "where c_custkey < 20 order by c_name, o_orderkey"),
}


@pytest.mark.parametrize("name", list(OUTER_STATEMENTS))
def test_outer_statements_equal_reference(conns, name):
    want, want_routes = jax_run(conns[0], OUTER_STATEMENTS[name])
    res, routes, _ = port_run(conns[1], OUTER_STATEMENTS[name])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes


PHASE13 = chip_smoke.join_feature_runs()


@pytest.mark.parametrize("name", list(PHASE13))
def test_phase13_statements_equal_reference(conns, name):
    sql, props, _fn = PHASE13[name]
    before = JSession({"tpch": conns[0]}, properties={"result_cache_enabled": False, **props})
    from presto_tpu.runtime.metrics import REGISTRY

    from torch_bridge import ROUTES

    snap = REGISTRY.snapshot()
    want = before.sql(sql)
    after = REGISTRY.snapshot()
    want_routes = {k: int(after.get(k, 0) - snap.get(k, 0)) for k in after
                   if k.startswith(ROUTES) and after.get(k, 0) - snap.get(k, 0)}
    mark_counters()
    res = PSession({"tpch": conns[1]}, properties=props, device="cpu").sql(sql)
    routes = {k: v for k, v in counters().items() if k.startswith(ROUTES) and v}
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes


#: phase-13 statements whose plan at sf 0.01 predicts a route the
#: executor does not take, in both packages: Q10's customer join plans
#: the payload kernel, whose value tables cannot carry its BYTES
#: columns, and runs dense
PLAN_DIFFERS_AT_SF001 = {"q10"}


@pytest.mark.resets_global_state
@pytest.mark.parametrize("name", list(PHASE13))
def test_phase13_oracles_equal_the_port(conns, name):
    """``chip_smoke``'s numpy oracle, planned strategy counters and
    filter counts (range and Bloom bits in numpy) against the port."""
    sql, props, fn = PHASE13[name]
    session = PSession({"tpch": conns[1]}, properties=props, device="cpu")
    predicted = chip_smoke.planned_routes(session, sql)
    want_filters = chip_smoke.expected_filter_counts(
        conns[1], name, chip_smoke.plan_filter_bits(session, sql))
    PREGISTRY.reset()  # a filter count of 0 is compared: count from an empty registry
    mark_counters()
    res = session.sql(sql)
    chip_smoke.same_result(res, fn(conns[1]), name)
    got = {k: v for k, v in counters().items()
           if k.startswith(("join.strategy.", "agg.strategy.")) and v}
    if name not in PLAN_DIFFERS_AT_SF001:
        assert got == predicted
    assert {k: v for k, v in counters().items() if k.startswith("join.filter_rows_")} \
        == want_filters


@pytest.mark.resets_global_state
@pytest.mark.parametrize("name", chip_smoke.FILTER_COUNT_ONLY)
def test_phase13_filter_counts_of_q9_and_q21(conns, name):
    from presto_tpu_torch.connectors.tpch.queries import QUERIES

    session = PSession({"tpch": conns[1]}, device="cpu")
    want = chip_smoke.expected_filter_counts(
        conns[1], name, chip_smoke.plan_filter_bits(session, QUERIES[name]))
    PREGISTRY.reset()  # the pruned count, 0, is compared: count from an empty registry
    mark_counters()
    session.sql(QUERIES[name])
    got = {k: v for k, v in counters().items() if k.startswith("join.filter_rows_")}
    assert got == want and want["join.filter_rows_pruned"] == 0


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


@pytest.mark.parametrize("name", ["full", "full_swapped", "right_q13", "right_nation",
                                  "cross_dict", "wide_bytes", "mix"])
def test_phase13_plans_equal_reference(plan_sessions, name):
    js, ps = plan_sessions
    sql = PHASE13[name][0]
    want = plan_shape(js.plan(sql), js.catalog, j_join_strategy, j_agg_strategy, j_value_bits)
    got = plan_shape(ps.plan(sql), ps.catalog, p_join_strategy, p_agg_strategy, p_value_bits)
    assert got == want
