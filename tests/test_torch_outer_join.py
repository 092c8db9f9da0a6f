"""Expansion joins and LEFT OUTER joins in the port against the JAX package.

- the JAX package's own join tests, mirrored on the port's operators
  (``tests/test_joins.py::test_left_outer_unique``,
  ``::test_expansion_join_with_duplicates``, ``::test_expansion_overflow_raises``,
  ``tests/test_ops.py::test_join_expand_vs_pandas`` and
  ``::test_join_expand_overflow``), each also run through both packages
  on the same batches;
- ``ops/join.probe_expand`` against ``presto_tpu.ops.join.probe_expand``
  on seeded numpy inputs: inner and left, ``emit_live`` with NULL keys,
  an all-dead batch, and the exact-capacity and overflow edges (every
  output array and the two scalars);
- TPC-H Q13 (a LEFT expansion join whose ON residual filters the build)
  and Q5 (an inner expansion join) through both ``Session.sql``s at sf
  0.01: frames, dtypes and ``join.strategy.*`` counters; their plans at
  sf 0.01 and SF1; and ``chip_smoke``'s numpy recomputations (the card's
  oracles) against the port;
- ``count(col)`` and other aggregates over null-extended rows, LEFT joins
  whose ON residual filters the build, WHERE filters over the
  null-extended side, a unique LEFT join, RIGHT and FULL joins (Q15's
  among them) equal to the reference, and Q17's ``<>`` correlation
  refused by both.

Exact comparisons throughout (integer and decimal data).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from presto_tpu.batch import Batch as JBatch
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec.joins import BuildOutput as JBuildOutput
from presto_tpu.exec.joins import JoinBuildOperator as JBuild
from presto_tpu.exec.joins import LookupJoinOperator as JLookup
from presto_tpu.exec.pipeline import BatchSource, Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.ops import join as jjoin
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec.joins import BuildOutput, JoinBuildOperator, LookupJoinOperator
from presto_tpu_torch.exec.operators import CapacityOverflow
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline
from presto_tpu_torch.expr import col
from presto_tpu_torch.ops import join as pjoin
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.types import BIGINT
from torch_bridge import (
    ANALYZER_REFUSALS,
    counters,
    mark_counters,
    port_batch,
    refused_alike,
    to_numpy,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SF = 0.01


# ---------------------------------------------------------------------------
# the operators, on the JAX join tests' batches
# ---------------------------------------------------------------------------


def _jbatch(arrays, cap=None, valids=None):
    return JBatch.from_numpy(arrays, {k: JBIGINT for k in arrays}, capacity=cap, valids=valids)


def build_batch():
    return _jbatch({"bk": np.array([1, 3, 5, 7], dtype=np.int64),
                    "bval": np.array([10, 30, 50, 70], dtype=np.int64)}, cap=8)


def dup_build_batch():
    return _jbatch({"bk": np.array([1, 1, 2, 2, 2], dtype=np.int64),
                    "bval": np.array([10, 11, 20, 21, 22], dtype=np.int64)}, cap=8)


def probe_batch(valids=None):
    return _jbatch({"pk": np.array([5, 2, 3, 7, 9, 1], dtype=np.int64),
                    "pval": np.array([100, 200, 300, 400, 500, 600], dtype=np.int64)},
                   cap=8, valids=valids)


def rows_of(batches, names) -> list:
    """The live rows of ``batches`` (either package) as tuples, a value
    None where its column is not valid, sorted."""
    out = []
    for b in batches:
        live = to_numpy(b.live)
        cols = []
        for n in names:
            c = b.columns[n]
            valid = live if c.valid is None else to_numpy(c.valid)
            cols.append([int(d) if v else None for d, v in zip(to_numpy(c.data), valid)])
        out += [tuple(cl[i] for cl in cols) for i in np.flatnonzero(live)]
    return sorted(out, key=repr)


def run_both(jbuild, jprobe, join_type, unique, out_capacity=None):
    """(JAX rows, port rows) of one join of ``jprobe`` against ``jbuild``
    on key bk = pk with payload bval."""
    names = ["pk", "pval", "bval"]
    jb = JBuild(jcol("bk", JBIGINT))
    JPipeline(BatchSource([jbuild]), [jb]).run()
    jj = JLookup(jb, jcol("pk", JBIGINT), [JBuildOutput("bval", "bval")], join_type,
                 unique=unique, out_capacity=out_capacity)
    want = rows_of(JPipeline(BatchSource([jprobe]), [jj]).run(), names)
    pb = JoinBuildOperator(col("bk", BIGINT))
    Pipeline(BatchStream.of([port_batch(jbuild)]), [pb]).run()
    pj = LookupJoinOperator(pb, col("pk", BIGINT), [BuildOutput("bval", "bval")], join_type,
                            unique=unique, out_capacity=out_capacity)
    got = rows_of(Pipeline(BatchStream.of([port_batch(jprobe)]), [pj]).run(), names)
    return want, got


@pytest.mark.parametrize("unique", [True, False])
def test_left_outer_unique(unique):
    """``test_joins.py::test_left_outer_unique`` (and the same join on the
    expansion probe): unmatched probe rows kept with a NULL payload."""
    want, got = run_both(build_batch(), probe_batch(), "left", unique,
                         None if unique else 32)
    assert got == want
    assert [r[0] for r in got] == [1, 2, 3, 5, 7, 9]
    vals = {r[0]: r[2] for r in got}
    assert vals[2] is None and vals[9] is None and vals[3] == 30


@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_expansion_join_with_duplicates(join_type):
    """``test_joins.py::test_expansion_join_with_duplicates``: each probe
    row once per matching build row (and, left, once null-extended when
    none matches), equal to pandas' merge."""
    want, got = run_both(dup_build_batch(), probe_batch(), join_type, False, 32)
    assert got == want
    left = pd.DataFrame({"pk": [5, 2, 3, 7, 9, 1], "pval": [100, 200, 300, 400, 500, 600]})
    right = pd.DataFrame({"bk": [1, 1, 2, 2, 2], "bval": [10, 11, 20, 21, 22]})
    m = left.merge(right, left_on="pk", right_on="bk", how=join_type)
    expect = sorted(((int(a), int(b), None if pd.isna(c) else int(c))
                     for a, b, c in zip(m["pk"], m["pval"], m["bval"])), key=repr)
    assert got == expect


def test_left_expansion_emits_null_keys():
    """A live probe row whose key is NULL matches nothing, yet a LEFT
    join keeps it, null-extended (``emit_live``); an inner join drops it."""
    valids = {"pk": np.array([True, False, True, True, False, True])}
    for jt in ("left", "inner"):
        want, got = run_both(dup_build_batch(), probe_batch(valids), jt, False, 32)
        assert got == want
        nulls = [r for r in got if r[0] is None]
        assert len(nulls) == (2 if jt == "left" else 0)
        assert all(r[2] is None for r in nulls)


def test_expansion_overflow_raises():
    """``test_joins.py::test_expansion_overflow_raises``: 8 x 8 pairs into
    16 slots."""
    zeros = {"bk": np.zeros(8, dtype=np.int64), "bval": np.arange(8, dtype=np.int64)}
    b = JoinBuildOperator(col("bk", BIGINT))
    Pipeline(BatchStream.of([port_batch(_jbatch(zeros))]), [b]).run()
    j = LookupJoinOperator(b, col("pk", BIGINT), [BuildOutput("bval", "bval")], "inner",
                           unique=False, out_capacity=16)
    pb = port_batch(_jbatch({"pk": np.zeros(8, dtype=np.int64),
                             "pval": np.arange(8, dtype=np.int64)}))
    with pytest.raises(CapacityOverflow):
        Pipeline(BatchStream.of([pb]), [j]).run()


def test_expansion_join_needs_a_capacity():
    b = JoinBuildOperator(col("bk", BIGINT))
    with pytest.raises(NotSupported, match="output capacity"):
        LookupJoinOperator(b, col("pk", BIGINT), (), "inner", unique=False)


def test_strategy_counts_once_per_operator():
    """``join.strategy.expand`` counts once per operator, however many
    batches it probes."""
    b = JoinBuildOperator(col("bk", BIGINT))
    Pipeline(BatchStream.of([port_batch(dup_build_batch())]), [b]).run()
    j = LookupJoinOperator(b, col("pk", BIGINT), [BuildOutput("bval", "bval")], "inner",
                           unique=False, out_capacity=32)
    mark_counters()
    Pipeline(BatchStream.of([port_batch(probe_batch()) for _ in range(3)]), [j]).run()
    assert counters()["join.strategy.expand"] == 1


# ---------------------------------------------------------------------------
# probe_expand against the JAX package's
# ---------------------------------------------------------------------------


def _mask(n, cap):
    m = np.zeros(cap, bool)
    m[:n] = True
    return m


def test_join_expand_vs_pandas():
    """``test_ops.py::test_join_expand_vs_pandas`` on the port."""
    rng = np.random.default_rng(0)
    bcap, pcap, ocap = 32, 16, 128
    bk = rng.integers(0, 6, bcap).astype(np.int64)
    pk = rng.integers(0, 8, pcap).astype(np.int64)
    bn, pn = 25, 12
    build = pjoin.build_lookup(torch.from_numpy(bk), torch.from_numpy(_mask(bn, bcap)), 32)
    res = pjoin.probe_expand(build, torch.from_numpy(pk), torch.from_numpy(_mask(pn, pcap)),
                             ocap)
    assert not bool(res.overflow)
    live = res.live.numpy()
    got = set(zip(res.probe_row.numpy()[live].tolist(), res.build_row.numpy()[live].tolist()))
    want = pd.DataFrame({"k": pk[:pn], "p": np.arange(pn)}).merge(
        pd.DataFrame({"k": bk[:bn], "b": np.arange(bn)}), on="k")
    assert got == set(zip(want["p"].tolist(), want["b"].tolist()))
    assert int(res.n_out) == len(want)


def test_join_expand_overflow():
    """``test_ops.py::test_join_expand_overflow`` on the port: 8 x 16
    pairs into 64 slots."""
    build = pjoin.build_lookup(torch.zeros(16, dtype=torch.int64), torch.ones(16, dtype=torch.bool),
                               16)
    res = pjoin.probe_expand(build, torch.zeros(8, dtype=torch.int64),
                             torch.ones(8, dtype=torch.bool), 64)
    assert bool(res.overflow) and int(res.n_out) == 128


def expand_inputs(case: str, seed: int):
    """(build keys, build live, probe keys, probe live, emit_live, left)
    for one differential case."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(-3, 9, 48).astype(np.int64)
    blive = rng.random(48) < 0.8
    pk = rng.integers(-4, 12, 40).astype(np.int64)
    plive = rng.random(40) < 0.75
    emit, left = None, case.startswith("left")
    if case == "left nulls":
        # live rows whose key is NULL: out of probe_live, in emit_live
        nulls = plive & (rng.random(40) < 0.3)
        emit, plive = plive.copy(), plive & ~nulls
    if case.endswith("all dead"):
        plive = np.zeros(40, bool)
    return bk, blive, pk, plive, emit, left


CASES = ["inner", "left", "left nulls", "all dead", "left all dead"]


def both_expand(bk, blive, pk, plive, emit, left, cap):
    jb = jjoin.build_lookup(jnp.asarray(bk), jnp.asarray(blive), 64)
    jr = jjoin.probe_expand(jb, jnp.asarray(pk), jnp.asarray(plive), cap, left=left,
                            emit_live=None if emit is None else jnp.asarray(emit))
    pb = pjoin.build_lookup(torch.from_numpy(bk), torch.from_numpy(blive), 64)
    pr = pjoin.probe_expand(pb, torch.from_numpy(pk), torch.from_numpy(plive), cap, left=left,
                            emit_live=None if emit is None else torch.from_numpy(emit))
    return jr, pr


def assert_same_expansion(jr, pr, what):
    for field in ("probe_row", "build_row", "live"):
        w, g = to_numpy(getattr(jr, field)), to_numpy(getattr(pr, field))
        assert g.shape == w.shape, (what, field)
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      err_msg=f"{what} {field}")
    assert int(pr.n_out) == int(jr.n_out), what
    assert bool(pr.overflow) == bool(jr.overflow), what


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_probe_expand_equals_reference(case, seed):
    inputs = expand_inputs(case, seed)
    jr, pr = both_expand(*inputs, 1 << 10)
    assert_same_expansion(jr, pr, case)
    n = int(pr.n_out)
    assert (n == 0) == case.endswith("all dead")
    # the capacity edges: exactly n_out slots, and one fewer (overflow)
    for cap in (max(n, 1), n - 1):
        if cap < 1:
            continue
        jr, pr = both_expand(*inputs, cap)
        assert_same_expansion(jr, pr, f"{case} at capacity {cap}")
        assert bool(pr.overflow) == (n > cap)


def test_left_all_dead_emits_live_rows_only():
    """A left probe whose keys are all NULL but whose rows are live emits
    one null-extended row each; an all-dead batch emits none."""
    bk, blive, pk, _, _, _ = expand_inputs("left", 5)
    live = np.ones(40, bool)
    jr, pr = both_expand(bk, blive, pk, np.zeros(40, bool), live, True, 64)
    assert_same_expansion(jr, pr, "left, every key NULL")
    assert int(pr.n_out) == 40 and not bool(pr.overflow)
    assert (pr.build_row.numpy()[:40] == 64).all()


# ---------------------------------------------------------------------------
# Q5 and Q13 through both Session.sql
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


def jax_run(conn, sql):
    before = REGISTRY.snapshot()
    df = JSession({"tpch": conn}).sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after.get(k, 0) - before.get(k, 0) for k in after
              if k.startswith(("join.strategy.", "join.filter_rows_"))
              or k == "exec.pallas_join_route"}
    return df, {k: v for k, v in routes.items() if v}


def port_run(conn, sql):
    mark_counters()
    res = PSession({"tpch": conn}, device="cpu").sql(sql)
    routes = {k: v for k, v in counters().items()
              if (k.startswith(("join.strategy.", "join.filter_rows_"))
                  or k == "exec.pallas_join_route") and v}
    return res, routes


@pytest.mark.parametrize("q", ["q13", "q5"])
def test_session_sql_equals_jax_session(conns, q):
    """One run of each package; the frames (values and dtypes), the
    routes (``join.strategy.expand`` once per capacity the retry ladder
    tried, in both) and the card's numpy oracle."""
    want, want_routes = jax_run(conns[0], QUERIES[q])
    res, routes = port_run(conns[1], QUERIES[q])
    got = pd.DataFrame(res.to_dict())
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes
    assert routes["join.strategy.expand"] >= 1
    oracle = getattr(chip_smoke, f"{q}_expected")(conns[1])
    assert list(oracle) == res.names
    for name, w in oracle.items():
        assert list(res.column(name)) == list(w), name
    if q == "q13":
        assert int(res.column("c_count")[0]) == 0  # customers without an order


PLAN_QUERIES = ["q5", "q13"]


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


@pytest.mark.parametrize("q", PLAN_QUERIES)
def test_plans_equal_the_reference(plan_sessions, q):
    from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg
    from presto_tpu.plan.bounds import agg_value_bits as j_bits
    from presto_tpu.plan.joinfilters import planned_join_strategy as j_join
    from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg
    from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join
    from presto_tpu_torch.plan.bounds import agg_value_bits as p_bits
    from test_torch_sql import plan_shape

    js, ps = plan_sessions
    want = plan_shape(js.plan(QUERIES[q]), js.catalog, j_join, j_agg, j_bits)
    got = plan_shape(ps.plan(QUERIES[q]), ps.catalog, p_join, p_agg, p_bits)
    assert got == want
    assert "strategy=expand" in ps.explain(QUERIES[q])


# statements over null-extended rows, each equal to the JAX package's frame
STATEMENTS = [
    # count(col) skips null-extended rows; every customer's orders filtered away
    "select count(*) as n, count(o_orderkey) as k from customer left join orders "
    "on c_custkey = o_custkey and o_totalprice < 0",
    # aggregates over a null-extended build: sum, min, max, count per group
    "select c_nationkey, count(*) as n, count(o_orderkey) as k, sum(o_totalprice) as s, "
    "min(o_orderdate) as d, max(o_orderkey) as m from customer left join orders "
    "on c_custkey = o_custkey and o_orderdate < date '1992-03-01' "
    "group by c_nationkey order by c_nationkey",
    # a WHERE conjunct over the null-extended side filters after the join
    "select count(*) as n, count(o_orderkey) as k from customer left join orders "
    "on c_custkey = o_custkey where o_totalprice > 200000",
    # the ON residual on the build alone filters the build (LIKE on BYTES)
    "select c_custkey, count(o_orderkey) as k from customer left join orders "
    "on c_custkey = o_custkey and o_comment like '%special%' "
    "group by c_custkey order by k desc, c_custkey limit 20",
    # a unique LEFT join (nation is keyed by n_nationkey), residual on the build
    "select count(*) as n, count(n_name) as k from supplier left join nation "
    "on s_nationkey = n_nationkey and n_regionkey = 1",
    # an inner expansion join: suppliers per customer nation
    "select c_nationkey, count(*) as n from customer join supplier "
    "on c_nationkey = s_nationkey where c_custkey < 200 group by c_nationkey "
    "order by c_nationkey",
]


@pytest.mark.parametrize("i", range(len(STATEMENTS)))
def test_statements_over_null_extended_rows(conns, i):
    want, want_routes = jax_run(conns[0], STATEMENTS[i])
    res, routes = port_run(conns[1], STATEMENTS[i])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes


@pytest.mark.parametrize("sql,what", [
    ("select count(*) from customer right join orders on c_custkey = o_custkey", "RIGHT JOIN"),
    ("select count(*) from customer full join orders on c_custkey = o_custkey", "FULL JOIN"),
    (QUERIES["q15"].replace("from supplier, revenue\nwhere s_suppkey = supplier_no\n  and",
                            "from supplier full join revenue on s_suppkey = supplier_no\n"
                            "where"), "FULL JOIN"),
    (QUERIES["q17"].replace("where l_partkey = p_partkey", "where l_partkey = p_partkey "
                            "and l_suppkey <> p_size"), "<> correlation in a scalar subquery"),
])
def test_joins_and_queries_still_refused(conns, sql, what):
    """RIGHT and FULL joins, also inside Q15, equal the JAX package's
    answers (frames, dtypes, route and filter counters); Q17's
    correlated scalar stops at a ``<>`` correlation in both packages,
    with the reference's class and words."""
    try:
        want, want_routes = jax_run(conns[0], sql)
    except Exception:  # noqa: BLE001 - the reference refuses: so must the port
        err = refused_alike(lambda: jax_run(conns[0], sql),
                            lambda: PSession({"tpch": conns[1]}, device="cpu").sql(sql))
        assert str(err) == ANALYZER_REFUSALS[what]
        return
    res, routes = port_run(conns[1], sql)
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
