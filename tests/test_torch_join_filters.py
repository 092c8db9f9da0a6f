"""Runtime join filters in the port against the JAX package
(``tests/test_join_route.py``'s filter tests, mirrored):

- toggling ``runtime_join_filters`` and ``pallas_join`` gives
  bit-identical frames, equal to the reference's, and the same pruned
  counts;
- TPC-H Q3 prunes (``join.filter_rows_pruned`` > 0, equal to the
  reference's), and EXPLAIN renders ``runtime_filter=['l_orderkey']``;
- string keys (dictionary VARCHAR, BYTES) never get a filter;
- the declared stats interval prunes before the build's products exist;
- ``plan/joinfilters``' placement equals the reference's on every TPC-H
  query at sf 0.01 and SF1 (plans only at SF1), and its building blocks
  (``filterable_key_pair``, ``probe_scan_target``) on hand-built plans;
- the build's filter products (min, max and Bloom words) equal the
  reference's.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import presto_tpu.plan.joinfilters as JF
import presto_tpu_torch.plan.joinfilters as PF
from presto_tpu.batch import Batch as JBatch
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.joinkeys import declared_key_interval as j_declared
from presto_tpu.exec.pipeline import BatchSource, Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu.types import INTEGER as JINTEGER
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.exec.joinkeys import declared_key_interval as p_declared
from presto_tpu_torch.exec.local_planner import JoinFilterSlot, LocalExecutor
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline
from presto_tpu_torch.expr import col as pcol
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.types import BIGINT, INTEGER
from torch_bridge import assert_same, port_batch, to_numpy

JOIN_QUERIES = {
    "q3": QUERIES["q3"],
    "semi": ("select count(*) c from lineitem where l_orderkey in "
             "(select o_orderkey from orders where o_orderdate < date '1995-03-15')"),
    "anti": ("select count(*) c from lineitem where l_orderkey not in "
             "(select o_orderkey from orders where o_orderdate >= date '1998-01-01')"),
    "left": ("select o_orderkey, o_custkey, c_name from orders "
             "left join customer on o_custkey = c_custkey order by o_orderkey limit 50"),
}
FILTERS = "join.filter_rows_"


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


def _jax(conn, sql, **props):
    before = REGISTRY.snapshot()
    df = JSession({"tpch": conn}, properties={"result_cache_enabled": False, **props}).sql(sql)
    after = REGISTRY.snapshot()
    return df, {k: int(after[k] - before.get(k, 0)) for k in after
                if k.startswith(FILTERS) and after[k] - before.get(k, 0)}


def _port(conn, sql, **props):
    COUNTERS.clear()
    res = PSession({"tpch": conn}, properties=props, device="cpu").sql(sql)
    return (pd.DataFrame(res.to_dict()),
            {k: v for k, v in COUNTERS.items() if k.startswith(FILTERS) and v})


@pytest.mark.parametrize("qname", sorted(JOIN_QUERIES))
def test_sql_toggles_bit_identical(conns, qname):
    q = JOIN_QUERIES[qname]
    frames = []
    for filters in (True, False):
        for kernel in (True, False):
            props = {"runtime_join_filters": filters, "pallas_join": kernel}
            got, got_filters = _port(conns[1], q, **props)
            want, want_filters = _jax(conns[0], q, **props)
            pd.testing.assert_frame_equal(got, want, check_exact=True)
            assert got_filters == want_filters
            if qname in ("q3", "anti", "left"):
                # anti and left joins never push a filter; the semi join
                # runs on the fused leaf route's membership fold here
                assert bool(got_filters) == (filters and qname == "q3")
            frames.append(got)
    for f in frames[1:]:
        pd.testing.assert_frame_equal(frames[0], f, check_exact=True)


def test_q3_routes_pallas_and_prunes(conns):
    COUNTERS.clear()
    PSession({"tpch": conns[1]}, device="cpu").sql(QUERIES["q3"])
    assert COUNTERS["exec.pallas_join_route"] > 0, "Q3 did not take the fused join route"
    assert COUNTERS["join.filter_rows_pruned"] > 0, "Q3's runtime filter pruned nothing"
    _df, want = _jax(conns[0], QUERIES["q3"])
    assert {k: COUNTERS[k] for k in want} == want


def test_explain_renders_strategy_and_filters(conns):
    out = PSession({"tpch": conns[1]}, device="cpu").explain(QUERIES["q3"])
    assert "strategy=" in out
    assert "runtime_filter=['l_orderkey']" in out
    jout = JSession({"tpch": conns[0]}).explain(QUERIES["q3"])
    assert ("runtime_filter=['l_orderkey']" in jout) and out.count("runtime_filter") == \
        jout.count("runtime_filter")


def test_string_keys_never_get_filters(conns):
    """String join keys normalize (codes across dictionaries, BYTES packs
    and hashes) during execution: build bounds over that domain must
    never prune the raw scan column. No edge is placed, and the answer
    is the same with the filters on and off."""
    for q in ("select count(*) c from customer a join "
              "(select distinct c_mktsegment m from customer) b on a.c_mktsegment = b.m",
              "select count(*) c from orders join "
              "(select o_clerk k from orders group by o_clerk) s on o_clerk = k"):
        ps = PSession({"tpch": conns[1]}, device="cpu")
        edges = PF.filter_edges(ps.plan(q))
        assert not any(j.left_keys[0].dtype.kind.name in ("VARCHAR", "BYTES")
                       for j, _s, _c in edges), "a string join key received a filter"
        on, on_f = _port(conns[1], q)
        off, _ = _port(conns[1], q, runtime_join_filters=False)
        pd.testing.assert_frame_equal(on, off, check_exact=True)
        assert on_f == {}
        want, _ = _jax(conns[0], q)
        pd.testing.assert_frame_equal(on, want, check_exact=True)


def _first_join(n, kind="Join"):
    if type(n).__name__ == kind:
        return n
    for c in n.children:
        r = _first_join(c, kind)
        if r is not None:
            return r
    return None


def test_declared_interval_prunes_without_runtime_products(conns):
    """The slot a join registers starts at the build key's DECLARED stats
    interval (the reference's), and a scan batch filtered before the
    build publishes anything prunes exactly the rows outside it."""
    js, ps = JSession({"tpch": conns[0]}), PSession({"tpch": conns[1]}, device="cpu")
    # Q3's lineitem-orders join, under its customer join
    jinner = _first_join(_first_join(js.plan(QUERIES["q3"])).left)
    pinner = _first_join(_first_join(ps.plan(QUERIES["q3"])).left)
    want = j_declared(jinner.right, jinner.right_keys[0], js.catalog)
    assert want is not None and want[0] >= 0
    ex = LocalExecutor(ps.catalog, device="cpu")
    slot = ex._register_join_filter(pinner)
    assert slot.col == "l_orderkey" and slot.declared == want
    assert slot.minmax is None and slot.bloom is None and slot.bounds() == want
    assert p_declared(pinner.right, pinner.right_keys[0], ps.catalog) == want
    lo, hi = 3, 40
    slot = JoinFilterSlot("k", (lo, hi))
    keys = np.arange(-5, 60, dtype=np.int32)
    pb = port_batch(JBatch.from_numpy({"k": keys}, {"k": JINTEGER}, capacity=80))
    out = ex._apply_join_filter(slot, pb)
    live = to_numpy(out.live)
    np.testing.assert_array_equal(np.flatnonzero(live), np.flatnonzero((keys >= lo)
                                                                       & (keys <= hi)))
    ex._flush_filter_stats()  # not registered on the executor: nothing to read back
    assert int(slot.stat_in) == len(keys) and int(slot.stat_pruned) == len(keys) - (hi - lo + 1)


@pytest.fixture(scope="module", params=[0.01, 1])
def plan_sessions(request):
    sf = request.param
    return (JSession({"tpch": JConnector(sf=sf)}),
            PSession({"tpch": PConnector(sf=sf, device="cpu")}, device="cpu"))


def _edges(mod, plan):
    return [(type(j).__name__, s.table, c) for j, s, c in mod.filter_edges(plan)]


@pytest.mark.parametrize("q", sorted(QUERIES, key=lambda k: int(k[1:])))
def test_filter_edges_equal_reference(plan_sessions, q):
    js, ps = plan_sessions
    assert _edges(PF, ps.plan(QUERIES[q])) == _edges(JF, js.plan(QUERIES[q]))


def test_probe_scan_target_follows_renames_only(conns):
    """Through Filter and Project renames to the scan column; a computed
    key, or one that crosses a join, has no target (both packages)."""
    sqls = [
        "select count(*) from (select l_orderkey as k from lineitem) a join orders on k = "
        "o_orderkey",
        "select count(*) from (select l_orderkey + 1 as k from lineitem) a join orders on k = "
        "o_orderkey",
        "select count(*) from lineitem join orders on l_orderkey = o_orderkey join customer on "
        "o_custkey = c_custkey where l_quantity > 10",
    ]
    js, ps = JSession({"tpch": conns[0]}), PSession({"tpch": conns[1]}, device="cpu")
    for sql in sqls:
        assert _edges(PF, ps.plan(sql)) == _edges(JF, js.plan(sql))
    assert _edges(PF, ps.plan(sqls[0])) and not _edges(PF, ps.plan(sqls[1]))


@pytest.mark.parametrize("nbits", [1 << 13, 1 << 16])
def test_build_filter_products_equal_reference(nbits):
    """min, max and the Bloom words over the live, valid build keys."""
    rng = np.random.default_rng(nbits)
    n = 3000
    keys = rng.integers(-50_000, 2_000_000, n).astype(np.int64)
    valid = rng.random(n) > 0.05
    jb = JBatch.from_numpy({"k": keys}, {"k": JBIGINT}, capacity=4096, valids={"k": valid})
    jbuild = JJ.JoinBuildOperator(jcol("k", JBIGINT), filter_bits=nbits)
    JPipeline(BatchSource([jb]), [jbuild]).run()
    pbuild = PJ.JoinBuildOperator(pcol("k", BIGINT), filter_bits=nbits)
    Pipeline(BatchStream.of([port_batch(jb)]), [pbuild]).run()
    assert int(pbuild.filter_minmax[0]) == int(jbuild.filter_minmax[0])
    assert int(pbuild.filter_minmax[1]) == int(jbuild.filter_minmax[1])
    assert_same(pbuild.filter_bloom, jnp.asarray(jbuild.filter_bloom))


def test_no_filter_products_without_filter_bits():
    jb = JBatch.from_numpy({"k": np.arange(5, dtype=np.int32)}, {"k": JINTEGER})
    pbuild = PJ.JoinBuildOperator(pcol("k", INTEGER))
    Pipeline(BatchStream.of([port_batch(jb)]), [pbuild]).run()
    assert pbuild.filter_minmax is None and pbuild.filter_bloom is None
