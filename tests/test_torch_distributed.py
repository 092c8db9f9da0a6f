"""Mesh sessions: the port's ``Session(..., mesh=make_mesh(n,
device="cpu"))`` (``exec/distributed.py`` over ``parallel/``) against the
JAX package's ``Session(..., mesh=make_mesh(n))`` on its virtual CPU
devices, both with the result cache off.

Every statement compares the frames (bit for bit, DOUBLE columns within
the JAX package's tolerance, rtol 1e-3 / atol 0.02; rows in order: every
statement here has an order the JAX package defines, its per-shard row
order included), the ``agg.strategy.*``, ``exchange.*`` and
``exec.leaf_*`` / ``exec.q1_*`` counter moves, and the names of the
query trace's ``exchange:`` spans. Cases: the distributed leaf route (Q1,
Q6, SSB Q1.1) and its forced ``value_overflow`` fallback; the high-
cardinality group-by with the partial-aggregation bypass off and on; a
global and a direct-strategy aggregation; the range sort, TopN and
Limit under a gather guard far below the table (the JAX package's
``_sort_env``) and the guard's refusal; the grouped (bucketed)
aggregation under a small ``join_build_budget_bytes``; UNION ALL and a
scalar subquery; a 2-D ``make_dcn_mesh(2, 2)`` against the flat mesh;
1, 2 and 4 shards giving one answer; a join, a semi join and a window
(ROADMAP C26, closed: once refused on a mesh). ROADMAP C27 (one process)
is pinned here. The other joins and windows are in
``test_torch_distributed_{joins,windows,degrade}.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from presto_tpu.connectors.ssb import SsbConnector as JSsb  # noqa: E402
from presto_tpu.connectors.ssb.queries import QUERIES as SSB  # noqa: E402
from presto_tpu.connectors.tpch import TpchConnector as JT  # noqa: E402
from presto_tpu.connectors.tpch.queries import QUERIES  # noqa: E402
from presto_tpu.parallel.mesh import make_dcn_mesh as jdcn  # noqa: E402
from presto_tpu.parallel.mesh import make_mesh as jmesh  # noqa: E402
from presto_tpu.runtime.metrics import REGISTRY as JR  # noqa: E402
from presto_tpu.runtime.session import Session as JSession  # noqa: E402
from presto_tpu_torch.connectors.ssb import SsbConnector as PSsb  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PT  # noqa: E402
import presto_tpu_torch.types as PT_  # noqa: E402
from presto_tpu_torch.parallel import multihost  # noqa: E402
from presto_tpu_torch.parallel.mesh import make_dcn_mesh, make_mesh  # noqa: E402
from presto_tpu_torch.runtime.errors import NotSupported, UserError  # noqa: E402
from presto_tpu_torch.runtime.metrics import REGISTRY as PR  # noqa: E402
from presto_tpu_torch.runtime.session import Session as PSession  # noqa: E402
from torch_bridge import port_frame, refused_alike  # noqa: E402

SF = 0.01
UNITS = 1 << 11  # several splits a table, so a shard reads more than one
NO_CACHE = {"result_cache_enabled": False}
#: the counter families a mesh run is held to
FAMILIES = ("agg.strategy.", "exchange.", "exec.leaf_", "exec.q1_", "batch.fallback")
#: per-process histogram statistics that are no per-query move
_STATS = (".p50", ".p95", ".p99", ".max")

GROUP_BY = ("select l_orderkey, sum(l_quantity) as q, count(*) as c, min(l_shipdate) as d "
            "from lineitem group by l_orderkey")
#: about one group a row: the partial-aggregation bypass's case
PAIR_GROUPS = ("select l_orderkey, l_linenumber, sum(l_quantity) as q from lineitem "
               "group by l_orderkey, l_linenumber")
TOP_GROUPS = ("select l_orderkey, sum(l_quantity) as q from lineitem group by l_orderkey "
              "order by q desc, l_orderkey limit 10")


@pytest.fixture(scope="module")
def conns():
    return {"tpch": (JT(sf=SF, units_per_split=UNITS),
                     PT(sf=SF, units_per_split=UNITS, device="cpu")),
            "ssb": (JSsb(sf=SF), PSsb(sf=SF, device="cpu"))}


def _moves(registry, before):
    after = registry.snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if k.startswith(FAMILIES) and d and not k.endswith(_STATS) \
                and "dispatch_s" not in k:
            out[k] = round(d, 9)
    return out


def _exchange_spans(session):
    rec = session.traces.for_query(session.query_history[-1].query_id)
    return [s.name for s in rec.spans if s.name.startswith("exchange:")]


def run_both(conns, sql, n=4, props=None, key="tpch", jm=None, pm=None, lie=None):
    """(port result, JAX frame) of one statement on n-shard meshes, after
    checking the counter moves and exchange spans are equal."""
    props = {**NO_CACHE, **(props or {})}
    jc, pc = conns[key]
    js = JSession({key: jc}, properties=dict(props), mesh=jm or jmesh(n))
    ps = PSession({key: pc}, properties=dict(props), device="cpu",
                  mesh=pm or make_mesh(n, device="cpu"))
    if lie is not None:
        lie(js)
        lie(ps)
    before = JR.snapshot()
    want = js.sql(sql)
    jmoves = _moves(JR, before)
    before = PR.snapshot()
    got = ps.sql(sql)
    pmoves = _moves(PR, before)
    assert pmoves == jmoves, sql
    assert _exchange_spans(ps) == _exchange_spans(js), sql
    return got, want, pmoves


def close_frame(res, want, what=""):
    """Equal frames: the same columns and rows in order, every non-DOUBLE
    column bit for bit with its dtype, DOUBLE within the JAX package's
    tolerance (its cross-shard reductions sum in another order)."""
    got = port_frame(res)
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if pd.api.types.is_float_dtype(w.dtype):
            assert g.dtype == w.dtype, (what, c)
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=0.02, err_msg=f"{what} {c}")
        else:
            assert g.dtype == w.dtype, (what, c, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {c}")


@pytest.mark.parametrize("name,key", [("q1", "tpch"), ("q6", "tpch"), ("q1_1", "ssb")])
def test_leaf_route_queries_equal_reference(conns, name, key):
    sql = (QUERIES if key == "tpch" else SSB)[name]
    got, want, moves = run_both(conns, sql, key=key)
    close_frame(got, want, name)
    assert moves["exec.leaf_fused_route"] == 1 and moves["agg.strategy.fused"] == 1
    # no partitioned exchange: the states all-reduce (SSB Q1.1 gathers
    # its folded date join's build side)
    assert moves.get("exchange.dispatches", 0) == (1 if key == "ssb" else 0)


def _lie(table, column, **fields):
    def lie(session):
        real = session.catalog.stats

        def lying(connector, t, c):
            st = real(connector, t, c)
            return dataclasses.replace(st, **fields) if (t, c) == (table, column) else st

        session.catalog.stats = lying

    return lie


def test_forced_value_overflow_falls_back_like_reference(conns):
    """Declared bounds tighter than the data: a shard's step trips
    ``value_overflow``, the route falls back to the generic operators,
    counted, with the right rows."""
    got, want, moves = run_both(conns, QUERIES["q6"],
                                lie=_lie("lineitem", "l_extendedprice", max_value=1.0))
    close_frame(got, want, "q6")
    assert moves["exec.leaf_route_fallback.value_overflow"] == 1
    assert "exec.leaf_fused_route" not in moves


@pytest.mark.parametrize("sql", [GROUP_BY, PAIR_GROUPS])
@pytest.mark.parametrize("bypass", [False, True])
def test_high_cardinality_group_by_equals_reference(conns, sql, bypass):
    """PARTIAL (or, with groups ~ rows, the bypass's per-row partials),
    the multi-round exchange on the hash of the keys, FINAL: the
    unordered result's rows come out in the JAX package's shard order."""
    got, want, moves = run_both(conns, sql, props={"partial_agg_bypass": bypass})
    close_frame(got, want, "group by")
    fires = bypass and sql is PAIR_GROUPS
    assert moves.get("agg.strategy.bypass", 0) == int(fires)
    assert moves.get("agg.strategy.partial", 0) == int(not fires)
    assert moves["exchange.dispatches"] >= 1 and moves["exchange.rows.aggregate"] > 0


@pytest.mark.parametrize("sql", [
    # a global aggregation the leaf route does not take (a LIKE filter)
    "select count(*) as c, sum(o_totalprice) as s, avg(o_totalprice) as a, "
    "min(o_orderdate) as mn, max(o_totalprice) as mx from orders "
    "where o_comment like '%special%'",
    # a direct-addressed one over two dictionary keys
    "select o_orderstatus, o_orderpriority, count(*) as c, sum(o_totalprice) as s, "
    "min(o_orderdate) as mn from orders where o_comment like '%special%' "
    "group by o_orderstatus, o_orderpriority",
    # UNION ALL of a sharded and a replicated input, and a scalar subquery
    "select n from (select o_orderkey as n from orders where o_orderkey < 40 "
    "union all select count(*) as n from nation)",
    "select count(*) as c from orders where o_totalprice > "
    "(select avg(o_totalprice) from orders)",
    TOP_GROUPS,
])
def test_aggregations_and_set_operations_equal_reference(conns, sql):
    got, want, _moves = run_both(conns, sql)
    close_frame(got, want, sql)


SORT_ENV = {"gather_row_limit": 1024}


@pytest.mark.parametrize("sql", [
    "select l_orderkey, l_extendedprice from lineitem order by l_extendedprice desc, l_orderkey",
    "select l_orderkey, l_extendedprice from lineitem "
    "order by l_extendedprice desc, l_orderkey limit 25",
    "select l_orderkey from lineitem limit 100",
    "select o_orderkey, o_orderdate from orders order by o_orderdate, o_orderkey desc",
])
def test_sort_topn_limit_without_replication(conns, sql):
    """The JAX package's ``_sort_env``: a gather guard far below the
    table, so only the range-partition sort and the local-first TopN and
    Limit can pass."""
    got, want, moves = run_both(conns, sql, props=SORT_ENV)
    close_frame(got, want, sql)
    assert moves["exchange.dispatches"] >= 1


def test_gather_limit_refusal_in_the_reference_words(conns):
    jc, pc = conns["tpch"]
    sql = "select l_orderkey from lineitem order by l_orderkey limit 5000"
    err = refused_alike(
        lambda: JSession({"tpch": jc}, properties={**NO_CACHE, **SORT_ENV},
                         mesh=jmesh(4)).sql(sql),
        lambda: PSession({"tpch": pc}, properties={**NO_CACHE, **SORT_ENV}, device="cpu",
                         mesh=make_mesh(4, device="cpu")).sql(sql))
    assert "exceeds gather_limit=1024" in str(err)


def test_grouped_aggregation_under_a_small_budget(conns):
    """An aggregation state estimated over ``join_build_budget_bytes``
    runs bucket by bucket over the whole mesh, each pass its own exchange;
    the spill counters and the rows are the JAX package's."""
    props = {"join_build_budget_bytes": 1 << 18}
    got, want, moves = run_both(conns, GROUP_BY, props=props)
    close_frame(got, want, "grouped")
    assert moves["exchange.dispatches"] >= 2
    resident, _w, _m = run_both(conns, GROUP_BY)
    a = port_frame(got).sort_values("l_orderkey").reset_index(drop=True)
    b = port_frame(resident).sort_values("l_orderkey").reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("sql", [TOP_GROUPS, GROUP_BY,
                                 "select l_orderkey, l_extendedprice from lineitem "
                                 "order by l_extendedprice desc, l_orderkey limit 20"])
def test_dcn_mesh_equals_flat_mesh_and_reference(conns, sql):
    got, want, _ = run_both(conns, sql, jm=jdcn(2, 2), pm=make_dcn_mesh(2, 2, device="cpu"))
    close_frame(got, want, sql)
    flat, _w, _m = run_both(conns, sql)
    pd.testing.assert_frame_equal(port_frame(got), port_frame(flat))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_one_answer_on_1_2_and_4_shards(conns, n):
    got, want, _ = run_both(conns, TOP_GROUPS, n=n)
    close_frame(got, want, f"{n} shards")
    _jc, pc = conns["tpch"]
    local = PSession({"tpch": pc}, properties=NO_CACHE, device="cpu").sql(TOP_GROUPS)
    # a mesh keeps the scan's narrow key storage where the local sort
    # strategy widens it, in both packages: compare values
    pd.testing.assert_frame_equal(port_frame(got), port_frame(local), check_dtype=False)


def test_mesh_template_falls_back_from_batched_dispatch(conns):
    """A bound template on a mesh session cannot batch: counted under
    ``batch.fallback.distributed``, as in the JAX package."""
    _got, _want, moves = run_both(
        conns, "select o_orderkey from orders where o_totalprice > 1000 "
               "order by o_orderkey limit 3",
        props={"batched_dispatch": True})
    assert moves["batch.fallback.distributed"] == 1


def test_mesh_session_fingerprints_apart_from_local(conns):
    from presto_tpu_torch.cache.fingerprint import plan_fingerprint

    _jc, pc = conns["tpch"]
    local = PSession({"tpch": pc}, device="cpu")
    plan = local.plan(QUERIES["q6"])
    fps = {plan_fingerprint(plan, local.catalog, {}, m)
           for m in (None, make_mesh(2, device="cpu"), make_mesh(4, device="cpu"),
                     make_dcn_mesh(2, 2, device="cpu"))}
    assert len(fps) == 4


def test_mesh_of_another_device_type_is_refused(conns):
    _jc, pc = conns["tpch"]
    with pytest.raises(UserError, match="cpu session cannot run on a mesh of cuda"):
        PSession({"tpch": pc}, device="cpu", mesh=make_mesh(2, devices=["cuda:0"] * 2))


def test_make_mesh_needs_the_devices(conns):
    with pytest.raises(UserError, match="need 2 devices, have 1"):
        make_mesh(2, devices=["cpu"])
    m = make_mesh(3, devices=["cpu"] * 3)
    assert (m.size, m.axis_names, m.shape) == (3, ("workers",), (3,))
    d = make_dcn_mesh(2, 2, device="cpu")
    assert (d.axis_names, d.shape) == (("dcn", "ici"), (2, 2))


def _mesh_sessions(conns, n=4, **props):
    jc, pc = conns["tpch"]
    props = {**NO_CACHE, **props}
    return (JSession({"tpch": jc}, properties=dict(props), mesh=jmesh(n)),
            PSession({"tpch": pc}, properties=dict(props), device="cpu",
                     mesh=make_mesh(n, device="cpu")))


def test_flight_record_carries_the_exchange_skew(conns):
    """The flight recorder's ``exchangeSkew`` and ``hotPartitions`` of a
    mesh run (read off the executor) equal the JAX package's."""
    got = []
    for s in _mesh_sessions(conns, flight_record_successes=True):
        s.sql(GROUP_BY)
        d = s.flight.latest().to_dict()
        got.append((d["exchangeSkew"], d["hotPartitions"]))
    assert got[0] == got[1]
    (skew,), hot = got[1]
    assert skew["site"] == "aggregate" and skew["rows"] > 0 and hot == []


def test_node_skew_and_the_fragment_headers_equal_reference(conns):
    """``execute`` records each exchange's skew on the Aggregate that drove
    it (``NodeStats.skew``, ``hot_partition``, ``exchange_rows``); once the
    fingerprint recurs, EXPLAIN (TYPE DISTRIBUTED) shows the observed skew
    on the fragment's header, in the JAX package's words."""
    out = []
    for s in _mesh_sessions(conns):
        for _ in range(2):
            _res, info = s.execute(GROUP_BY)
        stats = [(st["node"], st["skew"], st["hot_partition"], st["exchange_rows"])
                 for st in info.node_stats if st["skew"] > 0]
        out.append((stats, s.explain_distributed(GROUP_BY)))
    assert out[0] == out[1]
    (stats, text) = out[1]
    assert [t for t, *_ in stats] == ["Aggregate"]
    assert "skew~1.0x (observed)" in text


def test_host_spill_and_placement_equal_reference(conns):
    """The grouped tier's host side: ``_pull_host`` (every column to host
    RAM with the key's bucket ids) and ``_place_sharded`` (selected host
    rows back into a row-sharded batch, nearly equal contiguous chunks)
    against the JAX package's, array for array."""
    from presto_tpu.exec.distributed import DistBatch as JDist
    from presto_tpu.exec.distributed import DistributedExecutor as JExec
    from presto_tpu.expr import col as jcol
    from presto_tpu_torch.exec.distributed import DistBatch as PDist
    from presto_tpu_torch.exec.distributed import DistributedExecutor as PExec
    from presto_tpu_torch.expr import col as pcol
    from torch_bridge import port_batch, port_type

    js, ps = _mesh_sessions(conns)
    jb = JT(sf=SF, units_per_split=UNITS).scan(
        JT(sf=SF, units_per_split=UNITS).splits("orders")[0], ["o_orderkey", "o_custkey"],
        4 * 1024)
    jx, px = JExec(js.catalog, jmesh(4)), PExec(ps.catalog, make_mesh(4, device="cpu"))
    key_t = jb["o_custkey"].dtype
    jcols, jlive, jbids = jx._pull_host(JDist(jb, True), jcol("o_custkey", key_t), 5)
    pcols, plive, pbids = px._pull_host(PDist(port_batch(jb), True),
                                        pcol("o_custkey", port_type(key_t)), 5)
    np.testing.assert_array_equal(pbids, jbids)
    np.testing.assert_array_equal(plive, jlive)
    for name in jcols:
        for g, w in zip(pcols[name][:2], jcols[name][:2]):
            np.testing.assert_array_equal(g, w)
    for bk in range(5):
        sel = jlive & (jbids == bk)
        want = jx._place_sharded(jcols, sel)
        got = px._place_sharded(pcols, sel)
        np.testing.assert_array_equal(got.live.numpy(), np.asarray(want.live))
        for name in want.names:
            np.testing.assert_array_equal(got[name].data.numpy(), np.asarray(want[name].data))
            np.testing.assert_array_equal(got[name].valid.numpy(), np.asarray(want[name].valid))


@pytest.mark.resets_global_state
@pytest.mark.parametrize("sql", [TOP_GROUPS, "select o_orderkey, o_totalprice from orders "
                                 "order by o_totalprice desc, o_orderkey limit 5"])
def test_explain_analyze_on_a_mesh_equals_reference(conns, sql):
    """EXPLAIN ANALYZE on a mesh: the node rows (walls masked), the
    exchange span roll-ups and the executable cache's ``cache:`` lines
    from cleared caches, line for line."""
    import re

    import presto_tpu.cache.exec_cache as JEC
    import presto_tpu_torch.cache.exec_cache as PEC

    def masked(text):
        return [re.sub(r"(wall |^cache: \S+ )[\d.]+ms", r"\1?ms", line)
                for line in text.splitlines()]

    out = []
    for s, cache in zip(_mesh_sessions(conns), (JEC, PEC)):
        cache.EXEC_CACHE.clear()
        out.append(masked(s.explain_analyze(sql)))
    assert out[1] == out[0]
    assert any(line.startswith("exchange") for line in out[1])


@pytest.mark.parametrize("strategy", ["direct", "sort"])
def test_partial_and_final_phases_equal_reference(strategy):
    """``HashAggregationOperator(phase="partial")`` over two batches, then
    ``phase="final"`` over their outputs, and ``AggSpec.merge_kind``:
    counts and sums add, min and max merge by min and max."""
    import presto_tpu.exec.operators as JO
    import presto_tpu.expr as JE
    import presto_tpu.types as JTy
    import presto_tpu_torch.exec.operators as PO
    import presto_tpu_torch.expr as PE
    from presto_tpu.batch import Batch as JBatch
    from presto_tpu.batch import Dictionary as JDict
    from torch_bridge import port_batch, port_type

    rng = np.random.default_rng(5)
    d = JDict(["a", "b", "c"])
    key_t = JTy.varchar()
    batches = []
    for n in (40, 25):
        v = rng.integers(-50, 50, n)
        valid = rng.random(n) < 0.8
        batches.append(JBatch.from_numpy(
            {"k": rng.integers(0, 3, n).astype(np.int32), "v": v},
            {"k": key_t, "v": JTy.BIGINT}, valids={"v": valid}, dictionaries={"k": d}))

    def specs(M, T, E):
        col = E.col("v", T.BIGINT)
        return [M.AggSpec(kind, None if kind == "count_star" else col, f"{kind}_v", T.BIGINT)
                for kind in ("sum", "count", "count_star", "min", "max")]

    def run(M, E, T, bs, kd):
        keys = [("k", E.col("k", kd))]
        strat = M.DirectStrategy((0,), (1,), 3) if strategy == "direct" else M.SortStrategy(16)
        extra = {} if M is JO else {"device": "cpu"}
        part = M.HashAggregationOperator(keys, specs(M, T, E), strat, phase="partial", **extra)
        outs = []
        for b in bs:
            part.process(b)
            outs += part.finish()
            part.state = None
        final = M.HashAggregationOperator(keys, specs(M, T, E), strat, phase="final", **extra)
        for o in outs:
            final.process(o)
        return final.finish()[0]

    want = run(JO, JE, JTy, batches, key_t)
    got = run(PO, PE, PT_, [port_batch(b) for b in batches], port_type(key_t))
    assert [a.merge_kind for a in specs(PO, PT_, PE)] == \
        [a.merge_kind for a in specs(JO, JTy, JE)] == ["sum", "sum", "sum", "min", "max"]
    live = np.asarray(want.live)
    np.testing.assert_array_equal(got.live.numpy(), live)
    for name in want.names:
        np.testing.assert_array_equal(got[name].data.numpy()[live],
                                      np.asarray(want[name].data)[live], err_msg=name)


# ---------------------------------------------------------------------------
# ROADMAP C26 (closed): joins, semi joins and windows on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,sql", [
    ("Join", "select n_name, r_name from nation join region on n_regionkey = r_regionkey"),
    ("SemiJoin", "select n_name from nation where n_regionkey in "
                 "(select r_regionkey from region where r_name = 'ASIA')"),
    ("Window", "select n_name, row_number() over (order by n_name) as r from nation"),
])
def test_joins_and_windows_are_refused_on_a_mesh_c26(conns, kind, sql):
    """Once refused on a mesh (C26, its name kept): the port's mesh session
    now answers each, equal to the JAX package's mesh session (frames,
    counter moves, exchange spans) and to a local session."""
    got, want, _moves = run_both(conns, sql, n=2)
    close_frame(got, want, kind)
    _jc, pc = conns["tpch"]
    local = PSession({"tpch": pc}, properties=NO_CACHE, device="cpu").sql(sql)
    close_frame(local, want, kind)


def test_one_process_is_the_cluster_c27():
    """ROADMAP C27: a single PyTorch controller cannot address another
    host's devices: more than one process is refused, one is the cluster."""
    assert multihost.num_hosts() == 1
    multihost.initialize(num_processes=1)
    with pytest.raises(NotSupported, match="num_processes=2"):
        multihost.initialize("localhost:8476", num_processes=2, process_id=0)
    m = multihost.global_dcn_mesh(device="cpu")
    assert (m.axis_names, m.size) == (("workers",), 1)


def test_chip_smoke_phase23_on_the_cpu():
    """Phase 23 at sf 0.01 on four CPU shards: every answer against
    numpy and the one-device session, the exchanges and round-flag
    reads, EXPLAIN (TYPE DISTRIBUTED) and ``--mesh 1 -e`` Q6."""
    import chip_smoke

    out = chip_smoke.run_mesh_queries(PT(sf=SF, device="cpu"), device="cpu")
    assert set(out["walls"]) == set(chip_smoke.MESH_SQL)
    assert out["exchange"]["top groups"]["counters"]["exchange.dispatches"] >= 1
    assert [n for n, _ms in out["exchange"]["orders sort"]["walls_ms"]][0] == "exchange:sort"
    assert out["flag_reads"]["top groups"] >= 2
    assert out["q1_err"] == 0 and out["launches"]["q1"] == 0  # no CUDA kernel on the CPU
