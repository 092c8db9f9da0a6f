"""Distributed joins and semi joins: the port's mesh session
(``exec/distributed.py``'s broadcast, repartition and grouped joins)
against the JAX package's ``Session(mesh=make_mesh(n))`` on its virtual
CPU devices, and against the port's own one-device session.

Every statement compares the frames (rows in order, dtypes, DOUBLE
within the JAX package's tolerance), the ``join.distribution.*``,
``join.strategy.*``, ``exchange.*``, ``spill.*`` and ``adaptive.*``
counter moves and the ``exchange:`` spans. Cases: the twelve join kinds
of ``tests/test_distributed_joins.py`` on four shards at the default
distribution and with ``broadcast_join_row_limit=0`` (every join
repartitioned), its FULL OUTER row-level check, the fragmenter's
plan-proven broadcast, no fused-probe spec on the mesh, a salted
repartition join after a recorded hot destination, and ``chip_smoke.py``
phase 24 at sf 0.01. The eight-shard twins run under ``-m slow``, as the
JAX package's distributed modules do; TPC-H and the grouped tier are in
``test_torch_distributed_grouped.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from presto_tpu.connectors.tpch import TpchConnector as JT  # noqa: E402
from presto_tpu.connectors.tpch.queries import QUERIES  # noqa: E402
from presto_tpu.parallel.mesh import make_mesh as jmesh  # noqa: E402
from presto_tpu.runtime.metrics import REGISTRY as JR  # noqa: E402
from presto_tpu.runtime.session import Session as JSession  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PT  # noqa: E402
from presto_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from presto_tpu_torch.runtime.metrics import REGISTRY as PR  # noqa: E402
from presto_tpu_torch.runtime.session import Session as PSession  # noqa: E402
from test_distributed_joins import JOIN_QUERIES  # noqa: E402
from torch_bridge import port_frame  # noqa: E402

SF = 0.002
UNITS = 1 << 14  # the JAX package's distributed join tests' split size
NO_CACHE = {"result_cache_enabled": False}
#: the counter families a mesh join is held to
FAMILIES = ("join.distribution.", "join.strategy.", "exec.pallas_join_route",
            "join.pallas_fallback", "agg.strategy.", "exchange.", "spill.", "adaptive.",
            "exec.leaf_", "exec.q1_")
#: per-process histogram statistics that are no per-query move
_STATS = (".p50", ".p95", ".p99", ".max")
#: every join repartitioned
REPARTITION = {"broadcast_join_row_limit": 0}

#: the plan-proven broadcast of ``tests/test_fragmenter.py``
Q3ISH = ("select o_orderdate, sum(l_extendedprice * (1 - l_discount)) rev "
         "from lineitem join orders on l_orderkey = o_orderkey "
         "where o_orderdate < date '1995-03-15' "
         "group by o_orderdate order by rev desc limit 10")


@pytest.fixture(scope="module")
def conns():
    return JT(sf=SF, units_per_split=UNITS), PT(sf=SF, units_per_split=UNITS, device="cpu")


def _moves(registry, before):
    after = registry.snapshot()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if k.startswith(FAMILIES) and d and not k.endswith(_STATS) and "dispatch_s" not in k:
            out[k] = round(d, 9)
    return out


def _exchange_spans(session):
    rec = session.traces.for_query(session.query_history[-1].query_id)
    return [s.name for s in rec.spans if s.name.startswith("exchange:")]


def sessions(conns, n=4, props=None, jm=None, pm=None):
    """(JAX package's, port's) mesh sessions over one TPC-H connector
    pair, n shards each unless ``jm`` / ``pm`` give the meshes."""
    jc, pc = conns
    props = {**NO_CACHE, **(props or {})}
    return (JSession({"tpch": jc}, properties=dict(props), mesh=jm or jmesh(n)),
            PSession({"tpch": pc}, properties=dict(props), device="cpu",
                     mesh=pm or make_mesh(n, device="cpu")))


def run_both(conns, sql, n=4, props=None, jm=None, pm=None):
    """(port result, JAX frame, port counter moves) of one statement on
    n-shard meshes, after checking the counter moves and the exchange
    spans are equal."""
    js, ps = sessions(conns, n, props, jm, pm)
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
        assert g.dtype == w.dtype, (what, c, g.dtype, w.dtype)
        if pd.api.types.is_float_dtype(w.dtype):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=0.02, err_msg=f"{what} {c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {c}")


def local_frame(conns, sql, props=None):
    _jc, pc = conns
    return port_frame(PSession({"tpch": pc}, properties={**NO_CACHE, **(props or {})},
                               device="cpu").sql(sql))


def same_values(got, local, sort=None):
    """The mesh answer equals the one-device session's by value (a mesh
    keeps narrow scan storage where a local operator may widen it, in
    both packages)."""
    a, b = port_frame(got), local
    if sort:
        a = a.sort_values(sort).reset_index(drop=True)
        b = b.sort_values(sort).reset_index(drop=True)
    pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True),
                                  check_dtype=False)


@pytest.mark.parametrize("props", [{}, REPARTITION], ids=["default", "repartition"])
@pytest.mark.parametrize("name", sorted(JOIN_QUERIES))
def test_join_kind_equals_reference_and_local(conns, name, props):
    sql = JOIN_QUERIES[name]
    got, want, moves = run_both(conns, sql, props=props)
    close_frame(got, want, name)
    same_values(got, local_frame(conns, sql))
    if props and any(k.startswith("join.distribution.") for k in moves):
        # a replicated side (an aggregated subquery) still broadcasts
        assert moves["join.distribution.repartition"] >= 1, moves
    assert not any(k.startswith("exec.pallas_join_route") for k in moves)


def test_full_outer_row_level(conns):
    """The no-order customers appear once each, with NULL order columns."""
    sql = ("select c_custkey, o_orderkey from customer "
           "full outer join orders on c_custkey = o_custkey")
    for props in ({}, REPARTITION):
        got, want, _ = run_both(conns, sql, props=props)
        close_frame(got, want, "full")
        same_values(got, local_frame(conns, sql), sort=["c_custkey", "o_orderkey"])
        frame = port_frame(got)
        lonely = frame[frame["o_orderkey"].isna()]["c_custkey"]
        assert len(lonely) > 0 and lonely.is_unique


def test_plan_proven_broadcast(conns):
    """The fragmenter's sound bound proves the build small: broadcast
    without the live-count readback."""
    got, want, moves = run_both(conns, Q3ISH)
    close_frame(got, want, "q3ish")
    assert moves["join.distribution.broadcast"] == 1
    same_values(got, local_frame(conns, Q3ISH))


def test_mesh_probes_pass_no_fused_spec(conns, monkeypatch):
    """The mesh builds never carry a fused-probe spec (the JAX package's
    Pallas probes do not partition): ``exec.pallas_join_route`` stays 0
    where the one-device session takes the fused route."""
    from presto_tpu_torch.exec import joins

    specs = []
    real = joins.JoinBuildOperator.__init__

    def spy(self, key, *a, **k):
        specs.append(k.get("pallas"))
        real(self, key, *a, **k)

    monkeypatch.setattr(joins.JoinBuildOperator, "__init__", spy)
    _js, ps = sessions(conns)
    before = PR.snapshot()
    ps.sql(QUERIES["q3"])
    assert specs and all(s is None for s in specs)
    assert PR.snapshot().get("exec.pallas_join_route", 0) == before.get(
        "exec.pallas_join_route", 0)


# ---------------------------------------------------------------------------
# adaptive salting: a recurring hot destination
# ---------------------------------------------------------------------------

SALT_Q = ("select k, dv, count(*) c, sum(v) sv from probe "
          "join dim on k = dk group by k, dv order by k, dv")


def _zipf_tables(rows=4096, seed=7):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(rows) < 0.85, 7, rng.integers(0, 64, rows))
    probe = pd.DataFrame({"k": keys.astype(np.float64), "v": rng.integers(0, 100, rows)})
    dim = pd.DataFrame({"dk": np.arange(64, dtype=np.int64), "dv": np.arange(64, dtype=np.int64)})
    return probe, dim


def test_salted_repartition_join_after_a_hot_destination(conns, monkeypatch):
    """``tests/test_adaptive.py``'s zipfian stream on a repartitioned
    join: after the hot destination recurs in the plan-stats history the
    port salts as the JAX package does (``adaptive.salted``, EXPLAIN's
    ``repartition=salted(S)``), and every run's rows equal the unsalted
    run's and the reference's."""
    monkeypatch.setattr("presto_tpu.plan.adaptive.predicted_compile_cost", lambda kind: 0.0)
    monkeypatch.setattr("presto_tpu_torch.plan.adaptive.predicted_compile_cost",
                        lambda kind: 0.0)
    probe, dim = _zipf_tables()
    js, ps = sessions(conns, n=4, props=REPARTITION)
    for s, arrays in ((js, lambda f: f), (ps, lambda f: {c: f[c].to_numpy() for c in f})):
        mem = s.catalog.connector("memory")
        mem.create_table("probe", arrays(probe))
        mem.create_table("dim", arrays(dim))
    for i in range(4):
        bj, bp = JR.snapshot(), PR.snapshot()
        want, _ = js.execute(SALT_Q)
        jm = _moves(JR, bj)
        got, _ = ps.execute(SALT_Q)
        pm = _moves(PR, bp)
        assert pm == jm, i
        close_frame(got, want, f"run {i}")
    assert pm.get("adaptive.salted", 0) == 1
    assert "repartition=salted(" in ps.explain(SALT_Q)
    assert ps.explain(SALT_Q) == js.explain(SALT_Q)


# ---------------------------------------------------------------------------
# the eight-shard twins (slow, as the JAX package marks them)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(JOIN_QUERIES))
def test_join_kind_on_eight_shards(conns, name):
    for props in ({}, REPARTITION):
        got, want, _ = run_both(conns, JOIN_QUERIES[name], n=8, props=props)
        close_frame(got, want, name)


def test_chip_smoke_phase24_on_the_cpu():
    """Phase 24 at sf 0.01 on four CPU shards: every answer against numpy
    and the one-device session, the repartition, grouped and window
    exchanges, the degraded Q3, and no fused probe on the mesh."""
    import chip_smoke

    out = chip_smoke.run_mesh_join_queries(PT(sf=0.01, device="cpu"), device="cpu")
    assert set(out["walls"]) == set(chip_smoke.MESH_JOIN_SQL)
    c = out["counters"]
    assert c["q3 repartition"]["join.distribution.repartition"] >= 1
    assert c["q3 degraded"]["query.degraded_to_local"] == 1
    assert [n for n, _ms in out["exchange_ms"]["window"]] == ["exchange:window"]
    # no CUDA kernel on the CPU
    assert out["probe_err"] == {"exists": 0, "payload": 0}
