"""Distributed joins over TPC-H and the grouped tier: TPC-H Q3, Q5 and
Q10 and a semi and an anti join at sf 0.002 on 1, 2 and 4 shards,
``tests/test_distributed.py``'s repartition join path
(``broadcast_join_row_limit=0``), and under a ``join_build_budget_bytes``
below every relation the grouped (bucketed) joins and aggregations of
``tests/test_distributed_grouped.py``, each against the JAX package's
mesh session (frames, row order, dtypes; ``join.distribution.*``,
``exchange.*`` and ``spill.*`` counter moves; exchange spans) and the
port's one-device session. The eight-shard twins and every TPC-H query
on eight shards run under ``-m slow``.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from presto_tpu.connectors.tpch.queries import QUERIES  # noqa: E402
from test_torch_distributed_joins import (  # noqa: E402
    REPARTITION,
    close_frame,
    conns,  # noqa: F401 - the module fixture
    local_frame,
    run_both,
    same_values,
    sessions,
)

#: far below every relation at sf 0.002: every join and aggregation goes
#: through the grouped tier (``tests/test_distributed_grouped.py``)
TINY_BUDGET = 512


SEMI_ANTI = {
    # builds over a filtered scan stay sharded, so the joins run (a
    # count(*) semi join folds into the leaf route's membership test)
    "semi": "select o_orderkey, o_totalprice from orders where o_orderkey in "
            "(select l_orderkey from lineitem where l_quantity > 45) order by o_orderkey",
    "anti": "select o_orderkey, o_custkey from orders where o_orderkey not in "
            "(select l_orderkey from lineitem where l_quantity > 5) order by o_orderkey",
}


#: (statement, shards): the semi join on 1, 2 and 4 shards, Q3 on 2 and
#: 4, Q5, Q10 and the anti join on 4 in the fast tier; the rest slow
SHARD_CASES = ([("semi", n) for n in (1, 2, 4)] + [("q3", n) for n in (2, 4)]
               + [(q, 4) for q in ("q5", "q10", "anti")]
               + [pytest.param(q, n, marks=pytest.mark.slow)
                  for q, n in (("q3", 1), ("q5", 1), ("q5", 2), ("q10", 1), ("q10", 2),
                               ("anti", 1), ("anti", 2))])


@pytest.mark.parametrize("name,n", SHARD_CASES)
def test_tpch_joins_on_1_2_and_4_shards(conns, name, n):
    sql = QUERIES[name] if name in QUERIES else SEMI_ANTI[name]
    got, want, _ = run_both(conns, sql, n=n)
    close_frame(got, want, f"{name} on {n}")


@pytest.mark.parametrize("name", ["q3", "semi", "anti",
                                  pytest.param("q10", marks=pytest.mark.slow)])
def test_repartition_join_path(conns, name):
    """``test_distributed.py::test_repartition_join_path``'s switch:
    every join exchanges both sides."""
    sql = QUERIES[name] if name in QUERIES else SEMI_ANTI[name]
    got, want, moves = run_both(conns, sql, props=REPARTITION)
    close_frame(got, want, name)
    if name in QUERIES:  # a semi join counts no distribution, in both packages
        assert moves["join.distribution.repartition"] >= 1
    assert moves["exchange.rows.join.probe"] > 0 and moves["exchange.rows.join.build"] > 0


GROUPED = {
    "inner_unique": "select count(*) c, sum(o_totalprice) s, count(c_acctbal) a "
                    "from orders join customer on o_custkey = c_custkey",
    "left_expand": "select count(*) c, count(l_orderkey) lk from orders "
                   "left join lineitem on o_orderkey = l_orderkey and l_quantity > 45",
    "full_outer": "select count(*) c, count(c_custkey) ck, count(o_orderkey) ok "
                  "from customer full outer join orders on c_custkey = o_custkey",
    "semi": SEMI_ANTI["semi"],
    "anti": SEMI_ANTI["anti"],
    "join_then_agg": "select o_orderdate, count(*) n from orders "
                     "join lineitem on o_orderkey = l_orderkey "
                     "group by o_orderdate order by o_orderdate limit 20",
}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_tier_equals_reference_and_local(conns, name):
    """Under a budget below every relation both sides spill to host RAM
    and the repartition join replays bucket by bucket: the spill counters
    (``spill.planned_*``, ``spill.partitions_*``, ``spill.transfer_bytes``)
    and the rows are the JAX package's."""
    sql = GROUPED[name]
    props = {"join_build_budget_bytes": TINY_BUDGET}
    got, want, moves = run_both(conns, sql, props=props)
    close_frame(got, want, name)
    same_values(got, local_frame(conns, sql))
    assert any(k.startswith("spill.planned_") for k in moves), moves
    assert moves.get("join.distribution.grouped", 0) + \
        moves.get("join.distribution.hybrid", 0) >= 1, moves


def test_grouped_full_outer_row_level(conns):
    sql = ("select c_custkey, o_orderkey from customer "
           "full outer join orders on c_custkey = o_custkey")
    got, want, _ = run_both(conns, sql, props={"join_build_budget_bytes": TINY_BUDGET})
    close_frame(got, want, "grouped full")
    same_values(got, local_frame(conns, sql), sort=["c_custkey", "o_orderkey"])


def test_grouped_tier_engages(conns, monkeypatch):
    """The tiny budget routes through ``_grouped_dist_join`` and
    ``_grouped_dist_agg`` (the trigger never silently stays off)."""
    from presto_tpu_torch.exec.distributed import DistributedExecutor

    calls = {"join": 0, "agg": 0}
    orig_join = DistributedExecutor._grouped_dist_join
    orig_agg = DistributedExecutor._grouped_dist_agg

    def spy_join(self, *a, **k):
        calls["join"] += 1
        return orig_join(self, *a, **k)

    def spy_agg(self, *a, **k):
        calls["agg"] += 1
        return orig_agg(self, *a, **k)

    monkeypatch.setattr(DistributedExecutor, "_grouped_dist_join", spy_join)
    monkeypatch.setattr(DistributedExecutor, "_grouped_dist_agg", spy_agg)
    _js, ps = sessions(conns, props={"join_build_budget_bytes": TINY_BUDGET})
    ps.sql(GROUPED["inner_unique"])
    ps.sql("select l_orderkey, count(*) n, sum(l_quantity) q from lineitem "
           "group by l_orderkey order by l_orderkey limit 50")
    assert calls["join"] >= 1 and calls["agg"] >= 1




# ---------------------------------------------------------------------------
# the eight-shard twins (slow, as the JAX package marks them)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(QUERIES, key=lambda q: int(q[1:])))
def test_every_tpch_query_on_eight_shards(conns, name):
    for props in ({}, REPARTITION):
        got, want, _ = run_both(conns, QUERIES[name], n=8, props=props)
        close_frame(got, want, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_tier_on_eight_shards(conns, name):
    got, want, _ = run_both(conns, GROUPED[name], n=8,
                            props={"join_build_budget_bytes": TINY_BUDGET})
    close_frame(got, want, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["q3", "q7", "q98", "q33", "q36", "q38", "q97", "q10",
                                  "q16", "q76", "q22", "q28", "q47", "q95"])
def test_tpcds_distributed_matches_oracle(name):
    """``tests/test_tpcds_sql.py::test_tpcds_distributed_matches_oracle``:
    the port's eight-shard mesh session against the JAX package's pandas
    oracle at sf 0.02 (star joins, NULL-key joins, FULL OUTER, mark
    joins, windows over aggregates, UNION ALL, INTERSECT, rollups)."""
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.parallel.mesh import make_mesh
    from presto_tpu_torch.runtime.session import Session as PSession
    from torch_bridge import TPCDS_SF, TPCDS_UNITS, check_tpcds_query, tpcds_oracle_env

    _local, tables = tpcds_oracle_env()
    conn = TpcdsConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS, device="cpu")
    mesh = PSession({"tpcds": conn}, device="cpu", mesh=make_mesh(8, device="cpu"))
    check_tpcds_query((mesh, tables), name)
