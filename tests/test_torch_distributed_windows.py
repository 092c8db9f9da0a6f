"""Distributed windows: the port's mesh session (``exec/distributed.py``'s
partitioned window over the exchange on the partition keys' hash, and the
replicated window under its gather guard) against the JAX package's
``Session(mesh=...)`` on its virtual CPU devices.

Cases: ``tests/test_distributed.py``'s partition-parallel window under a
gather guard far below the table (flat mesh) and its DCN-mesh twin, the
unpartitioned window's gather-guard refusal in the JAX package's words
and its small-input pass, window statements over NULL, wide-string and
BYTES partition keys on 1, 2 and 4 shards, and a window over a join.
Frames compare rows in order, dtypes and the counter moves and exchange
spans (``test_torch_distributed_joins.run_both``).
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from presto_tpu.connectors.tpch import TpchConnector as JT  # noqa: E402
from presto_tpu.parallel.mesh import make_dcn_mesh as jdcn  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PT  # noqa: E402
from presto_tpu_torch.parallel.mesh import make_dcn_mesh  # noqa: E402
from test_torch_distributed_joins import (  # noqa: E402
    close_frame,
    local_frame,
    run_both,
    same_values,
    sessions,
)
from torch_bridge import port_frame, refused_alike  # noqa: E402

SF = 0.005
UNITS = 1 << 14
#: a gather guard far below the table: only the partitioned window passes
GUARD = {"gather_row_limit": 1024}

PARTITIONED = ("select l_orderkey, l_linenumber, "
               "sum(l_quantity) over (partition by l_orderkey) as order_qty, "
               "row_number() over (partition by l_orderkey order by l_linenumber) as rn "
               "from lineitem")
WINDOWS = {
    "rank_by_customer": "select o_custkey, o_orderkey, o_orderdate, row_number() over "
                        "(partition by o_custkey order by o_orderdate, o_orderkey) as r "
                        "from orders",
    # a wide CHAR partition key (its 7-byte chunks) and a running sum
    "wide_string_key": "select c_mktsegment, c_custkey, sum(c_acctbal) over "
                       "(partition by c_mktsegment order by c_custkey) as run from customer",
    # NULL partition keys form one partition
    "null_keys": "select o_orderkey, rank() over (partition by case when o_orderkey % 3 = 0 "
                 "then null else o_orderstatus end order by o_totalprice) as r from orders",
    "lag_lead": "select l_orderkey, l_linenumber, lag(l_extendedprice, 1) over "
                "(partition by l_orderkey order by l_linenumber) as prev, "
                "lead(l_quantity, 1) over (partition by l_orderkey order by l_linenumber) "
                "as next from lineitem",
    # ``tests/test_window.py::test_window_distributed_matches_local``
    "nation_rank": "select n_name, n_regionkey, rank() over (partition by n_regionkey "
                   "order by n_name) as rk from nation",
    "over_a_join": "select n_name, c_custkey, dense_rank() over (partition by n_name "
                   "order by c_acctbal desc) as d from customer join nation "
                   "on c_nationkey = n_nationkey",
}


@pytest.fixture(scope="module")
def conns():
    return JT(sf=SF, units_per_split=UNITS), PT(sf=SF, units_per_split=UNITS, device="cpu")


def test_partitioned_window_without_replication(conns):
    """``test_distributed.py::test_distributed_window_partition_parallel``:
    under a gather guard of 1024 rows only the exchange on the partition
    keys can pass; the rows and their order are the JAX package's."""
    got, want, moves = run_both(conns, PARTITIONED, props=GUARD)
    close_frame(got, want, "window")
    assert moves["exchange.dispatches"] >= 1
    same_values(got, local_frame(conns, PARTITIONED),
                sort=["l_orderkey", "l_linenumber"])


def test_dcn_mesh_window_partition_parallel(conns):
    """``test_distributed.py::test_dcn_mesh_window_partition_parallel``:
    the 2-D mesh gives the JAX package's rows and equals the flat mesh."""
    sql = ("select l_orderkey, sum(l_quantity) over (partition by l_orderkey) q "
           "from lineitem")
    got, want, _ = run_both(conns, sql, props=GUARD, jm=jdcn(2, 2),
                            pm=make_dcn_mesh(2, 2, device="cpu"))
    close_frame(got, want, "dcn window")
    flat, _w, _m = run_both(conns, sql, props=GUARD)
    close_frame(flat, want, "flat window")


def test_unpartitioned_window_gather_guard(conns):
    """``test_distributed.py::test_gather_fallback_guard``: a window with
    no PARTITION BY replicates, past ``gather_row_limit`` it is refused in
    the JAX package's words, and a small input passes."""
    js, ps = sessions(conns, props={"gather_row_limit": 16})
    err = refused_alike(
        lambda: js.sql("select l_orderkey, row_number() over (order by l_orderkey) rn "
                       "from lineitem"),
        lambda: ps.sql("select l_orderkey, row_number() over (order by l_orderkey) rn "
                       "from lineitem"))
    assert "gather_limit=16" in str(err)
    small = "select r_name, row_number() over (order by r_name) rn from region"
    got, want, _ = run_both(conns, small, props={"gather_row_limit": 16})
    close_frame(got, want, "small")
    assert len(port_frame(got)) == 5


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_window_statements_on_1_2_and_4_shards(conns, name, n):
    got, want, _ = run_both(conns, WINDOWS[name], n=n)
    close_frame(got, want, f"{name} on {n}")


def test_partitioned_window_values_against_numpy(conns):
    """The per-order sums and row numbers against numpy over the
    reference connector's decoded table."""
    jc, _pc = conns
    got = port_frame(run_both(conns, PARTITIONED, props=GUARD)[0])
    li = jc.table_pandas("lineitem")
    order = np.lexsort((li["l_linenumber"].to_numpy(), li["l_orderkey"].to_numpy()))
    keys = li["l_orderkey"].to_numpy()[order]
    qty = li["l_quantity"].to_numpy()[order]
    starts = np.r_[True, keys[1:] != keys[:-1]]
    seg = np.cumsum(starts) - 1
    sums = np.bincount(seg, weights=qty)[seg]
    rn = np.arange(len(keys)) - np.flatnonzero(starts)[seg] + 1
    g = got.sort_values(["l_orderkey", "l_linenumber"]).reset_index(drop=True)
    np.testing.assert_allclose(g["order_qty"].to_numpy(dtype=float), sums, rtol=1e-9)
    np.testing.assert_array_equal(g["rn"].to_numpy(), rn)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_window_statements_on_eight_shards(conns, name):
    got, want, _ = run_both(conns, WINDOWS[name], n=8)
    close_frame(got, want, name)
