"""The string-predicate slice through SQL: TPC-H Q9 and SSB ``q_like_part``
and ``q_like_phone`` in the port against the JAX package, on the CPU.

- at sf 0.01 each query, in a session holding only its own connector,
  gives the JAX package's DataFrame exactly (values and dtypes), with the
  same join, aggregation and leaf-route counters;
- the LIKE wrapper runs once per split of the filtered table (several
  splits here), and counts no launch on the CPU;
- the plan trees and the planned join and aggregation strategies equal
  the reference's at sf 0.01 and at SF1 (plans only);
- the ``starts_with`` pipeline over ``part`` (``workloads.part_name_pipeline``)
  equals the JAX package's scan -> FilterProject, and equals
  ``p_name like 'forest%'``;
- the multi-key packing equals ``presto_tpu.exec.joinkeys.join_key_exprs``
  (stats widths and the runtime min/max rung, the latter also end to end
  through the executor); keys that cannot pack raise ``NotSupported``
  (ROADMAP C10);
- ``chip_smoke.py``'s numpy recomputations (the card's oracles) equal the
  port here;
- more statements over the new constructs (NOT LIKE, SUBSTRING, EXTRACT,
  derived tables, NOT, NOT BETWEEN, a LIKE on a dictionary column) equal
  the JAX package's frames.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import presto_tpu.expr as JE
import presto_tpu.types as JT
import presto_tpu_torch.expr as PE
import presto_tpu_torch.types as PT
from presto_tpu.connectors.ssb import SsbConnector as JSsb
from presto_tpu.connectors.ssb.queries import QUERIES as SSB
from presto_tpu.connectors.tpch import TpchConnector as JTpch
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.exec.joinkeys import join_key_exprs as j_join_key_exprs
from presto_tpu.exec.leaf_route import agg_strategy_for as j_agg_strategy
from presto_tpu.exec.operators import FilterProjectOperator as JFilterProject
from presto_tpu.exec.pipeline import Pipeline as JPipeline
from presto_tpu.exec.pipeline import ScanSource as JScanSource
from presto_tpu.plan import nodes as JN
from presto_tpu.plan.bounds import agg_value_bits as j_value_bits
from presto_tpu.plan.joinfilters import planned_join_strategy as j_join_strategy
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.ssb import SsbConnector as PSsb
from presto_tpu_torch.connectors.tpch import TpchConnector as PTpch
from presto_tpu_torch.exec.joinkeys import join_key_exprs as p_join_key_exprs
from presto_tpu_torch.exec.leaf_route import agg_strategy_for as p_agg_strategy
from presto_tpu_torch.exec.local_planner import planned_join_strategy as p_join_strategy
from presto_tpu_torch.ops import cuda_strings
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.plan.bounds import agg_value_bits as p_value_bits
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.workloads import part_name_pipeline
from test_torch_sql import ast_shape, plan_shape
from torch_bridge import counters, mark_counters

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SF = 0.01
#: query -> (connector key, SQL, the table its LIKE filters)
QUERY_SET = {
    "q9": ("tpch", QUERIES["q9"], "part"),
    "ssb q_like_part": ("ssb", SSB["q_like_part"], "part"),
    "ssb q_like_phone": ("ssb", SSB["q_like_phone"], "customer"),
}
ROUTE_PREFIXES = ("join.strategy.", "exec.pallas_join_route", "exec.leaf_fused_route",
                  "exec.leaf_route_fallback", "agg.strategy.", "join.pallas_fallback")
JAX = {"tpch": JTpch, "ssb": JSsb}
PORT = {"tpch": PTpch, "ssb": PSsb}


def routes(counts) -> dict:
    return {k: v for k, v in counts.items() if k.startswith(ROUTE_PREFIXES) and v}


@pytest.fixture(scope="module")
def conns():
    return {k: (JAX[k](sf=SF), PORT[k](sf=SF, device="cpu")) for k in JAX}


@pytest.mark.parametrize("q", list(QUERY_SET))
def test_query_equals_jax_session(conns, q):
    key, sql, _ = QUERY_SET[q]
    before = REGISTRY.snapshot()
    want = JSession({key: conns[key][0]}, properties={"result_cache_enabled": False}).sql(sql)
    after = REGISTRY.snapshot()
    want_routes = routes({k: after.get(k, 0) - before.get(k, 0) for k in after})
    mark_counters()
    res = PSession({key: conns[key][1]}, device="cpu").sql(sql)
    got = pd.DataFrame(res.to_dict())
    assert len(want) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes(counters()) == want_routes


@pytest.mark.parametrize("q", list(QUERY_SET))
def test_like_runs_once_per_split_of_the_filtered_table(q):
    key, sql, table = QUERY_SET[q]
    conn = PORT[key](sf=SF, units_per_split=1 << 9, device="cpu")
    splits = len(conn.splits(table))
    assert splits > 1
    calls = []
    original = cuda_strings.like_mask

    def spy(data, pattern):
        calls.append((tuple(data.shape), pattern))
        return original(data, pattern)

    launches = cuda_strings.like_launches
    cuda_strings.like_mask = spy
    try:
        PSession({key: conn}, device="cpu").sql(sql)
    finally:
        cuda_strings.like_mask = original
    assert len(calls) == splits
    assert {c[1] for c in calls} == {{"q9": "%green%", "ssb q_like_part": "%sky%",
                                      "ssb q_like_phone": "Customer%1"}[q]}
    assert cuda_strings.like_launches == launches  # the plain version: no launch


@pytest.mark.parametrize("sf", [0.01, 1])
@pytest.mark.parametrize("q", list(QUERY_SET))
def test_plans_equal_reference(q, sf):
    key, sql, _ = QUERY_SET[q]
    js = JSession({key: JAX[key](sf=sf)})
    ps = PSession({key: PORT[key](sf=sf, device="cpu")}, device="cpu")
    jplan, pplan = js.plan(sql), ps.plan(sql)
    assert isinstance(pplan, PN.Output) and isinstance(jplan, JN.Output)
    want = plan_shape(jplan, js.catalog, j_join_strategy, j_agg_strategy, j_value_bits)
    got = plan_shape(pplan, ps.catalog, p_join_strategy, p_agg_strategy, p_value_bits)
    assert got == want


def _jax_part_pipeline(conn, fn: str, pattern: str):
    pred = JE.Call(JT.BOOLEAN, fn, (JE.col("p_name", JT.fixed_bytes(55)),
                                    JE.lit(pattern, JT.varchar())))
    proj = {"p_partkey": JE.col("p_partkey", JT.BIGINT)}
    return JPipeline(JScanSource(conn, "part", ["p_partkey", "p_name"]),
                     [JFilterProject(pred, proj)])


def test_starts_with_pipeline_equals_jax_filterproject():
    jconn = JTpch(sf=SF, units_per_split=1 << 10)
    pconn = PTpch(sf=SF, units_per_split=1 << 10, device="cpu")
    want = _jax_part_pipeline(jconn, "starts_with", "forest").run()
    got = part_name_pipeline(pconn, "starts_with", "forest").run()
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.live.numpy(), np.asarray(w.live))
        np.testing.assert_array_equal(g["p_partkey"].data.numpy(), np.asarray(w["p_partkey"].data))
    keys = chip_smoke.pipeline_keys(part_name_pipeline(pconn, "starts_with", "forest"))
    assert keys.size > 0
    np.testing.assert_array_equal(
        keys, chip_smoke.pipeline_keys(part_name_pipeline(pconn, "like", "forest%")))
    np.testing.assert_array_equal(keys, chip_smoke.prefix_rows_expected(pconn, "forest"))


def _two_key_join(plan):
    out = []

    def walk(n):
        if type(n).__name__ == "Join" and len(n.right_keys) > 1:
            out.append(n)
        for c in n.children:
            walk(c)

    walk(plan)
    assert len(out) == 1
    return out[0]


@pytest.mark.parametrize("sf", [0.01, 1])
def test_multi_key_packing_equals_reference(sf):
    """Q9's partsupp join: both keys pack by their stats widths into the
    same int64 expression tree as the reference's."""
    js = JSession({"tpch": JTpch(sf=sf)})
    ps = PSession({"tpch": PTpch(sf=sf, device="cpu")}, device="cpu")
    jn, pn = _two_key_join(js.plan(QUERIES["q9"])), _two_key_join(ps.plan(QUERIES["q9"]))

    def no_runtime(side, key):
        raise AssertionError("stats widths must suffice")

    want = j_join_key_exprs(jn.left_keys, jn.right_keys, {}, catalog=js.catalog,
                            lnode=jn.left, rnode=jn.right, runtime_minmax=no_runtime)
    got = p_join_key_exprs(pn.left_keys, pn.right_keys, catalog=ps.catalog,
                           lnode=pn.left, rnode=pn.right, runtime_minmax=no_runtime)
    assert ast_shape(got[0]) == ast_shape(want[0])
    assert ast_shape(got[1]) == ast_shape(want[1])
    assert got[2] == [] and want[2] == []
    assert got[0].fn == "add" and p_join_strategy(pn, ps.catalog) == "unique"


def _scan_pair(key_names):
    """A TableScan of nation in each package, and keys that name columns
    the scan does not carry (no stats interval: the runtime rung)."""
    jn = JN.TableScan("tpch", "nation", (("n_nationkey", "n_nationkey"),), (JT.BIGINT,))
    pn = PN.TableScan("tpch", "nation", (("n_nationkey", "n_nationkey"),), (PT.BIGINT,))
    jk = [JE.col(k, JT.BIGINT) for k in key_names]
    pk = [PE.col(k, PT.BIGINT) for k in key_names]
    return jn, pn, jk, pk


@pytest.mark.parametrize("minmax", [((0, 100), (0, 5000)), ((0, 1), (3, 7)),
                                    ((2, 2**40), (0, 2**20))],
                         ids=["small", "tiny", "wide"])
def test_multi_key_runtime_rung_equals_reference(conns, minmax):
    """Keys without stats intervals take their pack widths from the
    runtime min/max, in both packages alike."""
    jn, pn, jk, pk = _scan_pair(["k0", "k1"])

    def stub(side, key):
        return minmax[["k0", "k1"].index(key.name)]

    jcat = JSession({"tpch": conns["tpch"][0]}).catalog
    pcat = PSession({"tpch": conns["tpch"][1]}, device="cpu").catalog
    want = j_join_key_exprs(jk, jk, {}, catalog=jcat, lnode=jn, rnode=jn, runtime_minmax=stub)
    got = p_join_key_exprs(pk, pk, catalog=pcat, lnode=pn, rnode=pn, runtime_minmax=stub)
    assert ast_shape(got[0]) == ast_shape(want[0]) and ast_shape(got[1]) == ast_shape(want[1])


def test_two_key_join_without_stats_widths_reads_them_at_run_time(conns, monkeypatch):
    """Count keys have no stats interval: the executor reads each side's
    min/max over its live rows, packs by those widths, and the frame
    equals the JAX package's."""
    import presto_tpu_torch.exec.local_planner as lp

    read = []

    def spy(*args, runtime_minmax, **kw):
        def minmax(side, key):
            read.append((side, runtime_minmax(side, key)))
            return read[-1][1]

        return p_join_key_exprs(*args, runtime_minmax=minmax, **kw)

    monkeypatch.setattr(lp, "join_key_exprs", spy)
    sql = ("select count(*) as n, sum(a.c) as s from "
           "(select l_orderkey as k, count(*) as c from lineitem group by l_orderkey) a, "
           "(select o_orderkey as k2, count(*) as c2 from orders group by o_orderkey) b "
           "where a.k = b.k2 and a.c = b.c2")
    want = JSession({"tpch": conns["tpch"][0]}, properties={"result_cache_enabled": False}).sql(sql)
    res = PSession({"tpch": conns["tpch"][1]}, device="cpu").sql(sql)
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert int(want["n"][0]) > 0
    assert sorted(read) == [(0, (0, 7)), (1, (0, 1))]


def test_keys_that_cannot_pack_raise(conns):
    """A negative key (or widths over 63 bits) makes both packages mix
    the keys into a 63-bit hash with a verify pair per key: the same
    expressions and the same pairs (the C10 pin, lifted: the port used
    to refuse here)."""
    jn, pn, jk, pk = _scan_pair(["k0", "k1"])
    pcat = PSession({"tpch": conns["tpch"][1]}, device="cpu").catalog
    jcat = JSession({"tpch": conns["tpch"][0]}).catalog
    for stub in (lambda side, key: (-1, 10), lambda side, key: (0, 2**40)):
        want = j_join_key_exprs(jk, jk, {}, catalog=jcat, lnode=jn, rnode=jn,
                                runtime_minmax=stub)
        got = p_join_key_exprs(pk, pk, catalog=pcat, lnode=pn, rnode=pn, runtime_minmax=stub)
        assert want[0].fn == "hash63_mix" and len(want[2]) == 2
        assert [ast_shape(e) for e in got[:2]] == [ast_shape(e) for e in want[:2]]
        assert ast_shape(got[2]) == ast_shape(want[2])


ORACLES = {"q9": "q9_expected", "ssb q_like_part": "like_part_expected",
           "ssb q_like_phone": "like_phone_expected"}


@pytest.mark.parametrize("q", list(QUERY_SET))
def test_chip_oracle_equals_the_port(conns, q):
    key, sql, _ = QUERY_SET[q]
    conn = conns[key][1]
    want = getattr(chip_smoke, ORACLES[q])(conn)
    res = PSession({key: conn}, device="cpu").sql(sql)
    chip_smoke.same_result(res, want, q)


def test_chip_like_oracle_equals_the_plain_version(conns):
    """Phase 2's ``re`` oracle equals the plain LIKE on every LIKE
    pattern of the query sets over its own column (sf 0.01 here)."""
    for name, key, table, column, patterns, prefixes in chip_smoke.SF1_STRING_COLUMNS:
        rows = chip_smoke.column_rows(conns[key][1], table, column)
        texts = chip_smoke._text(rows)
        for p in patterns:
            got = cuda_strings.like_mask(torch.from_numpy(rows), p)
            np.testing.assert_array_equal(got.numpy(), chip_smoke.like_oracle(texts, p),
                                          err_msg=f"{name} {p}")
        for p in prefixes:
            got = cuda_strings.starts_with_mask(torch.from_numpy(rows), p)
            np.testing.assert_array_equal(got.numpy(), [t.startswith(p) for t in texts])


ADHOC = [
    ("tpch", "select count(*) as n from part where p_name not like '%green%'"),
    ("tpch", "select p_partkey, substring(p_name, 1, 6) as head from part "
             "where p_name like 'forest%' order by p_partkey limit 5"),
    ("tpch", "select extract(month from o_orderdate) as m, count(*) as n from orders "
             "where not (o_orderdate < date '1995-01-01') group by extract(month from o_orderdate) "
             "order by m"),
    ("tpch", "select y, count(*) as n from (select year(o_orderdate) as y from orders "
             "where o_orderdate not between date '1993-01-01' and date '1996-12-31') t "
             "group by y order by y"),
    ("tpch", "select n_name, count(*) as n from nation, supplier where n_nationkey = s_nationkey "
             "and n_name like '%AN%' and s_comment like '%ly%ly%' group by n_name "
             "order by n_name"),
    ("tpch", "select count(*) as n from customer where substr(c_phone, 1, 2) <> '13' "
             "and c_name like 'Customer#0000001%'"),
    ("ssb", "select c_city, count(*) as n from customer where c_name like 'Customer%9' "
            "and day(date '1995-03-04') = 4 group by c_city order by n desc, c_city limit 4"),
]


@pytest.mark.parametrize("i", range(len(ADHOC)))
def test_more_statements_equal_jax(conns, i):
    key, sql = ADHOC[i]
    want = JSession({key: conns[key][0]}, properties={"result_cache_enabled": False}).sql(sql)
    res = PSession({key: conns[key][1]}, device="cpu").sql(sql)
    assert len(want) > 0
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
