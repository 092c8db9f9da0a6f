"""The port's memory connector and DDL against the JAX package's.

- CREATE TABLE AS / INSERT INTO / DROP TABLE through both packages'
  ``Session.sql`` at sf 0.01 (``tests/test_memory.py``'s cases but the
  distributed and memory-pool ones): every answer equal, every refusal
  the same error class and words;
- the CTAS cases of ``tests/test_leaf_route.py`` (a CTAS table's group-by
  takes the fused leaf route; a NULL-bearing column never routes, and
  stats that lie about its NULLs trip the runtime guard; the bypass
  estimate of a near-unique key) and ``tests/test_narrowing.py``'s
  memory-connector narrowing, with the route counters equal;
- the type inference: one CTAS per type (BIGINT, INTEGER, DOUBLE,
  DECIMAL, DATE, BOOLEAN, VARCHAR, BYTES, all-NULL), each with and
  without NULLs, and over results of several batches (NULLs in some
  batches only; an all-NULL batch beside dated ones), each stored entry
  (types, arrays, masks, dictionaries, ColumnStats, rows) equal to what
  the reference's connector stores from the reference's frame of the same
  statement, and the INSERT of the same rows merged equal too.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

from presto_tpu.connectors.memory import MemoryConnector as JMemory
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.memory import MemoryConnector as PMemory
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import ROUTES, counters, mark_counters, port_frame, port_type

SF = 0.01


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture()
def sessions(conns):
    props = {"result_cache_enabled": False}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def routes_of(before: dict) -> dict:
    after = REGISTRY.snapshot()
    return {k: int(after[k] - before.get(k, 0)) for k in after
            if k.startswith(ROUTES) and after[k] != before.get(k, 0)}


def both(sessions, sql: str, check_routes: bool = True):
    """Run ``sql`` through both sessions: frames (and route counters)
    equal; returns the reference's frame."""
    js, ps = sessions
    before = REGISTRY.snapshot()
    want = js.sql(sql)
    want_routes = routes_of(before)
    mark_counters()
    got = port_frame(ps.sql(sql))
    pd.testing.assert_frame_equal(got, want)
    if check_routes:
        assert {k: v for k, v in counters().items() if k.startswith(ROUTES) and v} \
            == want_routes, sql
    return want


def refused_alike(sessions, sql: str, match: str):
    js, ps = sessions
    with pytest.raises(Exception, match=match) as jerr:
        js.sql(sql)
    with pytest.raises(Exception, match=match) as perr:
        ps.sql(sql)
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# tests/test_memory.py
# ---------------------------------------------------------------------------


def test_ctas_roundtrip_and_join_back(sessions):
    r = both(sessions, "create table flag_counts as select l_returnflag f, count(*) c "
                       "from lineitem group by l_returnflag")
    assert int(r["rows"][0]) == 3
    both(sessions, "select f, c from flag_counts order by f")
    both(sessions, "select f, c from flag_counts where c > 0 order by c desc limit 1")
    both(sessions, "select f, count(*) n from flag_counts join lineitem "
                   "on f = l_returnflag group by f order by f")


def test_insert_appends_atomically(sessions):
    both(sessions, "create table t as select 1 a, 2 b")
    both(sessions, "insert into t select 3 a, 4 b")
    both(sessions, "select a, b from t order by a")
    refused_alike(sessions, "insert into t select 5 a", "schema")
    assert len(both(sessions, "select * from t")) == 2


def test_drop_table(sessions):
    js, ps = sessions
    both(sessions, "create table gone as select 1 x")
    v = ps.catalog.version("gone")
    both(sessions, "drop table gone")
    assert ps.catalog.version("gone") == js.catalog.version("gone") == v + 1
    refused_alike(sessions, "select * from gone", "gone")
    both(sessions, "drop table if exists gone")
    refused_alike(sessions, "drop table gone", "not found")


def test_ctas_after_drop_resolves_the_new_schema(sessions):
    both(sessions, "create table re as select n_nationkey k from nation")
    both(sessions, "select k from re order by k")
    both(sessions, "drop table re")
    both(sessions, "create table re as select n_name nm, n_regionkey r from nation")
    both(sessions, "select nm, r from re order by nm")


def test_ctas_rejects_existing(sessions):
    both(sessions, "create table dup as select 1 x")
    refused_alike(sessions, "create table dup as select 2 x", "already exists")


def test_ddl_cannot_shadow_other_catalogs(sessions):
    refused_alike(sessions, "create table nation as select 1 x", "already exists")
    refused_alike(sessions, "insert into lineitem select 1 a", "read-only")
    refused_alike(sessions, "drop table nation", "read-only")


def test_fromless_select_and_string_literals(sessions):
    both(sessions, "select 'hello' z, 1 + 1 n")
    both(sessions, "select 'tag' t, n_name from nation order by n_name limit 2")


def test_insert_type_and_existence_guards(sessions):
    both(sessions, "create table typed as select 1 a, 2.5 x")
    both(sessions, "select x from typed")
    refused_alike(sessions, "insert into typed select 'str' a, 1.0 x", "type mismatch")
    both(sessions, "select a from typed")
    refused_alike(sessions, "insert into never_created select 1 z", "not found")


def test_catalog_version_bumps_once_per_write(sessions):
    js, ps = sessions
    seen = []
    ps.catalog.add_invalidation_listener(seen.append)
    for sql in ("create table v as select n_nationkey k from nation",
                "insert into v select n_nationkey k from nation where n_nationkey < 3",
                "drop table v"):
        both(sessions, sql)
        assert ps.catalog.version("v") == js.catalog.version("v")
    assert ps.catalog.version("v") == 3 and seen == ["v", "v", "v"]


def test_table_epochs_and_catalog_tokens_alike(sessions):
    """Each write bumps the memory connector's version epoch as the
    reference's does (a zero-row INSERT bumps nothing); each catalog
    keeps one token of its own."""
    js, ps = sessions
    jm, pm = js.catalog.connector("memory"), ps.catalog.connector("memory")
    for sql in ("create table e as select n_nationkey k from nation",
                "insert into e select n_nationkey k from nation where n_nationkey < 0",
                "insert into e select n_nationkey k from nation where n_nationkey < 3",
                "drop table e",
                "create table e as select n_regionkey k from nation"):
        both(sessions, sql)
        assert pm.table_epoch("e") == jm.table_epoch("e")
        assert pm.epochs() == jm.epochs()
    assert pm.table_epoch("never_written") == jm.table_epoch("never_written") == 0
    other = PSession({"tpch": ps.catalog.connector("tpch")}, device="cpu").catalog
    assert ps.catalog.cache_token() == ps.catalog.cache_token()
    assert other.cache_token() != ps.catalog.cache_token()


def test_nulls_and_strings_roundtrip():
    """The connector's direct API: one array a column."""
    cols = {"k": np.array([1, 2, 3]),
            "s": np.array(["apple", None, "banana"], dtype=object),
            "v": np.array([1.5, np.nan, 2.5]),
            "n": np.array([10, None, 30], dtype=object)}
    j, p = JMemory(), PMemory(device="cpu")
    j.create_table("t", pd.DataFrame(cols))
    p.create_table("t", cols)
    assert_same_entry(p, j, "t")
    want = JSession({"mem": j}).sql("select count(*) n, count(s) ns, count(n) nn from t")
    got = port_frame(PSession({"mem": p}, device="cpu").sql(
        "select count(*) n, count(s) ns, count(n) nn from t"))
    pd.testing.assert_frame_equal(got, want)
    assert got.iloc[0].tolist() == [3, 2, 2]


def test_double_stays_double_across_inserts():
    j, p = JMemory(), PMemory(device="cpu")
    j.create_table("d", pd.DataFrame({"x": [2.0, 4.0]}))
    p.create_table("d", {"x": np.array([2.0, 4.0])})
    j.insert("d", pd.DataFrame({"x": [1.5]}))
    p.insert("d", {"x": np.array([1.5])})
    assert_same_entry(p, j, "d")
    assert p.table_numpy("d")["x"].tolist() == [2.0, 4.0, 1.5]


# ---------------------------------------------------------------------------
# tests/test_leaf_route.py and tests/test_narrowing.py: CTAS tables route
# ---------------------------------------------------------------------------


def test_ctas_memory_table_routes(sessions):
    """A CTAS table's exact stats narrow its columns, so its group-by
    takes the fused leaf route (the leaf kernel), before and after an
    INSERT; ``narrow_storage`` off answers the same on the generic
    route."""
    both(sessions, "create table leaf_t as select l_linenumber k, l_partkey v, "
                   "l_suppkey p from lineitem")
    q = ("select k, sum(v) sv, count(*) c, min(p) mn, max(p) mx "
         "from leaf_t group by k order by k")
    want = both(sessions, q)
    assert counters()["exec.leaf_fused_route"] == 1
    both(sessions, "insert into leaf_t select l_linenumber k, l_partkey v, l_suppkey p "
                   "from lineitem where l_quantity < 10")
    both(sessions, q)
    assert counters()["exec.leaf_fused_route"] == 1
    js, ps = sessions
    off = PSession({"memory": ps.catalog.connector("memory")},
                   properties={"narrow_storage": False}, device="cpu")
    try:
        mark_counters()
        got_off = port_frame(off.sql(q))
        assert counters()["exec.leaf_fused_route"] == 0
    finally:
        import os

        os.environ.pop("PRESTO_TPU_NARROW", None)
    assert len(got_off) == len(want) == 7


def test_null_bearing_ctas_column_never_routes_wrong(sessions):
    """A CTAS column with NULLs declares an honest null_fraction, so the
    fragment is refused (stats reason); stats that lie about its NULLs
    trip the runtime guard (value_overflow) in both packages."""
    js, ps = sessions
    both(sessions, "create table nullt as select l_linenumber k, case when "
                   "l_linenumber = 1 then null else l_partkey end v from lineitem")
    q = "select k, count(v) c, sum(v) sv, min(v) mn from nullt group by k order by k"
    want = both(sessions, q)
    assert counters()["exec.leaf_route_fallback.stats"] == 1
    assert int(want[want.k == 1].c.iloc[0]) == 0  # count(v) skips NULLs

    def lying(catalog):
        real = catalog.stats

        def stats(connector, table, column):
            st = real(connector, table, column)
            if (table, column) == ("nullt", "v"):
                return dataclasses.replace(st, null_fraction=0.0)
            return st

        return real, stats

    jreal, js.catalog.stats = lying(js.catalog)
    preal, ps.catalog.stats = lying(ps.catalog)
    try:
        got = both(sessions, q)
        assert counters()["exec.leaf_route_fallback.value_overflow"] == 1
    finally:
        js.catalog.stats, ps.catalog.stats = jreal, preal
    pd.testing.assert_frame_equal(got, want)


def test_partial_agg_bypass_estimates(sessions):
    """A near-unique CTAS key (NDV ~ rows in the exact stats) bypasses
    partial aggregation, counted and rendered alike."""
    js, ps = sessions
    both(sessions, "create table bypass_t as select l_orderkey * 10 + "
                   "l_linenumber k, l_quantity v from lineitem")
    q = "select k, sum(v) sv, count(*) c from bypass_t group by k order by k"
    both(sessions, q)
    assert counters()["agg.strategy.bypass"] == 1
    assert ps.explain(q) == js.explain(q)
    assert "agg_strategy=bypass" in ps.explain(q)


def test_memory_connector_narrowing():
    """Written tables compute exact min/max at store time, so they narrow
    like generator tables, and answer alike narrowed or canonical."""
    import os

    cols = {"a": np.array([-32767, 32767, 5], np.int64), "b": np.array([1, 2, 3], np.int64),
            "s": np.array(["x", "y", "x"], dtype=object)}
    q = "select s, sum(a) sa, sum(b) sb from t group by s order by s"
    outs = []
    try:
        for narrow in ("1", "0"):
            os.environ["PRESTO_TPU_NARROW"] = narrow
            j, p = JMemory(), PMemory(device="cpu")
            j.create_table("t", pd.DataFrame(cols))
            p.create_table("t", cols)
            jphys, pphys = j.physical_schema("t"), p.physical_schema("t")
            assert {c: port_type(t) for c, t in jphys.items()} == pphys
            want = JSession({"memory": j}, properties={"result_cache_enabled": False}).sql(q)
            got = port_frame(PSession({"memory": p}, device="cpu").sql(q))
            pd.testing.assert_frame_equal(got, want)
            outs.append((got, pphys))
    finally:
        os.environ.pop("PRESTO_TPU_NARROW", None)
    assert outs[0][1]["a"].np_dtype == np.dtype(np.int16)
    assert outs[0][1]["b"].np_dtype == np.dtype(np.int8)
    pd.testing.assert_frame_equal(outs[0][0], outs[1][0])


# ---------------------------------------------------------------------------
# the type inference, entry for entry
# ---------------------------------------------------------------------------


def assert_same_entry(p, j, table: str) -> None:
    """The port's stored entry equals the reference's: types, arrays
    (values and dtypes), ``$valid`` masks, dictionaries, stats, rows."""
    pe, je = p._tables[table], j._tables[table]
    assert pe["rows"] == je["rows"]
    assert pe["types"] == {c: port_type(t) for c, t in je["types"].items()}
    assert sorted(pe["arrays"]) == sorted(je["arrays"])
    for c, a in je["arrays"].items():
        got = pe["arrays"][c]
        assert got.dtype == a.dtype, f"{c}: {got.dtype} != {a.dtype}"
        np.testing.assert_array_equal(got, a, err_msg=c)
    assert sorted(pe["dicts"]) == sorted(je["dicts"])
    for c, d in je["dicts"].items():
        assert list(pe["dicts"][c].values) == list(d.values), c
    assert sorted(pe["stats"]) == sorted(je["stats"])
    for c, st in je["stats"].items():
        got = pe["stats"][c]
        assert (got.ndv, got.min_value, got.max_value, got.null_fraction) == \
            (st.ndv, st.min_value, st.max_value, st.null_fraction), c


#: type -> (table, key column, expression): ``x`` is the expression, with
#: NULLs where ``key % 3 = 0`` in the NULL-bearing variant
TYPED = {
    "bigint": ("nation", "n_nationkey", "n_regionkey"),
    "integer": ("part", "p_partkey", "p_size"),
    "double": ("nation", "n_nationkey", "n_nationkey / 4"),
    "decimal": ("supplier", "s_suppkey", "s_acctbal"),
    "date": ("orders", "o_orderkey", "o_orderdate"),
    "boolean": ("nation", "n_nationkey", "n_regionkey < 2"),
    "varchar": ("nation", "n_nationkey", "n_name"),
    "bytes": ("nation", "n_nationkey", "cast(n_nationkey as varchar)"),
    "all_null": ("nation", "n_nationkey", "case when n_nationkey < 0 then n_nationkey end"),
}

#: several result batches (lineitem in 2^12-row splits, orders in 2^11):
#: NULLs in the first batches only, and an all-NULL first batch of dates
#: beside dated ones
BATCHED = {
    "bigint_nulls_in_some_batches":
        "select case when l_orderkey < 2000 then null else l_partkey end x from lineitem",
    "double_nulls_in_some_batches":
        "select case when l_orderkey < 2000 then null else l_partkey / 7 end x from lineitem",
    "date_all_null_batch":
        "select case when o_orderkey < 9000 then null else o_orderdate end x from orders",
    "varchar_nulls_in_some_batches":
        "select case when o_orderkey < 9000 then null else o_orderpriority end x from orders",
    "boolean_nulls_in_some_batches":
        "select case when l_orderkey < 2000 then null else l_quantity < 20 end x from lineitem",
}

INFER = {f"{t}{'_nulls' if nulls else ''}":
         (f"select {k} k, case when {k} % 3 = 0 then null else {e} end x from {tab}"
          if nulls else f"select {k} k, {e} x from {tab}")
         for t, (tab, k, e) in TYPED.items() for nulls in (False, True)}
# CASE over BYTES raises in the reference (ROADMAP C12): NULLs enter
# before the cast instead
INFER["bytes_nulls"] = ("select n_nationkey k, cast(case when n_nationkey % 3 = 0 then null "
                        "else n_nationkey end as varchar) x from nation")
INFER.update(BATCHED)


@pytest.fixture(scope="module")
def split_conns():
    """TPC-H at sf 0.01 in small splits, so results have several batches."""
    return JConnector(sf=SF, units_per_split=1 << 11), PConnector(sf=SF, units_per_split=1 << 11,
                                                                  device="cpu")


@pytest.mark.parametrize("case", list(INFER))
def test_inferred_column_equals_reference(split_conns, case):
    """CTAS of the statement's result stores what the reference stores
    from its frame, and INSERT of the same rows merges alike."""
    sql = INFER[case]
    jc, pc = split_conns
    df = JSession({"tpch": jc}, properties={"result_cache_enabled": False}).sql(sql)
    res = PSession({"tpch": pc}, device="cpu").sql(sql)
    if case in BATCHED:
        assert len([p for p in res.parts("x")]) > 1
    j, p = JMemory(), PMemory(device="cpu")
    j.create_table("t", df)
    p.create_table("t", res)
    assert_same_entry(p, j, "t")
    j.insert("t", df)
    p.insert("t", res)
    assert_same_entry(p, j, "t")


# ---------------------------------------------------------------------------
# chip_smoke.py phase 17, whole, on the CPU at a small scale
# ---------------------------------------------------------------------------


def test_chip_smoke_phase17_on_the_cpu():
    """Phase 17 (``chip_smoke.run_statement_queries``) runs its every check
    on the CPU at sf 0.01 (TPC-DS at the reference test's sf 0.02): the
    CTAS / INSERT / DROP answers, stats and versions, the star join, the
    EXPLAIN ANALYZE node rows and ``execute``, the prepared Q6 bindings
    and Q3, each against its numpy oracle, and the launch shapes held to
    the plain versions."""
    import os
    import sys

    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from torch_bridge import TPCDS_SF, TPCDS_UNITS

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out = chip_smoke.run_statement_queries(
        PConnector(sf=SF, device="cpu"),
        TpcdsConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS, device="cpu"),
        {"q3": (0.0, 0.0, 0.0, 0)}, device="cpu")
    assert out["routes"]["leaf group-by"]["exec.leaf_fused_route"] == 1
    assert out["routes"]["prepare q3p"]["prepare.slots_bound"] > 0
    assert len(out["templates"]["launches"]) == 4 * len(chip_smoke.TEMPLATE_CHECKS)
