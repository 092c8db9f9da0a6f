"""The port's cache tier (``presto_tpu_torch/cache/``) against the JAX
package's (``presto_tpu/cache/``), case for case after
``tests/test_cache.py``.

Every scenario runs through both packages on the same TPC-H data at
sf 0.01: fingerprints share and differ on the same plans (the digests
themselves are each package's own), the executable, result and stats
caches count the same hits, misses, evictions and invalidations, and
the answers are equal. The executable caches are process-wide, so a
case that counts their moves clears both first (``resets_global_state``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import presto_tpu.cache.exec_cache as JE
import presto_tpu.cache.stats_cache as JS
import presto_tpu.runtime.metrics as JM
import presto_tpu_torch.cache.exec_cache as PE
import presto_tpu_torch.cache.stats_cache as PS
import presto_tpu_torch.runtime.metrics as PM
from presto_tpu.batch import Dictionary as JDictionary
from presto_tpu.cache.result_cache import ResultCache as JResultCache
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.expr import BIGINT as JBIGINT
from presto_tpu.expr import InputRef as JInputRef
from presto_tpu.runtime import faults as JFaults
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.batch import Batch as PBatch
from presto_tpu_torch.batch import Dictionary as PDictionary
from presto_tpu_torch.batch import QueryResult
from presto_tpu_torch.cache.result_cache import ResultCache as PResultCache
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.expr import InputRef as PInputRef
from presto_tpu_torch.runtime import faults as PFaults
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.types import BIGINT as PBIGINT
from torch_bridge import port_frame, same_frame

# each ``cache`` package re-exports a ``fingerprint`` function that
# shadows its submodule of that name
JF = importlib.import_module("presto_tpu.cache.fingerprint")
PF = importlib.import_module("presto_tpu_torch.cache.fingerprint")

#: the executable-cache cases clear both packages' process-wide caches
pytestmark = pytest.mark.resets_global_state

SF = 0.01
AGG_JOIN_SQL = ("select n_name, count(*) c, sum(s_acctbal) b "
                "from supplier join nation on s_nationkey = n_nationkey "
                "group by n_name order by n_name")
#: the families the cache tier moves
FAMILIES = ("result_cache.", "exec_cache.", "stats_cache.", "plan_stats.", "prepare.template_",
            "prepare.coalesced", "query.completed", "query.started")


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


def sessions(conns, **props):
    return (JSession({"tpch": conns[0]}, properties=props or None),
            PSession({"tpch": conns[1]}, properties=props or None, device="cpu"))


class Moves:
    """The cache families' registry moves of one package over a block."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.before = self.mod.REGISTRY.snapshot()
        return self

    def __exit__(self, *exc):
        after = self.mod.REGISTRY.snapshot()
        self.moves = {k: after[k] - self.before.get(k, 0.0) for k in after
                      if k.startswith(FAMILIES) and not k.startswith("cache.")
                      and after[k] != self.before.get(k, 0.0)}
        return False


def clear_caches():
    JE.EXEC_CACHE.clear()
    PE.EXEC_CACHE.clear()
    JS.clear()
    PS.clear()


def both(conns, script, **props):
    """Run ``script(session, pkg)`` through each package's session from a
    cleared cache state: (reference's (result, moves), port's)."""
    out = []
    for session, pkg in zip(sessions(conns, **props), ("jax", "torch")):
        clear_caches()
        with Moves(JM if pkg == "jax" else PM) as m:
            res = script(session, pkg)
        out.append((res, m.moves))
    return out


def frame_list(res, pkg, col):
    frame = res if pkg == "jax" else port_frame(res)
    return [int(x) if isinstance(x, (int, np.integer)) else x for x in frame[col].tolist()]


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def test_dictionary_hashes_by_content_not_identity():
    import torch

    for D, F in ((JDictionary, JF), (PDictionary, PF)):
        d1, d2, d3 = D(["a", "b", "c"]), D(["a", "b", "c"]), D(["a", "b", "x"])
        assert d1 is not d2
        assert F.dictionary_fingerprint(d1) == F.dictionary_fingerprint(d2)
        assert F.dictionary_fingerprint(d1) != F.dictionary_fingerprint(d3)
        assert F.fingerprint(d1) == F.fingerprint(d2) != F.fingerprint(d3)
    # a literal held in a tensor hashes by its content, never the object
    t1, t2 = torch.tensor([1, 2, 3]), torch.tensor([1, 2, 3])
    assert PF.fingerprint(t1) == PF.fingerprint(t2) != PF.fingerprint(torch.tensor([1, 2, 4]))
    assert PF.fingerprint(t1) != PF.fingerprint(t1.to(torch.int32))


def test_fingerprint_distinguishes_structure():
    for F in (JF, PF):
        assert F.fingerprint((1, 2), 3) != F.fingerprint((1, 2, 3))
        assert F.fingerprint("12") != F.fingerprint(12)
        assert F.fingerprint([1, [2]]) != F.fingerprint([[1], 2])
        assert F.try_fingerprint(object()) is None


def test_identical_sql_has_identical_plan_fingerprint(conns):
    relations = []
    for s, F in zip(sessions(conns), (JF, PF)):
        fp1 = F.plan_fingerprint(s.plan(AGG_JOIN_SQL), s.catalog, s.properties)
        fp2 = F.plan_fingerprint(s.plan(AGG_JOIN_SQL), s.catalog, s.properties)
        fp3 = F.plan_fingerprint(s.plan(AGG_JOIN_SQL.replace("count(*)", "count(*) + 1")),
                                 s.catalog, s.properties)
        fp4 = F.plan_fingerprint(s.plan(AGG_JOIN_SQL), s.catalog, {"approx_join": True})
        assert fp1 is not None
        relations.append((fp1 == fp2, fp3 == fp1, fp4 == fp1))
    assert relations[0] == relations[1] == (True, False, False)


def test_slotted_plan_fingerprints_identically_across_reanalysis(conns):
    from presto_tpu.plan.templates import parameterize_plan as jparam
    from presto_tpu_torch.plan.templates import parameterize_plan as pparam

    fmt = ("select l_orderkey, l_linenumber, l_quantity + {} q"
           " from lineitem where l_extendedprice < {}"
           " order by l_orderkey, l_linenumber limit 10")
    psql = "select count(*) c from orders where o_orderkey between ? and ?"
    relations = []
    for s, F, param in zip(sessions(conns), (JF, PF), (jparam, pparam)):
        def template_fp(sql):
            plan, slots = param(s.plan(sql), s.catalog)
            assert slots
            return F.plan_fingerprint(plan, s.catalog, s.properties), slots

        fp1, slots1 = template_fp(fmt.format(3, 2000))
        fp2, slots2 = template_fp(fmt.format(3, 2000))
        fp3, slots3 = template_fp(fmt.format(7, 90000))
        h1, h2 = s.prepare(psql), s.prepare(psql)
        relations.append((fp1 == fp2, fp3 == fp1,
                          [(x.slot, str(x.dtype)) for x in slots1]
                          == [(x.slot, str(x.dtype)) for x in slots2],
                          [x.value for x in slots3] != [x.value for x in slots1],
                          F.plan_fingerprint(h1.plan, s.catalog, s.properties)
                          == F.plan_fingerprint(h2.plan, s.catalog, s.properties),
                          len(slots1)))
    assert relations[0] == relations[1]
    assert relations[1][:5] == (True, True, True, True, True)


def test_table_version_bump_changes_plan_fingerprint(conns):
    for s, F in zip(sessions(conns), (JF, PF)):
        fp1 = F.plan_fingerprint(s.plan("select count(*) c from region"), s.catalog, s.properties)
        s.catalog.invalidate("region")
        fp2 = F.plan_fingerprint(s.plan("select count(*) c from region"), s.catalog, s.properties)
        assert fp1 != fp2


def test_system_table_plans_are_volatile(conns):
    for s, F in zip(sessions(conns), (JF, PF)):
        plan = s.plan("select name from runtime_metrics")
        assert ("system", "runtime_metrics") in F.referenced_tables(plan)
        assert not F.plan_is_deterministic(plan, s.catalog)
        assert F.plan_is_deterministic(s.plan("select count(*) c from region"), s.catalog)


# ---------------------------------------------------------------------------
# executable cache
# ---------------------------------------------------------------------------


def _lru_script(mod):
    c = mod.ExecutableCache(max_entries=2)
    builds, got = [], []

    def build(tag):
        def b():
            builds.append(tag)
            return tag

        return b

    for key, tag in (("a", "a"), ("a", "a2"), ("b", "b"), ("a", "a3"), ("c", "c"),
                     ("a", "a4"), ("b", "b2")):
        got.append(c.get_or_build(c.key_of(key), build(tag)))
    got.append(c.get_or_build(None, build("u")))
    got.append(c.get_or_build(None, build("u2")))
    return builds, got, [r["hits"] for r in c.stats_rows()], [r["kind"] for r in c.stats_rows()]


def test_exec_cache_get_or_build_and_lru_eviction():
    moves = []
    for mod, reg in ((JE, JM), (PE, PM)):
        with Moves(reg) as m:
            out = _lru_script(mod)
        moves.append((out, m.moves))
    assert moves[0] == moves[1]
    builds, got, _hits, _kinds = moves[1][0]
    assert builds == ["a", "b", "c", "b2", "u", "u2"]
    assert got == ["a", "a", "b", "a", "c", "a", "b2", "u", "u2"]
    assert moves[1][1]["exec_cache.evicted"] == 2


def test_exec_cache_key_folds_content():
    """The port's counterpart of the reference's pallas-switch case: a key
    is the content of its parts (a tensor part by its values), never the
    identity of the objects, and the kind tag leads it."""
    import torch

    k0 = PE.EXEC_CACHE.key_of("probe", torch.tensor([1, 2]))
    k1 = PE.EXEC_CACHE.key_of("probe", torch.tensor([1, 2]))
    k2 = PE.EXEC_CACHE.key_of("probe", torch.tensor([1, 3]))
    assert k0 == k1 != k2 and k0.startswith("probe:")
    assert PE.EXEC_CACHE.key_of(object()) is None


def test_warm_identical_query_does_not_retrace(conns):
    """A second identical query in a fresh session (result cache off, so
    the pipeline runs) is served from the executable cache: the same
    hits and no misses in both packages, equal answers."""

    def script(session, pkg):
        make = JSession if pkg == "jax" else PSession
        conn = conns[0] if pkg == "jax" else conns[1]
        kw = {} if pkg == "jax" else {"device": "cpu"}
        first = session.sql(AGG_JOIN_SQL)
        reg = JM if pkg == "jax" else PM
        with Moves(reg) as warm:
            second = make({"tpch": conn}, properties={"result_cache_enabled": False},
                          **kw).sql(AGG_JOIN_SQL)
        return first, second, warm.moves

    (jres, _jm), (pres, _pm) = both(conns, script, result_cache_enabled=False)
    assert pres[2] == jres[2]
    assert pres[2]["exec_cache.hit"] > 0 and "exec_cache.miss" not in pres[2]
    same_frame(pres[0], jres[0])
    same_frame(pres[1], jres[1])


# ---------------------------------------------------------------------------
# result cache: unit level
# ---------------------------------------------------------------------------


def _result(tag: int, rows: int = 64) -> QueryResult:
    x = np.arange(tag, tag + rows, dtype=np.int64)
    return QueryResult(["x"], [PBatch.from_numpy({"x": x}, {"x": PBIGINT}, device="cpu")])


def test_result_cache_byte_budget_evicts_lru_first(conns):
    js, ps = sessions(conns)
    one = _result(0).nbytes
    rc = PResultCache(max_bytes=2 * one + one // 2)  # fits exactly two
    with Moves(PM) as m:
        rc.put("a", _result(1), (("t", 0),))
        rc.put("b", _result(2), (("t", 0),))
        assert rc.get("a", ps.catalog) is not None
        rc.put("c", _result(3), (("t", 0),))  # evicts b, the LRU entry
        assert rc.get("b", ps.catalog) is None
        assert rc.get("a", ps.catalog) is not None
        assert rc.get("c", ps.catalog) is not None
        assert rc.bytes_used <= rc.max_bytes
        assert not rc.put("huge", _result(9, rows=100_000), (("t", 0),))
        assert rc.get("huge", ps.catalog) is None
    # the reference on frames of the same shape counts the same moves
    import pandas as pd
    from presto_tpu.cache.result_cache import frame_bytes

    def df(tag, rows=64):
        return pd.DataFrame({"x": range(tag, tag + rows)})

    jrc = JResultCache(max_bytes=2 * frame_bytes(df(0)) + frame_bytes(df(0)) // 2)
    with Moves(JM) as jm:
        jrc.put("a", df(1), (("t", 0),))
        jrc.put("b", df(2), (("t", 0),))
        jrc.get("a", js.catalog)
        jrc.put("c", df(3), (("t", 0),))
        jrc.get("b", js.catalog)
        jrc.get("a", js.catalog)
        jrc.get("c", js.catalog)
        jrc.put("huge", df(9, rows=100_000), (("t", 0),))
        jrc.get("huge", js.catalog)
    assert m.moves == jm.moves
    assert m.moves["result_cache.evicted"] == 1 and m.moves["result_cache.skipped"] == 1


def test_result_cache_version_drift_drops_entry(conns):
    import pandas as pd

    js, ps = sessions(conns)
    out = []
    for s, rc, val, reg in ((js, JResultCache(1 << 20), pd.DataFrame({"x": [1]}), JM),
                            (ps, PResultCache(1 << 20), _result(1), PM)):
        rc.put("k", val, (("region", s.catalog.version("region")),))
        assert rc.get("k", s.catalog) is not None
        s.catalog.invalidate("region")
        with Moves(reg) as m:
            assert rc.get("k", s.catalog) is None
        assert len(rc) == 0
        out.append(m.moves)
    assert out[0] == out[1] == {"result_cache.invalidated": 1.0, "result_cache.miss": 1.0}


def test_result_cache_returns_defensive_copies(conns):
    _js, ps = sessions(conns)
    rc = PResultCache(max_bytes=1 << 20)
    src = _result(1)
    rc.put("k", src, ())
    out = rc.get("k", ps.catalog)
    for data, _valid, _t, _d in out._cols["x"]:
        data[:] = -1
    again = rc.get("k", ps.catalog)
    assert again.column("x").tolist() == src.column("x").tolist()
    # and a stored result shares nothing with the caller's
    for data, _valid, _t, _d in src._cols["x"]:
        data[:] = -7
    assert rc.get("k", ps.catalog).column("x").tolist() == list(range(1, 65))


# ---------------------------------------------------------------------------
# result cache: end to end
# ---------------------------------------------------------------------------


def test_warm_query_is_result_cache_hit_bitwise_identical(conns):
    import json

    def script(s, pkg):
        first, second = s.sql(AGG_JOIN_SQL), s.sql(AGG_JOIN_SQL)
        info = s.query_history[-1]
        return first, second, (info.cache_hit, info.state, json.loads(info.to_json())["cacheHit"])

    (jres, jm), (pres, pm) = both(conns, script)
    same_frame(pres[0], jres[0])
    same_frame(pres[1], jres[1])
    same_frame(pres[1], port_frame(pres[0]))
    assert pres[2] == jres[2] == (True, "FINISHED", True)
    assert pm == jm
    assert pm["result_cache.hit"] == 1


def test_result_cache_hit_skips_execution_entirely(conns):
    _js, ps = sessions(conns)
    ps.sql(AGG_JOIN_SQL)
    execs = []
    orig = ps.executor
    ps.executor = lambda: execs.append(1) or orig()
    with Moves(PM) as m:
        ps.sql(AGG_JOIN_SQL)
    assert execs == []  # no executor was even built
    assert m.moves["query.started"] == 1 and "exec_cache.hit" not in m.moves


def test_query_cached_event_fires(conns):
    def script(s, pkg):
        class L:
            def __init__(self):
                self.cached, self.completed = [], []

            def query_cached(self, info):
                self.cached.append(info.query_id)

            def query_completed(self, info):
                self.completed.append(info.query_id)

        lis = L()
        s.events.add(lis)
        s.sql("select count(*) c from region")
        n0 = len(lis.cached)
        s.sql("select count(*) c from region")
        return n0, len(lis.cached), lis.cached[0] == lis.completed[-1]

    (jres, _), (pres, _) = both(conns, script)
    assert pres == jres == (0, 1, True)


def test_explain_analyze_reports_cache_hit(conns):
    q = "select count(*) c from nation"
    for s in sessions(conns):
        first = s.explain_analyze(q)
        assert "result cache: HIT" not in first
        assert s.explain_analyze(q).startswith("result cache: HIT (no execution)")


def test_result_cache_disabled_bypasses_cleanly(conns):
    def script(s, pkg):
        out = (s.sql(AGG_JOIN_SQL), s.sql(AGG_JOIN_SQL))
        return out, len(s.result_cache), s.query_history[-1].cache_hit

    (jres, jm), (pres, pm) = both(conns, script, result_cache_enabled=False)
    same_frame(pres[0][1], jres[0][1])
    assert pres[1:] == jres[1:] == (0, False)
    assert not any(k.startswith("result_cache.") for k in pm)
    assert {k: v for k, v in pm.items() if k.startswith("result_cache.")} == \
        {k: v for k, v in jm.items() if k.startswith("result_cache.")}


def test_volatile_system_queries_never_cached(conns):
    def script(s, pkg):
        s.sql("select name, value from runtime_metrics")
        s.sql("select name, value from runtime_metrics")
        return len(s.result_cache)

    (jres, jm), (pres, pm) = both(conns, script)
    assert pres == jres == 0
    assert "result_cache.hit" not in pm and "result_cache.populated" not in pm


def test_fault_injected_runs_never_populate(conns):
    def script(s, pkg):
        F = JFaults if pkg == "jax" else PFaults
        with F.injected(F.FaultInjector()):  # armed but quiet
            a = s.sql("select count(*) c from region")
            b = s.sql("select count(*) c from region")
        return frame_list(a, pkg, "c"), frame_list(b, pkg, "c"), len(s.result_cache)

    (jres, jm), (pres, pm) = both(conns, script)
    assert pres == jres == ([5], [5], 0)
    assert "result_cache.populated" not in pm and "result_cache.populated" not in jm


def test_failed_queries_never_populate(conns):
    _js, ps = sessions(conns)

    class Boom:
        recorder = None

        def run(self, plan):
            raise RuntimeError("exec failure")

    ps.executor = lambda: Boom()
    with Moves(PM) as m:
        with pytest.raises(RuntimeError, match="exec failure"):
            ps.sql("select count(*) c from region")
    assert "result_cache.populated" not in m.moves
    assert len(ps.result_cache) == 0
    assert ps.query_history[-1].state == "FAILED"


def test_result_caches_are_per_session(conns):
    q = "select x from private"
    for make in (lambda: sessions(conns)[0], lambda: sessions(conns)[1]):
        s1, s2 = make(), make()
        s1.sql("create table private as select 1 x")
        s2.sql("create table private as select 2 x")
        got = []
        for s in (s1, s1, s2):
            res = s.sql(q)
            got.append(int((res["x"] if hasattr(res, "iloc") else res.column("x"))[0]))
        assert got == [1, 1, 2]


def test_shared_agg_step_keeps_per_trace_dictionaries(conns):
    """Operators sharing one cached aggregation step each decode their
    own dictionaries: three sessions, one step fingerprint."""
    q = "select x, count(*) c from t group by x order by x"
    for pkg in ("jax", "torch"):
        make = (lambda: sessions(conns)[0]) if pkg == "jax" else (lambda: sessions(conns)[1])
        got = []
        for rows in (("aa", "bb"), ("yy", "zz"), ("aa", "bb")):
            s = make()
            s.sql(f"create table t as select '{rows[0]}' x union all select '{rows[1]}' x")
            got.append(frame_list(s.sql(q), pkg, "x"))
        assert got == [["aa", "bb"], ["yy", "zz"], ["aa", "bb"]]


# ---------------------------------------------------------------------------
# DDL invalidation
# ---------------------------------------------------------------------------


def test_ctas_insert_drop_invalidate_result_cache(conns):
    def script(s, pkg):
        s.sql("create table t as select 1 a union all select 2 a")
        q = "select sum(a) s from t"
        out = [frame_list(s.sql(q), pkg, "s"), frame_list(s.sql(q), pkg, "s")]
        s.sql("insert into t select 10 a")
        out.append(frame_list(s.sql(q), pkg, "s"))
        s.sql("drop table t")
        s.sql("create table t as select 100 a")
        out.append(frame_list(s.sql(q), pkg, "s"))
        return out

    (jres, jm), (pres, pm) = both(conns, script)
    assert pres == jres == [[3], [3], [13], [100]]
    rc = {k: v for k, v in pm.items() if k.startswith("result_cache.")}
    assert rc == {k: v for k, v in jm.items() if k.startswith("result_cache.")}
    assert rc["result_cache.hit"] == 1 and rc["result_cache.invalidated"] >= 1


def test_stale_metadata_read_after_ctas_impossible(conns):
    _js, s = sessions(conns)
    s.sql("create table m as select 1 a")
    v1 = s.catalog.version("m")
    assert v1 == 1  # one bump per DDL statement
    assert s.catalog.resolve("m").row_count == 1
    s.sql("insert into m select 2 a")
    assert s.catalog.version("m") == v1 + 1
    assert s.catalog.resolve("m").row_count == 2
    # a direct Python-API write bumps the version too
    mem = s.catalog.connector("memory")
    v2 = s.catalog.version("direct")
    mem.create_table("direct", {"z": np.array([1, 2, 3], np.int64)})
    assert s.catalog.version("direct") > v2
    assert s.catalog.resolve("direct").row_count == 3
    mem.drop_table("direct")
    assert s.catalog.version("direct") > v2 + 1


def test_ddl_forces_full_miss_then_recaches(conns):
    def script(s, pkg):
        s.sql("create table r as select 5 v")
        q = "select v from r"
        s.sql(q)
        s.sql(q)
        s.sql("insert into r select 6 v")
        after = sorted(frame_list(s.sql(q), pkg, "v"))
        s.sql(q)
        return after, s.query_history[-1].cache_hit

    (jres, jm), (pres, pm) = both(conns, script)
    assert pres == jres == ([5, 6], True)
    assert {k: v for k, v in pm.items() if k.startswith("result_cache.")} == \
        {k: v for k, v in jm.items() if k.startswith("result_cache.")}


# ---------------------------------------------------------------------------
# stats cache
# ---------------------------------------------------------------------------


def test_stats_cache_content_keyed_and_version_invalidated(conns):
    out = []
    for s, S, ref in zip(sessions(conns), (JS, PS),
                         (JInputRef(JBIGINT, "l_partkey"), PInputRef(PBIGINT, "l_partkey"))):
        S.clear()
        plan_a = s.plan("select l_partkey from lineitem")
        plan_b = s.plan("select l_partkey from lineitem")
        k1 = S.minmax_key(s.catalog, plan_a, ref)
        k2 = S.minmax_key(s.catalog, plan_b, ref)
        calls = []
        v1 = S.cached_minmax(k1, lambda: (calls.append(1), (0, 7))[1])
        v2 = S.cached_minmax(k2, lambda: (calls.append(1), (9, 9))[1])
        s.catalog.invalidate("lineitem")
        k3 = S.minmax_key(s.catalog, plan_a, ref)
        other = sessions(conns)[0 if S is JS else 1]
        k4 = S.minmax_key(other.catalog, other.plan("select l_partkey from lineitem"), ref)
        out.append((k1 is not None and k1 == k2, v1, v2, calls, k3 != k1, k4 != k2))
    assert out[0] == out[1] == (True, (0, 7), (0, 7), [1], True, True)


def test_stats_cache_unbound_scalar_subtrees_uncacheable(conns):
    sql = ("select l_partkey from lineitem "
           "where l_quantity <= (select max(p_size) from part)")
    js, ps = sessions(conns)
    assert JS.minmax_key(js.catalog, js.plan(sql), JInputRef(JBIGINT, "l_partkey")) is None
    assert PS.minmax_key(ps.catalog, ps.plan(sql), PInputRef(PBIGINT, "l_partkey")) is None


# ---------------------------------------------------------------------------
# surfacing
# ---------------------------------------------------------------------------


def test_counters_surface_through_system_runtime_metrics(conns):
    names = []
    for s, pkg in zip(sessions(conns), ("jax", "torch")):
        s.sql(AGG_JOIN_SQL)
        s.sql(AGG_JOIN_SQL)
        frame = s.sql("select name, value from runtime_metrics")
        if pkg == "torch":
            frame = port_frame(frame)
        vals = {(n.decode() if isinstance(n, bytes) else n).rstrip("\x00 "): v
                for n, v in zip(frame["name"], frame["value"])}
        assert vals["result_cache.hit"] >= 1
        names.append({n for n in vals if n.startswith(("result_cache.", "exec_cache."))})
    want = {"result_cache.hit", "result_cache.miss", "result_cache.populated",
            "exec_cache.hit", "exec_cache.miss"}
    assert want <= names[1] and want <= names[0]


def test_exec_cache_max_entries_property_applies(conns):
    prior = PE.EXEC_CACHE.max_entries
    try:
        s = PSession({"tpch": conns[1]}, properties={"exec_cache_max_entries": 8}, device="cpu")
        s.sql("select count(*) c from region")
        assert PE.EXEC_CACHE.max_entries == 8
        # a session that never set the knob leaves the process bound alone
        PSession({"tpch": conns[1]}, device="cpu").sql("select count(*) c from region")
        assert PE.EXEC_CACHE.max_entries == 8
    finally:
        PE.EXEC_CACHE.set_max_entries(prior)


def test_chip_smoke_phase20_on_the_cpu():
    """Phase 20 (``chip_smoke.run_cache_queries``) runs its checks on the
    CPU at sf 0.01 (2^12 units a split, so several splits; a 2 MiB result
    budget, so the wide result evicts the narrow one): launch-free
    bitwise cache hits, the INSERT invalidation, warm executable- and
    stats-cache runs, the adaptive decision and its sticky replay, the
    flight records, the system tables against the session's stores and
    the coalesced pair, every wrapper call inside a ``fragment:`` span
    and the shapes held to plain."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out = chip_smoke.run_cache_queries(PConnector(sf=0.01, units_per_split=1 << 12, device="cpu"),
                                       device="cpu", cache_budget=2 << 20)
    assert out["adaptive"]["applied"] == [0, 0, 1, 1]
    assert [t for t, _c, _n in out["flight"]] == [("failed", "deadline"), ("retried",)]
    assert out["coalescer"]["coalesced"] == [False, True]
    assert out["big"]["held"] == out["big"]["wide_bytes"] <= out["big"]["budget"]
    assert out["system"]["runtime_nodes"] == [("cpu", "cpu")]
