"""Plan templates and prepared statements in the port against the JAX
package's.

- eligible literal positions (projection arithmetic, filter bounds
  outside leaf fragments, join-key arithmetic, aggregate inputs) slot in
  both packages: frames equal the reference's and the port's own with
  ``plan_templates`` off, ``prepare.*`` counters equal;
- a Q6-shaped leaf fragment's literals and LIMIT counts stay baked,
  counted alike (``prepare.slot_ineligible.leaf_route`` / ``.limit``),
  and the leaf kernel's route still runs;
- PREPARE / EXECUTE ... USING / DEALLOCATE PREPARE and
  ``Session.prepare`` / ``execute(handle, params)``: answers, binding
  and typing errors (class and words) equal, IN-list placeholders, and
  every binding running the handle's one ``PreparedStatement.plan``
  object (the port has no jit to re-trace);
- EXPLAIN: the port's text, ``params=[...]`` line included, equal to the
  reference's for the 22 TPC-H queries at sf 0.01 (plans only).

Both packages count ``prepare.template_hit`` / ``template_miss`` and set
``QueryInfo.template_hit`` from their plan-template fingerprints
(``test_template_hit_equals_reference``).
"""

import pandas as pd
import pytest

from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.runtime.metrics import REGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.expr import Literal, Param
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import ROUTES, counters, mark_counters, port_frame

SF = 0.01

PREFIXES = ROUTES + ("prepare.slot",)


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


def sessions_for(conns, **props):
    props = {"result_cache_enabled": False, **props}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def deltas(before: dict) -> dict:
    after = REGISTRY.snapshot()
    return {k: int(after[k] - before.get(k, 0)) for k in after
            if k.startswith(PREFIXES) and after[k] != before.get(k, 0)}


def port_counters() -> dict:
    return {k: v for k, v in counters().items() if k.startswith(PREFIXES) and v}


def run_both(js, ps, call):
    """``call(session)`` through both sessions: (reference result, port
    result), their counters equal."""
    before = REGISTRY.snapshot()
    want = call(js)
    want_counts = deltas(before)
    mark_counters()
    got = call(ps)
    assert port_counters() == want_counts
    return want, got


def sql_both(js, ps, sql):
    want, got = run_both(js, ps, lambda s: s.sql(sql))
    got = port_frame(got)
    pd.testing.assert_frame_equal(got, want)
    return got


def refused_alike(js, ps, call, match):
    with pytest.raises(Exception, match=match) as jerr:
        call(js)
    with pytest.raises(Exception, match=match) as perr:
        call(ps)
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert str(perr.value) == str(jerr.value)


ELIGIBLE_POSITIONS = {
    "projection_arith": ("select l_orderkey, l_linenumber, l_extendedprice + {} p from lineitem"
                         " order by l_orderkey, l_linenumber limit 20", (5, 4000)),
    "filter_bound": ("select l_orderkey, l_linenumber, l_quantity from lineitem"
                     " where l_extendedprice < {} order by l_orderkey, l_linenumber limit 30",
                     (2000, 90000)),
    "join_filter_bound": ("select o_orderpriority, count(*) c from lineitem"
                          " join orders on l_orderkey = o_orderkey where l_quantity < {}"
                          " group by o_orderpriority order by o_orderpriority", (10, 44)),
    "join_key_via_projection": ("select o_orderpriority, count(*) c from"
                                " (select l_orderkey + {} k from lineitem) l"
                                " join orders on k = o_orderkey"
                                " group by o_orderpriority order by o_orderpriority", (0, 11)),
    "agg_input": ("select o_orderpriority, sum(l_quantity + {}) s from lineitem"
                  " join orders on l_orderkey = o_orderkey"
                  " group by o_orderpriority order by o_orderpriority", (0, 29)),
}


@pytest.mark.parametrize("name", list(ELIGIBLE_POSITIONS))
def test_eligible_position_slots_alike(conns, name):
    fmt, lits = ELIGIBLE_POSITIONS[name]
    js, ps = sessions_for(conns)
    _js, off = sessions_for(conns, plan_templates=False)
    for v in lits:
        got = sql_both(js, ps, fmt.format(v))
        assert counters()["prepare.slots_bound"] >= 1
        pd.testing.assert_frame_equal(got, port_frame(off.sql(fmt.format(v))))


def test_leaf_route_literals_stay_baked(conns):
    """Q6's fragment lowers to the leaf kernel, whose admission proofs
    read the filter literals: they stay baked (counted), the route runs,
    and the answer equals the reference's and templates-off."""
    fmt = "select sum(l_extendedprice * l_discount) rev from lineitem where l_quantity < {}"
    js, ps = sessions_for(conns)
    _js, off = sessions_for(conns, plan_templates=False)
    for v in (30, 17):
        got = sql_both(js, ps, fmt.format(v))
        assert counters()["prepare.slot_ineligible.leaf_route"] > 0
        assert counters()["exec.leaf_fused_route"] == 1
        pd.testing.assert_frame_equal(got, port_frame(off.sql(fmt.format(v))))


def test_limit_stays_baked(conns):
    fmt = "select l_orderkey from lineitem order by l_orderkey limit {}"
    js, ps = sessions_for(conns)
    for n in (10, 25):
        got = sql_both(js, ps, fmt.format(n))
        assert counters()["prepare.slot_ineligible.limit"] == 1 and len(got) == n


def test_prepare_execute_python_api(conns, monkeypatch):
    """Every binding of a handle runs its one plan object."""
    from presto_tpu_torch.exec.local_planner import LocalExecutor

    js, ps = sessions_for(conns)
    _js, off = sessions_for(conns, plan_templates=False)
    sql = "select count(*) c from orders where o_orderkey < ?"
    hj, hp = run_both(js, ps, lambda s: s.prepare(sql))
    offs = {v: port_frame(off.sql(f"select count(*) c from orders where o_orderkey < {v}"))
            for v in (512, 4096)}
    ran = []
    orig = LocalExecutor.run

    def spy(self, plan):
        ran.append(plan)
        return orig(self, plan)

    monkeypatch.setattr(LocalExecutor, "run", spy)
    for v in (512, 4096):
        want, jinfo = js.execute(hj, [v])
        res, info = ps.execute(hp, [v])
        got = port_frame(res)
        pd.testing.assert_frame_equal(got, want)
        pd.testing.assert_frame_equal(got, offs[v])
        assert info.state == jinfo.state == "FINISHED"
    assert len(ran) == 2 and all(p is hp.plan for p in ran)
    assert any(isinstance(e, Param) for e in _exprs(hp.plan))


def test_bindings_and_logical_values_alike(conns):
    """A handle's slot-ordered binding (user values coerced, auto slots
    after) and its value half equal the reference's."""
    from presto_tpu.plan.templates import logical_values as j_values
    from presto_tpu_torch.plan.templates import logical_values as p_values

    js, ps = sessions_for(conns)
    sql = ("select count(*) c from orders where o_orderdate < ? and o_totalprice > ?"
           " and o_custkey + 7 > ?")
    hj, hp = run_both(js, ps, lambda s: s.prepare(sql))
    for args in (["1995-03-15", 1000.5, 20], ["1993-01-01", 250, 3]):
        jb, pb = hj.bind(args), hp.bind(args)
        assert [str(dt) for dt, _v in pb] == [str(dt) for dt, _v in jb]
        assert p_values(pb) == j_values(jb)


def _exprs(plan):
    out = []

    def walk_expr(e):
        out.append(e)
        for a in getattr(e, "args", ()):
            walk_expr(a)

    def walk(n):
        if isinstance(n, PN.Filter):
            walk_expr(n.predicate)
        if isinstance(n, PN.TableScan) and n.predicate is not None:
            walk_expr(n.predicate)
        for c in n.children:
            walk(c)

    walk(plan)
    return out


def test_prepare_execute_sql_surface(conns):
    js, ps = sessions_for(conns)
    sql_both(js, ps, "prepare p_rng from select count(*) c from orders"
                     " where o_orderkey between ? and ?")
    sql_both(js, ps, "execute p_rng using 100, 2000")
    sql_both(js, ps, "execute p_rng using -5, 900")  # unary minus
    sql_both(js, ps, "deallocate prepare p_rng")
    refused_alike(js, ps, lambda s: s.sql("execute p_rng using 1, 2"), "not found")
    refused_alike(js, ps, lambda s: s.sql("deallocate prepare p_rng"), "not found")


def test_execute_binding_errors(conns):
    js, ps = sessions_for(conns)
    sql = "select count(*) c from orders where o_orderkey < ?"
    hj, hp = js.prepare(sql), ps.prepare(sql)
    handles = {id(js): hj, id(ps): hp}
    for args, match in (([], "takes 1 parameter"), ([1, 2], "takes 1 parameter"),
                        (["not-a-number"], "cannot bind"), ([1.5], "cannot bind")):
        refused_alike(js, ps, lambda s: s.execute(handles[id(s)], args), match)


def test_param_typing_errors(conns):
    js, ps = sessions_for(conns)
    for call, match in (
            (lambda s: s.prepare("select ? x from region"), "cannot infer"),
            (lambda s: s.prepare("select count(*) c from region where ? = ?"), "cannot infer"),
            (lambda s: s.prepare("select count(*) c from region where r_name = ?"),
             "string parameters"),
            (lambda s: s.sql("select count(*) c from orders where o_orderkey < ?"), "PREPARE"),
            (lambda s: s.plan("select count(*) c from orders where o_orderkey < ?"), "PREPARE"),
            (lambda s: s.execute("select count(*) c from orders where o_orderkey < ?"),
             "PREPARE"),
            (lambda s: s.prepare("create table x as select 1 a"), "only queries"),
            (lambda s: s.explain("prepare p from select 1 a"), "DDL"),
            (lambda s: s.plan("drop table x"), "DDL")):
        refused_alike(js, ps, call, match)


def test_in_list_params(conns):
    js, ps = sessions_for(conns)
    sql = "select count(*) c from orders where o_orderkey in (?, 7, ?)"
    hj, hp = run_both(js, ps, lambda s: s.prepare(sql))
    want, _ = js.execute(hj, [1, 32])
    res, _ = ps.execute(hp, [1, 32])
    pd.testing.assert_frame_equal(port_frame(res), want)
    _js, off = sessions_for(conns, plan_templates=False)
    pd.testing.assert_frame_equal(
        port_frame(res), port_frame(off.sql("select count(*) c from orders"
                                            " where o_orderkey in (1, 7, 32)")))


def test_template_hit_equals_reference(conns):
    """Both packages fingerprint each plan template: the first run of a
    statement in a session is a ``prepare.template_miss``, the second a
    ``prepare.template_hit`` with ``QueryInfo.template_hit`` set, and a
    statement differing in a literal has the reference's verdict too."""
    js, ps = sessions_for(conns)
    sqls = ["select count(*) c from orders where o_orderkey < 77"] * 2 + [
        "select count(*) c from orders where o_orderkey < 78"]
    got, want = [], []
    for sql in sqls:
        before = REGISTRY.snapshot()
        js.sql(sql)
        after = REGISTRY.snapshot()
        mark_counters()
        ps.sql(sql)
        moves = counters()
        want.append((js.query_history[-1].template_hit,
                     after.get("prepare.template_hit", 0) - before.get("prepare.template_hit", 0),
                     after.get("prepare.template_miss", 0)
                     - before.get("prepare.template_miss", 0)))
        got.append((ps.query_history[-1].template_hit, moves["prepare.template_hit"],
                    moves["prepare.template_miss"]))
    assert got == want
    assert got[:2] == [(False, 0, 1), (True, 1, 0)]


def test_explain_renders_param_slots(conns):
    js, ps = sessions_for(conns)
    sql = ("select l_orderkey, l_extendedprice + 7 p from lineitem"
           " where l_extendedprice < 2000 order by l_orderkey limit 5")
    out = ps.explain(sql)
    assert out == js.explain(sql)
    assert "params=[" in out and "?0=" in out and "?1=" in out
    _js, off = sessions_for(conns, plan_templates=False)
    assert "params=[" not in off.explain(sql) and "?0" not in off.explain(sql)


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_tpch_explain_equals_jax_session(conns, q):
    js, ps = sessions_for(conns)
    want, got = run_both(js, ps, lambda s: s.explain(QUERIES[q]))
    assert got == want


def test_plan_stays_unparameterized(conns):
    """``plan()`` never slots a literal: the plan-shape tests compare the
    same trees as before."""
    _js, ps = sessions_for(conns)
    exprs = _exprs(ps.plan(QUERIES["q3"]))
    assert not any(isinstance(e, Param) for e in exprs)
    assert any(isinstance(e, Literal) for e in exprs)


def test_narrow_storage_is_mirrored_before_parameterizing(conns):
    """C16: a session with ``narrow_storage`` on, planning right after one
    with it off, bakes Q6's leaf fragment and routes it in the port; the
    reference mirrors the property only when it builds the executor,
    after parameterizing, so it slots the literals and its matcher then
    refuses them (``filter_shape``). The answers are equal."""
    import os

    js_on, ps_on = sessions_for(conns, narrow_storage=True)
    js_off, ps_off = sessions_for(conns, narrow_storage=False)
    sql = QUERIES["q6"]
    try:
        js_off.sql(sql)
        before = REGISTRY.snapshot()
        want = js_on.sql(sql)
        want_counts = deltas(before)
        ps_off.sql(sql)
        mark_counters()
        got = port_frame(ps_on.sql(sql))
    finally:
        os.environ.pop("PRESTO_TPU_NARROW", None)
    pd.testing.assert_frame_equal(got, want)
    assert want_counts.get("exec.leaf_route_fallback.filter_shape") == 1
    assert counters()["exec.leaf_fused_route"] == 1
    assert not counters()["exec.leaf_route_fallback.filter_shape"]


def test_param_evaluates_like_the_reference():
    """A slot broadcasts its bound value on the batch's device, as the
    reference's does; outside a scope it raises the same KeyError."""
    import jax.numpy as jnp
    import numpy as np

    from presto_tpu import expr as JE
    from presto_tpu.batch import Batch as JBatch
    from presto_tpu.plan.templates import device_params as j_device_params
    from presto_tpu.types import DATE as JDATE
    from presto_tpu.types import decimal as jdecimal
    from presto_tpu_torch import expr as PE
    from presto_tpu_torch.plan.templates import device_params as p_device_params
    from presto_tpu_torch.types import DATE, decimal
    from torch_bridge import assert_same, port_batch

    jb = JBatch.from_numpy({"x": np.arange(5, dtype=np.int64)},
                           {"x": jdecimal(12, 2)})
    pb = port_batch(jb)
    jbound = ((jdecimal(12, 2), 0.07), (JDATE, "1994-01-01"))
    pbound = ((decimal(12, 2), 0.07), (DATE, "1994-01-01"))
    with JE.param_scope(j_device_params(jbound)):
        want = [JE.evaluate(JE.Param(t, i), jb) for i, (t, _v) in enumerate(jbound)]
    with PE.param_scope(p_device_params(pbound, "cpu")):
        got = [PE.evaluate(PE.Param(t, i), pb) for i, (t, _v) in enumerate(pbound)]
    for g, w in zip(got, want):
        assert_same(g.data, jnp.asarray(w.data))
        assert_same(g.valid, jnp.asarray(w.valid))
    with pytest.raises(KeyError) as jerr:
        JE.evaluate(JE.Param(JDATE, 0), jb)
    with pytest.raises(KeyError) as perr:
        PE.evaluate(PE.Param(DATE, 0), pb)
    assert str(perr.value) == str(jerr.value)
