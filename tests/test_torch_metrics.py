"""The port's metrics registry and per-query attribution against the JAX
package's (``presto_tpu/runtime/metrics.py``, ``QueryInfo.attribute_metrics``).

Each statement runs through both packages' sessions at sf 0.01 (result
cache off in both), each from cleared executable and stats caches (they
are process-wide): ``QueryInfo.metrics`` (the ``exec_cache.*``,
``stats_cache.*`` and ``plan_stats.*`` families included; without
``exec.traces``, which counts XLA traces, ROADMAP C17; timers and
histograms by count), ``join_strategy`` and ``filter_selectivity`` are
equal, ``post_run.query.completed`` / ``post_run.query.failed``
included. The registries' OpenMetrics text, the session's gauges with
it, is byte-identical when fed the same adds, and the stat classes
answer alike.
"""

from __future__ import annotations

import threading

import pytest

import presto_tpu.cache.exec_cache as JE
import presto_tpu.cache.stats_cache as JS
import presto_tpu.runtime.metrics as JM
import presto_tpu_torch.cache.exec_cache as PE
import presto_tpu_torch.cache.stats_cache as PS
import presto_tpu_torch.runtime.metrics as PM
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import comparable_metrics

#: every case starts from cleared executable and stats caches
pytestmark = pytest.mark.resets_global_state

SF = 0.01

Q6_PREPARED = ("select sum(l_extendedprice * l_discount) as revenue from lineitem "
               "where l_shipdate >= ? and l_shipdate < ? and l_discount between ? and ? "
               "and l_quantity < ?")
Q6_BINDING = ["1994-01-01", "1995-01-01", 0.05, 0.07, 24]

#: name -> (statements run first, the statement whose QueryInfo is
#: compared, how it runs: "execute", "sql" or "prepared")
STATEMENTS = {
    "q1": ((), QUERIES["q1"], "execute"),
    "q3": ((), QUERIES["q3"], "execute"),
    "q6": ((), QUERIES["q6"], "execute"),
    "q10": ((), QUERIES["q10"], "execute"),
    "q1 sql": ((), QUERIES["q1"], "sql"),
    "q6 sql": ((), QUERIES["q6"], "sql"),
    "runtime-filtered join": ((), QUERIES["q3"], "sql"),
    "left join": ((), "select n_name, count(s_suppkey) c from nation left join supplier "
                      "on n_nationkey = s_nationkey group by n_name order by n_name",
                  "execute"),
    "ctas": ((), "create table li_t as select l_orderkey, l_linenumber, l_quantity "
                 "from lineitem where l_quantity < 20", "sql"),
    "insert": (("create table li_t as select l_orderkey, l_linenumber, l_quantity "
                "from lineitem where l_quantity < 20",),
               "insert into li_t select l_orderkey, l_linenumber, l_quantity from lineitem "
               "where l_quantity > 45", "sql"),
    "prepared q6": ((), Q6_PREPARED, "prepared"),
}


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture(autouse=True)
def cold_caches():
    """Both packages' executable and stats caches start empty, so their
    hits and misses count from the same state."""
    JE.EXEC_CACHE.clear()
    PE.EXEC_CACHE.clear()
    JS.clear()
    PS.clear()


def sessions(conns, **props):
    props = {"result_cache_enabled": False, **props}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def run(session, first, sql, how):
    for stmt in first:
        session.sql(stmt)
    if how == "execute":
        return session.execute(sql)[1]
    if how == "prepared":
        return session.execute(session.prepare(sql), Q6_BINDING)[1]
    session.sql(sql)
    return session.query_history[-1]


def attribution(info) -> tuple:
    return (comparable_metrics(info.metrics), info.join_strategy,
            round(info.filter_selectivity, 9), info.state)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_query_info_attribution_equals_reference(conns, name):
    first, sql, how = STATEMENTS[name]
    js, ps = sessions(conns)
    want = run(js, first, sql, how)
    got = run(ps, first, sql, how)
    assert attribution(got) == attribution(want)
    assert got.metrics.get("post_run.query.completed") == 1.0
    assert "query.completed" not in got.metrics


def test_customer_orders_join_attribution_equals_reference(conns):
    """The customer-orders join with a group-by: a join strategy, a
    filter observation and the route counters, as the reference."""
    sql = ("select c_mktsegment, count(*) c from customer join orders "
           "on c_custkey = o_custkey group by c_mktsegment order by c_mktsegment")
    js, ps = sessions(conns)
    want, got = js.execute(sql)[1], ps.execute(sql)[1]
    assert got.join_strategy == want.join_strategy != ""
    assert got.filter_selectivity == want.filter_selectivity
    assert got.metrics["join.filter_selectivity.count"] == 1.0
    assert attribution(got) == attribution(want)


def test_post_run_failed_on_a_statement_that_fails_at_execution(conns):
    sql = "select (select l_orderkey from lineitem) x"
    js, ps = sessions(conns)
    with pytest.raises(Exception) as jerr:
        js.execute(sql)
    with pytest.raises(Exception) as perr:
        ps.execute(sql)
    assert str(perr.value) == str(jerr.value)
    want, got = js.query_history[-1], ps.query_history[-1]
    assert got.state == want.state == "FAILED"
    assert got.error_code == want.error_code
    assert got.metrics.get("post_run.query.failed") == 1.0
    assert attribution(got) == attribution(want)


@pytest.mark.parametrize("how", ["execute", "sql"])
def test_to_json_equal_on_attributed_keys(conns, how):
    """``QueryInfo.to_json()``'s attribution keys agree."""
    import json

    js, ps = sessions(conns)
    want = json.loads(run(js, (), QUERIES["q3"], how).to_json())
    got = json.loads(run(ps, (), QUERIES["q3"], how).to_json())
    for key in ("joinStrategy", "filterSelectivity", "state", "outputRows", "approximate"):
        assert got[key] == want[key], key
    assert comparable_metrics(got["metrics"]) == comparable_metrics(want["metrics"])


# ---------------------------------------------------------------------------
# the registry and its exposition
# ---------------------------------------------------------------------------


def feed(mod):
    """A registry of ``mod`` fed one fixed sequence of adds."""
    reg = mod.MetricsRegistry()
    reg.counter("join.strategy.pallas").add()
    reg.counter("join.filter_rows_in").add(60297)
    reg.counter("exec.leaf_route_fallback.value-overflow").add(2)
    reg.counter("query.completed").add(0.5)
    for v in (0.0001, 0.02, 0.3, 4.0, 250.0):
        reg.timer("fragment.dispatch_s").add(v)
        reg.histogram("query.execution_s").add(v)
    for v in (0.0, 0.45, 0.55, 1.0):
        reg.histogram("join.filter_selectivity").add(v)
    reg.histogram("exchange.skew").add(3.5)
    reg.timer("never.timed")
    reg.histogram("never.observed")
    return reg


def test_metric_help_and_bounds_equal_reference():
    assert PM.METRIC_HELP == JM.METRIC_HELP
    assert PM.HISTOGRAM_BOUNDS == JM.HISTOGRAM_BOUNDS
    assert PM.DEFAULT_BOUNDS == JM.DEFAULT_BOUNDS
    assert PM.EXPOSITION_PREFIX == JM.EXPOSITION_PREFIX == "presto_tpu_"


@pytest.mark.parametrize("gauges", [None, {"memory_pool_occupancy": 0.25, "x.y-z": 3}])
def test_openmetrics_byte_identical(gauges):
    assert PM.to_openmetrics(feed(PM), gauges=gauges) == JM.to_openmetrics(feed(JM),
                                                                           gauges=gauges)


def test_openmetrics_of_an_empty_registry():
    assert PM.to_openmetrics(PM.MetricsRegistry()) == JM.to_openmetrics(JM.MetricsRegistry())


def test_snapshot_equal_reference():
    assert feed(PM).snapshot() == feed(JM).snapshot()


def test_export_metrics_file_equals_reference(conns, tmp_path, monkeypatch):
    """``Session.export_metrics(path)`` writes the registry's exposition
    with the live gauges (the memory pool, the executable cache's
    entries, the flight recorder's depth), byte for byte the reference's
    over registries fed the same adds, pools of one capacity and caches
    holding the same entries (the device gauges, which name each
    package's devices, off)."""
    js, ps = sessions(conns, memory_pool_bytes=1 << 30, device_telemetry=False)
    for s in (js, ps):
        s.sql("select count(*) c from region")
    assert len(PE.EXEC_CACHE) == len(JE.EXEC_CACHE) > 0
    monkeypatch.setattr(PM, "REGISTRY", feed(PM))
    monkeypatch.setattr(JM, "REGISTRY", feed(JM))
    path = tmp_path / "metrics.prom"
    text = ps.export_metrics(str(path))
    assert path.read_text() == text == js.export_metrics()
    assert "presto_tpu_exec_cache_entries " in text


# ---------------------------------------------------------------------------
# the stat classes (after tests/test_trace.py's histogram cases)
# ---------------------------------------------------------------------------

SERIES = {
    "latency": [0.001] * 98 + [0.5, 2.0],
    "ratios": [0.0, 0.01, 0.011, 0.5, 0.99, 1.0, 1.0],
    "overflow": [1e-6, 150.0, 1e4],
    "empty": [],
}


@pytest.mark.parametrize("series", list(SERIES))
@pytest.mark.parametrize("bounds", ["default", "selectivity"])
def test_histogram_quantiles_equal_reference(series, bounds):
    stats = []
    for mod in (JM, PM):
        b = mod.DEFAULT_BOUNDS if bounds == "default" else mod.SELECTIVITY_BOUNDS
        h = mod.HistogramStat("t", b)
        for v in SERIES[series]:
            h.add(v)
        snap = {}
        h.snapshot_into(snap)
        stats.append((h.counts, h.count, h.max, [h.quantile(q) for q in (0.5, 0.95, 0.99)],
                      snap))
    assert stats[0] == stats[1]


def test_histogram_percentiles_bracket_the_values():
    h = PM.HistogramStat("t")
    for v in SERIES["latency"]:
        h.add(v)
    assert h.count == 100 and h.max == 2.0
    assert h.quantile(0.5) <= 0.0018 and h.quantile(0.99) >= 0.5


def test_adds_are_thread_safe():
    reg = PM.MetricsRegistry()
    c, t, h = reg.counter("race.counter"), reg.timer("race.timer"), reg.histogram("race.hist")

    def bump():
        for _ in range(2000):
            c.add()
            t.add(0.001)
            h.add(0.001)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.total == t.count == h.count == 8 * 2000


def test_reset_drops_every_stat():
    reg = PM.MetricsRegistry()
    reg.counter("a").add(3)
    reg.histogram("b").add(1.0)
    reg.timer("c").add(1.0)
    assert reg.snapshot()
    reg.reset()
    assert reg.snapshot() == {}


def test_delta_collects_adds_of_its_context_only():
    """A delta installed in one thread's context sees that thread's adds;
    another thread's adds (no delta) reach only the global stat."""
    reg = PM.MetricsRegistry()
    delta = PM.QueryMetricsDelta()
    token = PM.install_delta(delta)
    try:
        reg.counter("mine").add(2)
        other = threading.Thread(target=lambda: reg.counter("theirs").add(5))
        other.start()
        other.join()
        assert PM.current_delta() is delta
    finally:
        PM.uninstall_delta(token)
    assert PM.current_delta() is None
    assert delta.snapshot() == {"mine": 2.0}
    assert reg.snapshot() == {"mine": 2.0, "theirs": 5.0}
