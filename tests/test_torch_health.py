"""The port's SLO tracker and health watchdog
(``presto_tpu_torch/runtime/health.py``) and device telemetry against the
JAX package's, case for case after ``tests/test_health.py``.

- metric hygiene: every literal metric family the port fires has a
  ``METRIC_HELP`` entry;
- device telemetry: ``sample_devices`` rows and ``system.device_stats``;
- tenant SLOs: the same burn rates and overrides on an injected latency
  series in both packages, and ``QueryManager._observe_slo`` feeding a
  tracker attached as ``session.slo`` alike;
- the watchdog: armed and quiet it costs under 5 % and never breaches; a
  seeded latency regression trips exactly one ``health.breach`` with a
  flight record of the in-flight query, in both packages.

The reference's W3C ``traceparent`` and request trace-context cases, and
its ``QueryServer`` wiring of the tracker, have their counterparts in
``tests/test_torch_server.py``; the cases here attach the tracker and
the monitor by hand.
Every monitor a case starts is closed (``live_monitors`` is checked after
each case).
"""

from __future__ import annotations

import pathlib
import re
import threading
import time

import pytest

import presto_tpu.runtime.health as JH
import presto_tpu.runtime.metrics as JM
import presto_tpu_torch.runtime.health as PH
import presto_tpu_torch.runtime.metrics as PM
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.lifecycle import QueryManager as JQueryManager
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.runtime.devices import DISPATCH_WALL, headroom_bytes, peak_bytes
from presto_tpu_torch.runtime.devices import sample_devices
from presto_tpu_torch.runtime.lifecycle import QueryManager as PQueryManager
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import port_frame

Q_FAST = "select count(*) c from nation"
SF = 0.005


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


@pytest.fixture(autouse=True)
def no_leaked_monitor():
    """Every port monitor a case starts is closed by its end."""
    yield
    leaked = PH.live_monitors()
    for mon in leaked:
        mon.close()
    assert not leaked, "a port HealthMonitor thread outlived its test"


def sessions(conns, **props):
    props = {"result_cache_enabled": False, **props}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def counter(mod, name):
    return mod.REGISTRY.snapshot().get(name, 0.0)


# ---------------------------------------------------------------------------
# metric hygiene
# ---------------------------------------------------------------------------


def test_metric_help_covers_every_literal_family():
    root = pathlib.Path(__file__).resolve().parent.parent
    pat = re.compile(r'REGISTRY\.(?:counter|timer|histogram)\(\s*"([^"{]+)"')
    fired = set()
    for path in sorted((root / "presto_tpu_torch").rglob("*.py")):
        fired.update(pat.findall(path.read_text()))
    missing = sorted(fired - set(PM.METRIC_HELP))
    assert not missing, f"metric families fired without a METRIC_HELP entry: {missing}"


# ---------------------------------------------------------------------------
# device telemetry
# ---------------------------------------------------------------------------


def test_device_sampling_rows_and_system_table(conns):
    rows = sample_devices()
    assert rows
    for r in rows:
        assert set(r) == {"device_id", "platform", "bytes_in_use", "peak_bytes",
                          "bytes_limit", "dispatch_wall_s", "dispatches"}
    assert isinstance(peak_bytes(), int)
    assert headroom_bytes() is None or isinstance(headroom_bytes(), int)
    _js, s = sessions(conns)
    wall0, n0 = DISPATCH_WALL.snapshot()
    s.sql(Q_FAST)
    wall1, n1 = DISPATCH_WALL.snapshot()
    assert n1 > n0 and wall1 >= wall0
    frame = port_frame(s.sql("select device_id, platform, bytes_in_use, dispatch_wall_s, "
                             "dispatches from device_stats"))
    assert len(frame) == len(rows)
    assert int(frame["dispatches"][0]) >= n1 - n0


# ---------------------------------------------------------------------------
# tenant SLOs
# ---------------------------------------------------------------------------


def test_slo_tracker_burn_rates_and_overrides():
    got = []
    for H in (JH, PH):
        slo = H.SloTracker(latency_objective_s=1.0, freshness_objective_s=10.0, window=8,
                           overrides={"gold": (0.1, None)})
        for dt in (0.2, 0.3, 0.4, 2.0):
            slo.observe_latency("web", dt)
        slo.observe_latency("gold", 0.2)  # the tighter override: a breach
        slo.observe_freshness("web", 3.0)
        got.append((slo.snapshot(), slo.burn_rate(), slo.burn_rate("web"), slo.gauges()))
    assert got[0] == got[1]
    rows = {r["tenant"]: r for r in got[1][0]}
    assert rows["web"]["latency_good"] == 3 and rows["web"]["latency_breach"] == 1
    assert rows["web"]["latency_burn_rate"] == pytest.approx(0.25)
    assert rows["gold"]["latency_objective_s"] == pytest.approx(0.1)
    assert rows["gold"]["latency_burn_rate"] == 1.0
    assert got[1][1] == 1.0 and got[1][2] == pytest.approx(0.25)


def test_slo_observes_each_query_through_the_lifecycle(conns):
    """A tracker attached as ``session.slo`` observes every executed
    query (a failure as a breach) and answers ``system.slo``, alike."""
    got = []
    for s, H, port in zip(sessions(conns), (JH, PH), (False, True)):
        s.slo = H.SloTracker(latency_objective_s=120.0)
        s.sql(Q_FAST)
        s.sql("select count(*) c from region")
        with pytest.raises(Exception):
            s.sql("select (select n_nationkey from nation) x")  # fails at execution
        frame = s.sql("select tenant, latency_objective_s, latency_good, latency_breach, "
                      "latency_burn_rate from slo")
        frame = port_frame(frame) if port else frame
        got.append([tuple(v.rstrip(b"\x00").decode() if isinstance(v, bytes) else v for v in r)
                    for r in frame.itertuples(index=False)])
    assert got[0] == got[1]
    assert got[1][0][0] == "default" and got[1][0][2:4] == (2, 1)


# ---------------------------------------------------------------------------
# the watchdog: armed and quiet
# ---------------------------------------------------------------------------


def test_watchdog_armed_quiet_overhead_under_5pct(conns):
    breaches0 = counter(PM, "health.breach")
    _js, s_on = sessions(conns)
    _js, s_off = sessions(conns, device_telemetry=False)
    s_on.slo = PH.SloTracker()
    s_on.health = PH.HealthMonitor(s_on, interval_s=0.05).start()
    try:
        s_on.sql(Q_FAST)
        s_off.sql(Q_FAST)

        def best_of(rounds):
            on, off = [], []
            for _ in range(rounds):
                t0 = time.perf_counter()
                s_off.sql(Q_FAST)
                off.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                s_on.sql(Q_FAST)
                on.append(time.perf_counter() - t0)
            return min(on), min(off)

        for rounds in (5, 9, 13):
            best_on, best_off = best_of(rounds)
            if best_on <= best_off * 1.05 + 0.005:
                break
        else:
            raise AssertionError(f"armed-quiet watchdog overhead too high: "
                                 f"on={best_on:.4f}s off={best_off:.4f}s")
        time.sleep(0.15)  # a few 0.05 s samples land
        assert s_on.health.snapshot(), "watchdog never sampled"
        assert s_on.health.breaches() == []
        assert counter(PM, "health.breach") == breaches0
    finally:
        s_on.health.close()
    assert not s_on.health.running()


# ---------------------------------------------------------------------------
# the watchdog: a seeded regression trips exactly one breach
# ---------------------------------------------------------------------------


def seeded_breach(session, H, M, QM, warm, monkeypatch, port: bool):
    """Drive a monitor by ``sample()`` alone: a clean baseline, then a
    seeded latency regression with a second slow query in flight. Returns
    the comparable outcome."""
    breaches0 = counter(M, "health.breach")
    warm.sql(Q_FAST)
    warm.sql("select count(*) c2 from region")
    s = session
    mon = H.HealthMonitor(s, min_samples=3, p99_factor=3.0, cooldown_s=1000.0)
    s.health = mon
    for _ in range(5):
        s.sql(Q_FAST)
    clean = [mon.sample()["breach"] for _ in range(4)]
    fast_p99 = max(i.execution_s for i in s.history.infos())
    delay = max(0.5, 5.0 * fast_p99)
    orig = QM._run_with_oom_ladder

    def slow_ladder(self, executor, plan, info, recorder, ctx):
        time.sleep(delay)
        return orig(self, executor, plan, info, recorder, ctx)

    monkeypatch.setattr(QM, "_run_with_oom_ladder", slow_ladder)
    s.sql(Q_FAST)
    errors: list = []

    def run_inflight():
        try:
            s.sql("select count(*) c2 from region")
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors.append(e)

    t = threading.Thread(target=run_inflight, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not s.query_manager.inflight_snapshot() and time.monotonic() < deadline:
        time.sleep(0.005)
    inflight = s.query_manager.inflight_snapshot()
    assert inflight, "the seeded query never registered in flight"
    cur = mon.sample()
    later = [mon.sample()["breach"] for _ in range(3)]
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    monkeypatch.setattr(QM, "_run_with_oom_ladder", orig)
    events = mon.breaches()
    recs = [r for r in s.flight.records() if "health_breach" in r.triggers]
    frame = s.sql("select breach, reason from health")
    frame = port_frame(frame) if port else frame
    reasons = [r.rstrip(b"\x00").decode() if isinstance(r, bytes) else r
               for r in frame["reason"]]
    return (clean, cur["breach"], "p99" in cur["reason"], later, len(events),
            counter(M, "health.breach") - breaches0,
            events[0]["query_id"] == inflight[0]["info"].query_id,
            events[0]["baseline_p99_s"] > 0, len(recs),
            recs[0].query_id == events[0]["query_id"], recs[0].trace_enabled,
            bool(recs[0].spans), bool(recs[0].plan_render), "reserved_bytes" in recs[0].pool,
            int(sum(frame["breach"])), any("p99" in r for r in reasons))


def test_seeded_latency_regression_trips_exactly_one_breach(conns, monkeypatch):
    got = []
    for (s, warm), H, M, QM, port in zip(
            zip(sessions(conns, trace_enabled=True), sessions(conns, trace_enabled=True)),
            (JH, PH), (JM, PM), (JQueryManager, PQueryManager), (False, True)):
        got.append(seeded_breach(s, H, M, QM, warm, monkeypatch, port))
    assert got[0] == got[1]
    assert got[1] == ([0, 0, 0, 0], 1, True, [0, 0, 0], 1, 1, True, True, 1, True, True,
                      True, True, True, 1, True)
