"""The port's fault points, query retries and events against the JAX
package's (``presto_tpu/runtime/{faults,events}.py`` and the sites in
``exec/``).

A ``FaultInjector`` that counts its reaches (``torch_bridge.
counting_injector``) shows the port's fault points sit at the
reference's sites and are reached as often per site, on one split a
table and on several (the prefetch worker's loads pass ``scan`` too); the
lifecycle's cancel checkpoint (``step.cancel_checkpoint``, A8) is the one
reference site the port does not have yet (ROADMAP C17). An injected
scan fault is re-run from the top under ``query_retries`` (``query.
retried``) and fails the query alike without it. Events come in the
reference's order, a raising listener is swallowed and counted, and the
history ring keeps ``query_history_limit`` entries.
"""

from __future__ import annotations

import random

import pandas as pd
import pytest
import torch

import presto_tpu.runtime.faults as JF
import presto_tpu_torch.runtime.faults as PF
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.connectors.tpch.queries import QUERIES
from presto_tpu.runtime.metrics import REGISTRY as JREGISTRY
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import pipeline as PP
from presto_tpu_torch.runtime.errors import TransientFailure
from presto_tpu_torch.runtime.metrics import REGISTRY as PREGISTRY
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import counting_injector, port_frame

SF = 0.01
UNITS = 2048

#: reference fault sites the port has no code for yet (none since the
#: lifecycle's cooperative cancel checkpoint, A8)
NOT_PORTED_SITES = ()

STATEMENTS = {
    "q1": QUERIES["q1"],
    "q3": QUERIES["q3"],
    "q6": QUERIES["q6"],
    "group-by over a join": ("select o_orderpriority, count(*) c, sum(l_quantity) q "
                             "from lineitem join orders on l_orderkey = o_orderkey "
                             "where l_shipdate < date '1995-01-01' "
                             "group by o_orderpriority order by o_orderpriority"),
}


@pytest.fixture(scope="module")
def conns():
    return {None: (JConnector(sf=SF), PConnector(sf=SF, device="cpu")),
            UNITS: (JConnector(sf=SF, units_per_split=UNITS),
                    PConnector(sf=SF, units_per_split=UNITS, device="cpu"))}


def sessions(pair, **props):
    return (JSession({"tpch": pair[0]}, properties={"result_cache_enabled": False, **props}),
            PSession({"tpch": pair[1]}, properties=props, device="cpu"))


def reaches(mod, session, call):
    inj = counting_injector(mod.FaultInjector)()
    with mod.injected(inj):
        call(session)
    return {k: v for k, v in inj.reaches.items() if k not in NOT_PORTED_SITES}


@pytest.mark.parametrize("how", ["sql", "execute"])
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_fault_reaches_per_site_equal_reference(conns, name, how):
    js, ps = sessions(conns[None])

    def call(s):
        return getattr(s, how)(STATEMENTS[name])

    want = reaches(JF, js, call)
    assert reaches(PF, ps, call) == want
    assert want.get("scan", 0) > 0


@pytest.mark.parametrize("name", ["q3", "group-by over a join"])
def test_fault_reaches_with_several_splits_equal_reference(conns, name, monkeypatch):
    monkeypatch.setattr(PP, "prefetch_enabled", lambda: True)
    js, ps = sessions(conns[UNITS])

    def call(s):
        return s.sql(STATEMENTS[name])

    want = reaches(JF, js, call)
    assert reaches(PF, ps, call) == want
    assert want["scan"] > len(conns[UNITS][1].splits("orders"))


def test_injected_scan_fault_is_retried_from_the_top(conns):
    sql = STATEMENTS["group-by over a join"]
    js, ps = sessions(conns[None], query_retries=1)
    answers, retried = [], []
    for mod, s, reg in ((JF, js, JREGISTRY), (PF, ps, PREGISTRY)):
        before = reg.snapshot().get("query.retried", 0.0)
        inj = mod.FaultInjector()
        inj.inject("scan", times=1)
        with mod.injected(inj):
            answers.append(s.sql(sql))
        retried.append(reg.snapshot()["query.retried"] - before)
        assert inj.fired("scan") == 1
        assert [i.state for i in s.query_history] == ["FAILED", "FINISHED"]
    pd.testing.assert_frame_equal(port_frame(answers[1]), answers[0])
    assert retried == [1.0, 1.0]


def test_injected_scan_fault_without_retries_fails_alike(conns):
    js, ps = sessions(conns[None])
    errors = []
    for mod, s in ((JF, js), (PF, ps)):
        inj = mod.FaultInjector()
        inj.inject("scan", times=1)
        with mod.injected(inj), pytest.raises(Exception) as err:
            s.sql(QUERIES["q6"])
        info = s.query_history[-1]
        errors.append((type(err.value).__name__, str(err.value), info.state, info.error_code,
                       info.retryable, info.metrics.get("post_run.query.failed")))
    assert errors[1] == errors[0]
    assert errors[1][:1] == ("TransientFailure",) and errors[1][3] == "TRANSIENT_FAILURE"
    assert isinstance(TransientFailure("x"), RuntimeError)


def test_inject_oom_raises_a_torch_out_of_memory_error():
    inj = PF.FaultInjector()
    spec = inj.inject_oom("step", times=2)
    for _ in range(2):
        with pytest.raises(torch.OutOfMemoryError, match="CUDA out of memory") as err:
            inj.check("step.join_build")
        assert isinstance(err.value, PF.BackendOom)
    inj.check("step.join_build")
    assert spec.fired == 2 and inj.fired_at("step.join_build") == 2
    assert PF.SITES == JF.SITES


def fire_pattern(mod, seed: int, specs, sites):
    inj = mod.FaultInjector(seed=seed)
    for site, kw in specs:
        inj.inject(site, **kw)
    out = []
    for site in sites:
        try:
            inj.check(site)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the pattern is the assertion
            out.append((type(e).__name__, str(e)))
    return out, inj.fired(), {s: inj.fired_at(s) for s in set(sites)}


SPEC_CASES = {
    "times": ([("scan", {"times": 2})], ["scan"] * 4),
    "prefix": ([("step", {"times": None})], ["step.agg", "step.join_build", "scan", "steps"]),
    "per_site": ([("step", {"times": 1, "per_site": True})],
                 ["step.agg", "step.agg", "step.join_build", "step.join_build"]),
    "probability": ([("scan", {"times": None, "probability": 0.3})], ["scan"] * 40),
    "message": ([("aggregation", {"message": "lost device"})], ["aggregation"] * 2),
    "first match": ([("scan", {"times": 1}), ("scan", {"times": 1, "error": ValueError})],
                    ["scan"] * 3),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
@pytest.mark.parametrize("seed", [0, 7])
def test_injector_fires_like_reference(case, seed):
    specs, sites = SPEC_CASES[case]
    assert fire_pattern(PF, seed, specs, sites) == fire_pattern(JF, seed, specs, sites)


def test_fault_point_is_a_no_op_without_an_injector():
    assert PF.active() is None
    PF.fault_point("scan")
    inj = PF.FaultInjector()
    with PF.injected(inj):
        assert PF.active() is inj
    assert PF.active() is None
    assert random.Random(0).random() == PF.FaultInjector(seed=0)._rng.random()


# ---------------------------------------------------------------------------
# events and the history ring
# ---------------------------------------------------------------------------


class Recording:
    def __init__(self):
        self.events = []

    def query_created(self, info):
        self.events.append(("created", info.state))

    def query_failed(self, info):
        self.events.append(("failed", info.state))

    def query_completed(self, info):
        self.events.append(("completed", info.state))


class Raising:
    def query_completed(self, info):
        raise RuntimeError("listener bug")


def test_events_come_in_the_reference_order(conns):
    js, ps = sessions(conns[None])
    got = []
    for mod, s in ((JF, js), (PF, ps)):
        listener = Recording()
        s.add_event_listener(listener)
        s.sql("select count(*) c from nation")
        s.execute("select count(*) c from region")
        inj = mod.FaultInjector()
        inj.inject("scan", times=None)
        with mod.injected(inj), pytest.raises(Exception):
            s.sql("select count(*) c from nation")
        with pytest.raises(Exception):
            s.execute("select (select l_orderkey from lineitem) x")
        got.append(listener.events)
    assert got[1] == got[0]
    assert got[1][4:7] == [("created", "QUEUED"), ("failed", "FAILED"),
                           ("completed", "FAILED")]


def test_listener_errors_are_swallowed_and_counted(conns):
    js, ps = sessions(conns[None])
    moved = []
    for s, reg in ((js, JREGISTRY), (ps, PREGISTRY)):
        s.add_event_listener(Raising())
        recording = Recording()
        s.add_event_listener(recording)
        before = reg.snapshot().get("events.listener_errors", 0.0)
        s.sql("select count(*) c from nation")
        moved.append((reg.snapshot()["events.listener_errors"] - before, recording.events,
                      s.query_history[-1].state))
    assert moved[1] == moved[0] == (1.0, [("created", "QUEUED"), ("completed", "FINISHED")],
                                    "FINISHED")


def test_history_ring_is_bounded_by_query_history_limit(conns):
    js, ps = sessions(conns[None], query_history_limit=2)
    for s in (js, ps):
        for t in ("nation", "region", "supplier"):
            s.sql(f"select count(*) c from {t}")
    assert len(ps.history) == len(js.history) == 2
    assert [i.sql for i in ps.history.infos()] == [i.sql for i in js.history.infos()]
    assert ps.history.infos()[-1] is ps.query_history[-1]
    assert len(ps.query_history) == 3
