"""Degradation to local (``degrade_to_local``): a mesh run that fails
with a retryable error, its fragment retries spent, re-plans onto the
one-device local pipeline (``runtime/lifecycle.QueryManager._degrade``).

Each case runs the JAX package's ``Session(mesh=make_mesh(n))`` and the
port's over the same faults and compares the frames, the
``query.degraded_to_local`` / ``query.oom_degraded`` / ``fragment.retried``
counter moves, ``QueryInfo.degraded``, its rung history and fragment
retries, and the span trees (the ``degrade_to_local`` span included,
ROADMAP C14); with the property off, or for an error that is not
retryable, both raise the same typed error. An OOM at every rung of a
mesh run (ROADMAP C19) ends as the JAX package's does. The span trees
hold ``exec_cache:build`` spans, so each faulted run starts from both
packages' executable caches cleared (``resets_global_state``).
"""

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

import presto_tpu.cache.exec_cache as JE  # noqa: E402
import presto_tpu.runtime.faults as JF  # noqa: E402
import presto_tpu_torch.cache.exec_cache as PE  # noqa: E402
import presto_tpu_torch.runtime.faults as PF  # noqa: E402
from presto_tpu.connectors.tpch import TpchConnector as JT  # noqa: E402
from presto_tpu.connectors.tpch.queries import QUERIES  # noqa: E402
from presto_tpu.runtime.metrics import REGISTRY as JR  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PT  # noqa: E402
from presto_tpu_torch.runtime.metrics import REGISTRY as PR  # noqa: E402
from test_torch_distributed_joins import close_frame, local_frame, same_values, sessions  # noqa: E402
from torch_bridge import refused_alike, span_tree  # noqa: E402

pytestmark = pytest.mark.resets_global_state

SF = 0.002
UNITS = 1 << 14
#: fragment retries without sleeping
FAST = {"retry_count": 1, "retry_backoff_s": 0.0}
#: the lifecycle's counters a degraded run is held to
FAMILIES = ("query.degraded_to_local", "query.oom_degraded", "fragment.retried",
            "join.strategy.", "join.distribution.", "exec.pallas_join_route", "exchange.dispatches")


@pytest.fixture(scope="module")
def conns():
    return JT(sf=SF, units_per_split=UNITS), PT(sf=SF, units_per_split=UNITS, device="cpu")


def _moves(registry, before):
    after = registry.snapshot()
    return {k: round(v - before.get(k, 0), 9) for k, v in after.items()
            if k.startswith(FAMILIES) and v != before.get(k, 0)
            and not k.endswith((".p50", ".p95", ".p99", ".max"))}


def _info_view(info):
    """What a degraded run's QueryInfo must share with the JAX package's:
    the rung history without its backend's words (an injected OOM reads
    "CUDA out of memory" in the port, "RESOURCE_EXHAUSTED" there) and
    without the live device headroom."""
    return (info.state, info.degraded, info.oom_retries, info.fragment_retries,
            [{k: v for k, v in r.items() if k not in ("error", "device_headroom_bytes")}
             for r in info.rung_history])


def run_faulted(conns, sql, arm, props=None, n=4):
    """(port result, JAX frame, port moves, port info, port session) of
    ``sql`` on n-shard meshes with the faults ``arm(injector)`` sets in
    each package, after checking the counter moves, the QueryInfo views
    and the span trees are equal."""
    js, ps = sessions(conns, n, {**FAST, **(props or {})})
    jinj, pinj = JF.FaultInjector(), PF.FaultInjector()
    arm(jinj)
    arm(pinj)
    JE.EXEC_CACHE.clear()
    PE.EXEC_CACHE.clear()
    before = JR.snapshot()
    with JF.injected(jinj):
        want = js.sql(sql)
    jmoves = _moves(JR, before)
    before = PR.snapshot()
    with PF.injected(pinj):
        got = ps.sql(sql)
    pmoves = _moves(PR, before)
    assert pmoves == jmoves
    jinfo, pinfo = js.query_history[-1], ps.query_history[-1]
    assert _info_view(pinfo) == _info_view(jinfo)
    assert span_tree(ps.traces.latest()) == span_tree(js.traces.latest())
    assert pinj.fired() == jinj.fired()
    return got, want, pmoves, pinfo, ps


@pytest.mark.parametrize("site,times", [("exchange.join", None), ("step.join_build", 2)])
@pytest.mark.parametrize("props", [{}, {"broadcast_join_row_limit": 0}],
                         ids=["default", "repartition"])
def test_retryable_fault_degrades_to_local(conns, site, times, props):
    """The mesh attempt fails at ``site`` after its one fragment retry;
    the local run (no exchange, and past the armed fires) answers."""
    if site == "exchange.join" and not props:
        props = {"broadcast_join_row_limit": 0}  # the broadcast has no exchange.join
    got, want, moves, info, ps = run_faulted(
        conns, QUERIES["q3"], lambda inj: inj.inject(site, times=times), props)
    close_frame(got, want, site)
    same_values(got, local_frame(conns, QUERIES["q3"]))
    assert moves["query.degraded_to_local"] == 1 and info.degraded
    assert info.state == "FINISHED" and info.fragment_retries >= 1
    names = [s.name for s in ps.traces.latest().spans]
    assert "degrade_to_local" in names


def test_degraded_run_takes_the_session_device_and_pallas_join(conns, monkeypatch):
    """The degraded LocalExecutor runs on the session's own device with
    the session's ``pallas_join``, as the JAX package's reads it."""
    from presto_tpu_torch.exec import local_planner

    made = []
    real = local_planner.LocalExecutor.__init__

    def spy(self, *a, **k):
        made.append(k)
        real(self, *a, **k)

    monkeypatch.setattr(local_planner.LocalExecutor, "__init__", spy)
    _js, ps = sessions(conns, 2, {**FAST, "pallas_join": False,
                                  "broadcast_join_row_limit": 0})
    inj = PF.FaultInjector()
    inj.inject("exchange.join", times=None)
    with PF.injected(inj):
        ps.sql(QUERIES["q3"])
    assert ps.query_history[-1].degraded
    assert made and made[-1]["device"] == ps.device
    assert made[-1]["pallas_join_enabled"] is False


def test_degradation_off_raises_the_typed_error(conns):
    js, ps = sessions(conns, 4, {**FAST, "degrade_to_local": False,
                                 "broadcast_join_row_limit": 0})
    jinj, pinj = JF.FaultInjector(), PF.FaultInjector()
    jinj.inject("exchange.join", times=None)
    pinj.inject("exchange.join", times=None)

    def jrun():
        with JF.injected(jinj):
            js.sql(QUERIES["q3"])

    def prun():
        with PF.injected(pinj):
            ps.sql(QUERIES["q3"])

    err = refused_alike(jrun, prun)
    assert type(err).__name__ == "TransientFailure"
    assert _info_view(ps.query_history[-1]) == _info_view(js.query_history[-1])
    info = ps.query_history[-1]
    assert info.state == "FAILED" and info.error_code == "TRANSIENT_FAILURE"
    assert not info.degraded and info.fragment_retries == 1


def test_a_failure_that_is_not_retryable_still_raises(conns):
    """Only a retryable failure degrades: a user error on the mesh
    propagates from both packages, the query not degraded."""
    from presto_tpu.runtime.errors import UserError as JUser
    from presto_tpu_torch.runtime.errors import UserError as PUser

    js, ps = sessions(conns, 2, {**FAST, "broadcast_join_row_limit": 0})
    jinj, pinj = JF.FaultInjector(), PF.FaultInjector()
    jinj.inject("exchange.join", error=JUser, times=None, message="refused")
    pinj.inject("exchange.join", error=PUser, times=None, message="refused")

    def jrun():
        with JF.injected(jinj):
            js.sql(QUERIES["q3"])

    def prun():
        with PF.injected(pinj):
            ps.sql(QUERIES["q3"])

    refused_alike(jrun, prun)
    assert not ps.query_history[-1].degraded


def test_oom_at_every_rung_on_a_mesh_c19(conns):
    """ROADMAP C19: an OOM that fires at every rung of a mesh run walks
    the mesh's OOM ladder; what follows (the error after the last rung,
    the rung history, no degradation from an OOM) is the JAX package's."""
    js, ps = sessions(conns, 4, {**FAST, "broadcast_join_row_limit": 0, "oom_ladder_max": 2})
    jinj, pinj = JF.FaultInjector(), PF.FaultInjector()
    jinj.inject_oom("exchange.join", times=None)
    pinj.inject_oom("exchange.join", times=None)
    jb, pb = JR.snapshot(), PR.snapshot()

    def jrun():
        with JF.injected(jinj):
            js.sql(QUERIES["q3"])

    def prun():
        with PF.injected(pinj):
            ps.sql(QUERIES["q3"])

    errs = []
    for run in (jrun, prun):
        with pytest.raises(Exception) as e:
            run()
        errs.append(e.value)
    # the same class and site; the backend's own words differ (C19's
    # "CUDA out of memory" against "RESOURCE_EXHAUSTED")
    assert [type(e).__name__ for e in errs] == ["DeviceOutOfMemory"] * 2
    assert [str(e).split(":")[0] for e in errs[1:]] == [str(errs[0]).split(":")[0]]
    assert _moves(PR, pb) == _moves(JR, jb)
    assert _info_view(ps.query_history[-1]) == _info_view(js.query_history[-1])
    assert ps.query_history[-1].oom_retries == 2


def test_oom_then_transient_on_a_mesh_degrades_with_the_rung_count(conns):
    """A mesh run that steps one OOM rung and then fails retryably
    degrades; the local run's ladder continues the query's rung count
    (its history holds the mesh's rung)."""

    def arm(inj):
        inj.inject_oom("exchange.join", times=1)
        inj.inject("step.grouped_join", times=None)

    got, want, moves, info, _ps = run_faulted(
        conns, QUERIES["q3"], arm, {"broadcast_join_row_limit": 0})
    close_frame(got, want, "oom then transient")
    assert info.degraded and info.oom_retries == 1
    assert [r["kind"] for r in info.rung_history][:1] == ["ladder"]


def test_degraded_stats_do_not_double_count(conns):
    """``execute``'s node stats after a degraded run hold the local run's
    only, as the JAX package's do."""
    out = []
    for s, F in zip(sessions(conns, 2, {**FAST, "broadcast_join_row_limit": 0}), (JF, PF)):
        inj = F.FaultInjector()
        inj.inject("exchange.join", times=None)
        with F.injected(inj):
            _res, info = s.execute(QUERIES["q3"])
        out.append((info.degraded, [(st["node"], st["invocations"], st["output_rows"])
                                    for st in info.node_stats]))
    assert out[0] == out[1] and out[1][0]
