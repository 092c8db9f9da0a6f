"""The port's query lifecycle (``runtime/lifecycle.py``, ``runtime/errors.py``)
against the JAX package's (``tests/test_lifecycle.py``, ``tests/test_spill.py``).

- the error taxonomy: classes, stdlib ancestry, codes and retry classes
  equal to the reference's; ``is_backend_oom`` on what the card raises;
  ``error_code`` on ``QueryInfo``;
- deadlines: a deadline fires at ``scan`` in a multi-split query (the
  check runs on the query's thread, not the prefetch worker), and a
  retry's backoff never sleeps past it;
- admission: rejection before any launch, and ``peak_estimate_bytes``
  equal to the reference's on all 22 TPC-H plans at sf 0.01;
- fragment retries on an injected ``TransientFailure``, with the
  reference's retry labels and counts;
- the OOM ladder: an injected ``BackendOom`` (a ``torch.OutOfMemoryError``)
  walks it with the reference's ``rung_history`` and ``oom_rung`` and
  the same answer; the failed attempt's frames are dropped before the
  next rung;
- ``QueryInfo.to_json``'s lifecycle fields.

The distributed cases of the reference's file (exchange faults,
distributed -> local degradation) are in
``test_torch_distributed_degrade.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import json  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

import presto_tpu.runtime.errors as JE  # noqa: E402
import presto_tpu_torch.runtime.errors as PE  # noqa: E402
from presto_tpu.connectors.tpch import TpchConnector as JConnector  # noqa: E402
from presto_tpu.runtime import faults as jfaults  # noqa: E402
from presto_tpu.runtime.lifecycle import peak_estimate_bytes as j_peak  # noqa: E402
from presto_tpu.runtime.session import Session as JSession  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector  # noqa: E402
from presto_tpu_torch.connectors.tpch.queries import QUERIES  # noqa: E402
from presto_tpu_torch.runtime import faults  # noqa: E402
from presto_tpu_torch.runtime import lifecycle  # noqa: E402
from presto_tpu_torch.runtime.lifecycle import peak_estimate_bytes as p_peak  # noqa: E402
from presto_tpu_torch.runtime.metrics import REGISTRY  # noqa: E402
from presto_tpu_torch.runtime.session import Session  # noqa: E402
from torch_bridge import same_frame  # noqa: E402

SF = 0.005
GROUPED_SQL = ("select l_orderkey, count(*) c, sum(l_quantity) q "
               "from lineitem group by l_orderkey")
JOIN_SQL = ("select n_name, count(*) c, sum(s_acctbal) b "
            "from supplier join nation on s_nationkey = n_nationkey "
            "group by n_name order by n_name")


@pytest.fixture(scope="module")
def jconn():
    return JConnector(sf=SF)


@pytest.fixture(scope="module")
def pconn():
    return PConnector(sf=SF, device="cpu")


def session(conn, **properties):
    return Session({"tpch": conn}, properties=properties, device="cpu")


def jsession(conn, **properties):
    return JSession({"tpch": conn}, properties={**properties, "result_cache_enabled": False})


def counter(name):
    return REGISTRY.snapshot().get(name, 0.0)


class SlowScans(PConnector):
    """A TPC-H connector whose every split scan sleeps ``delay`` s first."""

    delay = 0.0

    def scan(self, split, columns=None, capacity=None):
        time.sleep(self.delay)
        return super().scan(split, columns, capacity)


# ---------------------------------------------------------------------------
# the error taxonomy
# ---------------------------------------------------------------------------

CLASSES = ("UserError", "ResourceExhausted", "DeviceOutOfMemory", "SpillBudgetExceeded",
           "SpillPartitionOverflow", "ExceededTimeLimit", "ServerOverloaded", "QueryCancelled",
           "TransientFailure", "InternalError")


@pytest.mark.parametrize("name", CLASSES)
def test_taxonomy_equals_reference(name):
    p, j = getattr(PE, name), getattr(JE, name)
    assert p.error_code == j.error_code and p.retryable == j.retryable
    for base in (ValueError, RuntimeError):
        assert issubclass(p, base) == issubclass(j, base)
    e, f = p("boom"), j("boom")
    assert PE.error_code(e) == JE.error_code(f) and PE.is_retryable(e) == JE.is_retryable(f)
    assert PE.is_backend_oom(e) is JE.is_backend_oom(f) is False


def test_server_overloaded_carries_retry_after():
    e = PE.ServerOverloaded("shed", retry_after_s=2)
    assert e.retry_after_s == 2.0 and e.retryable


def test_is_backend_oom_matches_what_the_card_raises():
    assert PE.is_backend_oom(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.11 GiB total capacity)"))
    assert PE.is_backend_oom(RuntimeError("CUDA error: out of memory"))
    assert PE.is_backend_oom(MemoryError())
    assert PE.is_backend_oom(faults.BackendOom("injected"))
    # a sticky launch failure is not an OOM; a taxonomy error never is
    assert not PE.is_backend_oom(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not PE.is_backend_oom(PE.ResourceExhausted("reservation out of memory pool"))
    for exc in (MemoryError(), RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                ValueError("x")):
        assert PE.is_backend_oom(exc) == JE.is_backend_oom(exc)
    assert PE.is_backend_oom(PE.ResourceExhausted("out of memory")) == JE.is_backend_oom(
        JE.ResourceExhausted("out of memory"))


@pytest.mark.parametrize("exc", [NotImplementedError("x"), ValueError("x"), TimeoutError(),
                                 MemoryError(), KeyError("x")], ids=lambda e: type(e).__name__)
def test_error_code_of_foreign_exceptions(exc):
    assert PE.error_code(exc) == JE.error_code(exc)


def test_user_errors_carry_code_on_query_info(jconn, pconn):
    s = session(pconn)
    with pytest.raises(ValueError):
        s.sql("select nosuchcolumn from nation")
    info = s.query_history[-1] if s.query_history else None
    # an analysis error fails before tracking, as in the reference
    js = jsession(jconn)
    with pytest.raises(ValueError):
        js.sql("select nosuchcolumn from nation")
    assert (info is None) == (not js.query_history)
    with pytest.raises(ValueError):
        s.sql("select (select r_regionkey from region) x from nation")
    info = s.query_history[-1]
    assert info.state == "FAILED" and info.error_code == "USER_ERROR"
    assert info.retryable is False


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


def test_deadline_expiry_raises_exceeded_time_limit(pconn):
    s = session(pconn, query_max_run_time=1e-9)
    before = counter("query.deadline_exceeded")
    with pytest.raises(PE.ExceededTimeLimit):
        s.sql(GROUPED_SQL)
    info = s.query_history[-1]
    assert info.state == "FAILED" and info.error_code == "EXCEEDED_TIME_LIMIT"
    assert info.retryable is False
    assert counter("query.deadline_exceeded") > before
    assert s.pool().reserved_bytes == 0


@pytest.mark.parametrize("sql", [GROUPED_SQL, QUERIES["q6"]], ids=["grouped", "leaf-route"])
def test_deadline_fires_at_scan_in_a_multi_split_query(sql):
    """Every split scan takes 0.3 s and the deadline is 0.45 s: it expires
    while the second split loads, and the scan loop's check (on the
    query's thread) is the first to see it."""
    conn = SlowScans(sf=SF, units_per_split=1 << 10, device="cpu")
    conn.delay = 0.3
    assert len(list(conn.splits("lineitem"))) > 2
    s = session(conn, query_max_run_time=0.45)
    before = counter("query.deadline_exceeded")
    with pytest.raises(PE.ExceededTimeLimit, match=r"checked at scan\)"):
        s.sql(sql)
    # counted into the query's own metrics: the check ran in its context
    assert counter("query.deadline_exceeded") == before + 1
    assert s.query_history[-1].metrics.get("query.deadline_exceeded") == 1
    assert s.pool().reserved_bytes == 0


def test_retry_backoff_never_sleeps_past_the_deadline(pconn):
    s = session(pconn, query_max_run_time=0.3, retry_count=3, retry_backoff_s=30.0)
    inj = faults.FaultInjector()
    inj.inject("aggregation", times=None)
    t0 = time.monotonic()
    with faults.injected(inj):
        with pytest.raises(PE.ExceededTimeLimit):
            s.sql(GROUPED_SQL)
    assert time.monotonic() - t0 < 5.0  # not 30 s per attempt


def test_generous_deadline_does_not_fire(pconn):
    assert len(session(pconn, query_max_run_time=3600.0).sql("select count(*) c from nation")) == 1


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_admission_rejects_before_execution(pconn):
    s = session(pconn, query_max_memory_bytes=1)
    before = counter("query.admission_rejected")
    inj = faults.FaultInjector()
    inj.inject("scan", times=None)  # any scan would raise
    with faults.injected(inj):
        with pytest.raises(PE.ResourceExhausted, match="admission control"):
            s.sql(GROUPED_SQL)
    assert inj.fired() == 0
    assert counter("query.admission_rejected") == before + 1
    info = s.query_history[-1]
    assert info.error_code == "RESOURCE_EXHAUSTED" and info.state == "FAILED"
    assert s.pool().reserved_bytes == 0


def test_admission_default_is_permissive(pconn):
    s = session(pconn)
    assert s.prop("query_max_memory_bytes") is None
    assert len(s.sql(GROUPED_SQL)) > 0
    assert s.query_history[-1].memory_reserved_bytes > 0


@pytest.fixture(scope="module")
def plans01():
    from presto_tpu.connectors.tpch.queries import QUERIES as JQ

    js = JSession({"tpch": JConnector(sf=0.01)})
    ps = Session({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu")
    return js, ps, JQ


@pytest.mark.parametrize("q", [f"q{i}" for i in range(1, 23)])
def test_peak_estimate_bytes_equals_reference(plans01, q):
    js, ps, jq = plans01
    assert p_peak(ps.plan(QUERIES[q]), ps.catalog) == j_peak(js.plan(jq[q]), js.catalog)


# ---------------------------------------------------------------------------
# fragment retries
# ---------------------------------------------------------------------------


def _retry_run(mk, conn, fmod, sql, **properties):
    s = mk(conn, retry_count=3, retry_backoff_s=0.0, **properties)
    inj = fmod.FaultInjector()
    inj.inject("aggregation", times=2)
    with fmod.injected(inj):
        res = s.sql(sql)
    info = s.query_history[-1]
    return res, info, inj.fired()


def test_fragment_retries_equal_reference(jconn, pconn):
    before = counter("fragment.retried")
    want, jinfo, jfired = _retry_run(jsession, jconn, jfaults, JOIN_SQL)
    got, info, fired = _retry_run(session, pconn, faults, JOIN_SQL)
    same_frame(got, want, "retried")
    assert fired == jfired == 2
    assert info.state == "FINISHED" and info.fragment_retries == jinfo.fragment_retries == 2
    assert info.retry_events == jinfo.retry_events
    assert counter("fragment.retried") == before + 2
    assert info.metrics.get("fragment.retried") == 2


def test_retry_streaming_only_query(pconn):
    """A plan without a pipeline breaker drains its scan at the sink, so
    the sink drain is a retry boundary too."""
    s = session(pconn, retry_count=2, retry_backoff_s=0.0)
    inj = faults.FaultInjector()
    inj.inject("scan", times=1)
    with faults.injected(inj):
        res = s.sql("select n_name from nation")
    assert len(res) == 25
    assert s.query_history[-1].fragment_retries == 1


def test_retry_exhaustion_raises_the_fault(pconn):
    s = session(pconn, retry_count=1, retry_backoff_s=0.0)
    inj = faults.FaultInjector()
    inj.inject("aggregation", times=None)
    with faults.injected(inj):
        with pytest.raises(PE.TransientFailure):
            s.sql(GROUPED_SQL)
    info = s.query_history[-1]
    assert info.error_code == "TRANSIENT_FAILURE" and info.retryable is True
    assert info.fragment_retries == 1
    # exhaustion is tagged: ancestors do not multiply the retries
    assert inj.fired() == 2


def test_non_retryable_faults_are_not_retried(pconn):
    s = session(pconn, retry_count=5)
    inj = faults.FaultInjector()
    inj.inject("aggregation", error=PE.ResourceExhausted, times=None)
    with faults.injected(inj):
        with pytest.raises(PE.ResourceExhausted):
            s.sql(GROUPED_SQL)
    assert inj.fired() == 1


def test_query_level_retries_still_rerun_anything(pconn):
    s = session(pconn, query_retries=2, retry_count=0)
    inj = faults.FaultInjector()
    inj.inject("aggregation", error=PE.ResourceExhausted, times=2)
    with faults.injected(inj):
        assert len(s.sql(GROUPED_SQL)) > 0
    assert inj.fired() == 2


# ---------------------------------------------------------------------------
# the OOM ladder
# ---------------------------------------------------------------------------


def _masked(history):
    return [{k: v for k, v in e.items() if k != "error"} for e in history]


def _oom_run(mk, conn, fmod, site):
    s = mk(conn)
    inj = fmod.FaultInjector()
    inj.inject_oom(site, times=None)
    with fmod.injected(inj):
        res = s.sql(JOIN_SQL)
    return res, s.query_history[-1]


def test_injected_oom_walks_the_ladder_like_the_reference(jconn, pconn):
    """The estimate said resident; an OOM at the build refuted it. Rung 1
    re-plans into hybrid: the same answer, the same rung history (ladder
    entry, then the planned hybrid decisions at rung 1)."""
    want, jinfo = _oom_run(jsession, jconn, jfaults, "step.join_build")
    before = counter("query.backend_oom")
    got, info = _oom_run(session, pconn, faults, "step.join_build")
    same_frame(got, want, "after the ladder")
    assert info.oom_retries == jinfo.oom_retries == 1
    assert info.oom_rung == jinfo.oom_rung == 1
    assert _masked(info.rung_history) == _masked(jinfo.rung_history)
    assert [e["kind"] for e in info.rung_history][0] == "ladder"
    assert "BackendOom" in info.rung_history[0]["error"]
    assert counter("query.backend_oom") == before + 1


def test_oom_past_the_ladder_is_typed(pconn):
    s = session(pconn, oom_ladder_max=0)
    inj = faults.FaultInjector()
    inj.inject_oom("step.join_build", times=None)
    with faults.injected(inj):
        with pytest.raises(PE.DeviceOutOfMemory):
            s.sql(JOIN_SQL)
    assert s.query_history[-1].error_code == "DEVICE_OUT_OF_MEMORY"
    assert s.pool().reserved_bytes == 0


def test_a_failure_that_is_not_an_oom_never_walks_the_ladder(pconn):
    s = session(pconn)
    inj = faults.FaultInjector()
    inj.inject("step.join_build", error=RuntimeError, message="CUDA error: an illegal memory "
               "access was encountered", times=None)
    with faults.injected(inj):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            s.sql(JOIN_SQL)
    info = s.query_history[-1]
    assert info.oom_retries == 0 and info.rung_history == []
    assert inj.fired() == 1


def test_ladder_drops_the_failed_runs_frames(monkeypatch):
    """Between rungs the failed attempt's exception chain loses its
    frames, so the tensors they hold can be freed before the re-run."""
    held = []

    class Executor:
        device = torch.device("cpu")
        used_approx = False
        spill_events = ()
        oom_rung = 0

        def degrade_for_oom(self):
            self.oom_rung += 1
            return True

        def run(self, plan):
            if self.oom_rung == 0:
                big = torch.zeros(1 << 10)  # noqa: F841 -- a local the traceback holds
                try:
                    raise faults.BackendOom("rung 0")
                except Exception as e:
                    oom = lifecycle._map_backend_oom(e, "fragment:Test")
                    held.append(oom)
                    raise oom from e
            return "answer"

    s = session(PConnector(sf=0.001, device="cpu"))
    info = type("Info", (), {"oom_retries": 0, "rung_history": [], "approximate": False})()
    ctx = lifecycle.QueryContext()
    assert s.query_manager._run_with_oom_ladder(Executor(), None, info, None, ctx) == "answer"
    assert held[0].__traceback__ is None and held[0].__cause__.__traceback__ is None
    assert info.oom_retries == 1 and info.rung_history[0]["kind"] == "ladder"


# ---------------------------------------------------------------------------
# QueryInfo
# ---------------------------------------------------------------------------


def test_query_info_json_has_lifecycle_fields(pconn):
    s = session(pconn)
    s.sql("select count(*) c from nation")
    d = json.loads(s.query_history[-1].to_json())
    for key in ("errorCode", "retryable", "fragmentRetries", "degraded", "oomRung",
                "rungHistory", "retryEvents", "memoryReservedBytes", "memoryQueuedS",
                "devicePeakBytes"):
        assert key in d
    assert d["fragmentRetries"] == 0 and d["degraded"] is False and d["oomRung"] == 0
    assert d["memoryReservedBytes"] > 0 and d["devicePeakBytes"] == 0  # no card


def test_query_info_json_of_a_walked_ladder(pconn):
    _res, info = _oom_run(session, pconn, faults, "step.join_build")
    d = json.loads(info.to_json())
    assert d["oomRung"] == 1 and d["oomRetries"] == 1
    assert [e["kind"] for e in d["rungHistory"]][0] == "ladder"


# ---------------------------------------------------------------------------
# chip_smoke.py phase 19, on the CPU at a small scale
# ---------------------------------------------------------------------------


def test_chip_smoke_phase19_on_the_cpu():
    """Phase 19 (``chip_smoke.run_lifecycle_queries``) runs its checks on
    the CPU at sf 0.01 (2^12 units a split, so several splits): resident,
    hybrid and grouped answers against numpy and the resident run, the
    spill decisions and drained budgets, every wrapper call inside a
    ``fragment:`` span, the shapes held to plain, and the typed deadline,
    cancel and admission failures. The allocator's own OOM is the card's
    (phase 19 on the card)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out = chip_smoke.run_lifecycle_queries(PConnector(sf=0.01, units_per_split=1 << 12,
                                                      device="cpu"), device="cpu")
    modes = {label: [d["mode"] for d in v["decisions"]] for label, v in out["spill"].items()}
    assert modes["q3 hybrid"] == ["hybrid", "hybrid"] and modes["q3 resident"] == []
    assert modes["q3 grouped"][0] == "grouped"
    assert out["deadline"]["site"] in ("scan", "driver-loop", "driver-finish")
    assert "cancelled at 'scan'" in out["cancel"]
    assert "oom" not in out
