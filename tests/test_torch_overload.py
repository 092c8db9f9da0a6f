"""The port's overload control (``runtime/overload.py``) and cancellation
through ``Session.cancel``, against the JAX package's contracts
(``tests/test_overload.py``).

- ``CancelScope``: idempotent, typed, the ``step.cancel_checkpoint``
  fault site (a backend-shaped OOM there maps to ``DeviceOutOfMemory``);
- ``shed_retry_after``, ``CostEwma``, ``RetryBudget`` (the breaker opens
  under a storm, a half-open probe re-arms it) and ``OverloadController``
  (engages, recovers, pins) equal to the reference's, step for step;
- a session's retry storm fails fast once the budget drains;
- ``Session.cancel`` of a running query from a second thread: the next
  checkpoint raises ``QueryCancelled``, ``cancel.observed`` counts it
  once, the pool drains and the session's next query answers; an
  unknown id returns False;
- ``check_deadline`` outside a query is a no-op.

The reference's shedding, brown-out, HTTP and request-deadline cases
drive its server: their counterparts are in ``tests/test_torch_server.py``.
"""

import threading
import time

import pytest

from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runtime import faults
from presto_tpu_torch.runtime.errors import (
    DeviceOutOfMemory,
    QueryCancelled,
    TransientFailure,
)
from presto_tpu_torch.runtime.lifecycle import check_deadline
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.overload import (
    CancelScope,
    CostEwma,
    OverloadController,
    RetryBudget,
    shed_retry_after,
)
from presto_tpu_torch.runtime.session import Session
import torch_bridge  # noqa: F401  (pins one intra-op thread)

CONN = TpchConnector(sf=0.005, device="cpu")
SCAN_SQL = ("select l_orderkey, count(*) c, sum(l_quantity) q "
            "from lineitem group by l_orderkey")


def counter(name):
    return REGISTRY.snapshot().get(name, 0.0)


class Spec:
    def __init__(self, brownout=None):
        self.brownout = brownout


# ---------------------------------------------------------------------------
# the primitives, step for step against the reference's
# ---------------------------------------------------------------------------


def test_cancel_scope_is_idempotent_and_typed():
    scope = CancelScope("q1")
    scope.check("anywhere")  # a no-op until flipped
    before = counter("cancel.requested")
    assert scope.cancel("user asked") is True
    assert scope.cancel("second caller") is False  # the first reason wins
    assert counter("cancel.requested") == before + 1
    assert scope.cancelled and scope.reason == "user asked"
    observed = counter("cancel.observed")
    for _ in range(2):
        with pytest.raises(QueryCancelled) as ei:
            scope.check("morsel-loop")
    assert counter("cancel.observed") == observed + 1  # counted once
    assert ei.value.error_code == "QUERY_CANCELLED" and not ei.value.retryable
    assert "q1" in str(ei.value) and "user asked" in str(ei.value)


def test_cancel_checkpoint_is_a_fault_site_mapping_backend_oom():
    inj = faults.FaultInjector()
    inj.inject_oom("step", times=1)
    before = counter("query.backend_oom")
    with faults.injected(inj):
        with pytest.raises(DeviceOutOfMemory, match="cancel checkpoint 'gate'"):
            CancelScope("q").check("gate")
    assert inj.fired_at("step.cancel_checkpoint") == 1
    assert counter("query.backend_oom") == before + 1
    inj = faults.FaultInjector()
    inj.inject("step.cancel_checkpoint", times=1)
    with faults.injected(inj):
        with pytest.raises(TransientFailure):
            CancelScope("q").check("gate")


def test_primitives_equal_reference():
    from presto_tpu.runtime import overload as J

    assert [shed_retry_after(q) for q in range(0, 60, 3)] == \
        [J.shed_retry_after(q) for q in range(0, 60, 3)]
    assert shed_retry_after(10**9) == J.shed_retry_after(10**9) == 30.0
    a, b = CostEwma(alpha=0.3), J.CostEwma(alpha=0.3)
    for x in (4.0, 0.0, 2.5, 10.0):
        assert a.update(x) == b.update(x)
    assert (a.value, a.samples) == (b.value, b.samples)
    p = RetryBudget(capacity=3, refill_per_s=0.0, probe_cooldown_s=0.05)
    j = J.RetryBudget(capacity=3, refill_per_s=0.0, probe_cooldown_s=0.05)
    steps = []
    for budget in (p, j):
        out = [budget.try_spend() for _ in range(5)]
        out.append(budget.snapshot()["state"])
        time.sleep(0.06)
        out += [budget.try_spend(), budget.try_spend()]
        budget.record_success()
        out.append(budget.snapshot())
        steps.append(out)
    assert steps[0] == steps[1]


def test_shed_retry_after_monotone_and_capped():
    hints = [shed_retry_after(q) for q in range(0, 50, 5)]
    assert hints == sorted(hints) and len(set(hints)) == len(hints)
    assert shed_retry_after(10**9) == 30.0


def test_cost_ewma_first_sample_seeds_estimate():
    ewma = CostEwma(alpha=0.5)
    assert ewma.samples == 0 and ewma.value == 0.0
    ewma.update(4.0)
    assert ewma.value == 4.0
    ewma.update(0.0)
    assert ewma.value == 2.0


def test_retry_budget_storm_opens_breaker_then_probe_rearms():
    b = RetryBudget(capacity=3, refill_per_s=0.0, probe_cooldown_s=0.05)
    opened = counter("overload.breaker_open")
    assert all(b.try_spend() for _ in range(3))
    assert b.try_spend() is False and b.snapshot()["state"] == "open"
    assert counter("overload.breaker_open") == opened + 1
    assert b.try_spend() is False
    time.sleep(0.06)
    assert b.try_spend() is True  # half-open: exactly one probe
    assert b.try_spend() is False
    b.record_success()
    assert b.snapshot() == {"state": "closed", "tokens": 3.0, "capacity": 3.0}


def test_retry_budget_probe_failure_reopens_breaker():
    b = RetryBudget(capacity=1, refill_per_s=0.0, probe_cooldown_s=0.05)
    assert b.try_spend() and not b.try_spend()
    time.sleep(0.06)
    assert b.try_spend()
    b.record_failure()
    assert b.snapshot()["state"] == "open" and not b.try_spend()


def test_retry_budget_caps_session_retry_storm():
    """A permanent fault under a generous ``retry_count`` drains the
    budget and fails fast with the original typed error."""
    s = Session({"tpch": CONN}, properties={
        "retry_count": 50, "retry_backoff_s": 0.0, "retry_budget_tokens": 2.0,
        "retry_budget_refill_per_s": 0.0}, device="cpu")
    inj = faults.FaultInjector()
    inj.inject("scan", error=TransientFailure, times=None)
    opened = counter("overload.breaker_open")
    with faults.injected(inj):
        with pytest.raises(TransientFailure):
            s.sql("select n_name from nation order by n_name")
    assert counter("overload.breaker_open") == opened + 1
    assert inj.fired() == 3  # the first attempt and two budgeted retries
    assert s.pool().reserved_bytes == 0


def test_overload_controller_engages_and_recovers():
    ctl = OverloadController(cooldown_s=0.05)
    approx, plain = Spec("approx"), Spec()
    assert not ctl.engaged and ctl.mode_for(approx) is None
    ctl.on_breach({"kind": "p99_regression"})
    assert ctl.engaged and ctl.engagements == 1
    assert ctl.mode_for(approx) == "approx" and ctl.mode_for(plain) is None
    time.sleep(0.06)
    assert not ctl.engaged and ctl.mode_for(approx) is None
    assert ctl.snapshot()["engaged"] is False


def test_overload_controller_force_pins_past_cooldown():
    ctl = OverloadController(cooldown_s=0.0)
    ctl.force(True)
    time.sleep(0.01)
    assert ctl.engaged and ctl.forced
    ctl.force(False)
    assert not ctl.engaged


# ---------------------------------------------------------------------------
# Session.cancel and request deadlines
# ---------------------------------------------------------------------------


class GatedScans(TpchConnector):
    """A TPC-H connector whose second split scan of ``lineitem`` waits
    for ``go`` after setting ``reached``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.reached, self.go = threading.Event(), threading.Event()

    def scan(self, split, columns=None, capacity=None):
        if split.table == "lineitem" and split.chunk == 1:
            self.reached.set()
            assert self.go.wait(30)
        return super().scan(split, columns, capacity)


def test_session_cancel_of_a_running_query_from_a_thread():
    conn = GatedScans(sf=0.005, units_per_split=1 << 10, device="cpu")
    s = Session({"tpch": conn}, device="cpu")
    out = {}

    def run():
        try:
            out["res"] = s.sql(SCAN_SQL)
        except Exception as e:  # noqa: BLE001 -- asserted below
            out["err"] = e

    observed = counter("cancel.observed")
    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert conn.reached.wait(30)
    qid = s.query_history[-1].query_id
    assert s.cancel(qid, "operator") is True
    assert s.cancel(qid) is False  # already cancelled
    conn.go.set()
    t.join(60)
    assert not t.is_alive()
    assert isinstance(out.get("err"), QueryCancelled), out
    assert "operator" in str(out["err"])
    assert counter("cancel.observed") == observed + 1
    info = s.query_history[-1]
    assert info.state == "FAILED" and info.error_code == "QUERY_CANCELLED"
    assert info.metrics.get("cancel.observed") == 1
    assert s.pool().reserved_bytes == 0
    assert s.cancel(qid) is False  # terminal
    assert len(s.sql("select count(*) c from nation")) == 1


def test_session_cancel_unknown_query_returns_false():
    assert Session({"tpch": CONN}, device="cpu").cancel("no-such-query") is False


def test_check_deadline_without_a_query_is_a_no_op():
    check_deadline("anywhere")
