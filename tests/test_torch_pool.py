"""The port's memory arbitration (``runtime/memory.py``: ``MemoryPool``,
``HostSpillBudget``, ``device_budget_bytes``, the process-wide pools)
against the JAX package's contracts (``tests/test_memory.py``).

- the pool: reserve / release balance, an impossible reservation
  rejected at once with its detail, the FIFO queue (block then run, no
  head-of-line starvation), the timeout, tenants and release listeners;
- the balance across every query terminal state through ``Session``:
  success, user error, deadline, injected fault;
- ``device_budget_bytes`` on the CPU is the JAX package's CPU value (so
  CPU planning decisions match), and the arithmetic on a card.

The reference's result-cache-hit case waits for the result cache (A9).
"""

import threading
import time

import pytest

from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runtime import faults
from presto_tpu_torch.runtime import memory as M
from presto_tpu_torch.runtime.errors import ResourceExhausted, SpillBudgetExceeded
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.session import Session
import torch_bridge  # noqa: F401  (pins one intra-op thread)


def counter(name):
    return REGISTRY.snapshot().get(name, 0.0)


def wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


# ---------------------------------------------------------------------------
# the device budget
# ---------------------------------------------------------------------------


def test_device_budget_on_the_cpu_is_the_reference_value():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from presto_tpu.runtime.memory import DEFAULT_BUDGET_BYTES, device_budget_bytes

    assert M.DEFAULT_BUDGET_BYTES == DEFAULT_BUDGET_BYTES == 8 << 30
    assert M.device_budget_bytes("cpu") == device_budget_bytes() == 8 << 30
    assert M.executor_budget_bytes("cpu") == 8 << 30
    assert M.MIN_BUDGET_BYTES == 256 << 20 and M.DEFAULT_POOL_HEADROOM == 64


def test_budget_arithmetic_subtracts_bytes_in_use():
    cold = M.budget_from(16 << 30, 0)
    assert cold == 8 << 30
    assert M.budget_from(16 << 30, 2 << 30) == cold - (2 << 30)
    # a nearly full allocator still leaves the floor
    assert M.budget_from(16 << 30, 15 << 30) == 256 << 20


def test_cpu_session_plans_against_the_cpu_budget():
    s = Session({"tpch": TpchConnector(sf=0.001, device="cpu")}, device="cpu")
    assert s.join_build_budget() == (8 << 30) // 4
    assert s.executor().join_build_budget == (8 << 30) // 4
    assert s.query_manager.admission_limit() == (8 << 30) * 64


# ---------------------------------------------------------------------------
# MemoryPool
# ---------------------------------------------------------------------------


def test_pool_reserve_release_balance():
    pool = M.MemoryPool(1000)
    assert pool.reserve("q1", 400) >= 0.0
    pool.reserve("q2", 600)
    assert pool.reserved_bytes == 1000 and pool.free_bytes == 0
    assert pool.reservations() == {"q1": 400, "q2": 600}
    assert pool.snapshot() == {"capacity_bytes": 1000, "reserved_bytes": 1000, "free_bytes": 0,
                               "active_queries": 2, "queued_queries": 0}
    assert pool.release("q1") == 400
    assert pool.release("q1") == 0  # idempotent
    pool.release("q2")
    assert pool.reserved_bytes == 0 and pool.active_count == 0


def test_pool_over_capacity_rejected_immediately_with_detail():
    pool = M.MemoryPool(1000)
    before = counter("memory.rejected")
    t0 = time.monotonic()
    with pytest.raises(ResourceExhausted) as ei:
        pool.reserve("big", 2000, timeout_s=60.0, detail="peak at Join")
    assert time.monotonic() - t0 < 1.0  # can never fit: no queueing
    msg = str(ei.value)
    assert "2000" in msg and "1000" in msg and "peak at Join" in msg
    assert counter("memory.rejected") == before + 1
    assert pool.reserved_bytes == 0


def test_pool_timeout_raises_typed_with_pool_state():
    pool = M.MemoryPool(1000)
    pool.reserve("holder", 900)
    before = counter("memory.queue_timeouts")
    with pytest.raises(ResourceExhausted) as ei:
        pool.reserve("waiter", 500, timeout_s=0.05, detail="peak estimate 500 bytes at Aggregate")
    msg = str(ei.value)
    assert "500" in msg and "900/1000" in msg and "Aggregate" in msg
    assert counter("memory.queue_timeouts") == before + 1
    pool.release("holder")
    assert pool.reserved_bytes == 0 and pool.queued_count == 0


def test_pool_fifo_blocks_then_runs():
    pool = M.MemoryPool(1000)
    pool.reserve("blocker", 1000)
    got = []

    def waiter():
        pool.reserve("late", 800, timeout_s=30.0)
        got.append(pool.reservations())
        pool.release("late")

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    assert wait_for(lambda: pool.queued_count == 1)  # queued, not failed
    pool.release("blocker")
    t.join(timeout=10.0)
    assert not t.is_alive() and got == [{"late": 800}]
    assert pool.reserved_bytes == 0


def test_pool_fifo_no_starvation_head_of_line():
    """A large reservation at the head is not starved by a small one
    behind it that could fit now."""
    pool = M.MemoryPool(1000)
    pool.reserve("holder", 600)
    order = []

    def want(qid, n):
        pool.reserve(qid, n, timeout_s=30.0)
        order.append(qid)

    big = threading.Thread(target=want, args=("big", 900), daemon=True)
    big.start()
    assert wait_for(lambda: pool.queued_count == 1)
    small = threading.Thread(target=want, args=("small", 100), daemon=True)
    small.start()
    assert wait_for(lambda: pool.queued_count == 2)
    time.sleep(0.05)
    assert order == []
    pool.release("holder")
    big.join(timeout=10.0)
    pool.release("big")
    small.join(timeout=10.0)
    assert order == ["big", "small"]
    pool.release("small")
    assert pool.reserved_bytes == 0


def test_pool_tenants_and_release_listeners():
    pool = M.MemoryPool(1000)
    fired = []
    pool.add_release_listener(lambda: fired.append(1))
    pool.reserve("a", 100, tenant="dash")
    pool.reserve("b", 200, tenant="dash")
    pool.reserve("c", 300, tenant="batch")
    assert pool.tenant_reserved_bytes("dash") == 300
    assert pool.tenant_reserved_bytes("batch") == 300
    pool.release("a")
    assert pool.tenant_reserved_bytes("dash") == 200 and fired == [1]
    pool.release("b")
    pool.release("c")
    assert pool.tenant_reserved_bytes("dash") == 0 == pool.tenant_reserved_bytes("batch")
    assert len(fired) == 3
    pool.remove_release_listener(fired.append)  # unknown: idempotent


# ---------------------------------------------------------------------------
# HostSpillBudget and the process-wide budgets
# ---------------------------------------------------------------------------


def test_host_spill_budget_reserve_release_and_typed_overflow():
    b = M.HostSpillBudget(1000)
    b.reserve("join-build", 600)
    b.reserve("join-probe", 300)
    assert b.reserved_bytes == 900 and b.peak_bytes == 900
    before = counter("spill.host_rejected")
    with pytest.raises(SpillBudgetExceeded, match="spill_host_budget_bytes"):
        b.reserve("join-build", 200)
    assert counter("spill.host_rejected") == before + 1
    assert b.release("join-build", 100) == 100
    assert b.release("join-build") == 500 and b.release("join-build") == 0
    assert b.release("join-probe", 10**9) == 300
    assert b.reserved_bytes == 0 and b.snapshot()["peak_bytes"] == 900


def test_global_pools_are_sized_from_the_device_budget():
    budget = M.device_budget_bytes()
    assert M.global_pool().capacity_bytes == budget * M.DEFAULT_POOL_HEADROOM
    assert M.global_host_spill_budget().capacity_bytes == budget * M.DEFAULT_HOST_SPILL_FACTOR
    assert M.global_pool() is M.global_pool()


# ---------------------------------------------------------------------------
# the balance across every terminal state
# ---------------------------------------------------------------------------


@pytest.fixture()
def pooled():
    pool = M.MemoryPool(M.device_budget_bytes("cpu") * 64, name="test")
    s = Session({"tpch": TpchConnector(sf=0.005, device="cpu")}, memory_pool=pool,
                properties={"retry_backoff_s": 0.0}, device="cpu")
    return s, pool


def test_pool_balance_success_path(pooled):
    s, pool = pooled
    before = counter("memory.reserved")
    s.sql("select count(*) c from nation")
    assert counter("memory.reserved") == before + 1
    assert pool.reserved_bytes == 0 and pool.active_count == 0
    info = s.query_history[-1]
    assert info.memory_reserved_bytes > 0
    assert info.metrics.get("memory.reserved") == 1 and info.metrics.get("memory.released") == 1


def test_pool_balance_user_error_path(pooled):
    s, pool = pooled
    with pytest.raises(ValueError):
        s.sql("select (select r_regionkey from region) x from nation")
    assert pool.reserved_bytes == 0 and pool.active_count == 0


def test_pool_balance_deadline_path():
    pool = M.MemoryPool(M.device_budget_bytes("cpu") * 64, name="test")
    s = Session({"tpch": TpchConnector(sf=0.005, device="cpu")}, memory_pool=pool,
                properties={"query_max_run_time": 1e-9}, device="cpu")
    with pytest.raises(RuntimeError):
        s.sql("select count(*) c from lineitem")
    assert pool.reserved_bytes == 0 and pool.active_count == 0


def test_pool_balance_fault_path(pooled):
    s, pool = pooled
    inj = faults.FaultInjector()
    inj.inject("scan", times=None)
    with faults.injected(inj):
        with pytest.raises(RuntimeError):
            s.sql("select count(*) c from nation")
    assert inj.fired() > 0
    assert pool.reserved_bytes == 0 and pool.active_count == 0


def test_private_pool_from_the_property():
    s = Session({"tpch": TpchConnector(sf=0.001, device="cpu")},
                properties={"memory_pool_bytes": 1 << 30}, device="cpu")
    assert s.pool() is not M.global_pool() and s.pool().capacity_bytes == 1 << 30
    s.sql("select count(*) c from nation")
    assert s.pool().reserved_bytes == 0
    assert "q_" not in "".join(M.pool_leaks())  # nothing left in the global pool


def test_sessions_share_explicit_pool_and_serialize():
    """Two sessions over a pool that holds one query's reservation: the
    second queues, then runs; nobody fails."""
    q = "select count(*) c from nation"
    conn = TpchConnector(sf=0.005, device="cpu")
    probe = Session({"tpch": conn}, device="cpu")
    probe.sql(q)
    peak = probe.query_history[-1].memory_reserved_bytes
    assert peak > 0
    pool = M.MemoryPool(int(peak * 1.5), name="shared")
    pool.reserve("outsider", peak)
    results, errors = [], []

    def run():
        try:
            s = Session({"tpch": conn}, memory_pool=pool,
                        properties={"admission_queue_timeout_s": 60.0}, device="cpu")
            results.append(int(s.sql(q).column("c")[0]))
            info = s.query_history[-1]
            # time blocked on the pool is QUEUED time, not execution
            if not (info.memory_queued_s > 0.0
                    and info.queued_s + 1e-3 >= info.memory_queued_s):
                errors.append((info.memory_queued_s, info.queued_s))
        except Exception as e:  # noqa: BLE001 -- asserted empty below
            errors.append(e)

    threads = [threading.Thread(target=run, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    assert wait_for(lambda: pool.queued_count == 2, 10.0)
    pool.release("outsider")
    for t in threads:
        t.join(timeout=120.0)
        assert not t.is_alive(), "query hung in the admission queue"
    assert errors == [] and results == [25, 25]
    assert pool.reserved_bytes == 0 and pool.active_count == 0
