"""The port's out-of-core tier (``exec/spill.py``, ``exec/grouped.py``,
``exec/ladder.py`` and the spilled paths of ``exec/local_planner.py``)
against the JAX package's (``tests/test_spill.py``, ``tests/test_grouped.py``).

- the decisions: ``plan_spill``, ``fit_resident`` and ``expand_units``
  equal to the reference's over estimate, budget, rung and hot partition
  (hypothesis);
- the answers: planned hybrid, forced grouped and resident runs of the
  reference's Q3-shaped join, semi, anti and high-cardinality aggregation
  at sf 0.005 (2^12 units a split), through both ``Session.sql``s with the
  same properties: frames equal (dtypes included) and equal ``spill.*`` /
  ``join.strategy.*`` / ``agg.strategy.*`` moves;
- a 4x-over-budget build with zero ladder rungs; ``SpillBudgetExceeded``
  at ``spill_host_budget_bytes=2048``; ``SpillPartitionOverflow`` at the
  recursion cap; the host budget drains on success and after injected
  faults; the grouped LEFT join's unmatched rows; the refusal of wide
  string keys; the two-slot transfer pipeline.

The distributed grouped cases of the reference's files wait for the
distributed executor (A10), and its flight-record assertions for the
flight recorder (A9).
"""

import jax

jax.config.update("jax_platforms", "cpu")

import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from presto_tpu.connectors.tpch import TpchConnector as JConnector  # noqa: E402
from presto_tpu.exec import spill as JS  # noqa: E402
from presto_tpu.runtime.metrics import REGISTRY as JREG  # noqa: E402
from presto_tpu.runtime.session import Session as JSession  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector  # noqa: E402
from presto_tpu_torch.exec import pipeline as PP  # noqa: E402
from presto_tpu_torch.exec import spill as PS  # noqa: E402
from presto_tpu_torch.exec.grouped import HostSpill  # noqa: E402
from presto_tpu_torch.runtime import faults  # noqa: E402
from presto_tpu_torch.runtime.errors import (  # noqa: E402
    DeviceOutOfMemory,
    SpillBudgetExceeded,
    SpillPartitionOverflow,
    TransientFailure,
    error_code,
)
from presto_tpu_torch.runtime.memory import global_host_spill_budget  # noqa: E402
from presto_tpu_torch.runtime.metrics import REGISTRY as PREG  # noqa: E402
from presto_tpu_torch.runtime.session import Session as PSession  # noqa: E402
from presto_tpu_torch.types import BIGINT  # noqa: E402
from torch_bridge import assert_same, refused_alike, same_frame  # noqa: E402

SF = 0.005
UNITS = 1 << 12

Q3ISH = ("select o_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue "
         "from orders, lineitem where o_orderkey = l_orderkey "
         "and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15' "
         "group by o_orderkey order by revenue desc, o_orderkey limit 20")
SEMI = ("select c_custkey from customer where c_custkey in "
        "(select o_custkey from orders) order by c_custkey")
ANTI = ("select c_custkey from customer where c_custkey not in "
        "(select o_custkey from orders) order by c_custkey")
HICARD_AGG = ("select l_orderkey, count(*) n, sum(l_extendedprice) s "
              "from lineitem join orders on l_orderkey = o_orderkey "
              "group by l_orderkey order by l_orderkey limit 100")
LEFT = ("select l_orderkey, o_orderdate from lineitem "
        "left join orders on l_orderkey = o_orderkey "
        "and o_orderdate < date '1993-01-01' "
        "order by l_orderkey limit 30")
WIDE = ("select count(*) as n, sum(c) as c from orders join "
        "(select o_clerk as k, count(*) as c from orders group by o_clerk) s on o_clerk = k")
QUERIES = {"q3ish": Q3ISH, "semi": SEMI, "anti": ANTI, "hicard_agg": HICARD_AGG}

#: the reference test's budgets: hybrid for all four, fully grouped per
#: build side (the unit floor keeps one key's duplicate run)
HYBRID_BUDGET = 4096
GROUPED_BUDGETS = {"q3ish": 256, "semi": 448, "anti": 448}
CASES = ([("resident", q, None) for q in QUERIES]
         + [("hybrid", q, HYBRID_BUDGET) for q in QUERIES]
         + [("grouped", q, b) for q, b in GROUPED_BUDGETS.items()])

#: the counter families the spill tier moves
FAMILIES = ("spill.", "join.strategy.", "agg.strategy.", "query.oom_degraded")


def moves(reg, before: dict) -> dict:
    """The families' moves since ``before``; a histogram by its count and
    total (its quantiles are over the whole process's history)."""
    after = reg.snapshot()
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if k.startswith(FAMILIES) and v != before.get(k, 0.0)
            and not k.endswith((".p50", ".p95", ".p99", ".max"))}


def props(budget) -> dict:
    return {} if budget is None else {"join_build_budget_bytes": budget}


@pytest.fixture(scope="module")
def jconn():
    return JConnector(sf=SF, units_per_split=UNITS)


@pytest.fixture(scope="module")
def pconn():
    return PConnector(sf=SF, units_per_split=UNITS, device="cpu")


def j_run(conn, sql, properties):
    before = JREG.snapshot()
    df = JSession({"tpch": conn}, properties={**properties, "result_cache_enabled": False}).sql(sql)
    return df, moves(JREG, before)


def p_run(conn, sql, properties):
    before = PREG.snapshot()
    session = PSession({"tpch": conn}, properties=properties, device="cpu")
    res = session.sql(sql)
    return res, moves(PREG, before), session


@pytest.fixture(scope="module")
def ref(jconn):
    """The reference's (frame, counter moves) of every case, run once."""
    return {(mode, q): j_run(jconn, QUERIES[q], props(b)) for mode, q, b in CASES}


# ---------------------------------------------------------------------------
# the decisions
# ---------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(est=st.integers(0, 1 << 40), budget=st.integers(1, 1 << 32),
       rung=st.integers(0, 6), hot=st.one_of(st.none(), st.integers(0, 1 << 12)))
def test_plan_spill_equals_reference(est, budget, rung, hot):
    got = PS.plan_spill(est, budget, hot_partition=hot, oom_rung=rung)
    want = JS.plan_spill(est, budget, hot_partition=hot, oom_rung=rung)
    assert (got.mode, got.nbuckets, got.resident, got.est_bytes, got.budget,
            got.resident_budget) == (want.mode, want.nbuckets, want.resident, want.est_bytes,
                                     want.budget, want.resident_budget)
    assert got.explain() == want.explain()


@settings(max_examples=100, deadline=None)
@given(est_factor=st.integers(2, 60), rung=st.integers(0, 2), row_bytes=st.integers(1, 64),
       rows=st.lists(st.integers(0, 1 << 16), min_size=1, max_size=64))
def test_fit_resident_equals_reference(est_factor, rung, row_bytes, rows):
    budget = 1 << 20
    d_p = PS.plan_spill(est_factor * budget, budget, oom_rung=rung)
    d_j = JS.plan_spill(est_factor * budget, budget, oom_rung=rung)

    def bucket_rows(b):
        return rows[b % len(rows)]

    assert PS.fit_resident(d_p, bucket_rows, row_bytes) == JS.fit_resident(d_j, bucket_rows,
                                                                            row_bytes)


def _spills(keys: np.ndarray, nbuckets: int):
    """The same keys bucketed into a HostSpill of each package."""
    from presto_tpu import BIGINT as JBIGINT
    from presto_tpu.batch import Batch as JBatch
    from presto_tpu.exec.grouped import HostSpill as JHostSpill
    from presto_tpu.ops.hashing import partition_ids as j_pids
    from presto_tpu_torch.batch import Batch as PBatch
    from presto_tpu_torch.ops.hashing import partition_ids as p_pids

    n = len(keys)
    jb = JBatch.from_numpy({"k": keys}, {"k": JBIGINT}, capacity=n)
    pb = PBatch.from_numpy({"k": keys}, {"k": BIGINT}, capacity=n, device="cpu")
    js, ps = JHostSpill(nbuckets), HostSpill(nbuckets)
    js.append(jb, np.asarray(j_pids([jb["k"].data], nbuckets)))
    ps.append(pb, p_pids([pb["k"].data], nbuckets).numpy())
    return js, ps


def _j_ids(batch, modulus):
    from presto_tpu.ops.hashing import partition_ids

    return np.asarray(partition_ids([batch["k"].data], modulus))


def _p_ids(batch, modulus):
    from presto_tpu_torch.ops.hashing import partition_ids

    return partition_ids([batch["k"].data], modulus)


def _units(units):
    return [(u.bucket, u.modulus, u.residue, u.depth, u.build.bucket_rows(u.bucket))
            for u in units]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31), distinct=st.integers(1, 300), nbuckets=st.integers(1, 8),
       unit_budget=st.integers(64, 4096))
def test_expand_units_equals_reference(seed, distinct, nbuckets, unit_budget):
    keys = np.random.default_rng(seed).integers(0, distinct, 512).astype(np.int64)
    js, ps = _spills(keys, nbuckets)
    cold = list(range(nbuckets))
    from presto_tpu.runtime.errors import SpillPartitionOverflow as JOverflow

    try:
        want = _units(JS.expand_units(js, None, cold, unit_budget, 8, build_ids=_j_ids))
    except JOverflow as e:
        with pytest.raises(SpillPartitionOverflow) as ei:
            PS.expand_units(ps, None, cold, unit_budget, 8, build_ids=_p_ids)
        assert str(ei.value) == str(e)
        return
    assert _units(PS.expand_units(ps, None, cold, unit_budget, 8, build_ids=_p_ids)) == want


def test_plan_spill_decision_table():
    budget = 1 << 20
    assert PS.plan_spill(budget // 2, budget).mode == "resident"
    d = PS.plan_spill(4 * budget, budget)
    assert d.mode == "hybrid" and d.nbuckets == 8 and len(d.resident) >= 1
    assert d.explain() == f"hybrid({len(d.resident)}/8 resident)"
    assert PS.plan_spill(100 * budget, budget).mode == "grouped"
    # rung 1 re-buckets a lying under-budget estimate for real; rung 3
    # gives up on residency
    lied = PS.plan_spill(budget // 10, budget, oom_rung=1)
    assert lied.mode != "resident" and lied.nbuckets >= 2
    assert PS.plan_spill(4 * budget, budget, oom_rung=3).mode == "grouped"


# ---------------------------------------------------------------------------
# the answers: hybrid, grouped and resident against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,q,budget", CASES, ids=[f"{m}-{q}" for m, q, _b in CASES])
def test_answers_and_counters_equal_reference(pconn, ref, mode, q, budget):
    want, want_moves = ref[(mode, q)]
    res, got_moves, session = p_run(pconn, QUERIES[q], props(budget))
    same_frame(res, want, f"{mode} {q}")
    assert got_moves == want_moves
    if mode != "resident":
        assert got_moves.get(f"spill.planned_{mode}", 0) >= 1
        assert got_moves.get("query.oom_degraded", 0) == 0
        # bit-identical to the port's own resident run too
        same_frame(res, ref[("resident", q)][0], f"{mode} {q} vs resident")
    assert session.pool().reserved_bytes == 0
    assert global_host_spill_budget().reserved_bytes == 0


def test_explain_renders_the_planned_spill(jconn, pconn):
    js = JSession({"tpch": jconn}, properties={"join_build_budget_bytes": HYBRID_BUDGET})
    ps = PSession({"tpch": pconn}, properties={"join_build_budget_bytes": HYBRID_BUDGET},
                  device="cpu")
    got, want = ps.explain(Q3ISH), js.explain(Q3ISH)
    line = [ln for ln in got.splitlines() if "Join" in ln]
    assert line == [ln for ln in want.splitlines() if "Join" in ln]
    assert "strategy=hybrid spill=hybrid(" in line[0]


def test_four_x_over_budget_runs_with_zero_rungs(pconn, ref):
    """A build about 4x over its budget runs planned hybrid: no ladder
    rung, rows bit-identical, pool and host budget drained."""
    res, got, session = p_run(pconn, Q3ISH, {"join_build_budget_bytes": 11 << 10})
    same_frame(res, ref[("resident", "q3ish")][0], "4x over budget")
    assert got.get("spill.planned_hybrid", 0) >= 1
    assert got.get("spill.partitions_streamed", 0) >= 1
    assert got.get("query.oom_degraded", 0) == 0
    assert session.query_history[-1].oom_rung == 0
    assert session.pool().reserved_bytes == 0
    assert global_host_spill_budget().reserved_bytes == 0


def test_rung_history_carries_planned_spills(pconn):
    _res, _moves, session = p_run(pconn, Q3ISH, {"join_build_budget_bytes": HYBRID_BUDGET})
    hist = session.query_history[-1].rung_history
    assert hist and all(e["kind"] == "planned_hybrid" for e in hist)
    assert {e["node"] for e in hist} == {"Join", "Aggregate"}


# ---------------------------------------------------------------------------
# host budget and typed failures
# ---------------------------------------------------------------------------


def test_spill_host_budget_exceeded_is_typed_and_loud(jconn, pconn):
    properties = {"join_build_budget_bytes": HYBRID_BUDGET, "spill_host_budget_bytes": 2048}
    with pytest.raises(Exception) as jei:
        JSession({"tpch": jconn}, properties={**properties, "result_cache_enabled": False}
                 ).sql(Q3ISH)
    s = PSession({"tpch": pconn}, properties=properties, device="cpu")
    with pytest.raises(SpillBudgetExceeded) as ei:
        s.sql(Q3ISH)
    assert type(jei.value).__name__ == "SpillBudgetExceeded"
    assert str(ei.value) == str(jei.value)
    assert "spill_host_budget_bytes" in str(ei.value)
    info = s.query_history[-1]
    assert info.state == "FAILED" and info.error_code == "SPILL_BUDGET_EXCEEDED"
    assert s.pool().reserved_bytes == 0
    assert global_host_spill_budget().reserved_bytes == 0


@pytest.mark.parametrize("site,error", [("step.spill_transfer", "oom"),
                                        ("step.grouped_join", TransientFailure)])
def test_mid_spill_fault_drains_pool_and_host_budget(pconn, site, error):
    """A fault at a spill site mid-query: typed surface, the pool and the
    host budget back at zero, and the same session's next query right."""
    s = PSession({"tpch": pconn}, properties={"join_build_budget_bytes": HYBRID_BUDGET,
                                              "oom_ladder_max": 0}, device="cpu")
    inj = faults.FaultInjector()
    if error == "oom":
        inj.inject_oom(site, times=None)
    else:
        inj.inject(site, error=error, times=None)
    with faults.injected(inj):
        with pytest.raises(DeviceOutOfMemory if error == "oom" else TransientFailure):
            s.sql(Q3ISH)
    assert inj.fired_at(site) >= 1
    assert s.query_history[-1].state == "FAILED"
    assert s.pool().reserved_bytes == 0
    assert global_host_spill_budget().reserved_bytes == 0
    assert len(s.sql(Q3ISH)) == 20


def test_success_path_drains_host_budget(pconn, ref):
    budget = global_host_spill_budget()
    res, _moves, _s = p_run(pconn, Q3ISH, {"join_build_budget_bytes": HYBRID_BUDGET})
    same_frame(res, ref[("hybrid", "q3ish")][0])
    assert budget.reserved_bytes == 0
    assert budget.peak_bytes > 0  # the spill reserved


def test_grouped_left_join_emits_unmatched_probe_rows(jconn, pconn):
    properties = {"join_build_budget_bytes": 2048}
    want, want_moves = j_run(jconn, LEFT, properties)
    res, got_moves, _s = p_run(pconn, LEFT, properties)
    same_frame(res, want, "grouped LEFT join")
    assert got_moves == want_moves
    assert got_moves.get("join.strategy.hybrid", 0) + got_moves.get("join.strategy.grouped", 0)


def test_wide_string_keys_refused_in_grouped_joins(jconn, pconn):
    properties = {"join_build_budget_bytes": 1024}
    err = refused_alike(
        lambda: JSession({"tpch": jconn},
                         properties={**properties, "result_cache_enabled": False}).sql(WIDE),
        lambda: PSession({"tpch": pconn}, properties=properties, device="cpu").sql(WIDE))
    assert isinstance(err, NotImplementedError)
    assert str(err) == "wide string keys in grouped (spilled) joins"


def _one_key_spill(rows: int, distinct: bool = False):
    from presto_tpu_torch.batch import Batch

    keys = np.arange(rows, dtype=np.int64) if distinct else np.full(rows, 7, np.int64)
    spill = HostSpill(1)
    spill.append(Batch.from_numpy({"k": keys}, {"k": BIGINT}, capacity=rows, device="cpu"),
                 np.zeros(rows, np.int64))
    return spill


def test_partition_overflow_recursion_is_bounded_and_typed():
    spill = _one_key_spill(100)
    before = PREG.snapshot()
    with pytest.raises(SpillPartitionOverflow) as ei:
        PS.expand_units(spill, None, [0], unit_budget=64, row_bytes=8, build_ids=_p_ids)
    assert "recursive splits" in str(ei.value)
    assert error_code(ei.value) == "SPILL_PARTITION_OVERFLOW"
    assert moves(PREG, before).get("spill.partition_overflow") == PS.MAX_SPILL_RECURSION


def test_splittable_overflow_bucket_streams_in_units():
    units = PS.expand_units(_one_key_spill(256, distinct=True), None, [0], unit_budget=512,
                            row_bytes=8, build_ids=_p_ids)
    assert len(units) > 1
    assert sum(u.build.bucket_rows(u.bucket) for u in units) == 256
    for u in units:
        rows = u.build.bucket_rows(u.bucket)
        assert rows * 8 <= 512 or rows <= 16


def test_host_spill_round_trips_rows_validity_and_dictionaries():
    from presto_tpu_torch.batch import Batch, Dictionary
    from presto_tpu_torch.types import varchar

    d = Dictionary(["a", "b", "c"])
    b = Batch.from_numpy({"k": np.arange(6, dtype=np.int64), "s": np.array([0, 1, 2, 0, 1, 2],
                                                                          np.int32)},
                         {"k": BIGINT, "s": varchar()}, count=5,
                         valids={"s": np.array([1, 0, 1, 1, 1, 1], bool)},
                         dictionaries={"s": d}, capacity=8, device="cpu")
    spill = HostSpill(2)
    spill.append(b, np.array([0, 1, 0, 1, 0, 1, 0, 1]))
    assert [spill.bucket_rows(i) for i in range(2)] == [3, 2]  # row 5 is dead
    out = spill.bucket_batch(1, capacity=16)
    assert out.capacity == 16 and out["s"].dictionary is d
    assert out["k"].data[:2].tolist() == [1, 3] and out["s"].valid[:2].tolist() == [False, True]
    assert spill.total_bytes() > 0 and spill.release() > 0 and spill.total_bytes() == 0


# ---------------------------------------------------------------------------
# the two-slot transfer pipeline
# ---------------------------------------------------------------------------


def test_transfer_iter_double_buffers(monkeypatch):
    """Two loads are in flight at once: the first two items meet at a
    barrier that only concurrent workers can pass (a serial loop would
    time out on it)."""
    monkeypatch.setattr(PP, "prefetch_enabled", lambda: True)
    barrier = threading.Barrier(2)

    def load(i):
        if i < 2:
            barrier.wait(timeout=30)
        return i * 10

    assert list(PS.transfer_iter(load, range(4))) == [(0, 0), (1, 10), (2, 20), (3, 30)]


def test_transfer_iter_serial_without_prefetch(monkeypatch):
    monkeypatch.setattr(PP, "prefetch_enabled", lambda: False)
    order = []

    def load(i):
        order.append(i)
        return i

    assert list(PS.transfer_iter(load, range(3))) == [(0, 0), (1, 1), (2, 2)]
    assert order == [0, 1, 2]


def test_transfer_iter_checks_the_deadline_per_slot(monkeypatch):
    """Each submit slot is a cancel checkpoint: a scope flipped while
    units stream stops the transfers within one unit."""
    from presto_tpu_torch.runtime import lifecycle
    from presto_tpu_torch.runtime.errors import QueryCancelled
    from presto_tpu_torch.runtime.overload import CancelScope

    monkeypatch.setattr(PP, "prefetch_enabled", lambda: False)
    scope = CancelScope("q")
    token = lifecycle._CURRENT.set(lifecycle.QueryContext(cancel_scope=scope))
    loaded = []
    try:
        it = PS.transfer_iter(lambda i: loaded.append(i) or torch.zeros(1), range(5))
        next(it)
        scope.cancel("stop")
        with pytest.raises(QueryCancelled, match="spill-transfer"):
            next(it)
    finally:
        lifecycle._CURRENT.reset(token)
    assert loaded == [0]
