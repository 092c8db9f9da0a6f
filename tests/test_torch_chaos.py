"""The seeded chaos suite on the port, and the port's rounds held to the
JAX package's seed by seed.

Twins of the 13 cases of ``tests/test_chaos.py`` (the ladder, the
seeded sweeps, mixed ingest, concurrent sessions, the overload storm),
with that file's assertions, counters, rung counts and fire counts, run
on ``presto_tpu_torch`` on the CPU. The round driver and the threaded
groups are ``chip_smoke.py``'s (``run_chaos_round``,
``chaos_concurrent_sessions``, ``chaos_overload_storm``,
``chaos_mixed_ingest``), which phase 26 runs on the card at SF1; the
three sweeps the JAX package marks slow are slow here too.

The differential part: for seeds 0-9 (the seeds ``scripts/tier1.sh``
replays) the port's round gives the JAX package's label, the same fires
at every armed site, and equal frames, or the same error code, OOM
rungs and fragment retries. The JAX package's oracle and its ten rounds
run once per module.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import chip_smoke  # noqa: E402
import presto_tpu.runtime.faults as JF  # noqa: E402
import presto_tpu_torch.types as T  # noqa: E402
import test_chaos as J  # noqa: E402
from presto_tpu.connectors.tpch import TpchConnector as JT  # noqa: E402
from presto_tpu_torch.batch import Batch, QueryResult  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector as PT  # noqa: E402
from presto_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from presto_tpu_torch.runtime import faults  # noqa: E402
from presto_tpu_torch.runtime.errors import DeviceOutOfMemory, error_code  # noqa: E402
from presto_tpu_torch.runtime.health import live_monitors  # noqa: E402
from presto_tpu_torch.runtime.memory import pool_leaks  # noqa: E402
from presto_tpu_torch.runtime.metrics import REGISTRY  # noqa: E402
from presto_tpu_torch.runtime.session import Session  # noqa: E402
from torch_bridge import same_frame  # noqa: E402

SF = J.SF
CHAOS = chip_smoke.CHAOS_QUERIES
SMOKE_SEEDS = range(10)


@pytest.fixture(autouse=True)
def _port_leak_checks():
    """The JAX suite's conftest checks, on the port: every query released
    its global pool reservation and every health watchdog was closed."""
    yield
    assert not pool_leaks(), f"memory pool reservation leak: {pool_leaks()}"
    leaked = live_monitors()
    for mon in leaked:
        mon.close()
    assert not leaked, f"{len(leaked)} health watchdog thread(s) leaked"


@pytest.fixture(scope="module")
def conn():
    return PT(sf=SF, device="cpu")


@pytest.fixture(scope="module")
def oracle(conn):
    return chip_smoke.chaos_oracle(conn, device="cpu")


def _reference_round(conn, oracle, seed: int) -> dict:
    """The JAX package's ``run_chaos_round`` for ``seed``, with its
    injector's fires, its answer and its failed query's error code and
    retries (the injector and the session recorded by subclasses)."""
    made, sessions = [], []

    class Injector(JF.FaultInjector):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Recorded(J.Session):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            sessions.append(self)
            self.last = None

        def sql(self, sql):
            self.last = super().sql(sql)
            return self.last

    injector, session = JF.FaultInjector, J.Session
    JF.FaultInjector, J.Session = Injector, Recorded
    try:
        label = J.run_chaos_round(conn, oracle, seed)
    finally:
        JF.FaultInjector, J.Session = injector, session
    out = {"label": label, "frame": sessions[-1].last,
           "fired": {s: made[-1].fired_at(s) for s in J.FAULT_SITES}}
    if label.startswith("typed:"):
        info = [i for i in sessions[-1].query_history if i.state == "FAILED"][-1]
        out["info"] = (info.error_code, info.oom_retries, info.fragment_retries)
    return out


@pytest.fixture(scope="module")
def ref():
    """The JAX package's oracle and its rounds for ``SMOKE_SEEDS``."""
    jconn = JT(sf=SF)
    oracle = J.build_oracle(jconn)
    return {"oracle": oracle,
            "rounds": {seed: _reference_round(jconn, oracle, seed) for seed in SMOKE_SEEDS}}


def _counter(name):
    return REGISTRY.snapshot().get(name, 0.0)


# ---------------------------------------------------------------------------
# the round driver against the JAX package's
# ---------------------------------------------------------------------------


def test_statements_and_sites_are_the_reference_ones():
    assert chip_smoke.CHAOS_QUERIES == J.CHAOS_QUERIES
    assert chip_smoke.FAULT_SITES == J.FAULT_SITES
    assert chip_smoke.HANG_BUDGET_S == J.HANG_BUDGET_S


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_oracle_equals_reference(oracle, ref, name):
    """The port's fault-free answers, the rounds' oracle, equal the JAX
    package's frame for frame."""
    same_frame(oracle[name], ref["oracle"][name], name)


def _result(cols: dict) -> QueryResult:
    """A one-batch ``QueryResult`` of BIGINT / DOUBLE columns (None: NULL)."""
    arrays, types = {}, {}
    n = len(next(iter(cols.values()))[1])
    for name, (t, values) in cols.items():
        valid = np.array([v is not None for v in values])
        dtype = np.float64 if t is T.DOUBLE else np.int64
        arrays[name] = (np.array([0 if v is None else v for v in values], dtype),
                        None if valid.all() else valid)
        types[name] = t
    return QueryResult(list(cols), [Batch.from_arrays(arrays, np.ones(n, bool), types,
                                                      device="cpu")])


def _frame(cols: dict) -> pd.DataFrame:
    return pd.DataFrame({name: pd.Series(values, dtype="float64" if t is T.DOUBLE else None)
                         for name, (t, values) in cols.items()})


BASE = {"k": (T.BIGINT, [3, 1, 2, 1]), "x": (T.DOUBLE, [0.5, 1.25, None, 1e6])}
FRAME_CASES = {
    "equal": BASE,
    "rows permuted": {"k": (T.BIGINT, [1, 2, 3, 1]), "x": (T.DOUBLE, [1e6, None, 0.5, 1.25])},
    "float within 1e-6": {"k": BASE["k"], "x": (T.DOUBLE, [0.5, 1.25, None, 1e6 * (1 + 1e-8)])},
    "float past 1e-6": {"k": BASE["k"], "x": (T.DOUBLE, [0.5, 1.25, None, 1e6 * (1 + 1e-5)])},
    "int differs": {"k": (T.BIGINT, [3, 1, 2, 2]), "x": BASE["x"]},
    "NULL against a value": {"k": BASE["k"], "x": (T.DOUBLE, [0.5, 1.25, 0.0, 1e6])},
    "another column name": {"k": BASE["k"], "y": BASE["x"]},
    "a row more": {"k": (T.BIGINT, [3, 1, 2, 1, 4]), "x": (T.DOUBLE, [0.5, 1.25, None, 1e6, 2.0])},
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frames_equal_agrees_with_reference(case):
    """``chip_smoke.frames_equal`` on ``QueryResult``s gives the verdict
    ``tests/test_chaos.frames_equal`` gives on the same rows as frames."""
    got = FRAME_CASES[case]
    want = J.frames_equal(_frame(got), _frame(BASE))
    assert chip_smoke.frames_equal(_result(got), _result(BASE)) is want
    assert want is (case in ("equal", "rows permuted", "float within 1e-6"))


def _armed_sites(seed: int) -> list:
    return [spec.site for spec in chip_smoke.chaos_schedule(seed)[2].specs]


def test_mesh_seeds_past_the_reference_sweep_arm_an_exchange_fault():
    """Phase 26's mesh rounds after the JAX package's seeds 0-11 are the
    first twelve seeds past them whose schedule arms ``exchange``."""
    extra = chip_smoke.CHAOS_MESH_SEEDS[12:]
    assert chip_smoke.CHAOS_MESH_SEEDS[:12] == tuple(range(12))
    assert extra == tuple(seed for seed in range(12, extra[-1] + 1)
                          if "exchange" in _armed_sites(seed))
    assert len(extra) == 12


@pytest.mark.parametrize("seed", SMOKE_SEEDS)
def test_chaos_round_equals_reference(conn, oracle, ref, seed):
    """Seed by seed: the same label, the same fires at every site, equal
    frames on ``ok``; on ``typed`` the same error code, OOM rungs and
    fragment retries."""
    want = ref["rounds"][seed]
    seen = {}
    label = chip_smoke.run_chaos_round(conn, oracle, seed, device="cpu", seen=seen)
    assert label == want["label"]
    assert {s: seen["injector"].fired_at(s) for s in J.FAULT_SITES} == want["fired"]
    if label.startswith("ok:"):
        same_frame(seen["result"], want["frame"], label)
    else:
        info = [i for i in seen["session"].query_history if i.state == "FAILED"][-1]
        assert error_code(seen["error"]) == want["info"][0]
        assert (info.error_code, info.oom_retries, info.fragment_retries) == want["info"]


# ---------------------------------------------------------------------------
# the degradation ladder (twins of tests/test_chaos.py:260-385)
# ---------------------------------------------------------------------------


class _DegradeRecorder:
    def __init__(self):
        self.rungs = []

    def query_degraded(self, info):
        self.rungs.append(info.oom_retries)


def test_ladder_recovers_from_runtime_oom(conn, oracle):
    """The in-memory join build OOMs on every attempt; the ladder
    re-plans onto grouped execution, which dispatches at another site
    and answers right."""
    s = Session({"tpch": conn}, device="cpu")
    rec = _DegradeRecorder()
    s.add_event_listener(rec)
    before = _counter("query.oom_degraded")
    inj = faults.FaultInjector()
    inj.inject_oom("step.join_build", times=None)
    with faults.injected(inj):
        res = s.sql(CHAOS["join"])
    assert chip_smoke.frames_equal(res, oracle["join"])
    info = s.query_history[-1]
    assert info.state == "FINISHED"
    assert info.oom_retries == 1
    assert rec.rungs == [1]
    assert _counter("query.oom_degraded") == before + 1
    assert inj.fired_at("step.join_build") == 1
    assert inj.fired_at("step.grouped_join") == 0


def test_ladder_second_rung_doubles_buckets(conn, oracle):
    """Rung 1's grouped pass OOMs once too: rung 2 re-plans with doubled
    buckets and halved probe chunks and answers."""
    s = Session({"tpch": conn}, device="cpu")
    inj = faults.FaultInjector()
    inj.inject_oom("step.join_build", times=None)
    inj.inject_oom("step.grouped_join", times=1)
    with faults.injected(inj):
        res = s.sql(CHAOS["join"])
    assert chip_smoke.frames_equal(res, oracle["join"])
    assert s.query_history[-1].oom_retries == 2


def test_ladder_disabled_raises_typed_oom(conn):
    s = Session({"tpch": conn}, properties={"oom_ladder_max": 0}, device="cpu")
    inj = faults.FaultInjector()
    inj.inject_oom("step.join_build", times=None)
    with faults.injected(inj):
        with pytest.raises(DeviceOutOfMemory):
            s.sql(CHAOS["join"])
    info = s.query_history[-1]
    assert info.state == "FAILED"
    assert info.error_code == "DEVICE_OUT_OF_MEMORY"
    assert info.oom_retries == 0
    assert s.pool().reserved_bytes == 0


def test_ladder_exhaustion_is_typed_not_a_loop(conn):
    """Every rung OOMs: the ladder stops at ``oom_ladder_max`` with the
    typed error."""
    s = Session({"tpch": conn}, properties={"oom_ladder_max": 2}, device="cpu")
    inj = faults.FaultInjector()
    inj.inject_oom("step", times=None, per_site=False)
    with faults.injected(inj):
        with pytest.raises(DeviceOutOfMemory):
            s.sql(CHAOS["join"])
    assert s.query_history[-1].oom_retries == 2
    assert s.pool().reserved_bytes == 0


def test_oom_at_aggregation_step_recovers(conn, oracle):
    """A local aggregation has no spill tier to re-plan onto: its rung is
    a plain re-run, which recovers this one-time OOM."""
    s = Session({"tpch": conn}, device="cpu")
    inj = faults.FaultInjector()
    inj.inject_oom("step.agg", times=1)
    with faults.injected(inj):
        res = s.sql(CHAOS["agg"])
    assert chip_smoke.frames_equal(res, oracle["agg"])
    assert s.query_history[-1].oom_retries == 1


def test_degraded_local_run_gets_its_own_ladder(conn):
    """Exchange faults degrade the mesh run to the local pipeline, whose
    in-memory join build OOMs too: the degraded run walks its own ladder
    onto grouped execution, and the two ladders' rungs add up."""
    q = ("select s_nationkey k, count(*) c, min(n_regionkey) r "
         "from supplier join nation "
         "on s_nationkey = n_nationkey group by s_nationkey order by k")
    want = Session({"tpch": conn}, device="cpu").sql(q)
    s = Session({"tpch": conn}, mesh=make_mesh(2, device="cpu"), device="cpu",
                properties={"retry_count": 0, "retry_backoff_s": 0.0})
    inj = faults.FaultInjector()
    inj.inject("exchange.aggregate", times=None)
    inj.inject_oom("step.join_build", times=None)
    with faults.injected(inj):
        res = s.sql(q)
    assert chip_smoke.frames_equal(res, want)
    info = s.query_history[-1]
    assert info.state == "FINISHED"
    assert info.degraded
    assert info.oom_retries == 2
    assert s.pool().reserved_bytes == 0


def test_oom_surfaces_in_query_history_table(conn):
    s = Session({"tpch": conn}, device="cpu")
    inj = faults.FaultInjector()
    inj.inject_oom("step.join_build", times=None)
    with faults.injected(inj):
        s.sql(CHAOS["join"])
    h = s.sql("select oom_retries, memory_queued_s from query_history "
              "where oom_retries > 0")
    assert len(h) >= 1 and int(h.column("oom_retries").max()) >= 1
    p = s.sql("select * from memory_pool")
    assert len(p) == 1
    # the history scan itself holds the only live reservation
    assert int(p.column("capacity_bytes")[0]) > 0
    assert int(p.column("active_queries")[0]) <= 1


# ---------------------------------------------------------------------------
# seeded chaos sweeps (twins of tests/test_chaos.py:393-756)
# ---------------------------------------------------------------------------


def test_chaos_smoke_seeded(conn, oracle):
    outcomes = [chip_smoke.run_chaos_round(conn, oracle, seed, device="cpu")
                for seed in SMOKE_SEEDS]
    assert len(outcomes) == 10
    assert any(o.startswith("ok:") for o in outcomes)


@pytest.mark.slow
def test_chaos_200_rounds(conn, oracle):
    """200 seeded rounds: no wrong answer, hang or reservation leak, and
    both halves of the contract exercised."""
    outcomes = chip_smoke.chaos_rounds(conn, oracle, range(200), device="cpu")["outcomes"]
    ok = sum(o.startswith("ok:") for o in outcomes.values())
    typed = sum(o.startswith("typed:") for o in outcomes.values())
    assert ok + typed == 200
    assert ok >= 20 and typed >= 20, (ok, typed)


@pytest.mark.slow
def test_chaos_distributed_rounds(conn):
    """Rounds on an eight-shard mesh: exchange faults, the OOM ladder and
    degradation to local all in play."""
    oracle = chip_smoke.chaos_oracle(conn, device="cpu")
    outcomes = chip_smoke.chaos_rounds(conn, oracle, range(12), make_mesh(8, device="cpu"),
                                       device="cpu")["outcomes"]
    assert len(outcomes) == 12


def test_chaos_mixed_ingest_subscriptions(conn, oracle):
    """Appends, subscriptions and ad hoc statements under faults: no
    stale delivery, batched refreshes, a flagged approximate superset,
    every tenant admitted, budgets drained (``chaos_mixed_ingest``
    checks each)."""
    out = chip_smoke.chaos_mixed_ingest(conn, oracle, device="cpu")
    qd, dd = out["batch"]
    assert dd >= 1 and qd / dd > 1.0
    assert out["approx"] >= out["exact"]


@pytest.mark.slow
def test_chaos_concurrent_sessions_shared_pool(conn, oracle):
    """Three sessions on one small pool under faults: right or typed, no
    hang, the pool drained (``chaos_concurrent_sessions`` checks each)."""
    out = chip_smoke.chaos_concurrent_sessions(conn, oracle, device="cpu")
    assert len(out["outcomes"]) == 9


def test_chaos_overload_storm_seeded(conn, oracle):
    """A burst four times over two slots, mid-run cancels and faults at
    ``step.cancel_checkpoint``: finished right, failed typed or shed
    typed, every budget drained (``chaos_overload_storm`` checks each)."""
    out = chip_smoke.chaos_overload_storm(conn, oracle, device="cpu")
    assert out["shed"] >= 1 and out["cancelled"] >= 1
    assert any(s.startswith("FAILED:QUERY_CANCELLED:") for s in out["states"])


def test_chip_smoke_phase26_on_the_cpu():
    """Phase 26 on the CPU at sf 0.01: the numpy oracle, ten seeded
    rounds, the mesh rounds on two shards (an exchange fault must fire),
    the three threaded groups, the launch spans; the device-bytes check is
    the card's."""
    out = chip_smoke.run_chaos_queries(PT(sf=0.01, device="cpu"), device="cpu", seeds=10,
                                       mesh_shards=2)
    assert list(out["groups"]) == ["rounds", "mesh rounds", "concurrent sessions",
                                   "overload storm", "mixed ingest"]
    rounds = out["groups"]["rounds"]["outcomes"]
    assert sorted(rounds) == list(range(10))
    assert tuple(out["groups"]["mesh rounds"]["outcomes"]) == chip_smoke.CHAOS_MESH_SEEDS
    assert out["phase_s"] <= chip_smoke.CHAOS_PHASE_S
    assert out["device_bytes"] == {}
