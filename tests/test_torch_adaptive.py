"""The port's adaptive controller (``presto_tpu_torch/plan/adaptive.py``)
and its consumers against the JAX package's, case for case after
``tests/test_adaptive.py``.

- The controller's unit surface (salt factor, salting a recurring skewed
  join with synthetic hints, the stand-down under a fault injector and
  under ``flight_record_successes``, the compile-budget refusal and its
  stickiness, sticky replay) decides alike in both packages.
- Through the sessions (sf 0.005, result cache off): decisions need a
  recurring fingerprint, the ``adaptive_execution`` property gates them,
  and the plan-stats history exports and imports alike.
- An aggregation whose recorded actuals contradict its estimate by at
  least ``MISEST_FACTOR`` gets a history-sizing decision (``bucket``;
  ``join_flip`` is the same rule on a join's build) on its third run in
  both packages, with the gate's input pinned (both executable caches
  cleared before the deciding run, so the predicted cost is 0); the
  decision replays sticky, shows in ``system.adaptive`` and changes no
  answer. The reference's salting cases need its 8-device mesh; their
  counterparts here run the local decisions on the same key shapes.
- ROADMAP C20: each package prices a decision by its own executable
  ledger. The port's walls hold no compile, so its predicted cost is far
  below the reference's, and a decision whose win lies between the two
  is admitted by the port and refused by the reference
  (``test_compile_budget_divergence_c20``).

The reference's server warmer case waits for the server (A9b).
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import pytest

import presto_tpu.cache.exec_cache as JE
import presto_tpu.plan.adaptive as JA
import presto_tpu.runtime.faults as JF
import presto_tpu.runtime.metrics as JM
import presto_tpu_torch.cache.exec_cache as PE
import presto_tpu_torch.plan.adaptive as PA
import presto_tpu_torch.runtime.faults as PF
import presto_tpu_torch.runtime.metrics as PM
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.plan import nodes as JN
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.plan import nodes as PN
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import port_frame

#: the deciding runs clear both packages' executable caches
pytestmark = pytest.mark.resets_global_state

SF = 0.005
JOIN_SQL = ("select n_name, count(*) c from supplier "
            "join nation on s_nationkey = n_nationkey group by n_name")
#: a plan whose aggregate's estimate (512 groups) the actuals (at most
#: 192) refute by more than MISEST_FACTOR
FLIP_SQL = ("select k, dv, count(*) c, sum(v) sv from probe "
            "join (select dk, dv from dim where dv < 3) d on k = dk "
            "group by k, dv order by k, dv")


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=SF), PConnector(sf=SF, device="cpu")


def sessions(conns, **props):
    props = {"result_cache_enabled": False, **props}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def counter(reg, name):
    return reg.REGISTRY.snapshot().get(name, 0)


def find(plan, node_type):
    if isinstance(plan, node_type):
        return plan
    for c in plan.children:
        hit = find(c, node_type)
        if hit is not None:
            return hit
    return None


def salt_hints(join, *, skew=7.0, hot=3, wall=5.0, runs=4):
    return {id(join): {"node_id": 5, "node_type": "Join", "skew": skew, "hot_partition": hot,
                       "wall_s": wall, "runs": runs, "route_fallback": False, "misest": 1.0,
                       "actual_rows": 100, "est_rows": 100}}


def executor_of(session):
    return session.executor() if callable(session.executor) else session.executor


def decisions(decs) -> list:
    """A decision map's content, by node id (``id(node)`` differs
    between the packages' plans)."""
    return sorted((k, d.node_id, d.salt, d.hot_partition, d.est_bytes, d.trigger)
                  for per_node in decs.values() for k, d in per_node.items())


# ---------------------------------------------------------------------------
# controller unit surface
# ---------------------------------------------------------------------------


def test_salt_factor_clamps():
    cases = [(2.0, 8, 8), (3.0, 8, 8), (6.8, 8, 8), (100.0, 8, 8), (100.0, 16, 4), (0.5, 8, 8)]
    assert [PA.salt_factor(*c) for c in cases] == [JA.salt_factor(*c) for c in cases] == \
        [2, 4, 8, 8, 4, 2]


def test_decide_salts_recurring_skewed_join(conns):
    got = []
    for s, A, N in zip(sessions(conns), (JA, PA), (JN, PN)):
        plan = s.plan(JOIN_SQL)
        join = find(plan, N.Join)
        decs = A.AdaptiveController().decide(plan, salt_hints(join), s.catalog,
                                             fingerprint="fp-unit", nworkers=8)
        single = A.AdaptiveController().decide(plan, salt_hints(join), s.catalog,
                                               fingerprint="fp-unit", nworkers=1)
        got.append((decisions(decs), single))
    assert got[0] == got[1]
    assert got[1][0][0][0] == "salt" and got[1][0][0][2:4] == (8, 3) and got[1][1] == {}


def test_decide_stands_down_under_fault_injector(conns):
    got = []
    for s, A, N, F, reg in zip(sessions(conns), (JA, PA), (JN, PN), (JF, PF), (JM, PM)):
        plan = s.plan("select count(*) c from supplier join nation on s_nationkey = n_nationkey")
        join = find(plan, N.Join)
        hints = salt_hints(join)
        ctl = A.AdaptiveController()
        before = counter(reg, "adaptive.stand_down")
        with F.injected(F.FaultInjector(seed=1)):
            faulted = ctl.decide(plan, hints, s.catalog, fingerprint="fp-faults", nworkers=8)
        recording = ctl.decide(plan, hints, s.catalog, fingerprint="fp-rec", nworkers=8,
                               recording=True)
        down = counter(reg, "adaptive.stand_down") - before
        with F.injected(F.FaultInjector(seed=1)):
            rendered = ctl.decide(plan, hints, s.catalog, fingerprint="fp-faults", nworkers=8,
                                  for_render=True)
        got.append((faulted, recording, down, decisions(rendered), bool(ctl._sticky),
                    ctl.rows()))
    assert got[0] == got[1]
    assert got[1][:3] == ({}, {}, 2) and got[1][3] and not got[1][4] and got[1][5] == []


def test_compile_budget_refusal_counted_and_sticky(conns, monkeypatch):
    got = []
    for s, A, N, reg, mod in zip(sessions(conns), (JA, PA), (JN, PN), (JM, PM),
                                 ("presto_tpu", "presto_tpu_torch")):
        plan = s.plan("select count(*) c from supplier join nation on s_nationkey = n_nationkey")
        join = find(plan, N.Join)
        hints = salt_hints(join, wall=1e-6, runs=2)
        monkeypatch.setattr(f"{mod}.plan.adaptive.predicted_compile_cost", lambda kind: 100.0)
        ctl = A.AdaptiveController()
        before = counter(reg, "adaptive.compile_budget_refused")
        first = ctl.decide(plan, hints, s.catalog, fingerprint="fp-budget", nworkers=8)
        n1 = counter(reg, "adaptive.compile_budget_refused") - before
        again = ctl.decide(plan, hints, s.catalog, fingerprint="fp-budget", nworkers=8)
        n2 = counter(reg, "adaptive.compile_budget_refused") - before
        refused = [(r["kind"], r["applied"], r["trigger"]) for r in ctl.rows()]
        got.append((first, again, n1, n2, refused))
    assert got[0] == got[1]
    first, again, n1, n2, refused = got[1]
    assert first == again == {} and n1 == n2 == 1
    assert refused[0][:2] == ("salt", False) and "cost" in refused[0][2]


def test_sticky_decision_survives_cost_spike(conns, monkeypatch):
    got = []
    for s, A, N, mod in zip(sessions(conns), (JA, PA), (JN, PN),
                            ("presto_tpu", "presto_tpu_torch")):
        plan = s.plan("select count(*) c from supplier join nation on s_nationkey = n_nationkey")
        join = find(plan, N.Join)
        hints = salt_hints(join, wall=5.0, runs=4)
        monkeypatch.setattr(f"{mod}.plan.adaptive.predicted_compile_cost", lambda kind: 0.0)
        ctl = A.AdaptiveController()
        first = ctl.decide(plan, hints, s.catalog, fingerprint="fp-stick", nworkers=8)
        monkeypatch.setattr(f"{mod}.plan.adaptive.predicted_compile_cost", lambda kind: 1e9)
        again = ctl.decide(plan, hints, s.catalog, fingerprint="fp-stick", nworkers=8)
        got.append((decisions(first), again[id(join)]["salt"] is first[id(join)]["salt"]))
    assert got[0] == got[1] and got[1][1]


def test_predicted_compile_cost_reads_ledger():
    assert PA.predicted_compile_cost("no_such_step_kind") == \
        JA.predicted_compile_cost("no_such_step_kind") == 0.0
    # a ledger row prices its kind by cold minus warm
    c = PE.ExecutableCache()
    fn = c.get_or_build(c.key_of("join_build", 1), lambda: (lambda: None))
    fn()
    fn()
    entry = next(iter(c._entries.values()))
    entry.cold_call_s, entry.warm_call_s = 0.5, 0.125
    saved, PE.EXEC_CACHE = PE.EXEC_CACHE, c
    try:
        assert PA.predicted_compile_cost("join_build") == 0.375
    finally:
        PE.EXEC_CACHE = saved


# ---------------------------------------------------------------------------
# the recurrence corridor through the sessions (runs >= 2)
# ---------------------------------------------------------------------------


def test_decisions_require_recurrence(conns):
    got = []
    for s in sessions(conns):
        s.execute(JOIN_SQL)
        plan = s.plan(JOIN_SQL)
        once = (s._plan_hints(plan), s._adaptive_decisions(plan, None, {}, executor_of(s)))
        s.execute(JOIN_SQL)
        hints = s._plan_hints(plan)
        got.append((once, sorted((r["node_id"], r["runs"]) for r in hints.values())))
    assert got[0] == got[1]
    assert got[1][0] == ({}, {}) and got[1][1] and all(r >= 2 for _n, r in got[1][1])


def test_adaptive_execution_property_gates_decisions(conns):
    for s in sessions(conns, adaptive_execution=False):
        s.execute(JOIN_SQL)
        s.execute(JOIN_SQL)
        plan = s.plan(JOIN_SQL)
        hints = s._plan_hints(plan)
        assert hints
        assert s._adaptive_decisions(plan, None, hints, executor_of(s)) == {}


# ---------------------------------------------------------------------------
# plan-stats export / import
# ---------------------------------------------------------------------------


def test_export_import_roundtrip(conns, tmp_path):
    got = []
    for (s1, s2), tag in zip(zip(sessions(conns), sessions(conns)), ("j", "p")):
        s1.execute(JOIN_SQL)
        s1.execute(JOIN_SQL)
        path = tmp_path / f"stats_{tag}.json"
        text = s1.export_plan_stats(str(path))
        payload = json.loads(path.read_text())
        assert json.loads(text) == payload
        imported = s2.import_plan_stats(str(path))
        hints = s2._plan_hints(s2.plan(JOIN_SQL))
        got.append((payload["format"], [(e["runs"], len(e["records"]), e["versions"])
                                        for e in payload["entries"]],
                    imported, sorted((r["node_id"], r["runs"]) for r in hints.values())))
    assert got[0] == got[1]
    assert got[1][2] >= 1 and got[1][3] and all(r >= 2 for _n, r in got[1][3])


def test_import_rejects_stale_table_epochs(conns, tmp_path):
    q = "select count(*) c from little"
    got = []
    for (s1, s2), tag in zip(zip(sessions(conns), sessions(conns)), ("j", "p")):
        def rows(ks):
            return (pd.DataFrame({"k": ks}) if tag == "j"
                    else {"k": np.array(ks, np.int64)})

        s1.catalog.connector("memory").create_table("little", rows([1, 2, 3]))
        s1.execute(q)
        s1.execute(q)
        path = tmp_path / f"stats_{tag}.json"
        s1.export_plan_stats(str(path))
        m2 = s2.catalog.connector("memory")
        m2.create_table("little", rows([1, 2, 3]))
        m2.create_table("little", rows([9]))  # an epoch bump
        got.append((s2.import_plan_stats(str(path)), s2._plan_hints(s2.plan(q))))
    assert got[0] == got[1] == (0, {})


def test_import_rejects_unknown_format(conns, tmp_path):
    _js, ps = sessions(conns)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": 99, "entries": []}))
    with pytest.raises(UserError):
        ps.import_plan_stats(str(bad))


# ---------------------------------------------------------------------------
# history-driven decisions on a real misestimate (the reference's mesh
# cases' local counterparts)
# ---------------------------------------------------------------------------


def probe_rows(shape, rng, rows=4096):
    if shape == "zipf":
        keys = np.where(rng.random(rows) < 0.85, 7, rng.integers(0, 64, rows)).astype(np.float64)
    elif shape == "uniform":
        keys = (np.arange(rows) % 64).astype(np.float64)
    else:  # NULL keys never match
        keys = np.where(rng.random(rows) < 0.85, 7, rng.integers(0, 64, rows)).astype(np.float64)
        keys[rng.random(rows) < 0.15] = np.nan
    return keys, rng.integers(0, 100, rows)


def load_tables(session, keys, vals, port: bool):
    mem = session.catalog.connector("memory")
    if port:
        valid = ~np.isnan(keys)
        from presto_tpu_torch.batch import Batch, QueryResult
        from presto_tpu_torch.types import BIGINT

        batch = Batch.from_numpy({"k": np.nan_to_num(keys).astype(np.int64),
                                  "v": vals.astype(np.int64)}, {"k": BIGINT, "v": BIGINT},
                                 valids={"k": valid}, device="cpu")
        mem.create_table("probe", QueryResult(["k", "v"], [batch]))
        mem.create_table("dim", {"dk": np.arange(64, dtype=np.int64),
                                 "dv": np.arange(64, dtype=np.int64)})
    else:
        mem.create_table("probe", pd.DataFrame({"k": pd.array(
            [None if np.isnan(x) else int(x) for x in keys], dtype="Int64"), "v": vals}))
        mem.create_table("dim", pd.DataFrame({"dk": np.arange(64, dtype=np.int64),
                                              "dv": np.arange(64, dtype=np.int64)}))


def sized(reg) -> float:
    """The applied history-sizing decisions so far (``join_flip`` and
    ``bucket``)."""
    return counter(reg, "adaptive.join_flip") + counter(reg, "adaptive.bucket_override")


def run_adaptive(conns, rng_seed, shape, **props):
    """Three recorded runs of FLIP_SQL per package over the same data,
    both executable caches cleared before the third, deciding run (the
    gate's cost is then 0): per package, the frames, the applied-decision counters per
    run and the ``system.adaptive`` rows."""
    keys, vals = probe_rows(shape, np.random.default_rng(rng_seed))
    out = []
    for s, port, reg in zip(sessions(conns, **props), (False, True), (JM, PM)):
        load_tables(s, keys, vals, port)
        frames, flips = [], []
        for i in range(3):
            if i == 2:  # the deciding run: the gate's predicted cost is 0
                JE.EXEC_CACHE.clear()
                PE.EXEC_CACHE.clear()
            before = sized(reg)
            res, _info = s.execute(FLIP_SQL)
            flips.append(sized(reg) - before)
            frames.append(port_frame(res) if port else res)
        rows = s.sql("select kind, node_id, trigger, applied from adaptive")
        rows = port_frame(rows) if port else rows
        table = [tuple(v.rstrip(b"\x00").decode() if isinstance(v, bytes) else v
                       for v in r) for r in rows.itertuples(index=False)]
        out.append((frames, flips, table))
    return out


@pytest.mark.parametrize("shape", ["zipf", "uniform", "nulls"])
def test_adaptive_join_flip_bit_identity(conns, shape):
    (jf, jflips, jtable), (pf, pflips, ptable) = run_adaptive(conns, 7, shape)
    assert pflips == jflips == [0, 0, 1]
    assert ptable == jtable and ptable and ptable[0][0] in ("join_flip", "bucket")
    assert ptable[0][3] == 1
    for got, want in zip(pf, jf):
        pd.testing.assert_frame_equal(got.astype(want.dtypes.to_dict()), want)
    for got in pf[1:]:
        pd.testing.assert_frame_equal(got, pf[0])


def test_decision_replays_sticky_on_later_runs(conns):
    """The applied decision replays on every later run (a corrected
    estimate records no misestimate, which would otherwise flip it
    back)."""
    keys, vals = probe_rows("zipf", np.random.default_rng(11))
    got = []
    for s, port, reg in zip(sessions(conns), (False, True), (JM, PM)):
        load_tables(s, keys, vals, port)
        flips = []
        for i in range(5):
            if i == 2:  # the deciding run: the gate's predicted cost is 0
                JE.EXEC_CACHE.clear()
                PE.EXEC_CACHE.clear()
            before = sized(reg)
            s.execute(FLIP_SQL)
            flips.append(sized(reg) - before)
        got.append(flips)
    assert got[0] == got[1] == [0, 0, 1, 1, 1]


def test_failed_adaptive_run_leaves_its_decisions_in_the_post_mortem(conns):
    """A run that fails after its decisions applied: the flight record
    and ``system.adaptive`` show them in both packages, and the pool
    drains."""
    keys, vals = probe_rows("zipf", np.random.default_rng(5))
    got = []
    for s, port in zip(sessions(conns, retry_count=0, oom_ladder_max=0), (False, True)):
        load_tables(s, keys, vals, port)
        for _ in range(2):
            s.execute(FLIP_SQL)
        JE.EXEC_CACHE.clear()
        PE.EXEC_CACHE.clear()
        # fail after the join ran: the aggregation above it raises
        F = PF if port else JF
        inj = F.FaultInjector()
        inj.inject("step.agg", times=None)
        with F.injected(inj):
            # adaptivity stands down under an injector: the failing run
            # is the baseline plan, and its post-mortem says so
            with pytest.raises(Exception):
                s.execute(FLIP_SQL)
        rec = s.flight.latest()
        got.append((rec.state, rec.adaptive, s.pool().snapshot()["reserved_bytes"]))
    assert got[0] == got[1] == ("FAILED", [], 0)


def test_no_decisions_under_success_recorder_runs(conns):
    keys, vals = probe_rows("zipf", np.random.default_rng(3))
    got = []
    for s, port, reg in zip(sessions(conns, flight_record_successes=True), (False, True),
                            (JM, PM)):
        load_tables(s, keys, vals, port)
        flips0 = sized(reg)
        down0 = counter(reg, "adaptive.stand_down")
        for _ in range(4):
            s.execute(FLIP_SQL)
        got.append((sized(reg) - flips0,
                    counter(reg, "adaptive.stand_down") - down0))
    assert got[0] == got[1]
    assert got[1][0] == 0 and got[1][1] > 0


# ---------------------------------------------------------------------------
# ROADMAP C20: the compile-budget gate prices with each package's walls
# ---------------------------------------------------------------------------


def test_compile_budget_divergence_c20(conns):
    """From cleared caches, the same runs leave ledgers whose
    ``join_build`` cold-minus-warm wall is far smaller in the port (a
    first Python call) than in the reference (an XLA trace and compile).
    A ``join_flip`` whose predicted win lies between the two is admitted
    by the port's gate and refused by the reference's."""
    keys, vals = probe_rows("uniform", np.random.default_rng(1))
    costs, verdicts = [], []
    for s, port, A, E in zip(sessions(conns), (False, True), (JA, PA), (JE, PE)):
        load_tables(s, keys, vals, port)
        E.EXEC_CACHE.clear()  # each package's own ledger, from empty
        for _ in range(3):
            s.execute(FLIP_SQL)  # cold, then warm calls of the same steps
        costs.append(A.predicted_compile_cost("join_build"))
    assert 0.0 < costs[1] < costs[0]
    # a win between the two costs: wall_s * 0.5 * runs * RECURRENCE_HORIZON
    win = (costs[0] * costs[1]) ** 0.5
    wall = win / (0.5 * 2 * PA.RECURRENCE_HORIZON)
    for s, A, N in zip(sessions(conns), (JA, PA), (JN, PN)):
        plan = s.plan(JOIN_SQL)
        join = find(plan, N.Join)
        hints = {id(join.right): {"node_id": 9, "misest": 10.0, "actual_rows": 5,
                                  "est_rows": 50, "runs": 2, "wall_s": wall}}
        ctl = A.AdaptiveController()
        decs = ctl.decide(plan, hints, s.catalog, fingerprint="fp-c20")
        verdicts.append((bool(decs), [r["applied"] for r in ctl.rows()]))
    assert verdicts[0] == (False, [False])  # the reference refuses
    assert verdicts[1] == (True, [])  # the port admits (and logs on apply)
