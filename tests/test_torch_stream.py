"""The port's streaming ingestion (``presto_tpu_torch/stream/writer.py``
over ``connectors/memory.py``'s append path) against the JAX package's,
case for case after ``tests/test_stream_ingest.py``.

The same seeded micro-batches (ints with NULLs, doubles, dates, booleans,
a VARCHAR whose vocabulary grows) land in both packages' memory
connectors: after every append the stored entries (types, arrays, masks,
dictionaries, stats), the epochs and the ``stream.*`` counter moves are
equal, and the incremental stats equal a from-scratch store. Scoped
invalidation, the writer's create-then-append, its refusals and the SQL
INSERT path are held to the reference's contract.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

import presto_tpu.runtime.metrics as JM
import presto_tpu_torch.runtime.metrics as PM
from presto_tpu.connectors.memory import MemoryConnector as JMemory
from presto_tpu.runtime.session import Session as JSession
from presto_tpu.stream import StreamWriter as JStreamWriter
from presto_tpu_torch.connectors.memory import MemoryConnector as PMemory
from presto_tpu_torch.runtime.errors import UserError
from presto_tpu_torch.runtime.session import Session as PSession
from presto_tpu_torch.stream import StreamWriter
from test_torch_memory import assert_same_entry
import torch_bridge  # noqa: F401  (pins one intra-op thread)

STATS_COLS = ("k", "n", "d")  # INTEGER / BIGINT / DATE kinds carry stats


def counter(name: str) -> float:
    return PM.REGISTRY.snapshot().get(name, 0.0)


def _batches(seed: int, n_batches: int = 5, rows: int = 40):
    """(reference frame, port columns) per micro-batch: the reference
    test's generator, the port's copy as numpy columns (NULLs None)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        k = rng.integers(-1000, 1000, rows).astype(np.int64)
        nulls = rng.random(rows) < 0.3
        nullable = pd.array(k.copy(), dtype="Int64")
        nullable[nulls] = pd.NA
        x = rng.normal(size=rows)
        days = rng.integers(0, 400, rows)
        flags = rng.random(rows) < 0.5
        tags = [f"tag-{v}" for v in rng.integers(0, 4 + 3 * b, rows)]
        frame = pd.DataFrame({
            "k": k, "n": nullable, "x": x,
            "d": pd.to_datetime("2026-01-01") + pd.to_timedelta(days, unit="D"),
            "b": flags, "s": tags})
        cols = {"k": k, "n": np.array([None if m else int(v) for v, m in zip(k, nulls)],
                                      dtype=object),
                "x": x, "d": np.datetime64("2026-01-01", "D") + days.astype("timedelta64[D]"),
                "b": flags, "s": np.array(tags, dtype=object)}
        out.append((frame, cols))
    return out


def _concat(batches):
    return (pd.concat([f for f, _ in batches], ignore_index=True),
            {c: np.concatenate([p[c] for _, p in batches]) for c in batches[0][1]})


def stream_moves(registry, before) -> dict:
    after = registry.snapshot()
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after
            if k.startswith("stream.") and not k.endswith(("_s.total", "_s.p50", "_s.p95",
                                                           "_s.p99", "_s.max"))
            and after.get(k, 0.0) != before.get(k, 0.0)}


def test_incremental_stats_bit_identical_to_recompute():
    batches = _batches(seed=7)
    inc, jinc = PMemory(device="cpu"), JMemory()
    inc.create_table("t", batches[0][1])
    jinc.create_table("t", batches[0][0])
    for frame, cols in batches[1:]:
        inc.append("t", cols)
        jinc.append("t", frame)
        assert_same_entry(inc, jinc, "t")
    scratch = PMemory(device="cpu")
    scratch.create_table("t", _concat(batches)[1])
    for c in STATS_COLS:
        got, want = inc.stats("t", c), scratch.stats("t", c)
        assert want is not None, c
        assert (got.ndv, got.min_value, got.max_value, got.null_fraction) == \
            (want.ndv, want.min_value, want.max_value, want.null_fraction), c
    assert repr(inc.physical_schema("t")) == repr(scratch.physical_schema("t"))


def test_appended_table_scans_identical_to_recreated():
    batches = _batches(seed=11)
    inc = PMemory(device="cpu")
    inc.create_table("t", batches[0][1])
    rebuilds = counter("stream.dict_rebuilds")
    for _, cols in batches[1:]:
        inc.append("t", cols)
    assert counter("stream.dict_rebuilds") > rebuilds
    scratch = PMemory(device="cpu")
    scratch.create_table("t", _concat(batches)[1])
    got, want = inc.table_numpy("t"), scratch.table_numpy("t")
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        assert got[c].tolist() == want[c].tolist(), c
    assert len(inc.dictionaries("t")["s"].values) > 4
    jinc = JMemory()
    jinc.create_table("t", batches[0][0])
    for frame, _ in batches[1:]:
        jinc.append("t", frame)
    assert_same_entry(inc, jinc, "t")


def test_append_is_o_micro_batch_not_o_table():
    conn = PMemory(device="cpu")
    batches = _batches(seed=3, n_batches=4)
    conn.create_table("t", batches[0][1])
    calls = []
    orig = conn._built_entry
    conn._built_entry = lambda rows: (calls.append(rows.rows), orig(rows))[1]
    for _, cols in batches[1:]:
        conn.append("t", cols)
    assert calls == [], "append fell back to the full-table re-encode"
    assert conn.row_count("t") == sum(len(c["k"]) for _, c in batches)


def test_epochs_monotone_and_zero_row_noop():
    """The same write script moves both packages' epochs alike."""
    p, j = PMemory(device="cpu"), JMemory()
    cols = {"k": np.arange(5, dtype=np.int64)}
    df = pd.DataFrame(cols)
    seen = []
    for label, pw, jw in [
            ("create", lambda: p.create_table("t", cols), lambda: j.create_table("t", df)),
            ("append", lambda: p.append("t", cols), lambda: j.append("t", df)),
            ("zero rows", lambda: p.append("t", {"k": cols["k"][:0]}),
             lambda: j.append("t", df.iloc[:0])),
            ("drop", lambda: p.drop_table("t"), lambda: j.drop_table("t")),
            ("re-create", lambda: p.create_table("t", cols), lambda: j.create_table("t", df))]:
        assert pw() == jw() if label != "drop" else (pw(), jw())
        assert p.table_epoch("t") == j.table_epoch("t"), label
        seen.append(p.table_epoch("t"))
    assert seen == [1, 2, 2, 3, 4] and p.epochs() == j.epochs() == {"t": 4}


def test_append_rejects_schema_and_type_mismatch():
    conn = PMemory(device="cpu")
    conn.create_table("t", {"k": np.arange(5, dtype=np.int64)})
    with pytest.raises(KeyError):
        conn.append("missing", {"k": np.array([1])})
    with pytest.raises(UserError):
        conn.append("t", {"other": np.array([1])})
    with pytest.raises(UserError):  # DOUBLE into BIGINT never narrows
        conn.append("t", {"k": np.array([1.5])})
    assert conn.table_epoch("t") == 1, "a failed append must not bump"


def test_scoped_invalidation_append_to_a_keeps_b():
    conn = PMemory(device="cpu")
    s = PSession({"memory": conn}, properties={"result_cache_enabled": True,
                                               "collect_node_stats": True}, device="cpu")
    w = StreamWriter(s)
    w.append("a", {"v": np.arange(10, dtype=np.int64)})
    w.append("b", {"v": np.arange(20, dtype=np.int64)})
    qa, qb = "select sum(v) s from a", "select sum(v) s from b"
    s.sql(qa), s.sql(qb)
    hit0 = counter("result_cache.hit")
    s.sql(qb)
    assert counter("result_cache.hit") == hit0 + 1

    def ps_tables(store):
        return [{t for t, _v in e.versions} for e in store.entries()]

    before = ps_tables(s.plan_stats)
    assert any("a" in ts for ts in before) and any("b" in ts for ts in before)
    w.append("a", {"v": np.arange(10, 15, dtype=np.int64)})
    hit1 = counter("result_cache.hit")
    s.sql(qb)
    assert counter("result_cache.hit") == hit1 + 1, "the append to A evicted B's entry"
    after = ps_tables(s.plan_stats)
    assert not any("a" in ts for ts in after) and any("b" in ts for ts in after)
    hit2 = counter("result_cache.hit")
    res = s.sql(qa)
    assert counter("result_cache.hit") == hit2, "a stale hit on the appended table"
    assert int(res.column("s")[0]) == int(np.arange(15).sum())


def test_stream_writer_creates_then_appends():
    """``AppendResult``s and the ``stream.*`` moves equal the reference
    writer's on the same two micro-batches."""
    p = PSession({"memory": PMemory(device="cpu")}, device="cpu")
    j = JSession({"memory": JMemory()})
    results = {}
    for name, session, writer_cls, wrap, reg in (
            ("port", p, StreamWriter, lambda a: {"v": a}, PM.REGISTRY),
            ("jax", j, JStreamWriter, lambda a: pd.DataFrame({"v": a}), JM.REGISTRY)):
        w = writer_cls(session)
        before = reg.snapshot()
        r1 = w.append("t", wrap(np.arange(3, dtype=np.int64)))
        r2 = w.append("t", wrap(np.arange(3, 7, dtype=np.int64)))
        moves = stream_moves(reg, before)
        results[name] = (r1.__dict__ if hasattr(r1, "__dict__") else r1, r2, moves, w.epoch("t"))
    (p1, p2, pm, pe), (j1, j2, jm, je) = results["port"], results["jax"]
    assert (p1, p2.__dict__, pe) == (j1, j2.__dict__, je)
    assert pm == jm and pm["stream.appends"] == 2 and pm["stream.rows"] == 7
    assert p2.total_rows == 7 and p2.epoch == 2 and not p2.created
    res = p.sql("select count(*) c, max(v) m from t")
    assert int(res.column("c")[0]) == 7 and int(res.column("m")[0]) == 6


def test_stream_writer_rejects_unstreamable_catalog():
    from presto_tpu_torch.connectors.tpch import TpchConnector

    s = PSession({"tpch": TpchConnector(sf=0.001, device="cpu")}, device="cpu")
    with pytest.raises(UserError, match="not streamable"):
        StreamWriter(s, "tpch")
    with pytest.raises(UserError, match="unknown catalog"):
        StreamWriter(s, "nope")


def test_sql_insert_rides_the_append_path():
    conn = PMemory(device="cpu")
    s = PSession({"memory": conn}, device="cpu")
    s.sql("create table t as select 1 as v")
    e0 = conn.table_epoch("t")
    s.sql("insert into t select 2 as v")
    assert conn.table_epoch("t") == e0 + 1
    st = conn.stats("t", "v")
    assert (st.min_value, st.max_value, st.ndv) == (1, 2, 2.0)
