"""The port's join layer against the JAX package's, exactly.

- ``ops/cuda_join``: the table builders and the plain probes
  (``exists_probe_plain`` / ``payload_probe_plain``, which the CUDA
  kernels are held to on the card) against ``ops/pallas_join``'s
  builders and Pallas probes run in interpret mode, on seeded keys that
  cover the card's phase-2 cases: int8/int16/int32 keys, a negative
  ``key_min``, ``key_max = 2^31-1``, keys below, above and at both ends
  of the domain, dead rows, payloads of 1..4 columns, and a table at the
  exists budget (16384 words). The kernels' wrappers compute the plain
  version on CPU tensors, and a ragged capacity (which the Pallas
  kernels cannot block) is held to a numpy recomputation.
- ``exec/joins``: ``JoinBuildOperator`` + ``LookupJoinOperator`` on the
  sorted, dense and fused sides against the JAX operators built as
  ``tests/test_join_route.py`` builds them, including the out-of-domain
  build fallback and NULL keys.
Tolerance: exact everywhere (integer data).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.batch import Batch as JBatch
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.pipeline import BatchSource as JBatchSource
from presto_tpu.exec.pipeline import Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.ops import pallas_join
from presto_tpu.types import INTEGER as JINTEGER
from presto_tpu.types import narrow_physical as jnarrow
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.expr import col as pcol
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops import join as pjoin
from presto_tpu_torch.runtime.errors import InternalError
from presto_tpu_torch.runtime.metrics import COUNTERS
from torch_bridge import assert_same, port_batch, port_type, to_numpy

CAP = 4096  # a multiple of the Pallas probe block
I32MAX = (1 << 31) - 1

# (key dtype, key_min, key_max): probe keys are drawn over the whole
# dtype range around the domain, plus both ends and their neighbours
EXISTS_CASES = [
    ("int8", -100, 100),
    ("int16", -3000, 20000),
    ("int32", 1, 150000),  # Q3's customer-key domain at SF1
    ("int32", -70000, 70000),  # negative key_min
    ("int32", I32MAX - 50000, I32MAX),  # key_max = 2^31-1
    ("int32", 0, 16384 * 32 - 1),  # a table at the exists budget
]


def _keys(rng, dtype, kmin, kmax, n, spread=2000):
    """Probe keys in ``dtype``: around the domain, across its ends, and
    the ends themselves with their out-of-domain neighbours."""
    info = np.iinfo(dtype)
    lo, hi = max(info.min, kmin - spread), min(info.max, kmax + spread)
    k = rng.integers(lo, hi, n, endpoint=True)
    edges = [kmin, kmax, kmin - 1, kmax + 1, info.min, info.max]
    edges = [e for e in edges if info.min <= e <= info.max]
    k[: len(edges)] = edges
    return k.astype(dtype)


def _build_keys(rng, dtype, kmin, kmax, n):
    k = rng.integers(kmin, kmax, n, endpoint=True)
    k[:2] = [kmin, kmax]
    return k.astype(dtype)


def _live(rng, n):
    live = rng.random(n) < 0.85
    live[:6] = True  # the edge keys are live
    return live


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_eligibility_matches_reference():
    for d in (1, 31, 32, 33, 1000, 150000, 16384 * 32, 16384 * 32 + 1, 1 << 22, 0, -5):
        assert cuda_join.exists_words(d) == pallas_join.exists_words(d), d
        for n in (1, 2, 4, 9):
            assert cuda_join.payload_rows(d, n) == pallas_join.payload_rows(d, n), (d, n)
    for lo, hi in ((-(1 << 31), I32MAX), (-(1 << 31) - 1, 0), (0, 1 << 31), (5, 4), (3, 3)):
        assert cuda_join.interval_ok(lo, hi) == pallas_join.interval_ok(lo, hi)
    for dt in (torch.int8, torch.int16, torch.int32):
        assert cuda_join.key_dtype_ok(dt)
        assert pallas_join.key_dtype_ok(jnp.dtype(str(dt).split(".")[1]))
    assert not cuda_join.key_dtype_ok(torch.int64)
    assert not pallas_join.key_dtype_ok(jnp.int64)
    # divergence (ROADMAP C5): unsigned keys ride the Pallas kernels but
    # fall back in the port; the connector narrows to signed types only
    assert pallas_join.key_dtype_ok(jnp.uint8) and not cuda_join.key_dtype_ok(torch.uint8)


@pytest.mark.parametrize("dtype,kmin,kmax", EXISTS_CASES)
def test_exists_table_and_probe_match_pallas(dtype, kmin, kmax):
    rng = np.random.default_rng(abs(kmin) % 1000 + kmax % 997)
    bk = _build_keys(rng, dtype, kmin, kmax, 3000)
    blive = _live(rng, bk.shape[0])
    want_t, want_oob = pallas_join.build_exists_table(jnp.asarray(bk), jnp.asarray(blive),
                                                      kmin, kmax)
    got_t, got_oob = cuda_join.build_exists_table(_t(bk), _t(blive), kmin, kmax)
    assert_same(got_t, np.asarray(want_t)[:, 0], "exists table")
    assert bool(got_oob) == bool(want_oob) is False

    pk = _keys(rng, dtype, kmin, kmax, CAP)
    plive = _live(rng, CAP)
    want = pallas_join.exists_probe(want_t, kmin, kmax, jnp.asarray(pk), jnp.asarray(plive),
                                    interpret=True)
    got = cuda_join.exists_probe_plain(got_t, kmin, kmax, _t(pk), _t(plive))
    assert_same(got, want, "exists probe")
    before = cuda_join.exists_launches
    assert_same(cuda_join.exists_probe(got_t, kmin, kmax, _t(pk), _t(plive)), want,
                "exists wrapper on the CPU")
    assert cuda_join.exists_launches == before
    assert not got[~_t(plive)].any(), "a dead row matched"


@pytest.mark.parametrize("nval", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,kmin,kmax", [("int8", -60, 90), ("int16", -500, 2500),
                                             ("int32", I32MAX - 3000, I32MAX)])
def test_payload_tables_and_probe_match_pallas(dtype, kmin, kmax, nval):
    assert cuda_join.payload_rows(kmax - kmin + 1, nval) is not None
    rng = np.random.default_rng(nval * 31 + abs(kmin) % 97)
    domain = np.arange(kmin, kmax + 1)
    bk = rng.choice(domain, size=min(len(domain), 400), replace=False).astype(dtype)
    blive = _live(rng, bk.shape[0])
    vals = [rng.integers(-(1 << 31), 1 << 31, bk.shape[0]).astype(np.int32)]
    vals += [rng.integers(-128, 128, bk.shape[0]).astype(np.int8)] * (nval - 1)
    vals = vals[:nval]
    want_t, want_oob = pallas_join.build_payload_tables(
        jnp.asarray(bk), jnp.asarray(blive), kmin, kmax, [jnp.asarray(v) for v in vals])
    got_t, got_oob = cuda_join.build_payload_tables(_t(bk), _t(blive), kmin, kmax,
                                                    [_t(v) for v in vals])
    assert len(got_t) == len(want_t) == nval + 1
    for g, w in zip(got_t, want_t):
        assert_same(g, np.asarray(w)[:, 0], "payload table")
    assert bool(got_oob) == bool(want_oob) is False

    pk = _keys(rng, dtype, kmin, kmax, CAP, spread=300)
    plive = _live(rng, CAP)
    wm, wv = pallas_join.payload_probe(want_t, kmin, kmax, jnp.asarray(pk),
                                       jnp.asarray(plive), interpret=True)
    gm, gv = cuda_join.payload_probe_plain(got_t, kmin, kmax, _t(pk), _t(plive))
    assert_same(gm, wm, "payload matched")
    for g, w in zip(gv, wv):
        assert_same(g, w, "payload values")
    before = cuda_join.payload_launches
    wm2, wv2 = cuda_join.payload_probe(got_t, kmin, kmax, _t(pk), _t(plive))
    assert_same(wm2, wm)
    assert cuda_join.payload_launches == before


def test_ragged_capacity_and_oob_build():
    """A ragged capacity (no Pallas blocking) against numpy set
    membership, and a live build key outside the domain flags oob in
    both packages."""
    rng = np.random.default_rng(3)
    kmin, kmax = -1000, 5000
    bk = _build_keys(rng, "int16", kmin, kmax, 700)
    blive = _live(rng, bk.shape[0])
    table, _ = cuda_join.build_exists_table(_t(bk), _t(blive), kmin, kmax)
    pk = _keys(rng, "int16", kmin, kmax, 1000 + 3)
    plive = _live(rng, pk.shape[0])
    got = cuda_join.exists_probe_plain(table, kmin, kmax, _t(pk), _t(plive))
    want = plive & np.isin(pk, bk[blive])
    assert_same(got, want)

    bad = bk.copy()
    bad[5] = kmax + 7
    blive[5] = True
    _, got_oob = cuda_join.build_exists_table(_t(bad), _t(blive), kmin, kmax)
    _, want_oob = pallas_join.build_exists_table(jnp.asarray(bad), jnp.asarray(blive),
                                                 kmin, kmax)
    assert bool(got_oob) and bool(want_oob)
    blive[5] = False  # a dead out-of-domain key is fine
    _, got_oob = cuda_join.build_exists_table(_t(bad), _t(blive), kmin, kmax)
    assert not bool(got_oob)


def test_probe_refuses_uncovered_table_and_wide_keys():
    t = torch.zeros(8, dtype=torch.int32)
    keys = torch.zeros(16, dtype=torch.int32)
    live = torch.ones(16, dtype=torch.bool)
    with pytest.raises(InternalError, match="does not cover"):
        cuda_join.exists_probe(t, 0, 8 * 32, keys, live)
    with pytest.raises(InternalError, match="int8/int16/int32"):
        cuda_join.exists_probe(t, 0, 10, keys.to(torch.int64), live)
    with pytest.raises(InternalError, match="does not cover"):
        cuda_join.payload_probe((t, t), 0, 8, keys, live)
    with pytest.raises(InternalError, match="at most 16"):
        cuda_join.payload_probe([t] * (cuda_join.MAX_VALUES + 2), 0, 7, keys, live)


def test_payload_route_carries_at_most_max_values_columns():
    """Divergence (ROADMAP C7): one payload probe carries at most 16
    value columns, so the planner sends a wider payload to the dense or
    sorted probe, where the JAX package's budget alone would route it."""
    from presto_tpu_torch.exec.local_planner import LocalExecutor
    from presto_tpu_torch.plan.catalog import Catalog
    from presto_tpu_torch.types import INTEGER

    ex = LocalExecutor(Catalog({}), device="cpu")
    names = tuple(f"v{i}" for i in range(cuda_join.MAX_VALUES + 1))
    fields = {n: INTEGER for n in names}
    assert cuda_join.payload_rows(100, len(names)) and pallas_join.payload_rows(100, len(names))
    assert ex._pallas_spec((0, 99), names[:-1], fields, True, "inner").mode == "payload"
    assert ex._pallas_spec((0, 99), names, fields, True, "inner") is None


def test_sorted_and_dense_ops_match_reference():
    from presto_tpu.ops import join as jjoin

    rng = np.random.default_rng(11)
    bk = rng.choice(np.arange(-500, 3000), 900, replace=False).astype(np.int32)
    blive = _live(rng, bk.shape[0])
    pk = rng.integers(-600, 3100, CAP).astype(np.int32)
    plive = _live(rng, CAP)
    jside = jjoin.build_lookup(jnp.asarray(bk), jnp.asarray(blive), 1024)
    pside = pjoin.build_lookup(_t(bk), _t(blive), 1024)
    assert_same(pside.sorted_keys, jside.sorted_keys)
    assert_same(pside.row_idx, jside.row_idx)
    want = jjoin.probe_unique(jside, jnp.asarray(pk), jnp.asarray(plive))
    got = pjoin.probe_unique(pside, _t(pk), _t(plive))
    assert_same(got.matched, want.matched)
    assert_same(got.build_row, want.build_row)
    jd = jjoin.build_dense(jnp.asarray(bk), jnp.asarray(blive), -500, 3500)
    pd_ = pjoin.build_dense(_t(bk), _t(blive), -500, 3500)
    assert_same(pd_.table, jd.table)
    assert bool(pd_.overflow) == bool(jd.overflow) is False
    want = jjoin.probe_unique_dense(jd, jnp.asarray(pk), jnp.asarray(plive))
    got = pjoin.probe_unique_dense(pd_, _t(pk), _t(plive))
    assert_same(got.matched, want.matched)
    assert_same(got.build_row, want.build_row)
    # a live key outside the dense domain flags overflow in both
    assert bool(pjoin.build_dense(_t(bk), _t(blive), 0, 3000).overflow)
    assert bool(jjoin.build_dense(jnp.asarray(bk), jnp.asarray(blive), 0, 3000).overflow)


def test_build_refuses_the_sentinel_key():
    bk = np.array([1, 2, np.iinfo(np.int64).max], dtype=np.int64)
    from presto_tpu_torch.batch import Batch as PBatch
    from presto_tpu_torch.types import BIGINT

    b = PJ.JoinBuildOperator(pcol("bk", BIGINT))
    b.process(PBatch.from_numpy({"bk": bk}, {"bk": BIGINT}, device="cpu"))
    with pytest.raises(NotImplementedError, match="sentinel"):
        b.finish()


# ---------------------------------------------------------------------------
# operators: JoinBuildOperator + LookupJoinOperator, port vs JAX
# ---------------------------------------------------------------------------

OP_CASES = [
    # (join type, payload outputs, fused mode or None, dense domain)
    ("inner", False, None, None),  # sorted probe
    ("inner", False, None, (-40, 440)),  # dense probe
    ("inner", False, "exists", None),
    ("inner", True, None, None),
    ("inner", True, None, (-40, 440)),
    ("inner", True, "payload", (-40, 440)),
    ("left", True, "payload", None),
    ("left", True, None, (-40, 440)),
]


def _op_batches(rng, key_type):
    n_b, n_p = 150, 1500
    bk = rng.choice(np.arange(-40, 400), size=n_b, replace=False)
    bval = rng.integers(-(1 << 30), 1 << 30, size=n_b)
    pk = rng.integers(-80, 460, size=n_p)
    types = {"bk": key_type, "bval": JINTEGER, "pk": key_type, "pval": JINTEGER}
    bb = JBatch.from_numpy({"bk": bk, "bval": bval}, types, capacity=1024,
                           valids={"bk": rng.random(n_b) < 0.9})
    pb = JBatch.from_numpy({"pk": pk, "pval": np.arange(n_p)}, types, capacity=2048,
                           valids={"pk": rng.random(n_p) < 0.9})
    return bb, pb


def _assert_batches_equal(got, want):
    assert_same(got.live, want.live, "live")
    assert list(got.names) == list(want.names)
    for n in want.names:
        assert_same(got[n].data, want[n].data, f"{n} data")
        assert_same(got[n].valid, want[n].valid, f"{n} valid")
        assert got[n].dtype == port_type(want[n].dtype), n


@pytest.mark.parametrize("jt,with_payload,mode,dense", OP_CASES)
def test_join_operators_match_reference(jt, with_payload, mode, dense):
    rng = np.random.default_rng(5)
    key_type = jnarrow(JINTEGER, -80, 460)  # int16 storage, as the connector narrows
    bb, pb = _op_batches(rng, key_type)
    outs = ("bval",) if with_payload else ()
    dd = None if dense is None else (dense[0], dense[1] - dense[0] + 1)

    jb = JJ.JoinBuildOperator(
        jcol("bk", key_type), dense_domain=dd,
        pallas=None if mode is None else pallas_join.PallasJoinSpec(mode, -40, 399,
                                                                    payload=outs))
    JPipeline(JBatchSource([bb]), [jb]).run()
    jop = JJ.LookupJoinOperator(jb, jcol("pk", key_type),
                                [JJ.BuildOutput(o, o) for o in outs], jt)
    want = jop.process(pb)[0]

    pt = port_type(key_type)
    pbuild = PJ.JoinBuildOperator(
        pcol("bk", pt), dense_domain=dd,
        pallas=None if mode is None else cuda_join.PallasJoinSpec(mode, -40, 399,
                                                                  payload=outs))
    pbuild.process(port_batch(bb))
    pbuild.finish()
    COUNTERS.clear()
    pop = PJ.LookupJoinOperator(pbuild, pcol("pk", pt),
                                [PJ.BuildOutput(o, o) for o in outs], jt)
    got = pop.process(port_batch(pb))[0]
    assert pop._strategy == jop._strategy
    assert pop._strategy == ("pallas" if mode else "dense" if dense else "unique")
    assert COUNTERS[f"join.strategy.{pop._strategy}"] == 1
    assert COUNTERS["exec.pallas_join_route"] == (1 if mode else 0)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("mode", ["exists", "payload"])
def test_out_of_domain_build_falls_back(mode):
    """A live build key outside the planned domain discards the fused
    tables (counted) and the dense/sorted probe answers, as in JAX."""
    rng = np.random.default_rng(8)
    key_type = jnarrow(JINTEGER, -80, 460)
    bb, pb = _op_batches(rng, key_type)
    outs = ("bval",) if mode == "payload" else ()
    # [-40, 300] excludes some live build keys (they reach 399)
    jb = JJ.JoinBuildOperator(jcol("bk", key_type),
                              pallas=pallas_join.PallasJoinSpec(mode, -40, 300, payload=outs))
    JPipeline(JBatchSource([bb]), [jb]).run()
    jop = JJ.LookupJoinOperator(jb, jcol("pk", key_type), [JJ.BuildOutput(o, o) for o in outs])
    want = jop.process(pb)[0]

    pt = port_type(key_type)
    COUNTERS.clear()
    pbuild = PJ.JoinBuildOperator(pcol("bk", pt),
                                  pallas=cuda_join.PallasJoinSpec(mode, -40, 300, payload=outs))
    pbuild.process(port_batch(bb))
    pbuild.finish()
    assert pbuild.pallas is None and jb.pallas is None
    assert COUNTERS["join.pallas_fallback"] == 1
    pop = PJ.LookupJoinOperator(pbuild, pcol("pk", pt), [PJ.BuildOutput(o, o) for o in outs])
    got = pop.process(port_batch(pb))[0]
    assert pop._strategy == jop._strategy == "unique"
    _assert_batches_equal(got, want)


def test_wide_key_storage_skips_the_fused_route():
    """Canonical int64 probe keys cannot ride the kernels: per batch the
    operator degrades (counted) to the next side, identical rows."""
    rng = np.random.default_rng(9)
    from presto_tpu.types import BIGINT as JBIGINT

    bb, pb = _op_batches(rng, JBIGINT)
    jb = JJ.JoinBuildOperator(jcol("bk", JBIGINT), dense_domain=(-40, 440),
                              pallas=pallas_join.PallasJoinSpec("exists", -40, 399))
    JPipeline(JBatchSource([bb]), [jb]).run()
    want = JJ.LookupJoinOperator(jb, jcol("pk", JBIGINT), ()).process(pb)[0]
    pbuild = PJ.JoinBuildOperator(pcol("bk", port_type(JBIGINT)), dense_domain=(-40, 440),
                                  pallas=cuda_join.PallasJoinSpec("exists", -40, 399))
    pbuild.process(port_batch(bb))
    pbuild.finish()
    COUNTERS.clear()
    pop = PJ.LookupJoinOperator(pbuild, pcol("pk", port_type(JBIGINT)), ())
    got = pop.process(port_batch(pb))[0]
    assert pop._strategy == "dense" and COUNTERS["join.pallas_fallback"] == 1
    _assert_batches_equal(got, want)
    assert to_numpy(got.live).sum() > 0


def test_fused_route_takes_any_capacity():
    """Divergence (ROADMAP C4): the Pallas probes need a capacity that
    blocks into 1024-row tiles and fall back otherwise; the CUDA kernels
    take any capacity. Same rows either way."""
    rng = np.random.default_rng(12)
    key_type = jnarrow(JINTEGER, -80, 460)
    types = {"bk": key_type, "bval": JINTEGER, "pk": key_type, "pval": JINTEGER}
    bk = rng.choice(np.arange(-40, 400), size=150, replace=False)
    pk = rng.integers(-80, 460, size=900)
    bb = JBatch.from_numpy({"bk": bk, "bval": bk}, types, capacity=1024)
    pb = JBatch.from_numpy({"pk": pk, "pval": np.arange(900)}, types, capacity=1000)
    spec = ("payload", -40, 399)
    jb = JJ.JoinBuildOperator(jcol("bk", key_type),
                              pallas=pallas_join.PallasJoinSpec(*spec, payload=("bval",)))
    JPipeline(JBatchSource([bb]), [jb]).run()
    jop = JJ.LookupJoinOperator(jb, jcol("pk", key_type), [JJ.BuildOutput("bval", "bval")])
    want = jop.process(pb)[0]
    pt = port_type(key_type)
    pbuild = PJ.JoinBuildOperator(pcol("bk", pt),
                                  pallas=cuda_join.PallasJoinSpec(*spec, payload=("bval",)))
    pbuild.process(port_batch(bb))
    pbuild.finish()
    pop = PJ.LookupJoinOperator(pbuild, pcol("pk", pt), [PJ.BuildOutput("bval", "bval")])
    got = pop.process(port_batch(pb))[0]
    assert jop._strategy == "unique" and pop._strategy == "pallas"
    _assert_batches_equal(got, want)
