"""The port's 32-bit hashing, the sketch probe and the Q3 join step
against the JAX package's, exactly.

- ``ops/hashing``: ``mix32``, ``mix32_slots``, ``bloom_build`` and
  ``bloom_test`` equal ``presto_tpu.ops.hashing`` (values and dtypes) on
  full-range int32 keys, int64 keys past 2^31 (their low 32 bits),
  int8/int16 keys (sign-extended); the Bloom words have no false
  negatives.
- ``ops/cuda_join``: the sketch table equals the JAX builder's words,
  and ``sketch_probe_plain`` (which the CUDA kernel is held to on the
  card) equals ``pallas_join.sketch_probe`` in interpret mode;
  ``q3_probe_step_plain`` equals ``pallas_join.q3_probe_step`` in
  interpret mode at capacity 2^16, with one partition and with a small
  ``wmax`` that forces several, over keys below ``key_min`` and past the
  domain and dead rows; ``probe_block`` and ``q3_partitions`` are the
  JAX package's.
- the operators: the sketch route's superset semantics, its refusal of
  anti joins, its per-batch capacity rule (a capacity-1000 batch takes
  the exact probe, as in the JAX package), skewed keys — each against
  the JAX operators on the same batches.
- ``workloads.q3_probe_step`` on the CPU and ``chip_smoke``'s numpy
  oracles (the Q3 join and the Bloom test) equal the benchmark's oracle
  and the JAX package's results at sf 0.01.
Tolerance: exact everywhere (integer data; the benchmark's float
revenue oracle to 1e-9 relative).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.batch import Batch as JBatch
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.pipeline import BatchSource as JBatchSource
from presto_tpu.exec.pipeline import Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.ops import hashing as jhash
from presto_tpu.ops import pallas_join
from presto_tpu.types import INTEGER as JINTEGER
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.exec.operators import concat_batches
from presto_tpu_torch.expr import col as pcol
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops import hashing as phash
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.workloads import (
    Q3_COLS, Q3_CUTOFF, Q3_KEY_MIN, q3_domain, q3_probe_step, q3_probe_table)
from torch_bridge import assert_same, port_batch, port_type, to_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

NBITS = cuda_join.SKETCH_BITS


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(rng, dtype, n):
    if dtype == "int64 past 2^31":
        k = rng.integers(-(1 << 40), 1 << 40, n)
        k[:4] = [1 << 31, (1 << 32) + 5, -(1 << 31) - 1, (1 << 62) + 3]
        return k
    info = np.iinfo(dtype)
    k = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    k[:3] = [info.min, info.max, -1]
    return k


KEY_KINDS = ["int32", "int64 past 2^31", "int8", "int16"]


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_hashing_matches_reference(kind):
    rng = np.random.default_rng(len(kind))
    k = _keys(rng, kind, 5000)
    assert_same(phash.mix32(_t(k)), jhash.mix32(jnp.asarray(k)), "mix32")
    for got, want in zip(phash.mix32_slots(_t(k), NBITS), jhash.mix32_slots(jnp.asarray(k), NBITS)):
        assert_same(got, want, "mix32_slots")
    live = rng.random(5000) < 0.8
    words = phash.bloom_build(_t(k), _t(live), 1 << 15)
    jwords = jhash.bloom_build(jnp.asarray(k), jnp.asarray(live), 1 << 15)
    assert_same(words, jwords, "bloom_build")
    q = np.concatenate([k[:1000], _keys(rng, kind, 3000)])
    assert_same(phash.bloom_test(words, _t(q)), jhash.bloom_test(jwords, jnp.asarray(q)),
                "bloom_test")


def test_bloom_no_false_negatives():
    """tests/test_join_route.py::test_bloom_no_false_negatives on the port."""
    rng = np.random.default_rng(7)
    keys = rng.integers(-(1 << 31), 1 << 31, size=5000).astype(np.int64)
    live = rng.random(5000) < 0.8
    words = phash.bloom_build(_t(keys), _t(live), 1 << 15)
    hit = phash.bloom_test(words, _t(keys)).numpy()
    assert hit[live].all(), "bloom_test missed an inserted key"


def test_probe_block_and_partitions_match_reference():
    for cap in (1000, 1024, 2048, 3072, 4096, 1 << 16, 65536 + 1024, 1 << 20, 917504, 131072,
                1_000_003, 8 * 1024 * 3):
        assert cuda_join.probe_block(cap) == pallas_join.probe_block(cap), cap
    for domain in (1, 32, 33, 524288, 524289, 600_001, 6_000_001, 60_000_001):
        for wmax in (None, 4096, 1024, 37):
            assert cuda_join.q3_partitions(domain, wmax) == pallas_join.q3_partitions(domain, wmax)


@pytest.mark.parametrize("kind", ["int8", "int16", "int32"])
def test_sketch_table_and_probe_match_pallas(kind):
    rng = np.random.default_rng(11 + len(kind))
    bk = _keys(rng, kind, 3000)
    blive = rng.random(3000) < 0.85
    table = cuda_join.build_sketch_table(_t(bk), _t(blive))
    jtable = pallas_join.build_sketch_table(jnp.asarray(bk), jnp.asarray(blive), NBITS)
    assert_same(table, np.asarray(jtable)[:, 0], "sketch table words")
    cap = 4096  # the Pallas probe blocks it
    pk = _keys(rng, kind, cap)
    pk[3:1000] = rng.choice(bk, 997)
    plive = rng.random(cap) < 0.85
    want = pallas_join.sketch_probe(jtable, NBITS, jnp.asarray(pk), jnp.asarray(plive),
                                    interpret=True)
    got = cuda_join.sketch_probe_plain(table, NBITS, _t(pk), _t(plive))
    assert_same(got, want, "sketch probe")
    before = cuda_join.sketch_launches
    assert_same(cuda_join.sketch_probe(table, NBITS, _t(pk), _t(plive)), want,
                "sketch wrapper on the CPU")
    assert cuda_join.sketch_launches == before
    assert not got[~_t(plive)].any(), "a dead row hit"


@pytest.fixture(scope="module")
def q3_inputs():
    """sf 0.01 orders and the first lineitem split (capacity 2^16) of
    both packages, narrow as their connectors store them."""
    jc, pc = JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")
    split = jc.splits("lineitem")[0]
    jl = jc.scan(split, Q3_COLS, 1 << 16)
    assert jl.capacity == 1 << 16 and jl["l_orderkey"].data.dtype == jnp.int32
    jo = jc.scan(jc.splits("orders")[0], ["o_orderkey", "o_orderdate"])
    return jc, pc, jo, jl


@pytest.mark.parametrize("wmax", [None, 512])
def test_q3_step_matches_pallas(q3_inputs, wmax):
    """A bitmask over [1000, 41000): lineitem keys below key_min and past
    the domain, orders outside it dead on the build side, a third of the
    probe rows dead; wmax 512 splits the 1282-word mask into 3 of the JAX
    package's partitions."""
    _jc, _pc, jo, jl = q3_inputs
    key_min, domain, cutoff = 1000, 40000, Q3_CUTOFF
    ok = np.asarray(jo["o_orderkey"].data)
    blive = (np.asarray(jo.live) & (np.asarray(jo["o_orderdate"].data) < cutoff)
             & (ok >= key_min) & (ok < key_min + domain))
    w, nparts = pallas_join.q3_partitions(domain, wmax)
    assert (nparts > 1) == (wmax is not None)
    jtab, joob = pallas_join.build_exists_table(jnp.asarray(ok), jnp.asarray(blive), key_min,
                                                key_min + domain - 1, pad_words=w * nparts)
    tab, oob = cuda_join.build_exists_table(_t(ok), _t(blive), key_min, key_min + domain - 1,
                                            pad_words=w * nparts)
    assert not bool(oob) and not bool(joob)
    assert_same(tab, np.asarray(jtab)[:, 0], "Q3 bitmask")
    rng = np.random.default_rng(5)
    live = np.asarray(jl.live) & (rng.random(jl.capacity) < 0.67)
    jl2 = jl.with_live(jnp.asarray(live))
    keys = np.asarray(jl2["l_orderkey"].data)
    assert (live & (keys < key_min)).any() and (live & (keys >= key_min + domain)).any()
    # with partitions, some keys also fall past the padded table
    assert (live & (keys >= key_min + 32 * w * nparts)).any() == (wmax is not None)
    want = pallas_join.q3_probe_step(jtab, key_min, domain, cutoff, jl2, interpret=True,
                                     wmax=wmax)
    cols = [_t(np.asarray(jl2[c].data)) for c in Q3_COLS]
    got = cuda_join.q3_probe_step_plain(tab, key_min, domain, cutoff, *cols, _t(live))
    assert int(want[0]) > 0
    for g, w_, what in zip(got, want, ("count", "revenue")):
        assert_same(g, w_, what)
    before = cuda_join.q3_launches
    again = cuda_join.q3_probe_step(tab, key_min, domain, cutoff, *cols, _t(live), wmax=wmax)
    assert [int(x) for x in again] == [int(x) for x in got]
    assert cuda_join.q3_launches == before


def test_q3_workload_equals_the_benchmark_oracle(q3_inputs):
    """``workloads.q3_probe_table`` + ``q3_probe_step`` over every sf 0.01
    lineitem split equal bench.py's pandas oracle (count exactly, the
    float revenue to 1e-9) and ``chip_smoke.q3_join_expected`` exactly;
    the JAX kernel in interpret mode gives the same on the first split."""
    jc, pc, _jo, _jl = q3_inputs
    orders = concat_batches([pc.scan(s, ["o_orderkey", "o_orderdate"])
                             for s in pc.splits("orders")])
    domain = q3_domain(0.01)
    table = q3_probe_table(orders, Q3_CUTOFF, domain)
    n, rev = 0, 0
    for s in pc.splits("lineitem"):
        cnt, r = q3_probe_step(table, Q3_KEY_MIN, domain, Q3_CUTOFF, pc.scan(s, Q3_COLS))
        assert cnt.dtype == torch.int64 and r.dtype == torch.int64 and cnt.dim() == 0
        n, rev = n + int(cnt), rev + int(r)
    o_df, li_df = jc.table_pandas("orders"), jc.table_pandas("lineitem")
    odf = o_df[o_df.o_orderdate < np.datetime64("1995-03-15")]
    ldf = li_df[li_df.l_shipdate > np.datetime64("1995-03-15")]
    j = ldf.merge(odf, left_on="l_orderkey", right_on="o_orderkey")
    want_rev = float((j.l_extendedprice * (1 - j.l_discount)).sum())
    assert n == len(j) > 0
    np.testing.assert_allclose(rev / 10_000.0, want_rev, rtol=1e-9)
    assert (n, rev) == chip_smoke.q3_join_expected(pc)
    if len(pc.splits("lineitem")) == 1:
        jtab, _ = pallas_join.build_exists_table(
            jnp.asarray(to_numpy(orders["o_orderkey"].data)),
            jnp.asarray(to_numpy(orders.live)
                        & (to_numpy(orders["o_orderdate"].data) < Q3_CUTOFF)),
            1, domain, pad_words=table.shape[0])
        jl = jc.scan(jc.splits("lineitem")[0], Q3_COLS, 1 << 16)
        want = pallas_join.q3_probe_step(jtab, 1, domain, Q3_CUTOFF, jl, interpret=True)
        assert (int(want[0]), int(want[1])) == (n, rev)


def test_chip_bloom_oracle_equals_reference():
    """``chip_smoke.np_bloom_member`` (the card's Bloom oracle) is the
    JAX package's bloom_build + bloom_test over 2^19 bits."""
    rng = np.random.default_rng(3)
    build = rng.integers(-(1 << 33), 1 << 33, 20000)
    keys = np.concatenate([build[:500], rng.integers(-(1 << 33), 1 << 33, 20000)])
    words = jhash.bloom_build(jnp.asarray(build), jnp.ones(build.shape[0], bool), NBITS)
    want = np.asarray(jhash.bloom_test(words, jnp.asarray(keys)))
    np.testing.assert_array_equal(chip_smoke.np_bloom_member(build, keys), want)
    assert want[:500].all() and not want.all()


# ---------------------------------------------------------------------------
# the operators on the sketch route, against the JAX operators
# ---------------------------------------------------------------------------


def _probe_pair(bk, pk, spec_port, spec_jax, jt, cap=2048):
    """One semi/anti join of int32 keys through the JAX operators and the
    port's: (JAX live keys, port live keys, JAX strategy, port strategy)."""
    types = {"bk": JINTEGER, "pk": JINTEGER}
    jb = JBatch.from_numpy({"bk": bk}, {"bk": JINTEGER}, capacity=max(1024, len(bk)))
    jp = JBatch.from_numpy({"pk": pk}, {"pk": JINTEGER}, capacity=cap)
    b = JJ.JoinBuildOperator(jcol("bk", JINTEGER), pallas=spec_jax)
    JPipeline(JBatchSource([jb]), [b]).run()
    op = JJ.LookupJoinOperator(b, jcol("pk", JINTEGER), (), jt)
    (jout,) = JPipeline(JBatchSource([jp]), [op]).run()
    pt = port_type(types["bk"])
    pb = PJ.JoinBuildOperator(pcol("bk", pt), pallas=spec_port)
    pb.process(port_batch(jb))
    pb.finish()
    pop = PJ.LookupJoinOperator(pb, pcol("pk", pt), (), jt)
    (pout,) = pop.process(port_batch(jp))
    jkeys = np.asarray(jout["pk"].data)[np.asarray(jout.live)]
    pkeys = to_numpy(pout["pk"].data)[to_numpy(pout.live)]
    return jkeys, pkeys, op._strategy, pop._strategy


def _sketch_specs():
    return (cuda_join.PallasJoinSpec("sketch", nbits=NBITS),
            pallas_join.PallasJoinSpec("sketch", nbits=pallas_join.SKETCH_BITS))


def test_approx_join_superset_semantics():
    """tests/test_join_route.py's superset test on both packages: the
    sketch keeps every true match, the port keeps exactly the JAX
    package's rows, and both take the fused route."""
    rng = np.random.default_rng(1)
    bk = rng.choice(np.arange(0, 1 << 22), size=500, replace=False)
    pk = rng.integers(0, 1 << 22, size=3000)
    pk[:300] = bk[:300]
    jkeys, pkeys, js, ps = _probe_pair(bk, pk, *_sketch_specs(), "semi", cap=4096)
    assert js == ps == "pallas"
    np.testing.assert_array_equal(pkeys, jkeys)
    exact = pk[np.isin(pk, bk)]
    assert set(exact) <= set(pkeys) and len(pkeys) > len(exact) - 1


def test_anti_never_routes_sketch():
    """A sketch false positive would DROP anti-join rows: handed a sketch
    spec, both operators refuse it and answer exactly."""
    bk = np.arange(0, 50)
    pk = np.arange(0, 2000)
    jkeys, pkeys, js, ps = _probe_pair(bk, pk, *_sketch_specs(), "anti")
    assert js != "pallas" and ps != "pallas"
    np.testing.assert_array_equal(pkeys, jkeys)
    np.testing.assert_array_equal(pkeys, np.arange(50, 2000))


def test_sketch_refuses_a_capacity_the_reference_cannot_block():
    """ROADMAP C4's exception: a probe batch of capacity 1000 (not a
    multiple of 1024) takes the exact probe on both packages, counted as
    a fused-probe fallback, so the approximate answer never differs."""
    rng = np.random.default_rng(2)
    bk = rng.choice(np.arange(0, 1 << 22), size=5000, replace=False)
    pk = rng.integers(0, 1 << 22, size=1000)
    COUNTERS.clear()
    jkeys, pkeys, js, ps = _probe_pair(bk, pk, *_sketch_specs(), "semi", cap=1000)
    assert js != "pallas" and ps != "pallas"
    assert COUNTERS["join.pallas_fallback"] == 1
    np.testing.assert_array_equal(pkeys, jkeys)
    np.testing.assert_array_equal(pkeys, pk[np.isin(pk, bk)])


def test_skewed_keys_bit_identical():
    """The semi half of tests/test_join_route.py::test_skewed_keys_bit_identical:
    90 % of probe rows share one hot key, exists route against the JAX
    package's and against the generic probe."""
    rng = np.random.default_rng(9)
    hot = rng.random(2000) < 0.9
    pk = np.where(hot, 7, rng.integers(0, 256, size=2000))
    bk = np.concatenate([[7], rng.choice(np.arange(8, 200), size=40, replace=False)])
    specs = (cuda_join.PallasJoinSpec("exists", 0, 255),
             pallas_join.PallasJoinSpec("exists", 0, 255))
    jkeys, pkeys, js, ps = _probe_pair(bk, pk, *specs, "semi")
    assert js == ps == "pallas"
    np.testing.assert_array_equal(pkeys, jkeys)
    gj, gp, gjs, gps = _probe_pair(bk, pk, None, None, "semi")
    assert gjs != "pallas" and gps != "pallas"
    np.testing.assert_array_equal(gp, pkeys)
