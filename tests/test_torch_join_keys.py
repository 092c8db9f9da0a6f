"""Join-key normalization in the port against the JAX package, exactly:

- the key functions ``bytes_pack`` (widths 1-7), ``bytes_hash`` (widths
  1-40), ``hash63_mix`` (2-4 integer keys of int8-int64, negatives
  included) and ``dict_bytes`` (a dictionary's values cut or padded to
  the width) held to ``presto_tpu.expr.evaluate`` on seeded rows whose
  twins differ only in zero against space padding (PAD SPACE: equal
  keys), NULLs included; keys whose fold lands on the int64 maximum map
  to 0 in both;
- ``exec/joinkeys.join_key_exprs`` against the reference's, expression
  for expression and verify pair for verify pair: narrow and wide BYTES,
  shared and different dictionaries, a hash beside an integer key, codes
  of unprovable provenance, and the refusals;
- the verified probe: collision runs of 1-4 equal hashed keys keep each
  probe row's true match (and equal the reference's operator), a run of
  5 is refused by both, an inner expansion probe drops the pairs that
  differ by value;
- the packed build (``pack_bits``): the one-gather probe against the
  plain sorted one and the reference's, oversized keys flagged, and the
  SQL join that packs;
- join-key statements through both ``Session.sql``s at sf 0.01: frames,
  dtypes, route and filter counters, and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import presto_tpu.expr as JE
import presto_tpu.plan.nodes as JN
import presto_tpu.types as JT
import presto_tpu_torch.expr as PE
import presto_tpu_torch.plan.nodes as PN
import presto_tpu_torch.types as PT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.joinkeys import join_key_exprs as j_join_key_exprs
from presto_tpu.exec.pipeline import BatchSource, Pipeline as JPipeline
from presto_tpu.ops import join as jjoin
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.exec.joinkeys import join_key_exprs as p_join_key_exprs
from presto_tpu_torch.exec.pipeline import BatchStream, Pipeline
from presto_tpu_torch.ops import join as pjoin
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.session import Session as PSession
from test_torch_distinct_bytes import byte_rows
from test_torch_sql import ast_shape
from torch_bridge import (
    assert_same,
    jax_run,
    port_batch,
    port_run,
    port_type,
    refused_alike,
    to_numpy,
)

I64_MAX = np.iinfo(np.int64).max
FNV_PRIME = 1099511628211


def _both(cols: dict, n: int, live=None):
    """The same batch in each package: ``cols`` name -> (data, valid or
    None, JAX type[, JAX dictionary])."""
    live = np.ones(n, np.bool_) if live is None else live
    jl = jnp.asarray(live)
    jcols = {}
    for name, spec in cols.items():
        data, valid, t = spec[:3]
        d = spec[3] if len(spec) > 3 else None
        jcols[name] = JColumn(jnp.asarray(data), jl if valid is None else jnp.asarray(valid), t, d)
    jb = JBatch(jcols, jl)
    return jb, port_batch(jb)


def _eval_both(fn: str, cols: dict, n: int, out_type=None):
    jb, pb = _both(cols, n)
    jt = out_type or JT.BIGINT
    jargs = tuple(JE.col(name, spec[2]) for name, spec in cols.items())
    pargs = tuple(PE.col(name, port_type(spec[2])) for name, spec in cols.items())
    want = JE.evaluate(JE.Call(jt, fn, jargs), jb)
    got = PE.evaluate(PE.Call(port_type(jt), fn, pargs), pb)
    return got, want


def _assert_val(got, want, what):
    assert_same(got.data, want.data, what)
    assert_same(got.valid, want.valid, f"{what} validity")


@pytest.mark.parametrize("width", range(1, 8))
def test_bytes_pack_equals_reference(width):
    rng = np.random.default_rng(width)
    n = 203
    rows = byte_rows(rng, n, width)
    got, want = _eval_both("bytes_pack", {"s": (rows, rng.random(n) > 0.1,
                                                JT.fixed_bytes(width))}, n)
    _assert_val(got, want, f"bytes_pack width {width}")
    # the space-padded twins pack equal to their zero-padded originals
    twin = rows.copy()
    twin[twin == 0] = 32
    got2, _ = _eval_both("bytes_pack", {"s": (twin, None, JT.fixed_bytes(width))}, n)
    assert_same(got2.data, got.data, "PAD SPACE")


@pytest.mark.parametrize("width", [1, 7, 8, 13, 15, 16, 25, 40])
def test_bytes_hash_equals_reference(width):
    rng = np.random.default_rng(100 + width)
    n = 203
    rows = byte_rows(rng, n, width)
    got, want = _eval_both("bytes_hash", {"s": (rows, rng.random(n) > 0.1,
                                                JT.fixed_bytes(width))}, n)
    _assert_val(got, want, f"bytes_hash width {width}")
    assert int(to_numpy(got.data).max()) < I64_MAX and int(to_numpy(got.data).min()) >= 0
    twin = rows.copy()
    twin[twin == 0] = 32
    got2, _ = _eval_both("bytes_hash", {"s": (twin, None, JT.fixed_bytes(width))}, n)
    assert_same(got2.data, got.data, "PAD SPACE")


@pytest.mark.parametrize("nkeys", [2, 3, 4])
def test_hash63_mix_equals_reference(nkeys):
    rng = np.random.default_rng(200 + nkeys)
    n = 301
    kinds = [(np.int8, JT.INTEGER.with_physical(np.int8)),
             (np.int16, JT.INTEGER.with_physical(np.int16)),
             (np.int32, JT.INTEGER), (np.int64, JT.BIGINT)]
    cols = {}
    for i in range(nkeys):
        dt, t = kinds[(i + nkeys) % len(kinds)]
        info = np.iinfo(dt)
        data = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        cols[f"k{i}"] = (data, rng.random(n) > 0.1, t)
    got, want = _eval_both("hash63_mix", cols, n)
    _assert_val(got, want, f"hash63_mix of {nkeys} keys")


def test_fold_never_yields_the_sentinel():
    """Keys whose FNV fold masks to the int64 maximum (forced: the second
    key chosen so that a * prime + b wraps onto it, and -1 alone, whose
    mask is the maximum) become 0 in both packages."""
    a = np.array([0, 1, 12345, -7, 2**40], np.int64)
    with np.errstate(over="ignore"):
        b = np.int64(I64_MAX) - a * np.int64(FNV_PRIME)
    got, want = _eval_both("hash63_mix", {"a": (a, None, JT.BIGINT),
                                          "b": (b, None, JT.BIGINT)}, len(a))
    _assert_val(got, want, "forced onto the sentinel")
    assert not to_numpy(got.data).any()
    one = np.array([-1, I64_MAX, 5], np.int64)
    got, want = _eval_both("hash63_mix", {"a": (one, None, JT.BIGINT)}, 3)
    _assert_val(got, want, "one key")
    assert to_numpy(got.data).tolist() == [0, 0, 5]


@pytest.mark.parametrize("table,column,width", [("orders", "o_orderpriority", 15),
                                                ("orders", "o_orderpriority", 4),
                                                ("lineitem", "l_shipmode", 7),
                                                ("nation", "n_name", 25),
                                                ("orders", "o_orderstatus", 1)])
def test_dict_bytes_equals_reference(table, column, width):
    """Codes through the decode table, cut or zero-padded to the width."""
    d = JConnector(sf=0.01).dictionaries(table)[column]
    rng = np.random.default_rng(width)
    n = 157
    codes = rng.integers(0, len(d), n).astype(np.int32)
    got, want = _eval_both("dict_bytes", {"v": (codes, rng.random(n) > 0.1, JT.varchar(), d)},
                           n, out_type=JT.fixed_bytes(width))
    _assert_val(got, want, f"dict_bytes {column} at width {width}")
    assert tuple(got.data.shape) == (n, width)


def test_dict_bytes_without_a_dictionary_is_refused():
    cols = {"v": (np.zeros(3, np.int32), None, JT.varchar())}
    with pytest.raises(NotImplementedError):
        _eval_both("dict_bytes", cols, 3, out_type=JT.fixed_bytes(4))
    with pytest.raises(NotSupported, match="dictionary-less"):
        PE.evaluate(PE.Call(PT.fixed_bytes(4), "dict_bytes", (PE.col("v", PT.varchar()),)),
                    _both(cols, 3)[1])


# ---------------------------------------------------------------------------
# join_key_exprs
# ---------------------------------------------------------------------------


def _scan(pkg, table, cols):
    N, T = (JN, JT) if pkg == "j" else (PN, PT)
    return N.TableScan("tpch", table, tuple((c, c) for c, _t in cols),
                       tuple(t if pkg == "j" else port_type(t) for _c, t in cols))


def _keys(pkg, cols):
    E = JE if pkg == "j" else PE
    return [E.col(c, t if pkg == "j" else port_type(t)) for c, t in cols]


V = JT.varchar()
KEY_CASES = {
    # name: (left table, left key columns, right table, right key columns)
    "narrow bytes": ("customer", [("c_mktsegment", JT.fixed_bytes(7))],
                     "supplier", [("s_x", JT.fixed_bytes(7))]),
    "wide bytes": ("orders", [("o_clerk", JT.fixed_bytes(15))],
                   "orders", [("o_clerk", JT.fixed_bytes(15))]),
    "shared dictionary": ("orders", [("o_orderstatus", V)], "orders", [("o_orderstatus", V)]),
    "two dictionaries": ("lineitem", [("l_linestatus", V)], "orders", [("o_orderstatus", V)]),
    "wide two dictionaries": ("lineitem", [("l_shipmode", V)], "orders",
                              [("o_orderpriority", V)]),
    "hash beside an integer": ("orders", [("o_clerk", JT.fixed_bytes(15)),
                                          ("o_orderkey", JT.BIGINT)],
                               "orders", [("o_clerk", JT.fixed_bytes(15)),
                                          ("o_orderkey", JT.BIGINT)]),
    "two dictionaries beside an integer": ("lineitem", [("l_linestatus", V),
                                                         ("l_orderkey", JT.BIGINT)],
                                           "orders", [("o_orderstatus", V),
                                                      ("o_orderkey", JT.BIGINT)]),
    "unprovable codes": ("lineitem", [("zz", V)], "orders", [("zz2", V)]),
}


@pytest.mark.parametrize("name", list(KEY_CASES))
def test_join_key_exprs_equal_reference(name):
    """The same probe and build keys and the same verify pairs (keys
    outside the scans' columns take the runtime min/max stub)."""
    lt, lcols, rt, rcols = KEY_CASES[name]
    jcat = JSession({"tpch": JConnector(sf=0.01)}).catalog
    pcat = PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu").catalog
    calls = {"j": [], "p": []}

    def stub(pkg):
        def minmax(side, key):
            calls[pkg].append((side, key.name if hasattr(key, "name") else key.fn))
            return (0, 1000)
        return minmax

    want = j_join_key_exprs(_keys("j", lcols), _keys("j", rcols), {}, catalog=jcat,
                            lnode=_scan("j", lt, lcols), rnode=_scan("j", rt, rcols),
                            runtime_minmax=stub("j"))
    got = p_join_key_exprs(_keys("p", lcols), _keys("p", rcols), catalog=pcat,
                           lnode=_scan("p", lt, lcols), rnode=_scan("p", rt, rcols),
                           runtime_minmax=stub("p"))
    assert ast_shape(got[0]) == ast_shape(want[0])
    assert ast_shape(got[1]) == ast_shape(want[1])
    assert ast_shape(got[2]) == ast_shape(want[2])
    assert calls["p"] == calls["j"]


REFUSED_KEYS = {
    "unequal widths": ([("c_phone", JT.fixed_bytes(15))], [("s_name", JT.fixed_bytes(25))],
                       "unequal width"),
    "VARCHAR against a number": ([("o_orderstatus", V)], [("o_orderkey", JT.BIGINT)],
                                 "type mismatch"),
    "mix over unprovable codes": ([("zz", V), ("o_orderkey", JT.BIGINT)],
                                  [("zz2", V), ("o_orderkey", JT.BIGINT)], "unprovable"),
}


@pytest.mark.parametrize("name", list(REFUSED_KEYS))
def test_join_key_exprs_refuse_where_reference_refuses(name):
    lcols, rcols, what = REFUSED_KEYS[name]
    jcat = JSession({"tpch": JConnector(sf=0.01)}).catalog
    pcat = PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu").catalog

    def neg(side, key):
        return (-5, 5)  # a negative key: the mix fallback

    err = refused_alike(
        lambda: j_join_key_exprs(_keys("j", lcols), _keys("j", rcols), {}, catalog=jcat,
                                 lnode=_scan("j", "orders", lcols),
                                 rnode=_scan("j", "orders", rcols), runtime_minmax=neg),
        lambda: p_join_key_exprs(_keys("p", lcols), _keys("p", rcols), catalog=pcat,
                                 lnode=_scan("p", "orders", lcols),
                                 rnode=_scan("p", "orders", rcols), runtime_minmax=neg))
    assert isinstance(err, NotImplementedError) and what in str(err)


def test_runtime_minmax_is_shared_between_equal_keys_of_one_query():
    """The executor's query-scoped memo: a second join over the same
    subtree and key content reads no new min/max, in both packages."""
    cols = [("k0", JT.BIGINT), ("k1", JT.BIGINT)]
    counts = {}
    for pkg, fn, cat in (
            ("j", j_join_key_exprs, JSession({"tpch": JConnector(sf=0.01)}).catalog),
            ("p", p_join_key_exprs,
             PSession({"tpch": PConnector(sf=0.01, device="cpu")}, device="cpu").catalog)):
        calls = []
        memo: dict = {}

        def minmax(side, key):
            calls.append(side)
            return (0, 3)

        for _ in range(2):
            args = (_keys(pkg, cols), _keys(pkg, cols)) + (({},) if pkg == "j" else ())
            fn(*args, catalog=cat, lnode=_scan(pkg, "nation", cols),
               rnode=_scan(pkg, "nation", cols), runtime_minmax=minmax, minmax_memo=memo)
        counts[pkg] = len(calls)
    assert counts["p"] == counts["j"] == 2


# ---------------------------------------------------------------------------
# the verified probe
# ---------------------------------------------------------------------------


def _collision_batches(run: int, width: int = 12):
    """A build whose first ``run`` rows share one hashed key ``h`` with
    distinct values ``v``, plus rows of other keys; a probe of each
    build value (and a value no build row has) under its key."""
    rng = np.random.default_rng(run)
    vals = byte_rows(rng, run + 6, width)
    vals[:, 0] = np.arange(run + 6) + 65  # distinct first bytes
    h = np.concatenate([np.full(run, 77, np.int64), np.arange(6, dtype=np.int64) + 100])
    payload = np.arange(run + 6, dtype=np.int64) * 10
    stranger = vals[:1].copy()
    stranger[0, 0] = 33
    pv = np.concatenate([vals[::-1], stranger])
    ph = np.concatenate([h[::-1], [77]])
    t = JT.fixed_bytes(width)
    build = {"bh": (h, None, JT.BIGINT), "bv": (vals, None, t), "bp": (payload, None, JT.BIGINT)}
    probe = {"ph": (ph, None, JT.BIGINT), "pv": (pv, None, t)}
    return build, probe, len(h), len(ph)


def _verified_join(mod, E, T, build_batch, probe_batch, jt, unique, t, source):
    build = mod.JoinBuildOperator(E.col("bh", T.BIGINT))
    outs = [mod.BuildOutput("bp", "bp")]
    verify = [(E.col("pv", t), E.col("bv", t))]
    op = mod.LookupJoinOperator(build, E.col("ph", T.BIGINT), outs, jt, unique=unique,
                                out_capacity=None if unique else 64, verify=verify)
    if mod is JJ:
        JPipeline(BatchSource([build_batch]), [build]).run()
        return op.process(probe_batch)[0]
    Pipeline(BatchStream.of([build_batch]), [build]).run()
    return op.process(probe_batch)[0]


def _rows(b, names):
    live = to_numpy(b.live)
    cols = {n: (to_numpy(b[n].data), to_numpy(b[n].valid)) for n in names}
    out = []
    for i in np.flatnonzero(live):
        out.append(tuple(None if not cols[n][1][i] else
                         (bytes(cols[n][0][i]) if cols[n][0].ndim > 1 else int(cols[n][0][i]))
                         for n in names))
    return sorted(out, key=repr)


@pytest.mark.parametrize("jt", ["inner", "left"])
@pytest.mark.parametrize("run", [1, 2, 3, 4])
def test_collision_run_within_the_window_keeps_the_true_match(run, jt):
    build, probe, nb, npr = _collision_batches(run)
    jbb, pbb = _both(build, nb)
    jpb, ppb = _both(probe, npr)
    t = JT.fixed_bytes(12)
    want = _verified_join(JJ, JE, JT, jbb, jpb, jt, True, t, build)
    got = _verified_join(PJ, PE, PT, pbb, ppb, jt, True, port_type(t), build)
    names = ["ph", "pv", "bp"]
    assert _rows(got, names) == _rows(want, names)
    # each probe value finds its own row's payload
    for ph, pv, bp in _rows(got, names):
        if bp is not None:
            row = bp // 10
            assert pv == bytes(build["bv"][0][row])
    assert sum(r[2] is not None for r in _rows(got, names)) == nb


def test_collision_run_past_the_window_is_refused():
    build, probe, nb, npr = _collision_batches(5)
    jbb, pbb = _both(build, nb)
    jpb, ppb = _both(probe, npr)
    t = JT.fixed_bytes(12)
    with pytest.raises(NotImplementedError, match="candidate window"):
        _verified_join(JJ, JE, JT, jbb, jpb, "inner", True, t, build)
    with pytest.raises(NotSupported, match="candidate window"):
        _verified_join(PJ, PE, PT, pbb, ppb, "inner", True, port_type(t), build)


@pytest.mark.parametrize("run", [2, 5])
def test_inner_expansion_drops_pairs_that_differ_by_value(run):
    build, probe, nb, npr = _collision_batches(run)
    jbb, pbb = _both(build, nb)
    jpb, ppb = _both(probe, npr)
    t = JT.fixed_bytes(12)
    want = _verified_join(JJ, JE, JT, jbb, jpb, "inner", False, t, build)
    got = _verified_join(PJ, PE, PT, pbb, ppb, "inner", False, port_type(t), build)
    names = ["ph", "pv", "bp"]
    assert _rows(got, names) == _rows(want, names)
    assert len(_rows(got, names)) == nb


# ---------------------------------------------------------------------------
# the packed build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_build_matches_unpacked(seed):
    """The one-gather packed probe equals the plain sorted probe and the
    reference's packed build, dead rows, missing keys and unpackable
    probe keys included."""
    rng = np.random.default_rng(seed)
    bcap, pcap = 512, 2048
    bkeys = np.concatenate([rng.choice(np.arange(0, 40_000), 400, replace=False),
                            np.zeros(bcap - 400, np.int64)]).astype(np.int64)
    blive = np.arange(bcap) < 400
    pkeys = rng.integers(-100, 50_000, pcap).astype(np.int64)
    pkeys[:4] = [2**62, 2**62 - 1, -1, 0]
    plive = rng.random(pcap) < 0.9
    pb = int(bcap).bit_length()
    T = torch.from_numpy
    packed = pjoin.build_lookup(T(bkeys), T(blive), bcap, pack_bits=pb)
    plain = pjoin.build_lookup(T(bkeys), T(blive), bcap)
    jpacked = jjoin.build_lookup(jnp.asarray(bkeys), jnp.asarray(blive), bcap, pack_bits=pb)
    assert not bool(packed.sentinel_hit)
    assert_same(packed.packed, jpacked.packed, "packed keys")
    assert_same(packed.sorted_keys, jpacked.sorted_keys, "sorted keys")
    np.testing.assert_array_equal(to_numpy(packed.row_idx), to_numpy(jpacked.row_idx))
    got = pjoin.probe_unique(packed, T(pkeys), T(plive), pack_bits=pb)
    want = pjoin.probe_unique(plain, T(pkeys), T(plive))
    jwant = jjoin.probe_unique(jpacked, jnp.asarray(pkeys), jnp.asarray(plive), pack_bits=pb)
    assert_same(got.matched, want.matched)
    assert_same(got.matched, jwant.matched)
    m = to_numpy(got.matched)
    np.testing.assert_array_equal(to_numpy(got.build_row)[m], to_numpy(want.build_row)[m])
    np.testing.assert_array_equal(to_numpy(got.build_row)[m], to_numpy(jwant.build_row)[m])


def test_packed_build_flags_oversized_keys():
    keys = np.array([1, 2, 2**61], np.int64)
    live = np.ones(3, np.bool_)
    side = pjoin.build_lookup(torch.from_numpy(keys), torch.from_numpy(live), 4, pack_bits=16)
    jside = jjoin.build_lookup(jnp.asarray(keys), jnp.asarray(live), 4, pack_bits=16)
    assert bool(side.sentinel_hit) and bool(jside.sentinel_hit)


def test_build_refuses_a_key_past_its_packed_bound():
    """Stale stats: a live key past the key_max bound refuses the query in
    both packages, rather than mispack."""
    keys = np.array([1, 2, 2**60], np.int64)
    jb, pb = _both({"k": (keys, None, JT.BIGINT)}, 3)
    jbuild = JJ.JoinBuildOperator(JE.col("k", JT.BIGINT), key_max=3)
    with pytest.raises(NotImplementedError, match="advisory stats bound"):
        JPipeline(BatchSource([jb]), [jbuild]).run()
    pbuild = PJ.JoinBuildOperator(PE.col("k", PT.BIGINT), key_max=3)
    with pytest.raises(NotSupported, match="advisory stats bound"):
        Pipeline(BatchStream.of([pb]), [pbuild]).run()
    assert pbuild.pack_bits == jbuild.pack_bits == 2


def test_sql_join_packed_path_fires_and_matches():
    """An FK->PK join with stats-bounded keys packs its build (the same
    pack bits as the reference's) and answers as the reference does."""
    q = ("select n_name, count(*) as n from customer, nation "
         "where c_nationkey = n_nationkey group by n_name order by n_name")
    seen = {"j": [], "p": []}
    originals = {"j": JJ.JoinBuildOperator.finish, "p": PJ.JoinBuildOperator.finish}

    def spy(pkg):
        def finish(self):
            out = originals[pkg](self)
            seen[pkg].append(self.pack_bits)
            return out
        return finish

    JJ.JoinBuildOperator.finish, PJ.JoinBuildOperator.finish = spy("j"), spy("p")
    try:
        want, want_routes = jax_run(JConnector(sf=0.01), q)
        res, routes, _ = port_run(PConnector(sf=0.01, device="cpu"), q)
    finally:
        JJ.JoinBuildOperator.finish, PJ.JoinBuildOperator.finish = originals["j"], originals["p"]
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert seen["p"] == seen["j"] and any(p is not None for p in seen["p"])


# ---------------------------------------------------------------------------
# SQL at sf 0.01
# ---------------------------------------------------------------------------

KEY_STATEMENTS = {
    "narrow bytes": ("select count(*) as n from (select substring(c_phone, 1, 2) as cc "
                     "from customer) a join (select distinct substring(s_phone, 1, 2) as sc "
                     "from supplier) b on cc = sc"),
    "wide bytes, unique build": ("select count(*) as n, sum(c) as c from orders left join "
                                 "(select o_clerk as k, count(*) as c from orders "
                                 "group by o_clerk) s on o_clerk = k"),
    "wide bytes, expansion": ("select count(*) as n, sum(c) as c from orders join "
                              "(select o_clerk as k, count(*) as c from orders "
                              "group by o_clerk) s on o_clerk = k"),
    "two dictionaries": ("select l_linestatus, count(*) as n from lineitem join "
                         "(select distinct o_orderstatus from orders) s "
                         "on l_linestatus = o_orderstatus group by l_linestatus "
                         "order by l_linestatus"),
    "two dictionaries, left": ("select o_orderstatus, count(*) as n from "
                               "(select distinct o_orderstatus from orders) s left join "
                               "lineitem on l_linestatus = o_orderstatus "
                               "group by o_orderstatus order by o_orderstatus"),
    "mix": ("select count(*) as n, sum(c_custkey) as sc from customer join supplier "
            "on c_nationkey = s_nationkey and c_acctbal = s_acctbal"),
    "mix with matches": ("select count(*) as n from customer a join customer b "
                         "on a.c_nationkey = b.c_nationkey and a.c_acctbal = b.c_acctbal"),
    "hash beside an integer": ("select count(*) as n from orders a join orders b "
                               "on a.o_clerk = b.o_clerk and a.o_custkey = b.o_custkey"),
}


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


@pytest.mark.parametrize("name", list(KEY_STATEMENTS))
def test_join_key_statements_equal_reference(conns, name):
    want, want_routes = jax_run(conns[0], KEY_STATEMENTS[name])
    res, routes, _ = port_run(conns[1], KEY_STATEMENTS[name])
    pd.testing.assert_frame_equal(pd.DataFrame(res.to_dict()), want, check_exact=True)
    assert routes == want_routes
    assert len(want) > 0


REFUSED_STATEMENTS = {
    "wide string semi-join keys": ("select count(*) from orders where o_clerk in "
                                   "(select o_clerk from orders where o_orderkey < 100)"),
    "wide string keys on non-unique OUTER joins": (
        "select count(*) from (select o_clerk as k from orders where o_orderkey < 1000) a "
        "left join orders on k = o_clerk"),
    "unequal width": ("select count(*) from customer join supplier on c_phone = s_name"),
}


@pytest.mark.parametrize("what", list(REFUSED_STATEMENTS))
def test_join_key_statements_refused_where_reference_refuses(conns, what):
    err = refused_alike(lambda: jax_run(conns[0], REFUSED_STATEMENTS[what]),
                        lambda: port_run(conns[1], REFUSED_STATEMENTS[what]))
    assert isinstance(err, NotImplementedError) and what in str(err)


@pytest.mark.resets_global_state
def test_stats_cache_equals_reference(conns):
    """The runtime join-key min/max readbacks are kept across a session's
    queries by both packages' stats caches: on a repeated multi-key join
    each run moves the same ``stats_cache.*`` and ``join.filter_rows_*``
    counters as the reference's, the second run hits and reads nothing
    back, and both runs answer alike (both stats caches cleared first;
    result cache off)."""
    import presto_tpu.cache.stats_cache as JSC
    import presto_tpu.runtime.metrics as JM
    import presto_tpu_torch.cache.stats_cache as PSC
    import presto_tpu_torch.runtime.metrics as PM

    sql = KEY_STATEMENTS["mix with matches"]
    props = {"result_cache_enabled": False}
    runs = []
    for session, sc, reg in ((JSession({"tpch": conns[0]}, properties=props), JSC, JM),
                             (PSession({"tpch": conns[1]}, properties=props, device="cpu"),
                              PSC, PM)):
        sc.clear()
        out = []
        for _ in range(2):
            before = reg.REGISTRY.snapshot()
            frame = session.sql(sql)
            after = reg.REGISTRY.snapshot()
            moves = {k: after[k] - before.get(k, 0) for k in after
                     if k.startswith(("stats_cache.", "join.filter_rows_"))
                     and after[k] != before.get(k, 0)}
            out.append((frame if reg is JM else pd.DataFrame(frame.to_dict()), moves))
        runs.append(out)
    (j1, j2), (p1, p2) = runs
    assert p1[1] == j1[1] and p2[1] == j2[1]
    assert p2[1].get("stats_cache.hit", 0) > 0 and "stats_cache.miss" not in p2[1]
    for (got, _), (want, _) in ((p1, j1), (p2, j2)):
        pd.testing.assert_frame_equal(got, want, check_exact=True)