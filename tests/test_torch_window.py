"""Window functions in the port, against the JAX package:

- ``ops/window.py`` against ``presto_tpu.ops.window`` on the same numpy
  inputs (seeded): ``change_flags`` with NULLs, ``segment_starts`` /
  ``segment_ends``, ``seg_scan`` for sum, min and max over int64 and
  float32, ``rank_values`` with ties and ``windowed_agg`` in the RANGE,
  ROWS and whole-partition frames with rows that do not contribute.
  Integers exact; float32 sums within rtol 1e-5, atol 1e-4 (the two
  scans add in different trees), but a float32 sum whose global prefix
  passes 2^24 while every segment stays below it is exact: the port's
  scan restarts at each reset and never carries another partition's
  rows. The reference runs under ``jax.jit``;
- ``WindowOperator`` against the reference's on batches carried over by
  ``torch_bridge.port_batch``: several batches with dead rows, NULL
  partition and order keys, both null placements, DESC keys, a wide
  BYTES key, a dictionary VARCHAR min / max, and lag / lead at offsets
  1, 2 and past the partition (float32 running sums within rtol 1e-4,
  atol 1e-3).

The SQL surface of windows is held to the reference in
``tests/test_torch_window_sql.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.ops.window as JW
import presto_tpu_torch.ops.window as PW
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.batch import Dictionary as JDictionary
from presto_tpu.exec import operators as JO
from presto_tpu.expr import InputRef as JInputRef
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu.types import DOUBLE as JDOUBLE
from presto_tpu.types import INTEGER as JINTEGER
from presto_tpu.types import fixed_bytes as jfixed_bytes
from presto_tpu.types import varchar as jvarchar
from presto_tpu_torch.exec import operators as PO
from presto_tpu_torch.expr import InputRef as PInputRef
from torch_bridge import port_batch, port_type, to_numpy

# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


def _flags(rng, n: int, p: float) -> np.ndarray:
    f = rng.random(n) < p
    f[0] = True
    return f


@functools.lru_cache(maxsize=None)
def _jitted(fn_name: str, static: tuple):
    return jax.jit(getattr(JW, fn_name), static_argnums=static)


def _both(fn_name: str, *args):
    """(port result, reference result) of one ``ops/window`` function on
    the same numpy arguments; the reference's under ``jax.jit`` (its
    eager associative scans take seconds a call), string arguments
    static."""
    got = getattr(PW, fn_name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                 for a in args])
    static = tuple(i for i, a in enumerate(args) if isinstance(a, str))
    want = _jitted(fn_name, static)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                      for a in args])
    return got, want


def _same(got, want, what: str, rtol: float = 0.0):
    g, w = to_numpy(got), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=10 * rtol, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("seed", range(4))
def test_change_flags_with_nulls_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = 300
    a = rng.integers(0, 3, n).astype(np.int64)
    b = rng.integers(0, 2, n).astype(np.int32)
    va, vb = rng.random(n) < 0.7, rng.random(n) < 0.8
    a = np.where(va, a, 0)
    got = PW.change_flags([torch.from_numpy(a), torch.from_numpy(b)],
                          [torch.from_numpy(va), None])
    want = JW.change_flags([jnp.asarray(a), jnp.asarray(b)], [jnp.asarray(va), None])
    _same(got, want, "two columns, NULLs on the first")
    _same(PW.change_flags([torch.from_numpy(b)]), JW.change_flags([jnp.asarray(b)]),
          "one column")
    _same(PW.change_flags([torch.from_numpy(a[:1])]), JW.change_flags([jnp.asarray(a[:1])]),
          "one row")


@pytest.mark.parametrize("seed", range(4))
def test_segment_starts_and_ends_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 17, 500):
        f = _flags(rng, n, 0.1 + 0.2 * seed)
        for fn in ("segment_starts", "segment_ends"):
            got, want = _both(fn, f)
            _same(got, want, f"{fn} n={n}")


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float32])
def test_seg_scan_equals_reference_and_a_loop(kind, dtype):
    rng = np.random.default_rng(7)
    op = {"sum": np.add, "min": np.minimum, "max": np.maximum}[kind]
    for n in (1, 3, 257, 1000):
        vals = rng.integers(-50, 50, n).astype(dtype)
        if dtype == np.float32:
            vals = vals + rng.random(n).astype(np.float32)
        reset = _flags(rng, n, 0.15)
        got, want = _both("seg_scan", vals, reset, kind)
        loop = np.empty(n, dtype)
        for i in range(n):
            loop[i] = vals[i] if reset[i] else op(loop[i - 1], vals[i])
        rtol = 1e-5 if dtype == np.float32 and kind == "sum" else 0.0
        _same(got, want, f"seg_scan {kind} n={n}", rtol)
        _same(got, loop, f"seg_scan {kind} n={n} against a loop", rtol)


def test_float32_running_sums_never_cross_a_partition():
    """Segments of 50-150 rows of whole numbers up to 1000: every segment
    sum is below 2^24 and exact in float32, while the global prefix
    passes 2^24 (about 2.5e7). A scan that carried a value across a
    reset would lose low digits there; the port's equals the int64 sums
    exactly, as the reference's does."""
    rng = np.random.default_rng(3)
    lens = rng.integers(50, 150, 500)
    n = int(lens.sum())
    reset = np.zeros(n, bool)
    reset[np.concatenate([[0], np.cumsum(lens)[:-1]])] = True
    ints = rng.integers(0, 1001, n)
    assert ints.sum() > 2**24
    part = np.cumsum(reset)
    exact = np.zeros(n, np.int64)
    for p in np.unique(part):
        m = part == p
        exact[m] = np.cumsum(ints[m])
    assert exact.max() < 2**24
    vals = ints.astype(np.float32)
    got, want = _both("seg_scan", vals, reset, "sum")
    np.testing.assert_array_equal(to_numpy(got), exact.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(want), exact.astype(np.float32))
    # a global prefix minus its value at the segment start is not exact here
    cs = np.cumsum(vals, dtype=np.float32)
    starts = np.maximum.accumulate(np.where(reset, np.arange(n), 0))
    naive = cs - cs[starts] + vals[starts]
    assert not np.array_equal(naive, exact.astype(np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_rank_values_with_ties_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    part = _flags(rng, n, 0.05)
    peer = part | (rng.random(n) < 0.3)  # ties: runs of peers
    got, want = _both("rank_values", part, peer)
    for g, w, what in zip(got, want, ("row_number", "rank", "dense_rank")):
        _same(g, w, what)
    small = _both("rank_values", np.array([True, False, True, False, False]),
                  np.array([True, False, True, False, True]))
    for g, w in zip(*small):
        _same(g, w, "the reference's five-row case")
    np.testing.assert_array_equal(to_numpy(small[0][1]), [1, 1, 1, 1, 3])


@functools.lru_cache(maxsize=None)
def _three_frames(kind: str):
    """The reference's ``windowed_agg`` in the three frames, one jit."""
    return jax.jit(lambda *a: tuple(JW.windowed_agg(*a, kind, f) for f in FRAMES))


FRAMES = ("range", "rows", "full")


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float32])
def test_windowed_agg_equals_reference(kind, dtype):
    rng = np.random.default_rng(11)
    n = 600
    part = _flags(rng, n, 0.04)
    peer = part | (rng.random(n) < 0.4)
    vals = rng.integers(-1000, 1000, n).astype(dtype)
    contrib = rng.random(n) < 0.8
    contrib[:3] = False  # a frame with no contributing row: count 0
    args = (vals, contrib, part, peer)
    wants = _three_frames(kind)(*[jnp.asarray(a) for a in args])
    rtol = 1e-5 if dtype == np.float32 and kind == "sum" else 0.0
    for frame, (wv, wc) in zip(FRAMES, wants):
        gv, gc = PW.windowed_agg(*[torch.from_numpy(a) for a in args], kind, frame)
        _same(gc, wc, f"{kind} {frame} counts")
        _same(gv, wv, f"{kind} {frame} values", rtol)


def test_windowed_agg_reference_case():
    """tests/test_window.py's hand case: one partition of four rows (row
    1 not contributing) and one of two."""
    part = np.array([True, False, False, False, True, False])
    peer = np.array([True, False, True, False, True, True])
    vals = np.array([10, 99, 5, 7, 3, 4], np.int64)
    contrib = np.array([True, False, True, True, True, True])
    want = {"rows": [10, 10, 15, 22, 3, 7], "range": [10, 10, 22, 22, 3, 7],
            "full": [22, 22, 22, 22, 7, 7]}
    for frame, w in want.items():
        (gv, gc), (wv, wc) = _both("windowed_agg", vals, contrib, part, peer, "sum", frame)
        _same(gv, wv, frame)
        _same(gc, wc, frame)
        np.testing.assert_array_equal(to_numpy(gv), w)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

_FLAGS = JDictionary(["A", "N", "R"])


def _window_batch(seed: int, cap: int) -> JBatch:
    """p: int64 partition key (NULLs), o: int32 order key (NULLs, ties),
    w: a 12-byte BYTES key (zero and space padding alike), d: dictionary
    VARCHAR codes, v: BIGINT values (NULLs), f: DOUBLE values; a third of
    the rows dead."""
    rng = np.random.default_rng(seed)
    live = rng.random(cap) < 0.67
    words = [b"apple", b"apple  ", b"banana split", b"cherry", b"", b"apple pie"]
    w = np.zeros((cap, 12), np.uint8)
    for i, k in enumerate(rng.integers(0, len(words), cap)):
        raw = words[k]
        w[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    cols = {
        "p": (rng.integers(0, 4, cap).astype(np.int64), rng.random(cap) < 0.85, JBIGINT, None),
        "o": (rng.integers(0, 6, cap).astype(np.int32), rng.random(cap) < 0.8, JINTEGER, None),
        "w": (w, np.ones(cap, bool), jfixed_bytes(12), None),
        "d": (rng.integers(0, 3, cap).astype(np.int32), rng.random(cap) < 0.9,
              jvarchar(), _FLAGS),
        "v": (rng.integers(-500, 500, cap).astype(np.int64), rng.random(cap) < 0.75, JBIGINT,
              None),
        "f": (rng.normal(0, 100, cap).astype(np.float32), np.ones(cap, bool), JDOUBLE, None),
    }
    return JBatch({n: JColumn(jnp.asarray(d), jnp.asarray(v), t, dic)
                   for n, (d, v, t, dic) in cols.items()}, jnp.asarray(live))


_TYPES = {"p": JBIGINT, "o": JINTEGER, "w": jfixed_bytes(12), "d": jvarchar(), "v": JBIGINT,
          "f": JDOUBLE}


def _specs(funcs, package):
    """AggSpecs of (kind, input column or None, offset) in one package."""
    O, Ref = (JO, JInputRef) if package == "jax" else (PO, PInputRef)
    out = []
    for i, (kind, col, offset) in enumerate(funcs):
        t = _TYPES.get(col)
        if package != "jax" and t is not None:
            t = port_type(t)
        inp = None if col is None else Ref(t, col)
        if kind in ("row_number", "rank", "dense_rank", "count", "count_star"):
            dt = JBIGINT if package == "jax" else port_type(JBIGINT)
        elif kind == "sum" and col in ("v", "p"):
            dt = JBIGINT if package == "jax" else port_type(JBIGINT)
        else:
            dt = t
        out.append(O.AggSpec(kind, inp, f"{kind}{i}", dt, offset=offset))
    return out


def _keys(keys, package):
    O, Ref = (JO, JInputRef) if package == "jax" else (PO, PInputRef)
    return [O.SortKey(Ref(_TYPES[c] if package == "jax" else port_type(_TYPES[c]), c), desc, nf)
            for c, desc, nf in keys]


ALL_FUNCS = [("row_number", None, 1), ("rank", None, 1), ("dense_rank", None, 1),
             ("lag", "v", 1), ("lag", "v", 2), ("lag", "f", 9), ("lead", "v", 1),
             ("lead", "d", 2), ("lead", "v", 9), ("first_value", "v", 1),
             ("first_value", "w", 1), ("sum", "v", 1), ("sum", "f", 1), ("count", "v", 1),
             ("count_star", None, 1), ("min", "v", 1), ("max", "d", 1), ("min", "d", 1),
             ("max", "f", 1)]

OPERATOR_CASES = {
    "int partition, order with NULLs last": (["p"], [("o", False, False)], "range"),
    "NULLs first, DESC": (["p"], [("o", True, True)], "range"),
    "rows frame, two order keys": (["p"], [("o", False, True), ("v", True, False)], "rows"),
    "full frame": (["p"], [("o", False, False)], "full"),
    "wide BYTES partition": (["w"], [("o", False, False), ("v", False, False)], "range"),
    "wide BYTES order key, DESC": (["d"], [("w", True, False)], "rows"),
    "dictionary and int partition": (["d", "p"], [("o", True, False)], "range"),
    "no partition": ([], [("v", False, True)], "rows"),
}


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_window_operator_equals_reference(case):
    part, keys, frame = OPERATOR_CASES[case]
    jbs = [_window_batch(s, cap) for s, cap in ((1, 64), (2, 100), (3, 37))]
    jop = JO.WindowOperator([JInputRef(_TYPES[c], c) for c in part], _keys(keys, "jax"),
                            _specs(ALL_FUNCS, "jax"), frame)
    pop = PO.WindowOperator([PInputRef(port_type(_TYPES[c]), c) for c in part],
                            _keys(keys, "port"), _specs(ALL_FUNCS, "port"), frame)
    for jb in jbs:
        assert jop.process(jb) == []
        assert pop.process(port_batch(jb)) == []
    (want,), (got,) = jop.finish(), pop.finish()
    live = np.asarray(want.live)
    np.testing.assert_array_equal(to_numpy(got.live), live)
    assert live.sum() > 0 and not live[int(live.sum()):].any()  # the dead rows sort last
    assert got.names == want.names
    for name in want.names:
        g, w = got[name], want[name]
        gv, wv = to_numpy(g.valid)[live], np.asarray(w.valid)[live]
        np.testing.assert_array_equal(gv, wv, err_msg=f"{case}: {name} validity")
        gd, wd = to_numpy(g.data)[live][gv], np.asarray(w.data)[live][wv]
        assert gd.dtype == wd.dtype, f"{case}: {name} dtype {gd.dtype} != {wd.dtype}"
        if name.startswith("sum") and gd.dtype == np.float32:
            np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-3, err_msg=f"{case}: {name}")
        else:
            np.testing.assert_array_equal(gd, wd, err_msg=f"{case}: {name}")
        assert (g.dictionary is None) == (w.dictionary is None), name
        if w.dictionary is not None:
            assert list(g.dictionary.values) == list(w.dictionary.values)


def test_window_operator_refusals_match_reference():
    keys, funcs = _keys([("o", False, False)], "port"), _specs([("lag", "v", 1)], "port")
    with pytest.raises(ValueError, match=r"^lag\(\) requires ORDER BY in its window$"):
        PO.WindowOperator([], [], funcs)
    with pytest.raises(ValueError, match=r"^lag\(\) requires ORDER BY in its window$"):
        JO.WindowOperator([], [], _specs([("lag", "v", 1)], "jax"))
    with pytest.raises(Exception, match="unsupported window frame 'groups'"):
        PO.WindowOperator([], keys, funcs, "groups")
    assert PO.WindowOperator([], [], []).finish() == []
