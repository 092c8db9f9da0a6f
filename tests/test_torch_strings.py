"""The port's string predicates against the JAX package's, exactly:

- the plain ``like_mask`` and ``starts_with_mask`` of
  ``presto_tpu_torch/ops/strings.py`` (what ``ops/cuda_strings`` runs on
  CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernels to)
  against the JAX package's jnp ``strings.like_mask`` /
  ``starts_with_mask`` and its Pallas ``like_mask_pallas`` /
  ``starts_with_pallas`` in interpret mode, on a pattern set made from a
  seed, over widths 1, 7, 22, 55 and 79, at capacities that are not
  multiples of 256, with dead rows that hold any bytes (zeros inside
  them included: a row's length is its count of nonzero bytes); the
  pattern set and the rows are ``chip_smoke.py``'s (``like_patterns``,
  ``string_rows``), which holds the CUDA kernels to the same cases;
- ``_`` raises in both;
- the expression layer against ``presto_tpu.expr.evaluate`` on the same
  batches: LIKE / NOT LIKE on BYTES and on dictionary VARCHAR (a host
  regex over the dictionary, ``_`` included), ``starts_with``,
  ``substr`` and the BYTES comparisons (``ne`` and the others, against a
  literal and another BYTES column, PAD SPACE), ``year`` / ``month`` /
  ``day`` and ``cast_bigint``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.expr as JE
import presto_tpu.types as JT
import presto_tpu_torch.expr as PE
import presto_tpu_torch.types as PT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.batch import Dictionary as JDictionary
from presto_tpu.ops import strings as jstrings
from presto_tpu.ops.pallas_strings import like_mask_pallas, starts_with_pallas
from presto_tpu_torch.ops import cuda_strings
from presto_tpu_torch.ops import strings as pstrings
from torch_bridge import assert_same, port_batch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

WIDTHS = [1, 7, 22, 55, 79]
# the pattern set, the prefixes and the rows are chip_smoke.py's, so the
# card's phase 2 and these tests check the same cases
PATTERNS = chip_smoke.like_patterns()
PREFIXES = chip_smoke.PREFIXES
rows = chip_smoke.string_rows
capacity = chip_smoke.small_capacity  # at most 2^10, never a multiple of 256


@pytest.mark.parametrize("width", WIDTHS)
def test_like_plain_equals_jnp_and_pallas(width):
    data = rows(width, capacity(width), width)
    for p in PATTERNS:
        got = pstrings.like_mask(torch.from_numpy(data), p)
        assert_same(got, jstrings.like_mask(data, p), f"jnp {p!r} W={width}")
        assert_same(got, like_mask_pallas(data, p), f"pallas {p!r} W={width}")
        # the wrapper takes the plain version on a CPU tensor
        assert_same(cuda_strings.like_mask(torch.from_numpy(data), p), got, p)


def test_pattern_set_hits_and_misses():
    """The set is not vacuous: over the widths, each pattern both matches
    some row and misses some row, except those that cannot miss (only
    wildcards) or cannot match (a segment wider than every width)."""
    for p in PATTERNS:
        hits = np.concatenate([jstrings.like_mask(rows(w, capacity(w), w), p)
                               for w in WIDTHS])
        assert hits.all() == (p != "" and set(p) == {"%"}), p
        if "a" * 80 not in p and "b" * 80 not in p:
            assert hits.any(), p


@pytest.mark.parametrize("width", WIDTHS)
def test_starts_with_plain_equals_jnp_and_pallas(width):
    data = rows(width, capacity(width), 100 + width)
    for p in PREFIXES:
        got = pstrings.starts_with_mask(torch.from_numpy(data), p)
        assert_same(got, jstrings.starts_with_mask(data, p), f"jnp {p!r} W={width}")
        assert_same(got, starts_with_pallas(data, p), f"pallas {p!r} W={width}")
        assert_same(cuda_strings.starts_with_mask(torch.from_numpy(data), p), got, p)


def test_underscore_raises_in_both():
    data = rows(22, 300, 1)
    with pytest.raises(NotImplementedError):
        jstrings.like_mask(data, "a_b%")
    with pytest.raises(NotImplementedError):
        pstrings.like_mask(torch.from_numpy(data), "a_b%")
    with pytest.raises(NotImplementedError):
        cuda_strings.like_mask(torch.from_numpy(data), "%_")


def test_suffix_rule_and_greedy_match():
    """'%1' matches '011' (the suffix at the logical length, not the
    earliest '1'); greedy earliest occurrence leaves room for a later
    segment; embedded zeros count out of the length."""
    data = np.zeros((5, 6), np.uint8)
    for i, s in enumerate([b"011", b"0110", b"aaab", b"ab", b"a\x00b"]):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    t = torch.from_numpy(data)
    assert pstrings.like_mask(t, "%1").tolist() == [True, False, False, False, False]
    assert pstrings.like_mask(t, "%a%ab").tolist() == [False, False, True, False, False]
    assert pstrings.like_mask(t, "%ab").tolist() == [False, False, True, True, False]
    assert_same(pstrings.like_mask(t, "%b"), jstrings.like_mask(data, "%b"))


def test_like_program_layout():
    """The kernel's program: mode, anchors, segment lengths and bytes."""
    prog, pat = cuda_strings.like_program("ab%%c%de")
    assert prog.tolist() == [3, 1, 1, 3, 2, 1, 2] and bytes(pat) == b"abcde"
    assert cuda_strings.like_program("")[0].tolist() == [0, 0, 0, 0]
    assert cuda_strings.like_program("%%")[0].tolist() == [1, 0, 0, 0]
    assert cuda_strings.like_program("abc")[0].tolist() == [2, 1, 1, 1, 3]


# ---------------------------------------------------------------------------
# the expression layer
# ---------------------------------------------------------------------------

CAP = 1000
VALUES = ["Customer#000000011", "Customer#000000021", "Customer#1", "forest green",
          "sky blue", "a_b", "axb", "", "green%"]


def string_batch(seed: int = 7):
    """A JAX batch with BYTES columns (one with NULLs, one narrower),
    a dictionary VARCHAR column, a DATE column and dead rows."""
    rng = np.random.default_rng(seed)
    live = rng.random(CAP) < 0.9
    nulls = rng.random(CAP) < 0.1
    texts = [VALUES[i] for i in rng.integers(0, len(VALUES), CAP)]
    b15 = np.zeros((CAP, 15), np.uint8)
    b12 = np.zeros((CAP, 12), np.uint8)
    for i, s in enumerate(texts):
        raw = s.encode()[:15]
        b15[i, : len(raw)] = np.frombuffer(raw, np.uint8)
    b12[:] = b15[rng.permutation(CAP), :12]
    b12[::5, 2:] = 32  # trailing spaces equal the zero padding (PAD SPACE)
    d = JDictionary(VALUES)
    codes = rng.integers(0, len(d), CAP).astype(np.int8)
    days = rng.integers(-800_000, 800_000, CAP).astype(np.int32)
    days[:4] = [-1, 0, 59, 11016]  # around the epoch and a leap day
    jlive = jnp.asarray(live)
    cols = {
        "s": JColumn(jnp.asarray(b15), jlive, JT.fixed_bytes(15)),
        "sn": JColumn(jnp.asarray(b15), jnp.asarray(live & ~nulls), JT.fixed_bytes(15)),
        "t": JColumn(jnp.asarray(b12), jlive, JT.fixed_bytes(12)),
        "v": JColumn(jnp.asarray(codes), jlive, JT.varchar().with_physical(np.int8), d),
        "d": JColumn(jnp.asarray(days), jlive, JT.DATE),
    }
    return JBatch(cols, jlive)


def _exprs(m, T):
    """The same expressions built in the JAX package (m=JE, T=JT) or the
    port (m=PE, T=PT)."""
    s, sn, t = (m.col(c, T.fixed_bytes(w)) for c, w in (("s", 15), ("sn", 15), ("t", 12)))
    v = m.col("v", T.varchar().with_physical(np.int8))
    d = m.col("d", T.DATE)

    def lit(x):
        return m.lit(x, T.varchar())

    def call(fn, *args, t_=T.BOOLEAN):
        return m.Call(t_, fn, tuple(args))

    sub = call(m.substr_fn(1, 2), s, t_=T.fixed_bytes(2))
    out = {
        "like s %green%": call("like", s, lit("%green%")),
        "like sn Customer%1": call("like", sn, lit("Customer%1")),
        "not like s %#%": call("not", call("like", s, lit("%#%"))),
        "like v %e%": call("like", v, lit("%e%")),
        "like v a_b": call("like", v, lit("a_b")),
        "like v Customer%1": call("like", v, lit("Customer%1")),
        "not like v %green%": call("not", call("like", v, lit("%green%"))),
        "starts_with s forest": call("starts_with", s, lit("forest")),
        "starts_with sn Cust": call("starts_with", sn, lit("Cust")),
        "starts_with v sky": call("starts_with", v, lit("sky")),
        "substr(s, 1, 2) <> 'Cu'": call("ne", sub, lit("Cu")),
        "substr(s, 3, 40)": m.Call(T.fixed_bytes(40), m.substr_fn(3, 40), (s,)),
        "'sky' <> sn": call("ne", lit("sky blue"), sn),
        "s = t": call("eq", s, t),
        "s < t": call("lt", s, t),
        "sn >= 'forest'": call("ge", sn, lit("forest")),
        "t between 'a' and 'f'": call("between", t, lit("a"), lit("f")),
        "year(d)": call("year", d, t_=T.INTEGER),
        "month(d)": call("month", d, t_=T.INTEGER),
        "day(d)": call("day", d, t_=T.INTEGER),
        "cast_bigint(day(d))": call("cast_bigint", call("day", d, t_=T.INTEGER),
                                    t_=T.BIGINT),
    }
    return out


NAMES = list(_exprs(PE, PT))


@pytest.mark.parametrize("name", NAMES)
def test_expression_equals_reference(name):
    jb = string_batch()
    pb = port_batch(jb)
    want = JE.evaluate(_exprs(JE, JT)[name], jb)
    got = PE.evaluate(_exprs(PE, PT)[name], pb)
    assert_same(got.data, want.data, f"{name}: data")
    assert_same(got.valid, want.valid, f"{name}: valid")
    assert str(got.dtype) == str(want.dtype)
    if got.dtype.kind is PT.TypeKind.BOOLEAN:
        live = pb.live & got.valid
        assert bool((got.data & live).any()) and bool((~got.data & live).any()), name
