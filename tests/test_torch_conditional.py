"""The conditional and boolean expression library in the port against
``presto_tpu.expr.evaluate``, exactly (values, validity and the dtype
that holds them), on one seeded batch whose columns hold NULLs. The
reference runs under ``jax.jit``, as its operators run it: XLA turns a
division by the constant 10^scale into a multiply by its float32
reciprocal, which the port's DECIMAL -> DOUBLE conversion computes.

- the Kleene ``or`` over every pair of TRUE, FALSE and NULL;
- ``in`` with a NULL needle, a NULL item, an item absent from the
  needle's dictionary and BYTES items (PAD SPACE), and ``not in``;
- ``case``, searched and simple (``eq`` on the operand), with and without
  ELSE, with a bare-NULL branch, and a VARCHAR result whose literal is
  encoded against the column's dictionary;
- ``coalesce`` over BYTES and a literal (space-padded to the width), over
  dictionary VARCHAR with a present and an absent literal, and over
  numbers of two widths;
- ``is_null`` and ``is_not_null``, ``if`` (``nullif``'s form);
- ``neg`` at the narrow extremes (int8 -128, a DECIMAL on int16 -32768,
  which both packages wrap alike);
- ``cast_double`` of a DECIMAL and of integers, ``rescale_<s>`` (CAST to
  ``decimal(p,s)``) up and down (half away from zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import presto_tpu.expr as JE
import presto_tpu.types as JT
import presto_tpu_torch.expr as PE
import presto_tpu_torch.types as PT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.batch import Dictionary as JDictionary
from torch_bridge import assert_same, port_batch

CAP = 600
DICT = ["A", "C", "E", "G"]


def nullable_batch() -> JBatch:
    """Boolean columns ``a`` and ``b`` covering the nine (TRUE, FALSE,
    NULL) pairs in turn; ``q`` DECIMAL(12,2) on int16, ``i`` INTEGER on
    int8 (both with their dtype's extremes), ``k`` BIGINT, ``v`` VARCHAR
    on int8 codes of ``DICT``, ``s`` BYTES(6) rows of 'a', 'b' and spaces
    with zero tails, ``t`` BYTES(9); every column but ``k`` has NULLs."""
    rng = np.random.default_rng(20261017)
    live = rng.random(CAP) < 0.95
    tri = np.arange(CAP) % 9
    a_val, b_val = tri // 3, tri % 3  # 0 FALSE, 1 TRUE, 2 NULL

    def nulls(p=0.2):
        return rng.random(CAP) >= p

    q = rng.integers(-400, 400, CAP).astype(np.int16)
    q[:6] = [-32768, 32767, 0, -5, 5, -150]
    i = rng.integers(-3, 4, CAP).astype(np.int8)
    i[:4] = [-128, 127, 1, -1]
    alphabet = np.frombuffer(b"ab  ", np.uint8)
    s = alphabet[rng.integers(0, 4, (CAP, 6))]
    s[np.arange(6)[None, :] >= rng.integers(0, 7, CAP)[:, None]] = 0  # zero tails
    s[:3] = [list(b"ab\0\0\0\0"), list(b"ab    "), list(b"ab \0\0\0")]
    t = alphabet[rng.integers(0, 4, (CAP, 9))]
    t[np.arange(9)[None, :] >= rng.integers(0, 10, CAP)[:, None]] = 0
    dec2 = JT.decimal(12, 2).with_physical(np.int16)
    cols = {
        "a": JColumn(jnp.asarray(a_val == 1), jnp.asarray(a_val != 2), JT.BOOLEAN),
        "b": JColumn(jnp.asarray(b_val == 1), jnp.asarray(b_val != 2), JT.BOOLEAN),
        "q": JColumn(jnp.asarray(q), jnp.asarray(nulls()), dec2),
        "i": JColumn(jnp.asarray(i), jnp.asarray(nulls()), JT.INTEGER.with_physical(np.int8)),
        "k": JColumn(jnp.asarray(rng.integers(-10**12, 10**12, CAP)), jnp.asarray(live),
                     JT.BIGINT),
        "v": JColumn(jnp.asarray(rng.integers(0, len(DICT), CAP).astype(np.int8)),
                     jnp.asarray(nulls()), JT.varchar().with_physical(np.int8),
                     JDictionary(DICT)),
        "s": JColumn(jnp.asarray(s), jnp.asarray(nulls()), JT.fixed_bytes(6)),
        "t": JColumn(jnp.asarray(t), jnp.asarray(nulls(0.5)), JT.fixed_bytes(9)),
    }
    return JBatch(cols, jnp.asarray(live))


def _exprs(m, T):
    """The same expressions built in the JAX package (m=JE, T=JT) or the
    port (m=PE, T=PT)."""
    dec2 = T.decimal(12, 2).with_physical(np.int16)
    a, b = m.col("a", T.BOOLEAN), m.col("b", T.BOOLEAN)
    q, i = m.col("q", dec2), m.col("i", T.INTEGER.with_physical(np.int8))
    k, v = m.col("k", T.BIGINT), m.col("v", T.varchar().with_physical(np.int8))
    s, t = m.col("s", T.fixed_bytes(6)), m.col("t", T.fixed_bytes(9))

    def lit(x, t_=None):
        if t_ is None:
            t_ = T.varchar() if isinstance(x, str) else T.INTEGER
        return m.lit(x, t_)

    def call(fn, *args, t_=T.BOOLEAN):
        return m.Call(t_, fn, tuple(args))

    zero_dec = m.lit(0.0, T.decimal(12, 2))
    return {
        "a or b": call("or", a, b),
        "(a or b) and not a": call("and", call("or", a, b), call("not", a)),
        "q > 0 or v = 'C'": call("or", call("gt", q, zero_dec), call("eq", v, lit("C"))),
        "v in ('A', 'E')": call("in", v, lit("A"), lit("E")),
        "v in ('A', 'ZZZ')": call("in", v, lit("A"), lit("ZZZ")),
        "v not in ('C', 'B')": call("not", call("in", v, lit("C"), lit("B"))),
        "i in (1, -128, 3)": call("in", i, lit(1), lit(-128), lit(3)),
        "i in (1, NULL)": call("in", i, lit(1), lit(None)),
        "q in (0.05, -1.50)": call("in", q, m.lit(0.05, T.decimal(3, 2)),
                                   m.lit(-1.5, T.decimal(3, 2))),
        "s in ('ab', 'b a')": call("in", s, lit("ab"), lit("b a")),
        "s not in ('ab  ', 'a')": call("not", call("in", s, lit("ab  "), lit("a"))),
        "case q > 0 then q when q < -5 then -q end": call(
            "case", call("gt", q, zero_dec), q, call("lt", q, m.lit(-5.0, T.decimal(12, 2))),
            call("neg", q, t_=dec2), t_=dec2),
        "case a then i else k end": call("case", a, i, k, t_=T.BIGINT),
        "case v = 'A' then 1 when v = 'C' then 2 else 0 end": call(
            "case", call("eq", v, lit("A")), lit(1), call("eq", v, lit("C")), lit(2), lit(0),
            t_=T.INTEGER),
        "case a then NULL else i end": call("case", a, m.lit(None, T.INTEGER), i, t_=T.INTEGER),
        "case b then i when a then NULL end": call("case", b, i, a, m.lit(None, T.INTEGER),
                                                  t_=T.INTEGER),
        "case q > 0 then v else 'E' end": call("case", call("gt", q, zero_dec), v, lit("E"),
                                                t_=T.varchar()),
        "coalesce(s, 'zz')": call("coalesce", s, lit("zz"), t_=T.fixed_bytes(6)),
        "coalesce(s, 'toolongvalue')": call("coalesce", s, lit("toolongvalue"),
                                            t_=T.fixed_bytes(6)),
        "coalesce(v, 'E')": call("coalesce", v, lit("E"), t_=T.varchar()),
        "coalesce(v, 'Q')": call("coalesce", v, lit("Q"), t_=T.varchar()),
        "coalesce(i, k)": call("coalesce", i, k, t_=T.BIGINT),
        "coalesce(q, 0)": call("coalesce", q, lit(0), t_=T.decimal(12, 2)),
        "q is null": call("is_null", q),
        "s is null": call("is_null", s),
        "v is not null": call("is_not_null", v),
        "k is not null": call("is_not_null", k),
        "nullif(i, 1)": call("if", call("eq", i, lit(1)), m.lit(None, T.INTEGER), i,
                             t_=T.INTEGER),
        "if(a, q, 0)": call("if", a, q, lit(0), t_=T.decimal(12, 2)),
        "-i": call("neg", i, t_=T.INTEGER.with_physical(np.int8)),
        "-q": call("neg", q, t_=dec2),
        "-k": call("neg", k, t_=T.BIGINT),
        "cast(q as double)": call("cast_double", q, t_=T.DOUBLE),
        "cast(i as double)": call("cast_double", i, t_=T.DOUBLE),
        "cast(k as double)": call("cast_double", k, t_=T.DOUBLE),
        "cast(q as decimal(12,1))": call(m.rescale_decimal(1), q, t_=T.decimal(12, 1)),
        "cast(q as decimal(12,4))": call(m.rescale_decimal(4), q, t_=T.decimal(12, 4)),
        "cast(i as decimal(5,2))": call(m.rescale_decimal(2), i, t_=T.decimal(5, 2)),
    }


NAMES = list(_exprs(PE, PT))


def reference(expr, jb):
    """The JAX package's value of ``expr``: data and validity from a
    jitted evaluation, the type and dictionary from an eager one."""
    meta = JE.evaluate(expr, jb)
    data, valid = jax.jit(lambda b: (lambda v: (v.data, v.valid))(JE.evaluate(expr, b)))(jb)
    return JE.Val(data, valid, meta.dtype, meta.dictionary)


@pytest.mark.parametrize("name", NAMES)
def test_expression_equals_reference(name):
    jb = nullable_batch()
    pb = port_batch(jb)
    want = reference(_exprs(JE, JT)[name], jb)
    got = PE.evaluate(_exprs(PE, PT)[name], pb)
    assert_same(got.data, want.data, f"{name}: data")
    assert_same(got.valid, want.valid, f"{name}: valid")
    assert str(got.dtype) == str(want.dtype)
    assert got.dtype.phys == PT.DataType(PT.TypeKind(want.dtype.kind.value), want.dtype.precision,
                                         want.dtype.scale, want.dtype.width,
                                         want.dtype.phys).phys, name
    assert (got.dictionary is None) == (want.dictionary is None), name
    if got.dictionary is not None:
        assert list(got.dictionary.values) == list(want.dictionary.values)


def test_kleene_or_truth_table():
    """OR over every (TRUE, FALSE, NULL) pair: TRUE wins over NULL, FALSE
    OR NULL is NULL; ``evaluate_predicate`` reads NULL as FALSE."""
    pb = port_batch(nullable_batch())
    got = PE.evaluate(_exprs(PE, PT)["a or b"], pb)
    tri = np.arange(CAP) % 9
    a, b = tri // 3, tri % 3  # 0 FALSE, 1 TRUE, 2 NULL
    true = (a == 1) | (b == 1)
    null = ~true & ((a == 2) | (b == 2))
    np.testing.assert_array_equal(got.valid.numpy(), ~null)
    np.testing.assert_array_equal((got.data & got.valid).numpy(), true)
    pred = PE.evaluate_predicate(_exprs(PE, PT)["a or b"], pb)
    np.testing.assert_array_equal(pred.numpy(), true)


def test_neg_wraps_at_the_narrow_extremes_and_keeps_the_dtype():
    pb = port_batch(nullable_batch())
    i = PE.evaluate(_exprs(PE, PT)["-i"], pb)
    q = PE.evaluate(_exprs(PE, PT)["-q"], pb)
    assert i.data.dtype == PT.torch_dtype_of(np.int8) and i.data[:2].tolist() == [-128, -127]
    assert q.data.dtype == PT.torch_dtype_of(np.int16) and q.data[:2].tolist() == [-32768, -32767]
    assert i.dtype.phys == np.dtype(np.int8) and q.dtype.phys == np.dtype(np.int16)


def test_case_with_a_bytes_result_where_the_reference_fails():
    """``CASE WHEN a THEN s ELSE substr(t, 1, 6) END`` over BYTES: the JAX
    package's ``case`` selects [rows] against [rows, width] and raises
    (ROADMAP C12); the port picks whole rows, checked here against numpy."""
    jb = nullable_batch()

    def expr(m, T):
        a, s = m.col("a", T.BOOLEAN), m.col("s", T.fixed_bytes(6))
        t6 = m.Call(T.fixed_bytes(6), m.substr_fn(1, 6), (m.col("t", T.fixed_bytes(9)),))
        return m.Call(T.fixed_bytes(6), "case", (a, s, t6))

    with pytest.raises(ValueError, match="broadcast"):
        JE.evaluate(expr(JE, JT), jb)
    got = PE.evaluate(expr(PE, PT), port_batch(jb))
    cond = np.asarray(jb["a"].data) & np.asarray(jb["a"].valid)
    s, t = np.asarray(jb["s"].data), np.asarray(jb["t"].data)[:, :6]
    np.testing.assert_array_equal(got.data.numpy(), np.where(cond[:, None], s, t))
    np.testing.assert_array_equal(got.valid.numpy(), np.where(
        cond, np.asarray(jb["s"].valid), np.asarray(jb["t"].valid)))


def test_in_needle_validity_only():
    """The reference's NULL rule, copied: ``x IN (1, NULL)`` is NULL only
    where ``x`` is NULL (a miss stays FALSE, not NULL)."""
    jb = nullable_batch()
    got = PE.evaluate(_exprs(PE, PT)["i in (1, NULL)"], port_batch(jb))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jb["i"].valid))


@pytest.mark.parametrize("needle", ["i", "v"])
def test_in_needle_without_validity(needle):
    """A port column may carry no validity (``valid=None``: no NULLs).
    ``x IN (..., NULL)`` over it is then never NULL, as the reference
    gives for the same column with an all-TRUE validity: the NULL item's
    validity must not spread to the result."""
    jb = nullable_batch()
    c = jb[needle]
    jb = JBatch({**jb.columns, needle: JColumn(c.data, jnp.ones(CAP, bool), c.dtype,
                                               c.dictionary)}, jb.live)
    pb = port_batch(jb)
    p = pb[needle]
    pb = type(pb)({**pb.columns, needle: type(p)(p.data, None, p.dtype, p.dictionary)}, pb.live)

    def expr(m, T):
        t = {"i": T.INTEGER.with_physical(np.int8), "v": T.varchar().with_physical(np.int8)}
        item = {"i": m.lit(1, T.INTEGER), "v": m.lit("C", T.varchar())}[needle]
        return m.Call(T.BOOLEAN, "in", (m.col(needle, t[needle]), item, m.lit(None, item.dtype)))

    want = reference(expr(JE, JT), jb)
    got = PE.evaluate(expr(PE, PT), pb)
    assert_same(got.data, want.data, "data")
    assert_same(got.valid, want.valid, "valid")
    assert bool(got.valid.all())
