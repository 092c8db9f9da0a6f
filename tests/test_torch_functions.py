"""The scalar function library in the port against the JAX package's
(``tests/test_functions.py``'s families, held to the reference rather
than to Python):

- every math, string, date and cast function against
  ``presto_tpu.expr.evaluate`` run under ``jax.jit`` (as the reference's
  operators run it) on one seeded batch whose columns hold NULLs:
  values, validity, the dtype that holds them and a derived dictionary,
  exactly; the transcendental DOUBLE functions (``exp``, ``ln``,
  ``log10``, ``log2``, ``power``, ``sqrt``) and ``round(x, n)`` within
  ``RTOL`` (float32 libraries may differ in the last bits). The batch
  holds negative operands for ``mod``, ``sign``, ``round`` and
  ``truncate``, zero divisors, BYTES rows zero- and space-padded, dates
  before 1970 and past 2000, and every ``cast_varchar`` width the
  analyzer picks (INTEGER 11, BIGINT 20, DATE 10, TIMESTAMP 19, DECIMAL
  precision + 2) and narrower and wider ones;
- the refusals both packages make, type and words;
- the SQL surface: each family through both ``Session.sql``s at sf 0.01
  (frames and dtypes; DOUBLE columns within ``DOUBLE_TOL``, the
  tolerance ``tests/test_tpch_sql.py`` holds DOUBLE aggregates to; the
  route counters), and the statements both packages refuse.
"""

import datetime
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import presto_tpu.expr as JE
import presto_tpu.types as JT
import presto_tpu_torch.expr as PE
import presto_tpu_torch.types as PT
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.batch import Dictionary as JDictionary
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from torch_bridge import assert_same, jax_run, port_batch, port_run

CAP = 500
#: leading, trailing and inner spaces, commas, the empty string, mixed case
WORDS = ["  hello  ", "world", " spaced", "trail ", "a,b,c", "", "MiXeD", "lil", "x,y"]
#: date and timestamp text for the parses, one of each unparsable
TEXTS = ["1995-03-15", "2020-02-29", "bogus", "1969-07-20", "1995-03-15 13:45:30",
         "2024-02-29 23:59:59.250000", " 1998-12-01 "]
#: float32 transcendentals and round(x, n): relative tolerance
RTOL = 1e-6
#: DOUBLE columns of SQL results (the tests/test_tpch_sql.py tolerance)
DOUBLE_TOL = {"rtol": 1e-3, "atol": 0.02}

EPOCH = datetime.date(1970, 1, 1)


def function_batch() -> JBatch:
    """``x`` DOUBLE (halves for round, negatives, zeros), ``y`` DOUBLE
    divisors (zeros among them), ``i`` INTEGER on int8 (its extremes),
    ``k`` BIGINT and ``j`` BIGINT divisors (negative and zero), ``q``
    DECIMAL(12,2) on int16 (between -1 and 0 too), ``v`` VARCHAR of
    ``WORDS``, ``s`` BYTES(12) of ``WORDS`` (zero or space padding),
    ``d`` DATE (1900-2100 and the calendar edges), ``e`` DATE, ``t``
    TIMESTAMP (before and after the epoch), ``w`` VARCHAR of ``TEXTS``;
    every column but ``k`` has NULLs."""
    rng = np.random.default_rng(20261018)
    live = rng.random(CAP) < 0.95

    def nulls(p=0.15):
        return jnp.asarray(rng.random(CAP) >= p)

    x = (rng.integers(-4000, 4000, CAP) / 8).astype(np.float32)
    x[:10] = [-2.5, -0.5, 0.5, 2.5, 1.5, 0.0, -0.0, 1e-3, 7.25, -7.75]
    y = rng.integers(-6, 7, CAP).astype(np.float32) / 2
    i = rng.integers(-40, 40, CAP).astype(np.int8)
    i[:4] = [-128, 127, -7, 7]
    k = rng.integers(-10**12, 10**12, CAP)
    k[:4] = [-17, 17, -1, 0]
    j = rng.integers(-9, 10, CAP)
    j[:4] = [5, 5, -5, 0]
    q = rng.integers(-30000, 30000, CAP).astype(np.int16)
    q[:6] = [-50, -5, 50, -150, 149, 0]
    vcodes = rng.integers(0, len(WORDS), CAP).astype(np.int8)
    vdict = JDictionary(WORDS)
    word_codes = vdict.encode(WORDS)
    words = [WORDS[int(np.nonzero(word_codes == c)[0][0])] for c in vcodes]
    s = np.zeros((CAP, 12), np.uint8)
    for r, w in enumerate(words):
        raw = w.encode() + (b" " * (r % 3) if r % 2 else b"")  # space or zero padding
        s[r, : len(raw[:12])] = np.frombuffer(raw[:12], np.uint8)
    days = rng.integers(-25567, 47482, CAP).astype(np.int32)  # 1900 .. 2100
    edges = [datetime.date(2000, 2, 29), datetime.date(1999, 12, 31), datetime.date(2001, 1, 1),
             datetime.date(1970, 1, 1), datetime.date(2024, 2, 29), datetime.date(1900, 3, 1),
             datetime.date(1969, 12, 31), datetime.date(2100, 12, 31)]
    days[: len(edges)] = [(d - EPOCH).days for d in edges]
    t = rng.integers(-10**15, 10**15, CAP)
    t[:3] = [0, -1, 86_400_000_000 - 1]
    wdict = JDictionary(TEXTS)
    cols = {
        "x": JColumn(jnp.asarray(x), nulls(), JT.DOUBLE),
        "y": JColumn(jnp.asarray(y), nulls(), JT.DOUBLE),
        "i": JColumn(jnp.asarray(i), nulls(), JT.INTEGER.with_physical(np.int8)),
        "k": JColumn(jnp.asarray(k), jnp.asarray(live), JT.BIGINT),
        "j": JColumn(jnp.asarray(j), nulls(), JT.BIGINT),
        "q": JColumn(jnp.asarray(q), nulls(), JT.decimal(12, 2).with_physical(np.int16)),
        "v": JColumn(jnp.asarray(vcodes), nulls(), JT.varchar().with_physical(np.int8), vdict),
        "s": JColumn(jnp.asarray(s), nulls(), JT.fixed_bytes(12)),
        "d": JColumn(jnp.asarray(days), nulls(), JT.DATE),
        "e": JColumn(jnp.asarray(rng.permutation(days)), nulls(), JT.DATE),
        "t": JColumn(jnp.asarray(t), nulls(), JT.TIMESTAMP),
        "w": JColumn(jnp.asarray(rng.integers(0, len(TEXTS), CAP).astype(np.int32)), nulls(),
                     JT.varchar(), wdict),
    }
    return JBatch(cols, jnp.asarray(live))


def _exprs(m, T):
    """The same expressions built in the JAX package (m=JE, T=JT) or the
    port (m=PE, T=PT)."""
    x, y = m.col("x", T.DOUBLE), m.col("y", T.DOUBLE)
    i = m.col("i", T.INTEGER.with_physical(np.int8))
    k, j = m.col("k", T.BIGINT), m.col("j", T.BIGINT)
    dec2 = T.decimal(12, 2).with_physical(np.int16)
    q = m.col("q", dec2)
    v = m.col("v", T.varchar().with_physical(np.int8))
    s = m.col("s", T.fixed_bytes(12))
    d, e = m.col("d", T.DATE), m.col("e", T.DATE)
    t = m.col("t", T.TIMESTAMP)
    w = m.col("w", T.varchar())

    def call(t_, fn, *args):
        return m.Call(t_, fn, tuple(args))

    def lit(value, t_=None):
        if t_ is None:
            t_ = T.varchar() if isinstance(value, str) else T.INTEGER
        return m.lit(value, t_)

    out = {
        # math
        "mod(k, j)": call(T.BIGINT, "mod", k, j),
        "mod(i, 7)": call(T.INTEGER, "mod", i, lit(7)),
        "mod(i, -7)": call(T.INTEGER, "mod", i, lit(-7)),
        "mod(x, y)": call(T.DOUBLE, "mod", x, y),
        "mod(q, 3)": call(T.decimal(12, 2), "mod", q, lit(3)),
        "abs(i)": call(i.dtype, "abs", i),
        "abs(q)": call(q.dtype, "abs", q),
        "abs(x)": call(T.DOUBLE, "abs", x),
        "floor(x)": call(T.DOUBLE, "floor", x),
        "ceil(x)": call(T.DOUBLE, "ceil", x),
        "floor(q)": call(T.DOUBLE, "floor", q),
        "ceil(q)": call(T.DOUBLE, "ceil", q),
        "round(x)": call(T.DOUBLE, "round", x),
        "round(q)": call(T.DOUBLE, "round", q),
        "round(i)": call(T.DOUBLE, "round", i),
        "sign(x)": call(T.INTEGER, "sign", x),
        "sign(k)": call(T.INTEGER, "sign", k),
        "sign(q)": call(T.INTEGER, "sign", q),
        "truncate(x)": call(T.DOUBLE, "truncate", x),
        "truncate(q)": call(T.DOUBLE, "truncate", call(T.DOUBLE, "cast_double", q)),
        "greatest(i, k)": call(T.BIGINT, "greatest", i, k),
        "least(i, k, j)": call(T.BIGINT, "least", i, k, j),
        "greatest(q, x)": call(T.DOUBLE, "greatest", q, x),
        "least(v, v)": call(T.varchar(), "least", v, v),
        # transcendental (RTOL)
        "sqrt(x)": call(T.DOUBLE, "sqrt", x),
        "sqrt(q)": call(T.DOUBLE, "sqrt", q),
        "exp(x / 100)": call(T.DOUBLE, "exp", call(T.DOUBLE, "div", x, lit(100))),
        "ln(x)": call(T.DOUBLE, "ln", x),
        "log10(q)": call(T.DOUBLE, "log10", q),
        "log2(x)": call(T.DOUBLE, "log2", x),
        "power(x, 2)": call(T.DOUBLE, "power", x, lit(2)),
        "power(x, y)": call(T.DOUBLE, "power", x, y),
        "round(x, 2)": call(T.DOUBLE, "div", call(T.DOUBLE, "round", call(
            T.DOUBLE, "mul", call(T.DOUBLE, "cast_double", x), lit(100.0, T.DOUBLE))),
            lit(100.0, T.DOUBLE)),
        # strings
        "upper(s)": call(s.dtype, "upper", s),
        "lower(s)": call(s.dtype, "lower", s),
        "upper(v)": call(T.varchar(), "upper", v),
        "lower(v)": call(T.varchar(), "lower", v),
        "s || '-' || s": call(T.fixed_bytes(25), "concat", s, lit("-"), s),
        "length(s)": call(T.INTEGER, "length", s),
        "length(v)": call(T.INTEGER, "length", v),
        "strpos(s, 'l')": call(T.INTEGER, "strpos", s, lit("l")),
        "strpos(v, 'l')": call(T.INTEGER, "strpos", v, lit("l")),
        "strpos(s, '')": call(T.INTEGER, "strpos", s, lit("")),
        "strpos(s, 'lo  ')": call(T.INTEGER, "strpos", s, lit("lo  ")),
        "replace(v, 'l', 'L')": call(T.varchar(), "replace", v, lit("l"), lit("L")),
        "split_part(v, ',', 2)": call(T.varchar(), m.split_part_fn(",", 2), v),
        "split_part(v, ',', 5)": call(T.varchar(), m.split_part_fn(",", 5), v),
        "substr(v, 2, 3)": call(T.varchar(), m.substr_dict_fn(2, 3), v),
        "substr(v, -3, 2)": call(T.varchar(), m.substr_dict_fn(-3, 2), v),
        "substr(v, -20, 2)": call(T.varchar(), m.substr_dict_fn(-20, 2), v),
        "substr(v, 0, 2)": call(T.varchar(), m.substr_dict_fn(0, 2), v),
        "regexp_like(v, '^[a-z]+$')": call(T.BOOLEAN, "regexp_like", v, lit("^[a-z]+$")),
        "regexp_like(v, 'l')": call(T.BOOLEAN, "regexp_like", v, lit("l")),
        "trim(v) = 'hello'": call(T.BOOLEAN, "eq", call(T.varchar(), "trim", v), lit("hello")),
        # dates and timestamps
        "hour(t)": call(T.INTEGER, "hour", t),
        "minute(t)": call(T.INTEGER, "minute", t),
        "second(t)": call(T.INTEGER, "second", t),
        "cast(d as timestamp)": call(T.TIMESTAMP, "cast_timestamp", d),
        "last_day_of_month(d)": call(T.DATE, "last_day_of_month", d),
        "date_diff('day', d, e)": call(T.BIGINT, m.date_diff_fn("day"), d, e),
        "date_diff('day', d, 2000-06-15)": call(T.BIGINT, m.date_diff_fn("day"), d,
                                                lit("2000-06-15", T.DATE)),
        "parse_date(w)": call(T.DATE, m.parse_date_fn(), w),
        "parse_timestamp(w)": call(T.TIMESTAMP, m.parse_timestamp_fn(), w),
        # casts to VARCHAR: the analyzer's widths, and narrower and wider ones
        "cast(i as varchar)": call(T.fixed_bytes(11), m.cast_varchar_fn(11), i),
        "cast(k as varchar)": call(T.fixed_bytes(20), m.cast_varchar_fn(20), k),
        "cast(k as varchar(5))": call(T.fixed_bytes(5), m.cast_varchar_fn(5), k),
        "cast(d as varchar)": call(T.fixed_bytes(10), m.cast_varchar_fn(10), d),
        "cast(d as varchar(4))": call(T.fixed_bytes(4), m.cast_varchar_fn(4), d),
        "cast(d as varchar(14))": call(T.fixed_bytes(14), m.cast_varchar_fn(14), d),
        "cast(t as varchar)": call(T.fixed_bytes(19), m.cast_varchar_fn(19), t),
        "cast(t as varchar(22))": call(T.fixed_bytes(22), m.cast_varchar_fn(22), t),
        "cast(q as varchar)": call(T.fixed_bytes(14), m.cast_varchar_fn(14), q),
        "cast(q as varchar(5))": call(T.fixed_bytes(5), m.cast_varchar_fn(5), q),
        "cast(cast(q as decimal(12,0)) as varchar)": call(
            T.fixed_bytes(14), m.cast_varchar_fn(14),
            call(T.decimal(12, 0), m.rescale_decimal(0), q)),
        "cast(s as varchar(8))": call(T.fixed_bytes(8), m.cast_varchar_fn(8), s),
        "cast(s as varchar(16))": call(T.fixed_bytes(16), m.cast_varchar_fn(16), s),
        "cast(v as varchar(6))": call(T.fixed_bytes(6), m.cast_varchar_fn(6), v),
    }
    for fn in ("trim", "ltrim", "rtrim", "reverse"):
        out[f"{fn}(s)"] = call(s.dtype, fn, s)
        out[f"{fn}(v)"] = call(T.varchar(), fn, v)
    for fn in ("year", "month", "day", "quarter", "day_of_week", "day_of_year"):
        out[f"{fn}(d)"] = call(T.INTEGER, fn, d)
        out[f"{fn}(t)"] = call(T.INTEGER, fn, t)
    for unit in ("second", "minute", "hour", "day", "week", "month", "quarter", "year"):
        out[f"date_trunc('{unit}', d)"] = call(T.DATE, m.date_trunc_fn(unit), d)
        out[f"date_trunc('{unit}', t)"] = call(T.TIMESTAMP, m.date_trunc_fn(unit), t)
    for unit in ("day", "week", "month", "quarter", "year"):
        out[f"date_add('{unit}', 13, d)"] = call(T.DATE, m.date_add_fn(unit), lit(13), d)
        out[f"date_add('{unit}', -5, d)"] = call(T.DATE, m.date_add_fn(unit), lit(-5), d)
        out[f"date_diff('{unit}', d, e)"] = call(T.BIGINT, m.date_diff_fn(unit), d, e)
    return out


NAMES = list(_exprs(PE, PT))
APPROX = {"sqrt(x)", "sqrt(q)", "exp(x / 100)", "ln(x)", "log10(q)", "log2(x)",
          "power(x, 2)", "power(x, y)", "round(x, 2)"}


@pytest.fixture(scope="module")
def jbatch():
    return function_batch()


def reference(expr, jb):
    """The JAX package's value of ``expr``: data and validity from a
    jitted evaluation, the type and dictionary from an eager one."""
    meta = JE.evaluate(expr, jb)
    data, valid = jax.jit(lambda b: (lambda v: (v.data, v.valid))(JE.evaluate(expr, b)))(jb)
    return JE.Val(data, valid, meta.dtype, meta.dictionary)


@pytest.mark.parametrize("name", NAMES)
def test_function_equals_reference(jbatch, name):
    want = reference(_exprs(JE, JT)[name], jbatch)
    got = PE.evaluate(_exprs(PE, PT)[name], port_batch(jbatch))
    if name in APPROX:
        assert got.data.dtype == PT.torch_dtype_of(np.asarray(want.data).dtype), name
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=RTOL,
                                   err_msg=name)
    else:
        assert_same(got.data, want.data, f"{name}: data")
    assert_same(got.valid, want.valid, f"{name}: valid")
    assert str(got.dtype) == str(want.dtype), name
    assert got.dtype.phys == want.dtype.phys, name
    assert (got.dictionary is None) == (want.dictionary is None), name
    if got.dictionary is not None:
        assert list(got.dictionary.values) == list(want.dictionary.values), name


def test_the_batch_exercises_the_edges(jbatch):
    """NULLs in the DOUBLE and DECIMAL columns, both paddings in ``s``,
    negative divisors and dividends, dates before the epoch."""
    s = np.asarray(jbatch["s"].data)
    assert (s == 32).any() and (s == 0).any()
    assert not np.asarray(jbatch["x"].valid).all() and not np.asarray(jbatch["q"].valid).all()
    assert (np.asarray(jbatch["j"].data) < 0).any() and (np.asarray(jbatch["j"].data) == 0).any()
    assert (np.asarray(jbatch["d"].data) < 0).any() and (np.asarray(jbatch["t"].data) < 0).any()


def test_round_is_half_away_from_zero(jbatch):
    got = PE.evaluate(_exprs(PE, PT)["round(x)"], port_batch(jbatch)).data[:5].tolist()
    assert got == [-3.0, -1.0, 1.0, 3.0, 2.0]


def test_mod_takes_the_divisor_sign(jbatch):
    """Floor modulo, copied from the reference (``%`` is jnp.remainder):
    mod(-17, 5) = 3, mod(17, -5) is not an input here but mod(-1, -5) =
    -1; a zero divisor is NULL."""
    got = PE.evaluate(_exprs(PE, PT)["mod(k, j)"], port_batch(jbatch))
    assert got.data[:3].tolist() == [3, 2, -1]
    assert not bool(got.valid[3])


def test_sqrt_of_a_negative_number_is_null(jbatch):
    got = PE.evaluate(_exprs(PE, PT)["sqrt(x)"], port_batch(jbatch))
    x = np.asarray(jbatch["x"].data)
    assert not got.valid.numpy()[x < 0].any()


def test_cast_varchar_renders_each_width_and_sign(jbatch):
    """Left-aligned text, zero padding: '-0.50' for a DECIMAL between -1
    and 0, 'yyyy-mm-dd' (cut at 4: the year), 'yyyy-mm-dd hh:mm:ss'."""
    pb = port_batch(jbatch)
    ex = _exprs(PE, PT)

    def text(name, rows=4):
        data = PE.evaluate(ex[name], pb).data.numpy()[:rows]
        return [bytes(r).rstrip(b"\0").decode() for r in data]

    assert text("cast(q as varchar)", 6) == ["-0.50", "-0.05", "0.50", "-1.50", "1.49", "0.00"]
    assert text("cast(k as varchar)") == ["-17", "17", "-1", "0"]
    assert text("cast(d as varchar)", 2) == ["2000-02-29", "1999-12-31"]
    assert text("cast(d as varchar(4))", 2) == ["2000", "1999"]
    assert text("cast(t as varchar)", 3) == ["1970-01-01 00:00:00", "1969-12-31 23:59:59",
                                             "1970-01-01 23:59:59"]
    width = PE.evaluate(ex["cast(i as varchar)"], pb).data.shape[1]
    assert width == 11


#: (expression, the error both packages raise, its words)
REFUSED_EXPRS = {
    "replace over BYTES": (lambda m, T: m.Call(T.fixed_bytes(12), "replace", (
        m.col("s", T.fixed_bytes(12)), m.lit("l", T.varchar()), m.lit("L", T.varchar()))),
        NotImplementedError, "replace() requires a dictionary VARCHAR"),
    "split_part over BYTES": (lambda m, T: m.Call(T.fixed_bytes(12), m.split_part_fn(",", 1), (
        m.col("s", T.fixed_bytes(12)),)),
        NotImplementedError, "split_part() requires a dictionary VARCHAR"),
    "regexp_like over BYTES": (lambda m, T: m.Call(T.BOOLEAN, "regexp_like", (
        m.col("s", T.fixed_bytes(12)), m.lit("l", T.varchar()))),
        NotImplementedError, "regexp_like requires a dictionary VARCHAR"),
    "greatest with a literal": (lambda m, T: m.Call(T.varchar(), "greatest", (
        m.col("v", T.varchar().with_physical(np.int8)), m.lit("b", T.varchar()))),
        NotImplementedError, "greatest with a string literal"),
    "least across dictionaries": (lambda m, T: m.Call(T.varchar(), "least", (
        m.col("v", T.varchar().with_physical(np.int8)), m.col("w", T.varchar()))),
        NotImplementedError, "least across different dictionaries"),
    "strpos needle not a literal": (lambda m, T: m.Call(T.INTEGER, "strpos", (
        m.col("s", T.fixed_bytes(12)), m.col("s", T.fixed_bytes(12)))),
        NotImplementedError, "strpos needle must be a literal"),
}


@pytest.mark.parametrize("name", list(REFUSED_EXPRS))
def test_both_packages_refuse_the_expression(jbatch, name):
    build, error, words = REFUSED_EXPRS[name]
    with pytest.raises(error, match=re.escape(words)):
        JE.evaluate(build(JE, JT), jbatch)
    with pytest.raises(error, match=re.escape(words)):
        PE.evaluate(build(PE, PT), port_batch(jbatch))


@pytest.mark.parametrize("unit,factory", [("fortnight", "date_trunc_fn"),
                                          ("hour", "date_add_fn"), ("hour", "date_diff_fn")])
def test_unknown_units_are_refused_alike(unit, factory):
    with pytest.raises(NotImplementedError, match=f"unit '{unit}'"):
        getattr(JE, factory)(unit)
    with pytest.raises(NotImplementedError, match=f"unit '{unit}'"):
        getattr(PE, factory)(unit)


# ---------------------------------------------------------------------------
# the SQL surface, through both Session.sql
# ---------------------------------------------------------------------------

STATEMENTS = {
    "mod and %": ("select n_nationkey, n_nationkey % 7 as m, mod(n_nationkey - 12, 5) as m2, "
                  "mod(n_nationkey - 12, -5) as m3, (n_nationkey - 12) % 0 as z from nation "
                  "order by n_nationkey"),
    "math": ("select sqrt(n_nationkey) as s, abs(n_nationkey - 12) as a, round(n_nationkey / 7.0, 2)"
             " as r, floor(n_nationkey / 3.0) as f, ceil(n_nationkey / 3.0) as c, "
             "ceiling(n_nationkey / 3.0) as c2, sign(n_nationkey - 12) as sg, "
             "round(n_nationkey - 12.5) as rh, sqrt(n_nationkey - 12) as sn from nation"),
    "transcendental": ("select power(n_nationkey, 2) as p, pow(2, n_nationkey) as p2, "
                       "ln(n_nationkey + 1) as l, log10(n_nationkey + 1) as l10, "
                       "log2(n_nationkey + 1) as l2, exp(n_nationkey / 10.0) as e, "
                       "truncate((n_nationkey - 12) / 3.0) as t, greatest(n_nationkey, 10) as g, "
                       "least(n_nationkey, 10, n_regionkey) as le from nation"),
    "decimals": ("select c_custkey, abs(c_acctbal) as a, round(c_acctbal) as r, sign(c_acctbal) as s, "
                 "truncate(c_acctbal) as t, c_acctbal % 100 as m from customer "
                 "order by c_custkey limit 40"),
    "bytes strings": ("select c_custkey, upper(c_name) as u, lower(c_name) as lo, trim(c_address) as t, "
                      "ltrim(c_address) as lt, rtrim(c_address) as rt, reverse(c_phone) as r, "
                      "length(c_address) as ln, strpos(c_phone, '-') as sp, "
                      "char_length(c_name) as cl, c_name || '/' || c_phone as cat "
                      "from customer order by c_custkey limit 50"),
    "dictionary strings": ("select n_name, replace(n_name, 'A', '@') as r, length(n_name) as l, "
                           "reverse(n_name) as rv, trim(n_name) as t, strpos(n_name, 'AN') as sp, "
                           "regexp_like(n_name, '^[A-C]') as rl, substring(n_name, 1, 3) as s, "
                           "substr(n_name, -3) as tail, substr(n_name, 2) as s2 from nation "
                           "order by n_name"),
    "split_part": ("select p_partkey, p_type, split_part(p_type, ' ', 2) as sp, split_part(p_type, ' ', 9) "
                   "as sp9 from part order by p_partkey limit 30"),
    "string group": ("select split_part(p_type, ' ', 1) as k, count(*) as n from part "
                     "group by split_part(p_type, ' ', 1) order by k"),
    "dates": ("select o_orderkey, extract(quarter from o_orderdate) as q, day_of_week(o_orderdate) as dw, "
              "dow(o_orderdate) as dw2, day_of_year(o_orderdate) as dy, doy(o_orderdate) as dy2, "
              "quarter(o_orderdate) as q2, date_trunc('month', o_orderdate) as dt, "
              "date_trunc('week', o_orderdate) as wk, date_add('day', 3, o_orderdate) as da, "
              "date_add('month', -1, o_orderdate) as dm, "
              "date_diff('day', o_orderdate, date '1998-01-01') as dd, "
              "date_diff('month', o_orderdate, date '1998-01-01') as dmo, "
              "last_day_of_month(o_orderdate) as ld from orders order by o_orderkey limit 30"),
    "extract": ("select o_orderkey, extract(dow from o_orderdate) as a, extract(doy from o_orderdate) as b, "
                "extract(year from o_orderdate) as c, extract(month from o_orderdate) as d, "
                "extract(day from o_orderdate) as e from orders order by o_orderkey limit 10"),
    "timestamps": ("select o_orderkey, hour(cast(o_orderdate as timestamp)) as h, "
                   "minute(cast(o_orderdate as timestamp)) as mi, "
                   "second(cast(o_orderdate as timestamp)) as se, "
                   "cast(o_orderdate as timestamp) as ts, "
                   "date_trunc('hour', timestamp '1995-03-15 13:45:30') as th, "
                   "extract(hour from timestamp '1995-03-15 13:45:30') as eh "
                   "from orders order by o_orderkey limit 5"),
    "casts": ("select o_orderkey, cast(o_orderkey as varchar) as a, cast(o_orderdate as varchar) as b, "
              "cast(o_totalprice as varchar) as c, cast(o_custkey as varchar(4)) as d, "
              "cast(o_orderstatus as varchar) as e, cast(o_clerk as varchar(9)) as f, "
              "cast(cast(o_orderdate as timestamp) as varchar) as g, "
              "cast(o_totalprice - 200000 as varchar) as h from orders order by o_orderkey "
              "limit 20"),
    "literal casts": ("select cast('1998-01-01' as date) as d, "
                      "cast('1995-03-15 13:45:30' as timestamp) as t, cast(7 as varchar) as v"),
    "stddev": ("select l_returnflag, stddev(l_quantity) as s, stddev_samp(l_quantity) as s2, "
               "variance(l_discount) as v, var_samp(l_discount) as v2, count(*) as n "
               "from lineitem group by l_returnflag order by l_returnflag"),
    "stddev of one row": ("select n_regionkey, stddev(n_nationkey) as s, variance(n_nationkey) "
                          "as v from nation where n_nationkey < 6 group by n_regionkey "
                          "order by n_regionkey"),
    "stddev keyless": ("select stddev(o_totalprice) as s, variance(o_shippriority) as v "
                       "from orders"),
    "greatest over dates": ("select o_orderkey, greatest(o_orderdate, date '1995-01-01') as g, "
                            "least(o_orderdate, date '1995-01-01') as l from orders "
                            "order by o_orderkey limit 10"),
}

DOUBLE_RESULTS = {"math", "transcendental", "decimals", "stddev", "stddev of one row",
                  "stddev keyless"}

#: statements both packages refuse, with the reference's words
REFUSED = {
    "upper over dictionary VARCHAR": "select upper(n_name) from nation",
    "replace over BYTES": "select replace(c_name, 'a', 'b') from customer",
    "|| over dictionary VARCHAR": "select n_name || 'x' from nation",
    "cast BYTES to date": "select cast(cast(o_orderdate as varchar) as date) from orders",
    "round scale not a literal": "select round(n_nationkey, n_regionkey) from nation",
    "arity": "select strpos(n_name) from nation",
    "unknown function": "select levenshtein(n_name, 'a') from nation",
    "unit not a literal": "select date_trunc(n_name, n_nationkey) from nation",
    "EXTRACT field": "select extract(week from o_orderdate) from orders",
    "cast DOUBLE to varchar": "select cast(n_nationkey / 2.0 as varchar) from nation",
}


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax_session(conns, name):
    want, want_routes = jax_run(conns[0], STATEMENTS[name])
    res, routes, _ = port_run(conns[1], STATEMENTS[name])
    got = pd.DataFrame(res.to_dict())
    if name in DOUBLE_RESULTS:
        pd.testing.assert_frame_equal(got, want, check_exact=False, **DOUBLE_TOL)
    else:
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert routes == want_routes
    assert len(got) > 0


@pytest.mark.parametrize("name", list(REFUSED))
def test_both_packages_refuse_the_statement(conns, name):
    try:
        jax_run(conns[0], REFUSED[name])
    except Exception as e:  # noqa: BLE001 - the refusal is the answer
        want = e
    else:
        pytest.fail("the JAX package answered")
    with pytest.raises(Exception) as got:
        port_run(conns[1], REFUSED[name])
    assert (type(got.value).__name__, str(got.value)) == (type(want).__name__, str(want))
