"""Q1's expressions in the port against ``presto_tpu.expr.evaluate``:
``disc_price``, ``charge`` and the shipdate predicate, on narrow
batches, including half-away-from-zero rounding of negative products.
Exact (values, int64 dtypes, validity)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.expr as JE
import presto_tpu.types as JT
import presto_tpu.workloads as JW
import presto_tpu_torch.expr as PE
import presto_tpu_torch.workloads as PW
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu_torch.types import BOOLEAN, decimal, varchar
from torch_bridge import assert_same, port_batch

CAP = 1 << 12


def _jax_batch(rng, negative: bool):
    dec2 = JT.decimal(12, 2)
    lo_disc, hi_disc = (-50, 160) if negative else (0, 11)
    lo_ep = -10_500_000 if negative else 90000
    spec = {
        "l_shipdate": (np.int16, 9000, 11500, JT.DATE),
        "l_returnflag": (np.int8, 0, 3, JT.varchar()),
        "l_linestatus": (np.int8, 0, 2, JT.varchar()),
        "l_quantity": (np.int16, 100, 5001, dec2),
        "l_extendedprice": (np.int32, lo_ep, 10_500_000, dec2),
        "l_discount": (np.int16, lo_disc, hi_disc, dec2),
        "l_tax": (np.int8, -9 if negative else 0, 9, dec2),
    }
    live = jnp.asarray(rng.random(CAP) < 0.9)
    cols = {n: JColumn(jnp.asarray(rng.integers(lo, hi, CAP).astype(dt)), live,
                       typ.with_physical(dt))
            for n, (dt, lo, hi, typ) in spec.items()}
    return JBatch(cols, live)


@pytest.mark.parametrize("negative", [False, True], ids=["q1-domain", "negative"])
@pytest.mark.parametrize("which", [0, 1, 2], ids=["predicate", "disc_price", "charge"])
def test_q1_expressions_match_reference(negative, which):
    rng = np.random.default_rng(11 + which + 10 * negative)
    jb = _jax_batch(rng, negative)
    pb = port_batch(jb)
    jexpr = JW.q1_exprs()[which]
    pexpr = PW.q1_exprs()[which]
    want = JE.evaluate(jexpr, jb)
    got = PE.evaluate(pexpr, pb)
    assert_same(got.data, want.data, "data")
    assert_same(got.valid, want.valid, "valid")
    assert str(got.dtype) == str(want.dtype)
    if which == 0:
        assert_same(PE.evaluate_predicate(pexpr, pb), JE.evaluate_predicate(jexpr, jb))
    elif negative:
        assert (got.data < 0).any()  # the rounding of negative products is exercised


@pytest.mark.parametrize("f", [10, 100, 10_000])
def test_round_half_away_matches_reference(f):
    d = np.concatenate([np.arange(-3 * f, 3 * f + 1),
                        np.array([-(2**40) - f // 2, 2**40 + f // 2, -f // 2, f // 2])])
    want = JE._round_half_away(jnp.asarray(d, jnp.int64), np.int64(f))
    got = PE._round_half_away(torch.from_numpy(d), f)
    assert_same(got, want)
    # neither floor nor trunc division does this
    assert not np.array_equal(got.numpy(), d // f)


def test_rescale_rounds_half_away_on_negatives():
    dec4, dec2 = decimal(38, 4), decimal(38, 2)
    live = torch.ones(4, dtype=torch.bool)
    from presto_tpu_torch.batch import Batch, Column

    b = Batch({"x": Column(torch.tensor([-150, -149, 150, 149]), live, dec4)}, live)
    got = PE.evaluate(PE.Call(dec2, "add", (PE.col("x", dec4), PE.lit(0, dec2))), b)
    assert got.data.tolist() == [-2, -1, 2, 1]


def test_unported_function_raises_naming_it():
    pb = port_batch(_jax_batch(np.random.default_rng(0), False))
    ne = PE.Call(BOOLEAN, "ne", (PE.col("l_tax", decimal(12, 2)), PE.lit(0, decimal(12, 2))))
    e = PE.Call(BOOLEAN, "or", (ne, ne))
    with pytest.raises(NotImplementedError, match="'or'"):
        PE.evaluate(e, pb)


VARCHAR_LITERALS = ["A", "N", "R", "B", "", "Z"]  # present; absent between, before, after


@pytest.mark.parametrize("fn", ["eq", "lt", "le", "gt", "ge"])
@pytest.mark.parametrize("literal", VARCHAR_LITERALS)
def test_varchar_literal_comparisons_match_reference(fn, literal):
    """A dictionary VARCHAR column against a literal, present or absent
    from the dictionary (``l_returnflag = 'R'`` and its neighbours): the
    literal maps to its code, an absent one matches nothing under eq."""
    from presto_tpu.batch import Dictionary as JDictionary

    rng = np.random.default_rng(4)
    jb = _jax_batch(rng, False)
    d = JDictionary(["A", "N", "R"])
    col = jb["l_returnflag"]
    jb = JBatch({**jb.columns, "l_returnflag": JColumn(col.data, col.valid, col.dtype, d)},
                jb.live)
    pb = port_batch(jb)
    je = JE.Call(JT.BOOLEAN, fn, (JE.col("l_returnflag", JT.varchar()),
                                  JE.lit(literal, JT.varchar())))
    pe = PE.Call(BOOLEAN, fn, (PE.col("l_returnflag", varchar()), PE.lit(literal, varchar())))
    assert_same(PE.evaluate_predicate(pe, pb), JE.evaluate_predicate(je, jb), f"{fn} {literal!r}")


@pytest.mark.parametrize("fn", ["lt", "gt", "ge", "and"])
def test_date_comparisons_and_kleene_and_match_reference(fn):
    """``o_orderdate < date '1995-03-15'`` and friends on narrow DATE
    storage, and ``and`` over two such predicates."""
    rng = np.random.default_rng(6)
    jb = _jax_batch(rng, False)
    pb = port_batch(jb)

    def pred(E, T, f, iso):
        return E.Call(T.BOOLEAN, f, (E.col("l_shipdate", T.DATE), E.lit(iso, T.DATE)))

    import presto_tpu_torch.types as PT

    if fn == "and":
        je = JE.Call(JT.BOOLEAN, "and", (pred(JE, JT, "ge", "1994-01-01"),
                                         pred(JE, JT, "lt", "1995-03-15")))
        pe = PE.Call(PT.BOOLEAN, "and", (pred(PE, PT, "ge", "1994-01-01"),
                                         pred(PE, PT, "lt", "1995-03-15")))
    else:
        je, pe = pred(JE, JT, fn, "1995-03-15"), pred(PE, PT, fn, "1995-03-15")
    got, want = PE.evaluate(pe, pb), JE.evaluate(je, jb)
    assert_same(got.data & got.valid, want.data & want.valid, fn)
