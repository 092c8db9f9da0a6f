"""``chip_smoke.py``'s oracle checks on the CPU.

- phase 25's runs (``oracle_phase_runs``) at sf 0.01 with the kernels'
  plain versions: the 22 TPC-H and 15 SSB answers of the port's
  ``Session.sql``, each held here to the numpy oracle
  (``oracle_answers``) by ``same_as_oracle``. At this scale TPC-H Q18
  and SSB q3_4 answer no rows (the engine and the oracle alike), which
  the card's SF1 run (``run_oracle_queries``) refuses, and Q19 selects no
  rows, whose SUM the engine answers NULL and the oracle 0.0 (ROADMAP
  C28, pinned here);
- ``oracle_normalized`` equals ``tests/test_tpch_sql.normalize`` on frames
  with NULLs, dates, strings with trailing blanks and numbers in object
  columns, and ``same_as_oracle`` passes equal answers and refuses one
  value outside ``DOUBLE_TOL``, a changed string and a missing row.
"""

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from test_tpch_sql import normalize

#: the queries that answer no rows at sf 0.01, in the engine and the oracle
EMPTY_AT_SF001 = {"tpch q18", "ssb q3_4"}


def test_chip_smoke_phase25_on_the_cpu():
    out = chip_smoke.oracle_phase_runs(0.01, device="cpu")
    want = chip_smoke.oracle_by_label(0.01, [chip_smoke.oracle_answers(j)
                                             for j in chip_smoke.oracle_jobs(0.01)])
    assert sorted(want) == sorted(out["got"]) and len(want) == 37
    assert len(out["walls"]) == 37
    for label, (_sf, _seconds, cols) in want.items():
        got = out["got"][label]
        assert (len(cols[0]) == 0) == (label in EMPTY_AT_SF001), label
        if label == "tpch q19":
            # ROADMAP C28: at sf 0.01 no lineitem row passes Q19's filter;
            # the engine's SUM over no rows is NULL, the oracle's (as
            # pandas') 0.0
            with pytest.raises(RuntimeError, match=r"column 0 differs:\n\[nan\]\n\[0\.\]$"):
                chip_smoke.same_as_oracle(got, cols, label)
        else:
            chip_smoke.same_as_oracle(got, cols, label)
            assert len(got[0]) == len(cols[0]), label
    # no CUDA kernel on the CPU
    assert out["q1_err"] == 0 and out["launches"]["q1"] == 0
    assert out["probe_err"] == {"exists": 0, "payload": 0}


def frames():
    rng = np.random.default_rng(5)
    n = 40
    obj = rng.integers(0, 5, n).astype(object)
    obj[::7] = None
    words = np.array(["b ", "a", "c  ", None], dtype=object)[rng.integers(0, 4, n)]
    return {"f": np.round(rng.normal(0, 100, n), 3), "i": rng.integers(-3, 3, n),
            "o": obj, "s": words, "d": np.datetime64("1998-01-01") + rng.integers(0, 9, n)}


def test_oracle_normalized_equals_the_reference_normalize():
    cols = frames()
    got, _kinds = chip_smoke.oracle_normalized(list(cols.values()))
    want = normalize(pd.DataFrame(cols))
    for g, c in zip(got, want.columns):
        w = want[c]
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(g.astype(np.float64), w.to_numpy())
        elif w.dtype.kind == "M":
            assert (g == w.to_numpy().astype("datetime64[s]")).all()
        elif w.dtype.kind in "iu":
            assert g.tolist() == w.tolist()
        else:  # a NULL string: NaN in pandas' string column, None here
            assert [x if x is not None else "NULL" for x in g.tolist()] == \
                ["NULL" if x is None or x != x else x for x in w.tolist()]


def test_same_as_oracle_holds_and_refuses():
    cols = list(frames().values())
    perm = np.random.default_rng(1).permutation(len(cols[0]))
    chip_smoke.same_as_oracle([c[perm] for c in cols], cols, "shuffled rows")
    near = [c.copy() for c in cols]
    near[0] = near[0] + 0.01
    chip_smoke.same_as_oracle(near, cols, "within the tolerance")
    far = [c.copy() for c in cols]
    far[0][3] += 5.0
    with pytest.raises(RuntimeError, match="column 0 differs"):
        chip_smoke.same_as_oracle(far, cols, "one value off")
    other = [c.copy() for c in cols]
    other[3] = np.array(["zz" if x == "a" else x for x in other[3]], dtype=object)
    with pytest.raises(RuntimeError, match="differs"):
        chip_smoke.same_as_oracle(other, cols, "a changed string")
    with pytest.raises(RuntimeError, match="shape"):
        chip_smoke.same_as_oracle([c[1:] for c in cols], cols, "a missing row")
