"""What ``chip_smoke.py`` phase 16 holds TPC-DS to on the card, held here
on the CPU at the reference test's settings (sf 0.02, 2^15 units a
split), so that a fault in the phase's own checks shows before a card
run:

- the numpy oracles of q3, q7, q97 and q98 (``chip_smoke.tpcds_*_expected``)
  against the reference's pandas oracle (``tests/test_tpch_sql.compare``)
  and against the port's answer (``chip_smoke.close_result``);
- the strategy counters of those queries against their plans
  (``chip_smoke.planned_routes``);
- ``answer_of`` / ``same_answer``, the card-against-CPU comparison.
"""

import os
import sys

import pandas as pd
import pytest

from presto_tpu.oracle.tpcds_oracle import ORACLES
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.tpcds.queries import QUERIES
from test_tpch_sql import compare
from torch_bridge import TPCDS_SF, TPCDS_UNITS, LazyTables, one_thread, port_run

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

#: the oracles' DECIMAL columns (scaled by 100, as ``QueryResult.column``)
DECIMALS = {"q3": ("sum_agg",), "q98": ("i_current_price", "itemrevenue")}


@pytest.fixture(scope="module")
def env():
    from presto_tpu.connectors.tpcds import TpcdsConnector as JConnector

    with one_thread():
        conn = TpcdsConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS, device="cpu")
        yield (conn, chip_smoke.ColumnCache(conn),
               LazyTables(JConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS)))


@pytest.mark.parametrize("q", sorted(chip_smoke.TPCDS_ORACLES))
def test_numpy_oracle_equals_reference_oracle(env, q):
    _conn, cached, tables = env
    got = chip_smoke.TPCDS_ORACLES[q](cached)
    frame = pd.DataFrame({c: [v / 100 for v in vals] if c in DECIMALS.get(q, ()) else vals
                          for c, vals in got.items()})
    want = ORACLES[q](tables)
    assert len(want) > 0
    compare(frame, want, q)


@pytest.mark.parametrize("q", sorted(chip_smoke.TPCDS_ORACLES))
def test_numpy_oracle_and_planned_routes_equal_the_port(env, q):
    conn, cached, _tables = env
    res, routes, session = port_run(conn, QUERIES[q], key="tpcds")
    chip_smoke.close_result(res, chip_smoke.TPCDS_ORACLES[q](cached), q,
                            chip_smoke.TPCDS_DOUBLES.get(q, ()))
    got = {k: v for k, v in routes.items() if k.startswith(("join.strategy.", "agg.strategy."))}
    assert got == chip_smoke.planned_routes(session, QUERIES[q])


def test_same_answer_holds_doubles_within_tolerance_and_the_rest_exactly(env):
    conn = env[0]
    res, _routes, _session = port_run(conn, QUERIES["q7"], key="tpcds")
    a = chip_smoke.answer_of(res)
    assert a["doubles"] == ["agg1", "agg2", "agg3", "agg4"]
    chip_smoke.same_answer(a, a, "q7")
    near = {**a, "columns": {**a["columns"], "agg2": [v * (1 + 5e-4) for v in
                                                      a["columns"]["agg2"]]}}
    chip_smoke.same_answer(near, a, "q7 within tolerance")
    far = {**a, "columns": {**a["columns"], "agg2": [v * 1.01 + 1 for v in
                                                     a["columns"]["agg2"]]}}
    with pytest.raises(RuntimeError, match="column agg2 differs"):
        chip_smoke.same_answer(far, a, "q7 past tolerance")
    ids = a["columns"]["i_item_id"]
    moved = {**a, "columns": {**a["columns"], "i_item_id": ids[1:] + ids[:1]}}
    with pytest.raises(RuntimeError, match="column i_item_id differs"):
        chip_smoke.same_answer(moved, a, "q7 rows out of order")



def _small_connectors() -> dict:
    from presto_tpu_torch.connectors.ssb import SsbConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector

    return {"tpch": TpchConnector(sf=0.01, units_per_split=1 << 11, device="cpu"),
            "ssb": SsbConnector(sf=0.01, units_per_split=1 << 14, device="cpu"),
            "tpcds": TpcdsConnector(sf=0.01, units_per_split=1 << 14, device="cpu")}


SMALL = _small_connectors()


@pytest.mark.parametrize("key,table", [(k, t) for k, c in SMALL.items() for t in c.tables()])
def test_generated_once_scans_equal_the_generator(key, table):
    """Every phase scans from ``generated_once``: each split's columns, a
    projection of them and their ``$valid`` masks, bit for bit as the
    generator gives them, and the same ``Batch``."""
    import numpy as np

    conn = SMALL[key]
    cols = list(conn.schema(table))
    some = cols[::2]
    splits = conn.splits(table)
    direct = [(conn.scan_numpy(s), conn.scan_numpy(s, some), conn.scan(s, some))
              for s in splits]
    odd = conn.splits(table, target_splits=3)[-1]
    odd_direct = conn.scan_numpy(odd, some)
    with chip_smoke.generated_once() as generated:
        _seconds, held = chip_smoke.prefill(conn)
        assert held > 0
        assert len(generated) == sum(len(conn.splits(t)) for t in conn.tables())
        for s, (full, part, batch) in zip(splits, direct):
            for want, got in ((full, conn.scan_numpy(s)), (part, conn.scan_numpy(s, some))):
                assert list(got) == list(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            again = conn.scan(s, some)
            for c in some:
                assert torch_equal(again[c].data, batch[c].data)
                assert (again[c].valid is None) == (batch[c].valid is None)
                if batch[c].valid is not None:
                    assert torch_equal(again[c].valid, batch[c].valid)
        got = conn.scan_numpy(odd, some)
        assert list(got) == list(odd_direct)
        assert all(np.array_equal(got[k], odd_direct[k]) for k in odd_direct)
    assert not chip_smoke.GENERATED
    assert "scan_numpy" not in vars(conn)


def torch_equal(a, b) -> bool:
    return a.dtype == b.dtype and bool((a == b).all())


def test_q3_answers_the_same_from_generated_data(env):
    conn = env[0]
    res, _routes, _session = port_run(conn, QUERIES["q3"], key="tpcds")
    with chip_smoke.generated_once():
        chip_smoke.prefill(conn)
        again, _routes, _session = port_run(conn, QUERIES["q3"], key="tpcds")
    assert chip_smoke.answer_of(again) == chip_smoke.answer_of(res)
