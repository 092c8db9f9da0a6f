"""The port's TPC-DS connector against the JAX package's, at sf 0.01:

- the metadata of all 23 tables (schema, physical schema, dictionary
  values, row counts, unique keys, functional dependencies, splits) at
  sf 0.01 and SF1;
- ``scan_numpy`` of every split of every table bit-identical, every
  column and every ``<col>$valid`` mask;
- ``scan`` of a split of each fact table equal to the reference's Batch
  (data, validity, live, dtypes, dictionary values), ``split_valids``
  and ``Batch.from_numpy`` with masks;
- ``table_dicts`` handing out one ``Dictionary`` object per column;
- the 99 statements equal to the reference's, character for character;
- the reference's ``test_generator_determinism`` and
  ``test_fact_nulls_flow_through`` mirrored on the port.
"""

import numpy as np
import pytest

from presto_tpu.connectors.tpcds import TpcdsConnector as JConnector
from presto_tpu.connectors.tpcds import schema as JS
from presto_tpu.connectors.tpcds.queries import QUERIES as JQUERIES
from presto_tpu.spi import split_valids as j_split_valids
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.tpcds import schema as PS
from presto_tpu_torch.connectors.tpcds.queries import QUERIES
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.spi import split_valids
from torch_bridge import port_type

SF = 0.01
FACTS = ["store_sales", "catalog_sales", "web_sales", "store_returns", "catalog_returns",
         "web_returns", "inventory"]


@pytest.fixture(scope="module")
def connectors():
    return TpcdsConnector(sf=SF, device="cpu"), JConnector(sf=SF)


def test_every_table_is_covered():
    assert sorted(PS.TABLES) == sorted(JS.TABLES)
    assert len(PS.TABLES) == 23
    assert set(FACTS) <= set(PS.TABLES)


@pytest.mark.parametrize("sf", [SF, 1])
@pytest.mark.parametrize("table", sorted(JS.TABLES))
def test_metadata_matches_reference(table, sf):
    port, ref = TpcdsConnector(sf=sf, device="cpu"), JConnector(sf=sf)
    assert port.tables() == ref.tables()
    assert port.row_count(table) == ref.row_count(table)
    assert port.unique_keys(table) == ref.unique_keys(table)
    assert port.func_deps(table) == ref.func_deps(table)
    assert {c: port_type(d) for c, d in ref.schema(table).items()} == dict(port.schema(table))
    assert ({c: port_type(d) for c, d in ref.physical_schema(table).items()}
            == port.physical_schema(table))
    assert ({c: list(d.values) for c, d in port.dictionaries(table).items()}
            == {c: list(d.values) for c, d in ref.dictionaries(table).items()})
    assert [vars(s) for s in port.splits(table)] == [vars(s) for s in ref.splits(table)]
    assert ([vars(s) for s in port.splits(table, 3)]
            == [vars(s) for s in ref.splits(table, 3)])


def test_schema_constants_match_reference():
    for name in ("ROWS_PER_SF", "FIXED_ROWS", "RETURN_PARENT", "RETURN_FRACTION",
                 "INVENTORY_WEEKS", "UNIQUE_KEYS", "FUNC_DEPS", "DATE_DIM_ROWS",
                 "DATE_SK_BASE", "SALES_DATE_LO", "SALES_DATE_HI"):
        assert getattr(PS, name) == getattr(JS, name), name
    assert sorted(PS.DICTS) == sorted(JS.DICTS)
    for c, d in JS.DICTS.items():
        assert list(PS.DICTS[c].values) == list(d.values), c


def test_table_dicts_hands_out_one_dictionary_per_column():
    for table in PS.TABLES:
        a, b = PS.table_dicts(table), PS.table_dicts(table)
        assert a.keys() == b.keys()
        for c in a:
            assert a[c] is b[c], f"{table}.{c}"
    conn = TpcdsConnector(sf=SF, device="cpu")
    x = conn.scan(conn.splits("customer_demographics")[0], ["cd_marital_status"])
    y = conn.scan(conn.splits("customer_demographics")[1], ["cd_marital_status"])
    assert x["cd_marital_status"].dictionary is y["cd_marital_status"].dictionary


@pytest.mark.parametrize("table", sorted(JS.TABLES))
def test_generator_is_bit_identical(connectors, table):
    port, ref = connectors
    for ps, js in zip(port.splits(table), ref.splits(table), strict=True):
        got, want = port.scan_numpy(ps), ref.scan_numpy(js)
        assert list(got) == list(want)
        for c in want:
            assert got[c].dtype == want[c].dtype, c
            assert got[c].shape == want[c].shape, c
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"{table}.{c}")


@pytest.mark.parametrize("table", FACTS)
def test_scan_matches_reference(connectors, table):
    port, ref = connectors
    ps, js = port.splits(table), ref.splits(table)
    split = len(js) - 1
    pb, jb = port.scan(ps[split]), ref.scan(js[split])
    assert pb.capacity == jb.capacity
    np.testing.assert_array_equal(pb.live.numpy(), np.asarray(jb.live))
    assert pb.names == jb.names
    masked = 0
    for name in jb.names:
        pc, jc = pb[name], jb[name]
        assert pc.data.numpy().dtype.name == np.asarray(jc.data).dtype.name, name
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data), err_msg=name)
        assert pc.dtype == port_type(jc.dtype), name
        assert (pc.valid is pb.live) == (jc.valid is jb.live), name
        np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(jc.valid), err_msg=name)
        masked += pc.valid is not pb.live
        if jc.dictionary is not None:
            assert list(pc.dictionary.values) == list(jc.dictionary.values)
        else:
            assert pc.dictionary is None
    # every fact table carries NULL-able foreign keys
    assert masked > 0


def test_split_valids_and_masked_batch():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1000, 3000).astype(np.int64)
    mask = rng.random(3000) > 0.1
    arrays = {"k": keys, "k$valid": mask, "v": keys * 3}
    data, valids = split_valids(arrays)
    jdata, jvalids = j_split_valids(arrays)
    assert list(data) == list(jdata) == ["k", "v"]
    assert list(valids) == list(jvalids) == ["k"]
    assert valids["k"] is mask
    types = dict(PS.TABLES["store_sales"])
    t = {"k": types["ss_item_sk"], "v": types["ss_item_sk"]}
    b = Batch.from_numpy(data, t, capacity=4096, valids=valids, device="cpu")
    assert b.capacity == 4096
    assert b["v"].valid is b.live
    assert b["k"].valid is not b.live
    np.testing.assert_array_equal(b["k"].valid.numpy()[:3000], mask)
    assert not b["k"].valid.numpy()[3000:].any()
    np.testing.assert_array_equal(b["k"].data.numpy()[:3000], keys)


@pytest.mark.parametrize("name", sorted(JQUERIES, key=lambda x: int(x[1:])))
def test_statement_text_equals_reference(name):
    assert QUERIES[name] == JQUERIES[name]


def test_every_statement_is_copied():
    assert sorted(QUERIES) == sorted(JQUERIES)
    assert len(QUERIES) == 99


def test_generator_determinism():
    a = TpcdsConnector(sf=0.01, device="cpu").table_numpy("store_sales", ["ss_item_sk"])
    b = TpcdsConnector(sf=0.01, device="cpu").table_numpy("store_sales", ["ss_item_sk"])
    np.testing.assert_array_equal(a["ss_item_sk"], b["ss_item_sk"])
    conn = TpcdsConnector(sf=0.01, device="cpu")
    s = conn.splits("store_sales")[0]
    full = conn.scan_numpy(s)
    pruned = conn.scan_numpy(s, ["ss_item_sk", "ss_net_paid"])
    np.testing.assert_array_equal(full["ss_item_sk"], pruned["ss_item_sk"])
    np.testing.assert_array_equal(full["ss_net_paid"], pruned["ss_net_paid"])


def test_fact_nulls_flow_through():
    conn = TpcdsConnector(sf=0.02, units_per_split=1 << 15, device="cpu")
    got = Session({"tpcds": conn}, device="cpu").sql(
        "select count(*) as n, count(ss_sold_date_sk) as nd from store_sales")
    arrays, valids = split_valids(conn.table_numpy("store_sales", ["ss_sold_date_sk"]))
    assert int(got.column("n")[0]) == len(arrays["ss_sold_date_sk"])
    assert int(got.column("nd")[0]) == int(valids["ss_sold_date_sk"].sum())
    assert int(got.column("nd")[0]) < int(got.column("n")[0])
