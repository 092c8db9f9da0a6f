"""The oracles' inputs and their independence.

- ``table_logical``, on the TPC-H, SSB and TPC-DS connectors and on a
  memory table made by CREATE TABLE AS, equals the JAX package's
  ``table_pandas`` of the same table: the column order, the values, the
  NULL positions and the dtype kind (the exact dtype of a number);
- ``presto_tpu_torch/oracle/*.py`` imports only numpy, the standard
  library and ``presto_tpu_torch.oracle``: no torch, no engine module, no
  connector (the caller passes the frames in).
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from presto_tpu.connectors.ssb import SsbConnector as JSsb
from presto_tpu.connectors.tpcds import TpcdsConnector as JTpcds
from presto_tpu.connectors.tpch import TpchConnector as JTpch
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.ssb import SsbConnector
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.oracle.frame import isnull
from presto_tpu_torch.runtime.session import Session as PSession
from torch_bridge import TPCDS_SF, TPCDS_UNITS

ROOT = Path(__file__).resolve().parent.parent
ORACLE_FILES = sorted((ROOT / "presto_tpu_torch" / "oracle").glob("*.py"))


def assert_same_table(got, want: pd.DataFrame, name: str) -> None:
    assert got.columns == list(want.columns), name
    assert len(got) == len(want), name
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c]
        wv = w.to_numpy()
        if wv.dtype.kind in "iufb":
            assert g.dtype == wv.dtype, f"{name}.{c}: {g.dtype} != {wv.dtype}"
        elif wv.dtype.kind == "M":
            assert g.dtype.kind == "M", f"{name}.{c}: {g.dtype}"
        else:  # object, and pandas' strings
            assert g.dtype == object, f"{name}.{c}: {g.dtype}"
        gnull, wnull = isnull(g), w.isna().to_numpy()
        assert (gnull == wnull).all(), f"{name}.{c}: NULL positions"
        gl, wl = g[~gnull], wv[~wnull]
        if wv.dtype.kind == "M":
            gl, wl = gl.astype("datetime64[s]"), wl.astype("datetime64[s]")
        assert np.array_equal(gl, wl) if gl.dtype != object else \
            gl.tolist() == list(wl), f"{name}.{c}: values"


CONNECTORS = {
    "tpch": (lambda: JTpch(sf=0.005, units_per_split=1 << 14),
             lambda: TpchConnector(sf=0.005, units_per_split=1 << 14, device="cpu")),
    "ssb": (lambda: JSsb(sf=0.02), lambda: SsbConnector(sf=0.02, device="cpu")),
    "tpcds": (lambda: JTpcds(sf=TPCDS_SF, units_per_split=TPCDS_UNITS),
              lambda: TpcdsConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS,
                                     device="cpu")),
}
CASES = [(schema, table) for schema, (_, make) in CONNECTORS.items()
         for table in make().tables()]


@pytest.fixture(scope="module")
def conns():
    return {schema: (j(), p()) for schema, (j, p) in CONNECTORS.items()}


@pytest.mark.parametrize("schema,table", CASES)
def test_table_logical_equals_table_pandas(conns, schema, table):
    jconn, pconn = conns[schema]
    assert_same_table(pconn.table_logical(table), jconn.table_pandas(table),
                      f"{schema}.{table}")


@pytest.mark.parametrize("schema,table,cols", [
    ("tpch", "orders", ["o_comment", "o_orderkey", "o_orderdate"]),
    ("ssb", "customer", ["c_city", "c_custkey"]),
    ("tpcds", "customer", ["c_birth_year", "c_customer_id", "c_current_addr_sk"]),
])
def test_table_logical_of_chosen_columns(conns, schema, table, cols):
    """``columns``: only those columns, in the order asked, NULLs where the
    reference has them."""
    jconn, pconn = conns[schema]
    assert_same_table(pconn.table_logical(table, cols), jconn.table_pandas(table, cols),
                      f"{schema}.{table}")


def test_table_logical_of_a_memory_table():
    """A CTAS table holding NULLs, dates, decimals, dictionary strings and
    padded bytes: the memory connector's ``table_logical`` equals the
    reference memory connector's ``table_pandas`` of the same statement."""
    sql = ("create table t as select l_orderkey, l_shipdate, l_extendedprice, "
           "l_returnflag, l_comment, case when l_linenumber = 1 then null "
           "else l_quantity end q from lineitem where l_orderkey < 300")
    js = JSession({"tpch": JTpch(sf=0.01)})
    ps = PSession({"tpch": TpchConnector(sf=0.01, device="cpu")}, device="cpu")
    js.sql(sql)
    ps.sql(sql)
    want = js.catalog.connector("memory").table_pandas("t")
    assert want.q.isna().any()
    assert_same_table(ps.catalog.connector("memory").table_logical("t"), want, "t")
    cols = ["q", "l_comment"]
    assert_same_table(ps.catalog.connector("memory").table_logical("t", cols),
                      js.catalog.connector("memory").table_pandas("t", cols), "t")


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: relative import"
            out.add(node.module)
    return out


def test_the_scan_covers_the_oracles():
    assert [p.name for p in ORACLE_FILES] == [
        "__init__.py", "frame.py", "ssb_oracle.py", "tpcds_oracle.py", "tpch_oracle.py"]


@pytest.mark.parametrize("path", ORACLE_FILES, ids=lambda p: p.name)
def test_oracle_imports_only_numpy_and_the_standard_library(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        ok = (root == "numpy" or root in sys.stdlib_module_names or root == "__future__"
              or mod == "presto_tpu_torch.oracle" or mod.startswith("presto_tpu_torch.oracle."))
        assert ok, f"{path.name} imports {mod}"
