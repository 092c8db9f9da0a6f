"""Helpers for the port's differential tests (``test_torch_*.py``).

Carry types and batches from the JAX package (the reference) to the
PyTorch port as numpy arrays, so both packages see the same inputs; run
one statement through each package's ``Session.sql`` with the route
counters it bumps (``jax_run``, ``port_run``).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

import presto_tpu_torch.types as PT
from presto_tpu_torch.batch import Batch as PBatch
from presto_tpu_torch.batch import Dictionary as PDictionary

# One intra-op thread in every process that imports this module: every
# ``test_torch_*.py`` does, so every pytest-xdist worker runs the port's
# CPU tensors single-threaded. With torch's default pool (one thread a
# core) six workers on an eight-core host oversubscribe the cores, and a
# sort over a few hundred thousand rows then takes minutes, not a second.
torch.set_num_threads(1)


def port_type(t) -> PT.DataType:
    """The port's DataType equal to a JAX-package DataType."""
    return PT.DataType(PT.TypeKind(t.kind.value), t.precision, t.scale, t.width, t.phys)


def port_dictionary(d):
    return None if d is None else PDictionary(list(d.values))


def port_batch(jb, device="cpu") -> PBatch:
    """A JAX-package Batch rebuilt in the port through ``Batch.from_arrays``:
    a column whose validity WAS the JAX batch's live array gets the port
    batch's live tensor object."""
    live = np.asarray(jb.live)
    columns, types, dicts = {}, {}, {}
    for name, c in jb.columns.items():
        if c.valid is jb.live:
            valid = live
        elif c.valid is None:
            valid = None
        else:
            valid = np.asarray(c.valid)
        columns[name] = (np.asarray(c.data), valid)
        types[name] = port_type(c.dtype)
        dicts[name] = port_dictionary(c.dictionary)
    return PBatch.from_arrays(columns, live, types, dicts, device=device)


def to_numpy(x) -> np.ndarray:
    """Host copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what: str = "") -> None:
    """Exact equality of values AND dtypes (by numpy name)."""
    g, w = to_numpy(got), to_numpy(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def same_frame(res, want, what: str = "") -> None:
    """The port's ``QueryResult`` equals the JAX package's frame: the same
    columns in order, each equal in values and dtype (``port_frame``)."""
    got = port_frame(res)
    assert list(got.columns) == list(want.columns), what
    for c in want.columns:
        assert_same(got[c].to_numpy(), want[c].to_numpy(), f"{what} {c}")


def port_frame(res):
    """The port's ``QueryResult`` as the JAX package's ``Session.sql``
    builds its frame: one frame per result batch, concatenated (pandas
    infers each batch's column dtypes apart, so a UNION branch with NULL
    keys makes its column ``object`` there)."""
    import pandas as pd

    parts = {name: res.parts(name) for name in res.names}
    n = len(parts[res.names[0]]) if res.names else 0
    frames = [pd.DataFrame({name: p[i] for name, p in parts.items()}) for i in range(n)]
    if not frames:
        return pd.DataFrame(columns=res.names)
    return pd.concat(frames, ignore_index=True)[list(res.names)]


#: the route counters the SQL differential tests compare; the runtime
#: join filters' scanned and pruned row counts among them
ROUTES = ("join.strategy.", "exec.pallas_join_route", "join.pallas_fallback", "agg.strategy.",
          "exec.leaf_", "exec.q1_", "join.filter_rows_")


def jax_run(conn, sql, key="tpch"):
    """(frame, route counters) of ``sql`` through the JAX package's
    ``Session.sql`` over ``conn`` alone (result cache off)."""
    from presto_tpu.runtime.metrics import REGISTRY
    from presto_tpu.runtime.session import Session as JSession

    before = REGISTRY.snapshot()
    df = JSession({key: conn}, properties={"result_cache_enabled": False}).sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after.get(k, 0) - before.get(k, 0) for k in after if k.startswith(ROUTES)}
    return df, {k: int(v) for k, v in routes.items() if v}


def port_run(conn, sql, key="tpch"):
    """(QueryResult, route counters, session) of ``sql`` through the
    port's ``Session.sql`` over ``conn`` alone, on the CPU (a before /
    after ``REGISTRY.snapshot()`` diff, as ``jax_run``)."""
    from presto_tpu_torch.runtime.metrics import REGISTRY
    from presto_tpu_torch.runtime.session import Session as PSession

    before = REGISTRY.snapshot()
    session = PSession({key: conn}, device="cpu")
    res = session.sql(sql)
    after = REGISTRY.snapshot()
    routes = {k: after.get(k, 0) - before.get(k, 0) for k in after if k.startswith(ROUTES)}
    return res, {k: int(v) for k, v in routes.items() if v}, session


#: the port's ``REGISTRY.snapshot()`` at the last :func:`mark_counters`
_MARK: dict = {}


def mark_counters() -> None:
    """Start a count: :func:`counters` reads the moves from here."""
    from presto_tpu_torch.runtime.metrics import REGISTRY

    global _MARK
    _MARK = REGISTRY.snapshot()


def counters() -> collections.Counter:
    """The port's registry moves since :func:`mark_counters` (a before /
    after ``REGISTRY.snapshot()`` diff), name -> amount (0 for a name that
    did not move): every name whose total changed, and every name created
    since the mark (after a ``REGISTRY.reset()``, a name added 0 too)."""
    from presto_tpu_torch.runtime.metrics import REGISTRY

    after = REGISTRY.snapshot()
    moves = {k: v - _MARK.get(k, 0.0) for k, v in after.items()
             if k not in _MARK or v != _MARK[k]}
    return collections.Counter({k: int(v) if v == int(v) else v for k, v in moves.items()})


# ---------------------------------------------------------------------------
# TPC-DS: the 99 queries through the port against the reference's oracle
# ---------------------------------------------------------------------------

#: the reference test's settings (``tests/test_tpcds_sql.py``): its
#: literals were tuned to return rows at sf 0.02
TPCDS_SF = 0.02
TPCDS_UNITS = 1 << 15

#: queries whose port run takes over about 20 s in one worker on the CPU
#: at ``TPCDS_SF`` (46-527 s with one thread, four modules at once; in
#: q10 the sort strategy's group ids, one stable argsort a key, take most
#: of it); they run under ``-m slow``
TPCDS_SLOW = {"q10", "q35", "q64", "q91"}


class LazyTables(dict):
    """The oracle's input frames, decoded on first use by the reference
    connector's ``table_pandas`` (``customer_demographics`` alone is
    1.92M rows at any scale factor)."""

    def __init__(self, conn):
        super().__init__()
        self.conn = conn

    def __missing__(self, table):
        frame = self[table] = self.conn.table_pandas(table)
        return frame


def tpcds_params(lo: int, hi: int) -> list:
    """The queries q<lo>..q<hi>, each a test case (``TPCDS_SLOW`` marked
    slow)."""
    import pytest

    return [pytest.param(f"q{i}", marks=pytest.mark.slow) if f"q{i}" in TPCDS_SLOW
            else f"q{i}" for i in range(lo, hi + 1)]


def tpcds_oracle_env():
    """(port session on the CPU, lazily decoded oracle tables) at the
    reference test's settings."""
    from presto_tpu.connectors.tpcds import TpcdsConnector as JConnector
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.runtime.session import Session as PSession

    conn = TpcdsConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS, device="cpu")
    return (PSession({"tpcds": conn}, device="cpu"),
            LazyTables(JConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS)))


def check_tpcds_query(env, name: str) -> None:
    """The port's answer to TPC-DS ``name`` equals the reference's pandas
    oracle under ``tests/test_tpch_sql.compare`` (the contract of the
    reference's own ``test_tpcds_query_matches_oracle``)."""
    from presto_tpu.oracle.tpcds_oracle import ORACLES
    from presto_tpu_torch.connectors.tpcds.queries import QUERIES
    from test_tpch_sql import compare

    session, tables = env
    got = port_frame(session.sql(QUERIES[name]))
    want = ORACLES[name](tables)
    assert len(want) > 0, f"{name}: oracle returned no rows (bad constants)"
    compare(got, want, name)


#: the analyzer's refusals the tests name by their construct, with the
#: words both packages raise (ROADMAP C22)
ANALYZER_REFUSALS = {
    "<> correlation in a scalar subquery": "<> correlation in scalar subquery unsupported",
    "uncorrelated EXISTS": "uncorrelated EXISTS not supported",
}


def refused_alike(jax_call, port_call):
    """Both calls raise, with the same class name and the same words
    (what ``QueryInfo``'s error, the ``query_failed`` event and the
    CLI's ``error:`` line carry). Returns the port's error."""
    try:
        jax_call()
    except Exception as e:  # noqa: BLE001 - the refusal is the answer
        jerr = e
    else:
        raise AssertionError("the JAX package answered")
    try:
        port_call()
    except Exception as e:  # noqa: BLE001 - the refusal is the answer
        perr = e
    else:
        raise AssertionError(f"the port answered where the JAX package raised {jerr!r}")
    assert (type(perr).__name__, str(perr)) == (type(jerr).__name__, str(jerr))
    return perr


# ---------------------------------------------------------------------------
# Observability: the divergences the differential tests take out
# (ROADMAP C14, C17) and a fault injector that counts its reaches
# ---------------------------------------------------------------------------

#: metric families absent from the port's ``QueryInfo.metrics`` (ROADMAP
#: C17): ``exec.traces`` counts XLA traces, which the port has none of
C17_FAMILIES = ("exec.traces",)

#: spans the port does not record (ROADMAP C14, closed: the
#: ``degrade_to_local`` span came with the distributed joins)
C14_SPANS = ()

#: a histogram snapshot's quantile keys
_QUANTILES = ("p50", "p95", "p99", "max")


def comparable_metrics(metrics: dict) -> dict:
    """``QueryInfo.metrics`` without the C17 families (plain or under
    ``post_run.``), timers and histograms by ``.count`` only where their
    values are wall times: the totals, and the quantiles of a histogram
    of seconds (a name ending ``_s``, e.g. ``fragment.dispatch_s``)."""
    out = {}
    for k, v in metrics.items():
        name = k[len("post_run."):] if k.startswith("post_run.") else k
        if name.startswith(C17_FAMILIES) or k.endswith((".total", ".total_s")):
            continue
        base, _dot, stat = name.rpartition(".")
        if stat in _QUANTILES and base.endswith("_s"):
            continue
        out[k] = v
    return out


def span_tree(rec) -> list:
    """(name, cat, depth) of each span in recording order, C14's spans
    taken out and their children lifted to the parent."""
    depth = {}
    out = []
    for s in rec.spans:
        parent = -1 if s.parent_id < 0 else depth[s.parent_id]
        if s.name.startswith(C14_SPANS):
            depth[s.span_id] = parent
            continue
        depth[s.span_id] = parent + 1
        out.append((s.name, s.cat, parent + 1))
    return out


def counting_injector(base):
    """A ``FaultInjector`` subclass (of either package's ``base``) that
    counts every ``check(site)`` reach in ``reaches`` (site -> calls)."""

    class CountingInjector(base):
        def __post_init__(self):
            super().__post_init__()
            self.reaches = collections.Counter()

        def check(self, site: str) -> None:
            self.reaches[site] += 1
            super().check(site)

    return CountingInjector


def _oracle_kind(a: np.ndarray) -> str:
    """The kind of an oracle answer's column: a NULL-able number (float64,
    or object holding numbers and None/NaN), an integer, a string, a date
    or a bool."""
    k = a.dtype.kind
    if k in "iu":
        return "int"
    if k in "fc":
        return "number"
    if k in "mM":
        return "date"
    if k == "b":
        return "bool"
    live = [v for v in a.tolist() if v is not None and v == v]
    if live and all(isinstance(v, str) for v in live):
        return "str"
    if all(isinstance(v, (int, float, np.number)) and not isinstance(v, bool) for v in live):
        return "number"
    return "object"


def assert_oracle_equal(got, want, name: str, rounded=()) -> None:
    """The port's numpy oracle answer ``got`` (an ``oracle.frame.Frame``)
    equals the reference's pandas answer ``want``: the same column names
    and row count, the rows in the reference's order, float64 columns
    within rtol = atol = 1e-9 (one unit of the last place of a column the
    reference rounds: ``rounded`` maps it to its decimals), every other
    column exact with NULL where the reference has NULL. A NULL-able
    integer column may come back float64 (or, with no NULL, int64) where
    pandas keeps it object (ROADMAP C29): both are numbers."""
    assert list(got.columns) == list(want.columns), (
        f"{name}: columns {got.columns} != {list(want.columns)}")
    assert len(got) == len(want), f"{name}: {len(got)} rows != {len(want)}"
    g = {c: np.asarray(got[c].to_numpy()) for c in got.columns}
    w = {c: want[c].to_numpy() for c in want.columns}
    rounded = dict(rounded)
    for c in want.columns:
        gv, wv = g[c], np.asarray(w[c])
        if wv.dtype.kind not in "biufcmMO":  # pandas' string arrays
            wv = np.asarray(wv, dtype=object)
        gk, wk = _oracle_kind(gv), _oracle_kind(wv)
        assert gk == wk or (wv.dtype == object and wk == "number" and gk == "int"), \
            f"{name}: column {c} kind {gk} != {wk}"
        gnull = np.array([v is None or v != v for v in gv.tolist()], bool) \
            if gk != "date" else np.isnat(gv)
        wnull = np.array([v is None or v != v for v in wv.tolist()], bool) \
            if wk != "date" else np.isnat(wv)
        assert (gnull == wnull).all(), f"{name}: column {c} NULLs differ"
        gl, wl = gv[~gnull], wv[~wnull]
        if wk == "date":
            assert (gl.astype("datetime64[s]") == wl.astype("datetime64[s]")).all(), \
                f"{name}: column {c}"
        elif wk in ("number", "int") and wv.dtype.kind not in "iu":
            tol = 10.0 ** -rounded[c] if c in rounded else 1e-9
            np.testing.assert_allclose(gl.astype(np.float64), wl.astype(np.float64),
                                       rtol=1e-9, atol=tol, err_msg=f"{name}: column {c}")
        else:
            assert gl.tolist() == wl.tolist(), f"{name}: column {c}"


def selects_rows(want) -> bool:
    """Whether a reference oracle answer rests on rows: it has a row, and
    a one-row answer is not all 0 or NaN in its numbers (a SUM over no
    rows)."""
    if len(want) != 1:
        return len(want) > 1
    nums = [v for v in want.iloc[0].tolist()
            if isinstance(v, (int, float, np.number)) and not isinstance(v, bool)]
    return not nums or any(v == v and v != 0 for v in nums)


def edited_tables(tables, edits):
    """Both sides' oracle tables (reference, port) with each edit (table,
    column, rows, value) applied to copies of the same rows on both
    sides; the tables no edit touches are the ones given."""
    from collections import ChainMap

    jt, pt = tables
    jnew, pnew = {}, {}
    for table, col, rows, value in edits:
        if table not in jnew:
            jnew[table], pnew[table] = jt[table].copy(), pt[table].copy()
        j = jnew[table]
        j.iloc[rows, j.columns.get_loc(col)] = value
        p = np.asarray(pnew[table][col].to_numpy()).copy()
        p[rows] = value
        pnew[table][col] = p
    return ChainMap(jnew, jt), ChainMap(pnew, pt)


#: the columns the reference's TPC-DS oracle rounds (to these decimals):
#: the port's may differ there by one unit of the last place
TPCDS_ROUNDED = {"q2": {c: 2 for c in ("r_sun", "r_mon", "r_fri", "r_sat")},
                 "q49": {"return_ratio": 6}, "q78": {"ratio": 2}}


def tpcds_oracle_tables():
    """(reference tables, port tables) for the oracles at the reference
    test's scale: the JAX connector's ``table_pandas`` frames and the
    port connector's ``table_logical`` frames, each decoded on first use."""
    from presto_tpu.connectors.tpcds import TpcdsConnector as JConnector
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.oracle import frame

    conn = TpcdsConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS, device="cpu")
    return (LazyTables(JConnector(sf=TPCDS_SF, units_per_split=TPCDS_UNITS)),
            frame.LazyTables(conn.table_logical))


def check_tpcds_oracle(tables, name: str) -> None:
    """The port's numpy oracle for TPC-DS ``name`` equals the reference's
    pandas oracle on the same generated data."""
    from presto_tpu.oracle.tpcds_oracle import ORACLES as JORACLES
    from presto_tpu_torch.oracle.tpcds_oracle import ORACLES

    jt, pt = tables
    want = JORACLES[name](jt)
    assert len(want) > 0, f"{name}: reference oracle returned no rows"
    assert_oracle_equal(ORACLES[name](pt), want, name, TPCDS_ROUNDED.get(name, {}))
