"""``python -m presto_tpu_torch`` against ``python -m presto_tpu``.

- ``split_statements`` equals the reference's, quoted semicolons
  included;
- ``run_statement`` on the same statements in both packages (sessions
  over TPC-H at sf 0.01): HELP, SHOW TABLES, SET SESSION (and its
  refusals), the ``(n rows)`` footers and every ``error:`` line equal
  byte for byte, the four analyzer refusals of ROADMAP C22 among them;
  the walls masked; each printed table the port's layout of the
  reference frame's values, cell for cell; SHOW SESSION's ``name =
  value`` lines equal but for ``degrade_to_local`` (not ported yet);
- ``EXPLAIN (TYPE DISTRIBUTED)`` printing the reference's fragments and
  ``--mesh 2 -e`` printing the reference mesh session's table (ROADMAP
  C24, closed), the default ``--device cuda`` refused without a GPU;
- ``main`` with ``--device cpu``: the REPL loop, ``-e`` / ``-f``,
  ``metrics``, ``flightrec`` and ``health``;
- ``chip_smoke``'s phase 22 on the CPU at sf 0.01: its in-process part
  (``run_cli_queries``) and the ``serve`` subprocess answering Q1 over
  HTTP and draining on SIGINT (``run_cli_serve``).
"""

import io
import json
import re
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import presto_tpu.__main__ as JC
import presto_tpu_torch.__main__ as PC
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.runtime.session import Session as JSession
from presto_tpu_torch.connectors.tpch import TpchConnector as PConnector
from presto_tpu_torch.connectors.tpch.queries import QUERIES
from presto_tpu_torch.runtime.session import Session as PSession

#: the reference's properties the port has not ported yet (the
#: distributed-to-local degradation)
A10 = ("degrade_to_local",)

WALL = re.compile(r"^\[\d+\.\d{3}s\]$")
FOOTER = re.compile(r"^\((\d+) rows?\)$")


@pytest.fixture(scope="module")
def conns():
    return JConnector(sf=0.01), PConnector(sf=0.01, device="cpu")


@pytest.fixture()
def sessions(conns):
    props = {"result_cache_enabled": False}
    return (JSession({"tpch": conns[0]}, properties=props),
            PSession({"tpch": conns[1]}, properties=props, device="cpu"))


def printed(run_statement, session, stmt):
    """(stdout lines, stderr text, return value) of one statement."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        keep = run_statement(session, stmt)
    return out.getvalue().splitlines(), err.getvalue(), keep


@pytest.mark.parametrize("text", [
    "select 1; select 2",
    "select ';' as s; select 2;",
    'select "a;b" from t; ;; select \'x\'\'y;\' ',
    "select 1 -- no end",
    "",
])
def test_split_statements_equals_reference(text):
    assert PC.split_statements(text) == JC.split_statements(text)


#: statements whose whole output is not a table: equal byte for byte
PLAIN = [
    "help",
    "show tables",
    "set session direct_group_limit = 64",
    "set session partial_agg_bypass = 'false'",
    "set session pallas_strings = false",
    "set session query_retries = -1",
    "set session direct_group_limit = lots",
    "set session no_such_property = 1",
    "set session direct_group_limit",
    "quit",
    # the analyzer's refusals (ROADMAP C22)
    "select count(*) from nation where exists (select 1 from region)",
    "select count(*) from nation n where n_nationkey > (select count(*) from region r "
    "where r.r_regionkey <> n.n_regionkey)",
    "select count(*) from nation where exists (select * from region "
    "where r_regionkey = n_regionkey) = true",
    "select interval '1' day",
    "select date '1998-12-01' - interval '1' day * 90",
    # refusals at run time, and a parse error
    "select count(*) from customer where c_phone in (select s_phone from supplier)",
    "select count(*) from customer c join supplier s on c.c_phone = s.s_name",
    "select count(*) from part where p_name = p_type",
    "select x'ab' from nation",
    "select no_such_column from nation",
]


def without_a10(text: str) -> str:
    """An unknown-property refusal lists the known names: the port's list
    lacks the distributed properties."""
    for name in A10:
        text = text.replace(f"{name}, ", "")
    return text


@pytest.mark.parametrize("stmt", PLAIN)
def test_plain_lines_equal_reference(sessions, stmt):
    js, ps = sessions
    lines, err, keep = printed(JC.run_statement, js, stmt)
    assert printed(PC.run_statement, ps, stmt) == (lines, without_a10(err), keep)


#: statements answered with a table
TABLES = {
    "q1": QUERIES["q1"],
    "q3": QUERIES["q3"],
    "q6": QUERIES["q6"],
    "names with blanks": "select n_name, n_regionkey from nation where n_name like 'UNITED%' "
                         "order by n_name",
    "NULLs": "select c_custkey, o_orderkey from customer left join orders "
             "on c_custkey = o_custkey and o_totalprice > 500000 where c_custkey < 5 "
             "order by c_custkey",
    "no rows": "select r_name from region where r_regionkey > 10",
    "one row": "select count(*) as n from nation",
}


class _Frame:
    """The reference frame through the port's printer's reading
    interface: column names, logical values (NaN as NULL), row count."""

    def __init__(self, df):
        self.df, self.names = df, list(df.columns)

    def __len__(self):
        return len(self.df)

    def logical(self, name):
        vals = self.df[name].to_numpy()
        if vals.dtype.kind == "M":
            vals = vals.astype("datetime64[D]")
        return [None if (v is None or (isinstance(v, float) and np.isnan(v))) else v
                for v in vals]


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_print_the_reference_values(sessions, name):
    js, ps = sessions
    sql = TABLES[name]
    want_lines, want_err, _ = printed(JC.run_statement, js, sql)
    got_lines, got_err, _ = printed(PC.run_statement, ps, sql)
    assert got_err == want_err == ""
    # the footer and the wall line close both outputs
    assert FOOTER.match(got_lines[-2]) and WALL.match(got_lines[-1])
    assert got_lines[-2] == want_lines[-2] and WALL.match(want_lines[-1])
    want = js.sql(sql)
    assert got_lines[:-2] == PC.format_table(_Frame(want), 100).splitlines()


def test_max_rows_cuts_the_table_not_the_footer(sessions):
    _js, ps = sessions
    lines, _err, _ = printed(lambda s, q: PC.run_statement(s, q, max_rows=3), ps,
                             "select n_nationkey from nation order by n_nationkey")
    assert lines[1:5] == ["          0", "          1", "          2", "..."]
    assert lines[-2] == "(25 rows)"


def test_show_session_lines_equal_reference(sessions):
    js, ps = sessions
    want, _e, _k = printed(JC.run_statement, js, "show session")
    got, _e, _k = printed(PC.run_statement, ps, "show session")

    def values(lines):
        return [ln for ln in lines if not ln.startswith("    ")
                and ln.split(" = ")[0] not in A10]

    assert values(got) == values(want)
    assert len(values(got)) == len(got) // 2


def test_distributed_explain_and_mesh_are_refused(sessions):
    """ROADMAP C24, closed: ``EXPLAIN (TYPE DISTRIBUTED)`` prints the
    reference's fragments byte for byte, and ``--device cpu --mesh 2 -e``
    runs on a 2-shard mesh and prints the reference mesh session's table
    (its footer and wall line too)."""
    from presto_tpu.parallel.mesh import make_mesh as jmesh

    js, ps = sessions
    for sql in ("select 1", QUERIES["q3"], QUERIES["q1"]):
        stmt = "explain (type distributed) " + sql
        assert printed(PC.run_statement, ps, stmt) == printed(JC.run_statement, js, stmt)
    sql = ("select l_orderkey, sum(l_quantity) as q from lineitem group by l_orderkey "
           "order by q desc, l_orderkey limit 5")
    out, err = run_main(["--mesh", "2", "-e", sql])
    jout, jerr = io.StringIO(), io.StringIO()
    with redirect_stdout(jout), redirect_stderr(jerr):
        JC.main(["--mesh", "2", "-e", sql])
    lines, jlines = out.splitlines(), jout.getvalue().splitlines()
    assert err == jerr.getvalue() == ""
    assert lines[-2] == jlines[-2] == "(5 rows)" and WALL.match(lines[-1])
    want = JSession({"tpch": JConnector(sf=0.01)}, mesh=jmesh(2)).sql(sql)
    assert lines[:-2] == PC.format_table(_Frame(want), 100).splitlines()


def test_default_device_is_the_card(capsys):
    if torch.cuda.is_available():
        PC.main(["-e", "select 1"])
        assert capsys.readouterr().out.splitlines()[-2] == "(1 row)"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PC.main(["-e", "select 1"])


def run_main(argv, stdin=None, monkeypatch=None):
    out, err = io.StringIO(), io.StringIO()
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    with redirect_stdout(out), redirect_stderr(err):
        PC.main(["--device", "cpu"] + argv)
    return out.getvalue(), err.getvalue()


def test_repl_runs_statements_until_quit(monkeypatch):
    out, err = run_main([], stdin="select count(*)\n as n from region;\nhelp;\nquit;\n"
                        "select 1;\n", monkeypatch=monkeypatch)
    lines = out.splitlines()
    assert lines[0].startswith("presto-tpu REPL")
    assert "(1 row)" in out and "SHOW TABLES;" in out and err == ""
    # the statement after QUIT never ran
    assert out.count("(1 row)") == 1


def test_execute_and_file(tmp_path):
    script = tmp_path / "s.sql"
    script.write_text("select count(*) as n from region;\nselect 'a;b' as s from region "
                      "where r_regionkey = 0;\n")
    out, err = run_main(["-f", str(script), "-e", "select 1 as one"])
    assert err == ""
    assert [ln for ln in out.splitlines() if FOOTER.match(ln)] == ["(1 row)"] * 3
    assert "a;b" in out.splitlines()


def test_metrics_flightrec_and_health():
    from presto_tpu_torch.runtime.metrics import REGISTRY

    out, err = run_main(["metrics", "-e", QUERIES["q6"]])
    assert err == ""
    key = "presto_tpu_exec_leaf_fused_route_total "
    (line,) = [ln for ln in out.splitlines() if ln.startswith(key)]
    assert float(line[len(key):]) == REGISTRY.snapshot()["exec.leaf_fused_route"]
    failing = "select count(*) from customer where c_phone in (select s_phone from supplier)"
    out, err = run_main(["flightrec", "-e", failing])
    assert err == "error: NotImplementedError: wide string semi-join keys\n"
    (record,) = json.loads(out)
    assert record["state"] == "FAILED" and record["sql"] == failing
    assert record["errorCode"] == "NOT_SUPPORTED" and record["planRender"]
    out, err = run_main(["health", "-e", "select count(*) as n from nation"])
    sections = [ln for ln in out.splitlines() if ln.startswith("== ")]
    assert sections == ["== devices ==", "== health ==", "== slo ==",
                        "== top queries (by execution_s) =="]
    assert "  device 0 (cpu): in_use=0" in out and "select count(*) as n from nation" in out


def test_chip_smoke_phase22_on_the_cpu():
    """Phase 22's in-process part at sf 0.01 on the CPU: every printed
    answer against numpy, the metrics text against the registry, one
    profiler trace a profiled query, the LIKE after ``pallas_strings`` off
    and on (both taken on the CPU, whose one route is the plain version:
    ROADMAP C23 closed), ``health`` and ``flightrec``."""
    import chip_smoke

    out = chip_smoke.run_cli_queries(0.01, device="cpu")
    assert set(out["walls"]) == {f"{q} {t}" for q in ("q1", "q6", "q3")
                                 for t in ("first", "profiled")}
    assert out["traced"] == []  # no CUDA kernel on the CPU
    assert out["probe_err"] == {"exists": 0, "payload": 0} and out["q1_err"] == 0


def test_serve_subprocess_answers_and_drains():
    """``python -m presto_tpu_torch serve --device cpu --port 0``: Q1 over
    HTTP against numpy, then SIGINT and ``pool_reserved_bytes=0``."""
    import chip_smoke

    out = chip_smoke.run_cli_serve(0.01, device="cpu")
    assert out["drain"].startswith("drained=True inflight=0 pool_reserved_bytes=0 ")
