"""CLI / REPL: ``python -m presto_tpu_torch``.

Counterpart of ``presto_tpu/__main__.py``: the ``presto-cli``-shaped
console over one in-process ``Session`` — an interactive statement loop
with EXPLAIN / EXPLAIN ANALYZE, ``SET SESSION`` / ``SHOW SESSION`` /
``SHOW TABLES``, one-shot ``-e`` and ``-f`` modes, and the ``metrics``,
``flightrec``, ``health`` and ``serve`` commands. Results print as a
plain table (the JAX package prints a pandas frame; the port imports no
pandas) with the same ``(n rows)`` footer and ``[x.xxxs]`` wall line.
Queries run on the card unless ``--device cpu`` is given; without a GPU
the default raises. ``--mesh N`` runs the session distributed over an
N-shard mesh of the session's device (``parallel/mesh.make_mesh``; on
the CPU N logical shards), and ``EXPLAIN (TYPE DISTRIBUTED)`` renders a
plan's fragments and exchanges.

Examples::

    python -m presto_tpu_torch --catalog tpch --sf 1
    python -m presto_tpu_torch --catalog tpcds --sf 0.01 \
        -e "select count(*) from store_sales"
    python -m presto_tpu_torch --device cpu metrics -f queries.sql
    python -m presto_tpu_torch --mesh 1 -e "select count(*) from lineitem"
    python -m presto_tpu_torch serve --port 0 --sf 1
"""

from __future__ import annotations

import argparse
import sys
import time

from presto_tpu_torch.runtime.errors import NotSupported


def make_connector(catalog: str, sf: float, device="cuda"):
    if catalog == "tpch":
        from presto_tpu_torch.connectors.tpch import TpchConnector

        return TpchConnector(sf=sf, device=device)
    if catalog == "tpcds":
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector

        return TpcdsConnector(sf=sf, device=device)
    if catalog == "ssb":
        from presto_tpu_torch.connectors.ssb import SsbConnector

        return SsbConnector(sf=sf, device=device)
    raise SystemExit(f"unknown catalog {catalog!r} (tpch, tpcds, ssb)")


HELP = """\
Statements end with ';'. Besides SQL:
  EXPLAIN <query>;            show the optimized plan
  EXPLAIN ANALYZE <query>;    execute and annotate the plan with actuals
  SET SESSION <name> = <value>;
  SHOW SESSION;               list session properties
  SHOW TABLES;                list tables in the catalog
  HELP;  QUIT; / EXIT;
"""


def split_statements(text: str) -> list[str]:
    """Split on ';' outside single/double-quoted strings (a quoted
    ``';'`` must not end a statement)."""
    out, buf, quote = [], [], None
    for ch in text:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
            buf.append(ch)
        elif ch == ";":
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if "".join(buf).strip():
        out.append("".join(buf))
    return [s for s in out if s.strip()]


def cell_text(v) -> str:
    """One printed cell: NULL, or the value's own ``str`` (a numpy
    scalar prints the shortest text that reads back to it)."""
    return "NULL" if v is None else str(v)


def table_rows(result) -> list[list[str]]:
    """A ``QueryResult``'s rows as printed cells, in row order."""
    cols = [[cell_text(v) for v in result.logical(n)] for n in result.names]
    return [list(r) for r in zip(*cols)]


def format_table(result, max_rows: int) -> str:
    """The table ``run_statement`` prints: a header of column names and
    at most ``max_rows`` rows, each column right-aligned to its widest
    cell (``...`` when rows were left out)."""
    rows = table_rows(result)
    shown = rows[:max_rows]
    widths = [max([len(n)] + [len(r[i]) for r in shown])
              for i, n in enumerate(result.names)]
    lines = [" ".join(n.rjust(w) for n, w in zip(result.names, widths))]
    lines += [" ".join(c.rjust(w) for c, w in zip(r, widths)) for r in shown]
    if len(rows) > len(shown):
        lines.append("...")
    return "\n".join(lines)


def _print_result(result, max_rows: int):
    print(format_table(result, max_rows))
    print(f"({len(result)} row{'s' if len(result) != 1 else ''})")


def run_statement(session, stmt: str, max_rows: int = 100) -> bool:
    """Execute one statement; returns False to quit the loop."""
    s = stmt.strip().rstrip(";").strip()
    if not s:
        return True
    low = s.lower()
    if low in ("quit", "exit"):
        return False
    if low == "help":
        print(HELP, end="")
        return True
    if low == "show session":
        for name, value, desc in session.show_session():
            print(f"{name} = {value}")
            print(f"    {desc}")
        return True
    if low == "show tables":
        for cat, conn in session.catalog.connectors.items():
            for t in conn.tables():
                print(f"{cat}.{t}")
        return True
    if low.startswith("set session"):
        rest = s[len("set session"):].strip()
        if "=" not in rest:
            print("usage: SET SESSION <name> = <value>", file=sys.stderr)
            return True
        name, _, value = rest.partition("=")
        value = value.strip().strip("'\"")
        try:
            session.set_property(name.strip(), value)
            print(f"SET {name.strip()} = {session.prop(name.strip())}")
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
        except NotSupported as e:  # a route this session's device cannot take
            print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return True
    try:
        if low.startswith("explain analyze"):
            print(session.explain_analyze(s[len("explain analyze"):]))
        elif low.startswith("explain (type distributed)"):
            n = len("explain (type distributed)")
            print(session.explain_distributed(s[n:]))
        elif low.startswith("explain"):
            print(session.explain(s[len("explain"):]))
        else:
            t0 = time.perf_counter()
            res = session.sql(s)
            wall = time.perf_counter() - t0
            _print_result(res, max_rows)
            print(f"[{wall:.3f}s]")
    except Exception as e:  # noqa: BLE001 - the REPL survives bad statements
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
    return True


def repl(session, max_rows: int):
    print("presto-tpu REPL — HELP; for commands, QUIT; to leave")
    buf: list[str] = []
    while True:
        try:
            prompt = "presto> " if not buf else "     -> "
            line = input(prompt)
        except EOFError:
            print()
            return
        except KeyboardInterrupt:
            buf.clear()
            print()
            continue
        buf.append(line)
        joined = "\n".join(buf)
        if ";" not in line:
            continue
        buf.clear()
        if not run_statement(session, joined, max_rows):
            return


def load_tenants(path):
    """Tenant config JSON -> (specs, total_slots). Accepts a bare list
    of {name, weight?, max_concurrent?, max_bytes?, slo_latency_s?,
    slo_freshness_s?} objects or {"total_slots": N, "tenants": [...]}."""
    import json

    from presto_tpu_torch.server.scheduler import TenantSpec

    with open(path) as f:
        cfg = json.load(f)
    total = None
    rows = cfg
    if isinstance(cfg, dict):
        total = cfg.get("total_slots")
        rows = cfg.get("tenants", [])
    specs = [
        TenantSpec(r["name"], float(r.get("weight", 1.0)),
                   r.get("max_concurrent"), r.get("max_bytes"),
                   r.get("slo_latency_s"), r.get("slo_freshness_s"))
        for r in rows
    ]
    return specs, total


def health_report(session) -> str:
    """``python -m presto_tpu_torch health``: a top-style plain-text
    snapshot of serving health — device telemetry, the watchdog's latest
    vitals and breach ledger, per-tenant SLO burn rates, and the
    heaviest recent queries. Works on a bare session too (the device and
    query sections always render; the watchdog and SLO sections say when
    absent)."""
    from presto_tpu_torch.runtime.devices import sample_devices

    lines = ["== devices =="]
    for d in sample_devices():
        lines.append(
            f"  device {d['device_id']} ({d['platform']}): "
            f"in_use={d['bytes_in_use']} peak={d['peak_bytes']} "
            f"limit={d['bytes_limit']} "
            f"dispatch_wall={d['dispatch_wall_s']:.3f}s "
            f"dispatches={d['dispatches']}")
    lines.append("== health ==")
    mon = getattr(session, "health", None)
    if mon is None:
        lines.append("  (no watchdog: attach a QueryServer, or "
                     "health_monitor=false)")
    else:
        samples = mon.snapshot()
        if samples:
            last = samples[-1]
            lines.append(
                f"  qps={last['qps']:.2f} p50={last['p50_s']:.4f}s "
                f"p99={last['p99_s']:.4f}s queue={last['queue_depth']} "
                f"pool={last['pool_occupancy']:.0%} "
                f"cache_hit={last['cache_hit_rate']:.0%} "
                f"lag={last['freshness_lag_s']:.1f}s "
                f"burn={last['slo_burn']:.2f}")
        for b in mon.breaches():
            lines.append(f"  BREACH [{b['reason']}] "
                         f"p99={b['p99_s']:.4f}s "
                         f"query={b.get('query_id', '-')}")
    lines.append("== slo ==")
    slo = getattr(session, "slo", None)
    rows = slo.snapshot() if slo is not None else []
    if not rows:
        lines.append("  (no observations)")
    for r in rows:
        lines.append(
            f"  {r['tenant']}: latency {r['latency_good']}/"
            f"{r['latency_good'] + r['latency_breach']} good "
            f"(burn={r['latency_burn_rate']:.2f}, "
            f"objective={r['latency_objective_s']}s), freshness "
            f"burn={r['freshness_burn_rate']:.2f}")
    lines.append("== top queries (by execution_s) ==")
    infos = sorted(session.history.infos(),
                   key=lambda i: i.execution_s, reverse=True)[:10]
    if not infos:
        lines.append("  (no completed queries)")
    for i in infos:
        lines.append(
            f"  {i.query_id} {i.state:>8} {i.execution_s:8.4f}s "
            f"tenant={i.tenant or '-'} "
            f"device_peak={i.device_peak_bytes} "
            f"{' '.join(i.sql.split())[:60]}")
    return "\n".join(lines)


def serve(session, args) -> None:
    """``python -m presto_tpu_torch serve``: the multi-tenant HTTP front
    end over one session, with graceful SIGINT shutdown — stop
    accepting, drain in-flight queries (pool reservations release on
    every terminal state), flush the flight recorder when --flight-out
    is given, and print one summary line."""
    import signal
    import threading

    from presto_tpu_torch.server.frontend import HttpFrontend, QueryServer

    # the serving layer exists to exploit load shape: batched dispatch
    # defaults on unless the operator explicitly set the property
    if "batched_dispatch" not in session.properties:
        session.set_property("batched_dispatch", True)
    tenants, total_slots = (load_tenants(args.tenants)
                            if args.tenants else ([], None))
    server = QueryServer(session=session, tenants=tenants,
                         total_slots=total_slots)
    http = HttpFrontend(server, host=args.host, port=args.port)
    stop = threading.Event()

    def on_sigint(signum, frame):
        # first ^C: the graceful drain below; a second ^C falls through
        # to the default handler (hard exit)
        signal.signal(signal.SIGINT, signal.default_int_handler)
        stop.set()

    signal.signal(signal.SIGINT, on_sigint)
    ten = ", ".join(s.name for s in tenants) or "(open admission)"
    print(f"presto-tpu serving on http://{args.host}:{http.port} "
          f"— tenants: {ten}; ^C drains and exits", flush=True)
    # the HTTP loop runs on a worker thread: httpd.shutdown() deadlocks
    # when called from the thread inside serve_forever (the SIGINT
    # handler runs on the main thread's stack), so the main thread waits
    # for the signal and then drives the drain
    http.start_background()
    try:
        stop.wait()
    finally:
        http.shutdown()
        summary = server.shutdown(drain_timeout_s=30.0,
                                  flight_path=args.flight_out)
        print(f"drained={summary['drained']} "
              f"inflight={summary['inflight']} "
              f"pool_reserved_bytes={summary['pool_reserved_bytes']} "
              f"flight_records={summary['flight_records']}"
              + (f" -> {args.flight_out}" if args.flight_out else ""),
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("command", nargs="?", default=None,
                    help="optional subcommand: 'metrics' prints the "
                         "process metrics registry as OpenMetrics/"
                         "Prometheus text after any -e/-f statements "
                         "run, then exits; 'flightrec' prints the "
                         "flight-recorder post-mortem ring as JSON the "
                         "same way; 'serve' starts the multi-tenant HTTP "
                         "front end on --port with graceful SIGINT drain; "
                         "'health' prints a top-style serving-health "
                         "snapshot after any -e/-f statements run")
    ap.add_argument("--catalog", default="tpch",
                    help="tpch | tpcds | ssb (default tpch)")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="scale factor (default 0.01)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run distributed over an N-device mesh")
    ap.add_argument("-e", "--execute", default=None, metavar="SQL",
                    help="execute one statement and exit")
    ap.add_argument("-f", "--file", default=None,
                    help="execute ';'-separated statements from a file")
    ap.add_argument("--max-rows", type=int, default=100)
    ap.add_argument("--session", action="append", default=[],
                    metavar="NAME=VALUE", help="initial session property")
    ap.add_argument("--host", default="127.0.0.1",
                    help="serve: bind address (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=8080,
                    help="serve: HTTP port (default 8080; 0 = ephemeral)")
    ap.add_argument("--tenants", default=None, metavar="CFG",
                    help="serve: JSON tenant config file — either a "
                         "list of {name, weight, max_concurrent, "
                         "max_bytes} objects or {'total_slots': N, "
                         "'tenants': [...]}")
    ap.add_argument("--flight-out", default=None, metavar="PATH",
                    help="serve: write the flight-recorder ring as "
                         "JSON to PATH during graceful shutdown")
    args = ap.parse_args(argv)

    if args.command not in (None, "metrics", "flightrec", "serve",
                            "health"):
        raise SystemExit(
            f"unknown command {args.command!r} "
            "('metrics', 'flightrec', 'serve', 'health')")
    from presto_tpu_torch.devices import resolve_device
    from presto_tpu_torch.runtime.session import Session

    device = resolve_device(args.device)
    props = {}
    for kv in args.session:
        name, _, value = kv.partition("=")
        props[name.strip()] = value.strip()
    mesh = None
    if args.mesh is not None:
        from presto_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh, device=device)
    conn = make_connector(args.catalog, args.sf, device)
    session = Session({args.catalog: conn}, properties=props, device=device, mesh=mesh)

    if args.command == "serve":
        return serve(session, args)
    ran = False
    if args.execute is not None:
        run_statement(session, args.execute, args.max_rows)
        ran = True
    if args.file is not None:
        with open(args.file) as f:
            text = f.read()
        for stmt in split_statements(text):
            run_statement(session, stmt, args.max_rows)
        ran = True
    if args.command == "metrics":
        # the -e/-f statements above run first, so `metrics -e "<sql>"`
        # scrapes the metrics that query moved
        print(session.export_metrics(), end="")
        return
    if args.command == "flightrec":
        # the dump-on-failure workflow: -e/-f statements run first (the
        # loop keeps the session alive through failures), then every
        # captured post-mortem dumps as JSON
        print(session.export_flight_record())
        return
    if args.command == "health":
        print(health_report(session))
        return
    if ran:
        return
    repl(session, args.max_rows)


if __name__ == "__main__":
    main()
