"""Walls of the 99 TPC-DS queries at SF1 in two checkouts, in turns, on one card.

Run from the root of a checkout, with an earlier commit unpacked under
``local/`` (which ``.gitignore`` lists)::

    mkdir -p local/prev
    git archive <commit> | tar -x -C local/prev
    python3 presto_tpu_torch/tools/tpcds_turns.py --previous local/prev

Each turn is a fresh process in one checkout's root, in the order
previous, this, this, previous. It imports that checkout's
``presto_tpu_torch`` and ``chip_smoke``, builds the kernels, generates
TPC-DS SF1 once (``chip_smoke.generated_once`` and ``prefill``), and runs
each of the 99 queries once through ``Session.sql`` with
``trace_enabled`` off, timing each from a synchronized card to a
synchronized card. This weighs a host-side change (the query lifecycle's
admission walk and fragment spans, say) on phase 16's statements
without the profiler and the CPU-answer workers of ``chip_smoke.py``.

Prints one JSON line per turn (its walls), then each turn's total, the
median per query of this checkout's least wall minus the previous
one's, and the queries that moved most; ``--out PATH`` also writes them
to one JSON file. Needs one card.

``--hooks q22,q7,q3`` instead weighs the query lifecycle's per-query
hooks inside one process of this checkout: each named query runs
``--rounds`` times with the hooks on and bypassed in turns (bypassed:
``QueryManager.run_plan`` reduced to the metric delta around
``executor.run``, ``run_fragment`` to the bare dispatch, every
``check_deadline`` to nothing, the executor's spill estimates to 0), so
process-to-process spread, which the turns above see, is out of the
comparison.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def worker(tree: str) -> dict:
    """One turn in ``tree``: the wall of each TPC-DS query at SF1."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.connectors.tpcds.queries import QUERIES
    from presto_tpu_torch.ops import _build
    from presto_tpu_torch.runtime.session import Session

    assert cs.__file__.startswith(tree), cs.__file__
    _build.build()
    out = {"tree": tree, "walls": {}}
    with cs.generated_once():
        conn = TpcdsConnector(sf=1, device="cuda")
        out["prefill_s"] = cs.prefill(conn)[0]
        session = Session({"tpcds": conn}, properties={"trace_enabled": False}, device="cuda")
        for name, sql in QUERIES.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.sql(sql)
            torch.cuda.synchronize()
            out["walls"][name] = time.perf_counter() - t0
    out["total_s"] = sum(out["walls"].values())
    return out


@contextlib.contextmanager
def hooks_bypassed():
    """The lifecycle's per-query hooks reduced to what ran before them
    (see the module docstring)."""
    from presto_tpu_torch.exec import leaf_route, local_planner, q1_route
    from presto_tpu_torch.runtime import lifecycle
    from presto_tpu_torch.runtime.metrics import QueryMetricsDelta, install_delta, uninstall_delta

    def run_plan(self, executor, plan, info, recorder):
        delta = QueryMetricsDelta()
        token = install_delta(delta)
        try:
            return executor.run(plan)
        finally:
            uninstall_delta(token)
            info.attribute_metrics(delta.snapshot())

    saved = [(lifecycle.QueryManager, "run_plan", run_plan),
             (local_planner, "run_fragment", lambda label, fn: fn()),
             (local_planner, "estimate_node_bytes", lambda node, catalog: 0)]
    saved += [(mod, "check_deadline", lambda where="driver": None)
              for mod in (lifecycle, local_planner, leaf_route, q1_route)]
    saved = [(obj, name, getattr(obj, name), new) for obj, name, new in saved]
    for obj, name, _old, new in saved:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old, _new in saved:
            setattr(obj, name, old)


def hooks(queries: list, rounds: int) -> dict:
    """Walls of ``queries`` at SF1 with the hooks on and bypassed in
    turns, in this process (this checkout)."""
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.connectors.tpcds.queries import QUERIES
    from presto_tpu_torch.ops import _build
    from presto_tpu_torch.runtime.session import Session

    _build.build()
    out = {}
    with cs.generated_once():
        conn = TpcdsConnector(sf=1, device="cuda")
        cs.prefill(conn)
        session = Session({"tpcds": conn}, properties={"trace_enabled": False}, device="cuda")
        for q in queries:
            session.sql(QUERIES[q])
            walls = {"on": [], "bypassed": []}
            for _ in range(rounds):
                for label in walls:
                    cm = hooks_bypassed() if label == "bypassed" else contextlib.nullcontext()
                    with cm:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        session.sql(QUERIES[q])
                        torch.cuda.synchronize()
                        walls[label].append(time.perf_counter() - t0)
            out[q] = walls
            print(f"{q}: " + ", ".join(
                f"{k} median {statistics.median(v):.4f} s of {[round(x, 4) for x in v]}"
                for k, v in walls.items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", help="root of the earlier checkout")
    ap.add_argument("--out", help="also write the turns and the summary here (JSON)")
    ap.add_argument("--hooks", help="comma-separated queries: hooks on / bypassed in turns")
    ap.add_argument("--rounds", type=int, default=5, help="turns per query under --hooks")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.worker:
        print(json.dumps(worker(opts.worker)))
        return 0
    if opts.hooks:
        sys.path.insert(0, str(HERE))
        result = hooks(opts.hooks.split(","), opts.rounds)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {smi.stdout.strip()}")
        if opts.out:
            Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
            Path(opts.out).write_text(json.dumps({"hooks": result, "card": smi.stdout.strip()}))
        return 0
    if not opts.previous:
        ap.error("--previous is required")
    import torch

    if not torch.cuda.is_available():
        print("tpcds_turns: CUDA is not available", file=sys.stderr)
        return 2
    prev = str(Path(opts.previous).resolve())
    here = str(HERE)
    turns = []
    for tree in (prev, here, here, prev):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    this = [t["walls"] for t in turns if t["tree"] == here]
    previous = [t["walls"] for t in turns if t["tree"] == prev]
    diff = {q: min(w[q] for w in this) - min(w[q] for w in previous) for q in this[0]}
    moved = sorted(diff.items(), key=lambda kv: abs(kv[1]), reverse=True)[:5]
    summary = {"card": smi.stdout.strip(),
               "totals_s": [(("this" if t["tree"] == here else "previous"), t["total_s"])
                            for t in turns],
               "median_diff_ms": statistics.median(diff.values()) * 1e3,
               "moved_most_s": moved}
    print(f"turns (previous, this, this, previous): "
          f"{[round(s, 3) for _w, s in summary['totals_s']]} s")
    print(f"this checkout's least wall minus the previous one's, median over the 99: "
          f"{summary['median_diff_ms']:.3f} ms; moved most: "
          f"{[(q, round(d, 3)) for q, d in moved]} s")
    print(f"card: {summary['card']}")
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps({"turns": turns, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
