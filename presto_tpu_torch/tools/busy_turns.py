"""Device busy time of SF1 statements in two checkouts, in turns, on one card.

Run from the root of a checkout, with an earlier commit unpacked under
``local/`` (which ``.gitignore`` lists)::

    mkdir -p local/prev
    git archive <commit> | tar -x -C local/prev
    python3 presto_tpu_torch/tools/busy_turns.py --previous local/prev

Each turn is a fresh process in one checkout's root, in the order
previous, this, this, previous. It imports that checkout's
``presto_tpu_torch`` and ``chip_smoke``, builds the kernels, and
generates TPC-H SF1 once (``chip_smoke.generated_once`` and
``prefill``). Then, for each statement of ``STATEMENTS``, it runs the
statement twice through ``Session.sql`` with ``narrow_storage`` on, as
``chip_smoke`` phase 7 does, and three more times under the profiler
(``chip_smoke.device_ops``). It keeps each profiled run's device busy ms
and the last one's three device ops with the most time. In this
checkout's turns each statement also runs with ``plan_templates`` off.

Prints one JSON line per turn, then the busy ms per statement and
checkout; ``--out PATH`` also writes them all to one JSON file. Needs
one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

#: (name, where the statement comes from in ``chip_smoke``, key)
STATEMENTS = (("q1", "QUERIES", "q1"), ("q6", "QUERIES", "q6"), ("q3", "QUERIES", "q3"),
              ("q12", "QUERIES", "q12"), ("math", "SURFACE_SQL", "math"))
PROFILED = 3
HERE = Path(__file__).resolve().parents[2]


def worker(tree: str, templates: bool) -> dict:
    """One turn in ``tree``: busy ms of every statement (see the module
    docstring). ``templates``: also with ``plan_templates`` off."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.ops import _build
    from presto_tpu_torch.runtime.session import Session

    assert cs.__file__.startswith(tree), cs.__file__
    _build.build()
    out = {"tree": tree, "statements": {}}
    with cs.generated_once():
        conn = cs.TpchConnector(sf=1, device="cuda")
        out["prefill_s"] = cs.prefill(conn)[0]
        for name, where, key in STATEMENTS:
            sql = getattr(cs, where)[key]
            variants = {"default": {"narrow_storage": True}}
            if templates:
                variants["templates off"] = {"narrow_storage": True, "plan_templates": False}
            for label, props in variants.items():
                session = Session({"tpch": conn}, properties=props, device="cuda")
                for _ in range(2):
                    session.sql(sql)
                torch.cuda.synchronize()
                busy, ops = [], []
                for _ in range(PROFILED):
                    b, _scan_s, ops = cs.device_ops(session, conn, sql)
                    busy.append(b)
                out["statements"][f"{name} {label}"] = {
                    "busy_ms": busy, "top": [(k, ms, c) for k, ms, c in ops[:3]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", help="root of the earlier checkout")
    ap.add_argument("--out", help="also write the turns and the summary here (JSON)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--templates", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.worker:
        print(json.dumps(worker(opts.worker, opts.templates)))
        return 0
    if not opts.previous:
        ap.error("--previous is required")
    import torch

    if not torch.cuda.is_available():
        print("busy_turns: CUDA is not available", file=sys.stderr)
        return 2
    prev = str(Path(opts.previous).resolve())
    here = str(HERE)
    turns = []
    for tree in (prev, here, here, prev):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", tree]
        if tree == here:
            cmd.append("--templates")
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    summary = {"card": smi.stdout.strip(), "busy_ms": {}}
    for t in turns:
        which = "this" if t["tree"] == here else "previous"
        for k, v in t["statements"].items():
            summary["busy_ms"].setdefault(f"{k} ({which})", []).extend(v["busy_ms"])
    for k, v in summary["busy_ms"].items():
        print(f"{k}: median {statistics.median(v):.3f} ms of {v}")
    print(f"card: {summary['card']}")
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps({"turns": turns, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
