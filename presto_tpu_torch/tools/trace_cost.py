"""The host cost of span tracing on the card: the 99 TPC-DS queries at SF1.

Run from the root of a checkout::

    python3 presto_tpu_torch/tools/trace_cost.py [--out PATH]

It builds the kernels and generates TPC-DS SF1 once
(``chip_smoke.generated_once`` and ``prefill``), runs every query once
to warm, then, query by query, four more runs through ``Session.sql`` in
turns: ``trace_enabled`` on, off, off, on. No profiler runs and no other
process shares the host. It prints the sum over the queries of the least
wall of each side, the median and the extremes of on minus off a query,
and the spans each query records (``TraceRecorder.spans``) and drops;
``--out`` also writes every wall and span count as JSON. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the walls and span counts here as JSON")
    args = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.ops import _build
    from presto_tpu_torch.runtime.session import Session

    if not torch.cuda.is_available():
        print("trace_cost: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build()
    with cs.generated_once():
        conn = TpcdsConnector(sf=1, device="cuda")
        print("generated TPC-DS SF1 (s, GiB):", cs.prefill(conn), flush=True)
        queries = cs._tpcds_queries()
        sessions = {on: Session({"tpcds": conn}, properties={"trace_enabled": on},
                                device="cuda") for on in (True, False)}
        for sql in queries.values():
            sessions[False].sql(sql)
        walls: dict = {True: {}, False: {}}
        spans = {}
        for name, sql in queries.items():
            for on in (True, False, False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sessions[on].sql(sql)
                torch.cuda.synchronize()
                walls[on].setdefault(name, []).append(time.perf_counter() - t0)
            rec = sessions[True].traces.latest()
            spans[name] = (len(rec.spans), rec.dropped)
    on = {q: min(v) for q, v in walls[True].items()}
    off = {q: min(v) for q, v in walls[False].items()}
    diff = sorted((1e3 * (on[q] - off[q]), q) for q in on)
    counts = [n for n, _d in spans.values()]
    print(f"sum of least walls: on {sum(on.values()):.3f} s, off {sum(off.values()):.3f} s")
    print(f"on - off ms: median {statistics.median(d for d, _q in diff):.3f}, largest "
          f"{[(q, round(d, 2)) for d, q in diff[-5:]]}, smallest "
          f"{[(q, round(d, 2)) for d, q in diff[:5]]}")
    print(f"spans a query: median {statistics.median(counts):g}, max {max(counts)} "
          f"({max(spans, key=lambda q: spans[q][0])}), dropped "
          f"{sum(d for _n, d in spans.values())}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"on": walls[True], "off": walls[False], "spans": spans}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
