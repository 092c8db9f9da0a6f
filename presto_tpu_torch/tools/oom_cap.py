"""``chip_smoke.real_oom`` (phase 19's allocator OOM) repeated, with free
bytes left inside the caching allocator's segments, on one card.

Run from the root of a checkout; ``--tree`` names a checkout whose
``chip_smoke.py`` and ``presto_tpu_torch`` to use (default: this one)::

    python3 presto_tpu_torch/tools/oom_cap.py --slack-gib 4 --rounds 3
    python3 presto_tpu_torch/tools/oom_cap.py --tree local/prev --slack-gib 4

Builds the kernels and generates TPC-H SF1 once (``chip_smoke.generated_once``
and ``prefill``). Each round first takes ``--slack-gib`` GiB as one tensor,
frees it and keeps four 2 MiB tensors carved from its segment, so
``empty_cache()`` cannot return that segment and its free bytes stay
reserved, as the tensors earlier phases keep leave them in a whole
``chip_smoke.py`` run. Then it calls ``real_oom`` and prints one JSON line:
whether it passed, its outcome and the cap, or the error it raised.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".", help="checkout whose chip_smoke.py to run")
    ap.add_argument("--slack-gib", type=float, default=4.0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.connectors.tpch import TpchConnector

    assert cs.__file__.startswith(tree), cs.__file__
    cs._build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    with cs.generated_once():
        cs.prefill(TpchConnector(sf=1, device="cuda"))
        conn = TpchConnector(sf=1, device="cuda")
        want = {"q3": cs.q3_expected(conn), "hicard_agg": cs.hicard_expected(conn)}
        for k in range(args.rounds):
            big = torch.empty(int(args.slack_gib * 2**30), dtype=torch.uint8, device="cuda")
            del big
            keep = [torch.empty(2 << 20, dtype=torch.uint8, device="cuda") for _ in range(4)]
            torch.cuda.empty_cache()
            row = {"tree": tree, "round": k, "reserved": torch.cuda.memory_reserved(),
                   "allocated": torch.cuda.memory_allocated()}
            try:
                out = cs.real_oom(conn, want, "cuda")
                row.update(ok=True, **{key: out[key] for key in out
                                       if key not in ("rung_history", "peaks")})
            except Exception as e:  # noqa: BLE001 -- the round's result
                row.update(ok=False, error=repr(e)[:300])
            print(json.dumps(row), flush=True)
            del keep
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
