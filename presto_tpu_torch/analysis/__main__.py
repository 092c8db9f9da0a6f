"""CLI: ``python -m presto_tpu_torch.analysis [options] [paths...]``.

With no paths it analyzes ``presto_tpu_torch/`` and ``chip_smoke.py``,
the port's tree.

Exit status: 0 when every finding is suppressed or baselined, 1 when
unsuppressed findings remain, 2 on usage errors — so the tier-1 gate
is a plain shell `||`.
"""

from __future__ import annotations

import argparse
import os
import sys

from presto_tpu_torch.analysis.engine import RULES, analyze


def _default_root() -> str:
    """The repo root: the directory holding the ``presto_tpu_torch``
    package (analysis findings/baselines carry repo-relative paths,
    so the root must be stable no matter the CWD)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.analysis",
        description="engine-invariant static analysis of the port")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to analyze (default: "
                             "presto_tpu_torch/ and chip_smoke.py under "
                             "the repo root)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--rule", action="append", dest="rules",
                        metavar="ID",
                        help="run only this rule id (repeatable)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON path (default: the "
                             "package's analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (report everything)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    import presto_tpu_torch.analysis.rules  # noqa: F401 — registers RULES

    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid}  {r.name} [{r.severity}]\n    {r.description}")
        return 0

    if args.rules:
        unknown = [r for r in args.rules if r not in RULES]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)} "
                  f"(--list-rules shows the catalog)", file=sys.stderr)
            return 2

    root = _default_root()
    paths = args.paths
    if not paths:
        paths = [os.path.join(root, "presto_tpu_torch"),
                 os.path.join(root, "chip_smoke.py")]
        paths = [p for p in paths if os.path.exists(p)]

    result = analyze(
        paths, root=root, rule_ids=args.rules,
        baseline=[] if args.no_baseline else None,
        baseline_path=args.baseline)

    if args.format == "json":
        sys.stdout.write(result.to_json())
    else:
        for f in result.findings:
            print(f.render())
        n = len(result.findings)
        print(f"{n} finding{'s' if n != 1 else ''} "
              f"({len(result.suppressed)} suppressed, "
              f"{len(result.baselined)} baselined)")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
