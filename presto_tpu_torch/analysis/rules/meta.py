"""Analyzer meta rules (PT0xx): the linter linting its own escape
hatches."""

from __future__ import annotations

from typing import Iterator

from presto_tpu_torch.analysis.engine import ModuleInfo, Rule, register
from presto_tpu_torch.analysis.findings import Finding


@register
class SuppressionWithoutReason(Rule):
    id = "PT001"
    name = "suppression-without-reason"
    severity = "error"
    description = (
        "a `# presto-lint: ignore[...]` comment without a `-- reason` "
        "tail; it does NOT suppress (see ModuleInfo.suppression_for) — "
        "this finding makes the silent no-op loud")
    motivation = (
        "reasonless-noqa rot: an unexplained suppression outlives the "
        "code it excused and nobody dares delete it")

    def check_module(self, mod: ModuleInfo, project) -> Iterator:
        for sup in mod.suppressions:
            if not sup.reason:
                yield Finding(
                    rule=self.id, severity=self.severity, path=mod.rel,
                    line=sup.line, col=0,
                    message=("presto-lint suppression without a reason "
                             "(use `# presto-lint: ignore[ID] -- why`)"),
                    hint="every suppression must say why it is sound",
                    anchor=mod.source_line(sup.line))
