"""Structured findings — the analyzer's one output type.

A :class:`Finding` is a machine-checkable claim that one source
location violates one engine invariant. Everything downstream —
text rendering, the JSON exposition the CI gate diffs, suppression
matching, and the reviewed baseline — keys off the fields here, so
the schema is versioned (:data:`SCHEMA_VERSION`) and additions must
be backward compatible (tests pin the field set).

Baseline identity is the ``(rule, path, anchor)`` triple, where
``anchor`` is the stripped source line text: line NUMBERS drift on
every unrelated edit above a finding, but the flagged line itself
only changes when the finding's subject changes — exactly when the
entry must be justified again.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: bump only with a migration note in README — tests pin this
SCHEMA_VERSION = 1

#: severity ladder; both levels fail the clean-mode gate (a "warning"
#: is advisory in *message tone*, not in enforcement — an invariant
#: either holds or it does not)
SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    #: how to fix it (or how to suppress it legitimately)
    hint: str = ""
    #: stripped source text of the flagged line — the baseline anchor
    anchor: str = ""
    #: extra rule-specific context (kept JSON-scalar valued)
    data: dict = field(default_factory=dict, compare=False, hash=False)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
            "anchor": self.anchor,
            "data": dict(self.data),
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}"
                + (f"\n    hint: {self.hint}" if self.hint else ""))

    @property
    def baseline_key(self) -> tuple:
        return (self.rule, self.path, self.anchor)
