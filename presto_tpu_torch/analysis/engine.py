"""Rule engine: file walking, suppression, baseline, orchestration.

The analyzer is a *whole-project* pass over stdlib-``ast`` trees — no
third-party deps, no imports of the analyzed code (analysis must work
on a box without torch or a CUDA device). Rules come in two
scopes: per-module (most) and per-project (cross-module facts like
lock-ordering cycles). Each rule is a singleton registered in
:data:`RULES`; the CLI and tests enumerate that registry, so adding a
rule is one module in ``analysis/rules/`` plus a catalog line in the
README's port section.

Two escape hatches, both reviewable in diffs:

- inline: ``# presto-lint: ignore[RULE-ID] -- reason`` on the flagged
  line or the line directly above. The reason is MANDATORY — a
  suppression without one does not suppress and instead raises the
  meta-finding ``PT001`` (so "I'll explain later" cannot land).
- baseline: ``presto_tpu_torch/analysis/baseline.json`` holds reviewed, justified
  grandfathered findings keyed by ``(rule, path, anchor-line-text)``
  — content-anchored so unrelated edits above a finding do not orphan
  the entry, while any edit to the flagged line itself forces a
  re-review.
"""

from __future__ import annotations

import ast
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Iterable, Iterator, Optional

from presto_tpu_torch.analysis.findings import Finding

#: directories never analyzed (generated/vendored/VCS state)
SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "notes"}

_SUPPRESS_RE = re.compile(
    r"#\s*presto-lint:\s*ignore\[([A-Za-z0-9*,\s-]+)\]"
    r"(?:\s*--\s*(.*\S))?")


@dataclass
class Suppression:
    line: int
    rules: tuple
    reason: str


class ModuleInfo:
    """One parsed source file plus the derived maps every rule needs."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        #: repo-relative path — what findings and the baseline carry
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        self.suppressions = self._parse_suppressions(text)
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    @property
    def is_test(self) -> bool:
        base = os.path.basename(self.rel)
        return ("tests" + os.sep) in self.rel or \
            self.rel.startswith("tests/") or base.startswith("test_") or \
            base == "conftest.py"

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, severity: str, node: ast.AST,
                message: str, hint: str = "", **data) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, severity=severity, path=self.rel,
                       line=line, col=getattr(node, "col_offset", 0),
                       message=message, hint=hint,
                       anchor=self.source_line(line), data=data)

    @staticmethod
    def _parse_suppressions(text: str) -> "list[Suppression]":
        out = []
        try:
            toks = tokenize.generate_tokens(StringIO(text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    rules = tuple(r.strip() for r in m.group(1).split(",")
                                  if r.strip())
                    out.append(Suppression(tok.start[0], rules,
                                           (m.group(2) or "").strip()))
        except tokenize.TokenError:
            pass
        return out

    def suppression_for(self, finding: Finding) -> Optional[Suppression]:
        """Same-line or directly-preceding-line match; ``*`` matches
        every rule. Reasonless suppressions never match (PT001 flags
        them instead)."""
        for sup in self.suppressions:
            if not sup.reason:
                continue
            if sup.line not in (finding.line, finding.line - 1):
                continue
            if "*" in sup.rules or finding.rule in sup.rules:
                return sup
        return None


class Rule:
    """One invariant check. Subclasses set the class attrs and override
    one (or both) of the check hooks."""

    id: str = ""
    name: str = ""
    severity: str = "error"
    description: str = ""
    #: the historical bug that motivated the rule (README catalog)
    motivation: str = ""

    def check_module(self, mod: ModuleInfo,
                     project: "Project") -> Iterator[Finding]:
        return iter(())

    def check_project(self, project: "Project") -> Iterator[Finding]:
        return iter(())


#: rule-id -> singleton (populated by analysis.rules imports)
RULES: "dict[str, Rule]" = {}


def register(cls):
    """Class decorator: instantiate and index the rule by id."""
    inst = cls()
    assert inst.id and inst.id not in RULES, f"duplicate rule {inst.id}"
    RULES[inst.id] = inst
    return cls


class Project:
    """All analyzed modules plus cross-module lookup helpers."""

    def __init__(self, modules: "list[ModuleInfo]", root: str):
        self.modules = modules
        self.root = root
        self.by_rel = {m.rel: m for m in modules}

    def engine_modules(self) -> "list[ModuleInfo]":
        return [m for m in self.modules if not m.is_test]

    def test_modules(self) -> "list[ModuleInfo]":
        return [m for m in self.modules if m.is_test]


def _iter_py_files(paths: Iterable[str], root: str) -> Iterator[str]:
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in SKIP_DIRS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def load_project(paths: "Iterable[str]", root: Optional[str] = None
                 ) -> Project:
    """Parse every ``.py`` under ``paths`` (files or directories).
    Unparseable files are skipped — the syntax gate (compileall) owns
    those; the linter must not double-report."""
    root = os.path.abspath(root or os.getcwd())
    modules = []
    seen = set()
    for path in _iter_py_files(paths, root):
        if path in seen:
            continue
        seen.add(path)
        rel = os.path.relpath(path, root)
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            modules.append(ModuleInfo(path, rel, text))
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
    return Project(modules, root)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str] = None) -> "list[dict]":
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", [])
    for e in entries:
        assert e.get("reason"), \
            f"baseline entry without a reason: {e!r}"
    return entries


@dataclass
class AnalysisResult:
    findings: "list[Finding]" = field(default_factory=list)
    suppressed: "list[tuple[Finding, Suppression]]" = \
        field(default_factory=list)
    baselined: "list[tuple[Finding, dict]]" = field(default_factory=list)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_json(self) -> str:
        from presto_tpu_torch.analysis.findings import SCHEMA_VERSION

        return json.dumps({
            "version": SCHEMA_VERSION,
            "findings": [f.to_dict() for f in self.findings],
            "counts": {
                "open": len(self.findings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
            },
        }, indent=2, sort_keys=True) + "\n"


def analyze(paths: "Iterable[str]", root: Optional[str] = None,
            rule_ids: "Optional[Iterable[str]]" = None,
            baseline: "Optional[list[dict]]" = None,
            baseline_path: Optional[str] = None) -> AnalysisResult:
    """Run the (selected) rules over ``paths`` and partition raw
    findings into open / suppressed / baselined."""
    import presto_tpu_torch.analysis.rules  # noqa: F401 — registers RULES

    project = load_project(paths, root)
    selected = [RULES[r] for r in rule_ids] if rule_ids else \
        list(RULES.values())
    raw: "list[Finding]" = []
    for rule in selected:
        for mod in project.modules:
            raw.extend(rule.check_module(mod, project))
        raw.extend(rule.check_project(project))
    if rule_ids:
        raw = [f for f in raw if f.rule in set(rule_ids)]
    raw.sort(key=lambda f: (f.path, f.line, f.rule, f.col))

    entries = baseline if baseline is not None else \
        load_baseline(baseline_path)
    bl_index: "dict[tuple, dict]" = {}
    for e in entries:
        bl_index[(e["rule"], e["path"], e["anchor"])] = e

    result = AnalysisResult()
    for f in raw:
        mod = project.by_rel.get(f.path)
        sup = mod.suppression_for(f) if mod is not None else None
        if sup is not None:
            result.suppressed.append((f, sup))
            continue
        ent = bl_index.get(f.baseline_key)
        if ent is not None:
            result.baselined.append((f, ent))
            continue
        result.findings.append(f)
    return result
