"""File walking, inline suppressions, and result aggregation.

Port of ``repro.analysis.engine`` (stdlib only, as there), with the port's
suppression marker.  Suppression syntax (same line as the finding):

    v = t.item()                   # rt: ignore[RT005]
    y = risky()                    # rt: ignore          (blanket, any rule)
    z = f(a, b)                    # rt: ignore[RT002, RT004]

An unknown rule ID inside the brackets suppresses nothing (typos fail
loudly as still-active findings rather than silently widening the
ignore).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.rules import RULES, Finding, check_source

# Directory names never walked implicitly.  The fixture corpus under
# tests/analysis_fixtures/ is *deliberately* full of findings — it is
# analyzed only when a fixture file is passed as an explicit argument.
EXCLUDED_DIRS = {
    "__pycache__",
    ".git",
    ".pytest_cache",
    "analysis_fixtures",
    ".repro-xla-cache",
}

_SUPPRESS_RE = re.compile(r"#\s*rt:\s*ignore(?:\[([A-Za-z0-9_,\s]*)\])?", re.IGNORECASE)


def iter_py_files(paths: list[str | Path]) -> list[Path]:
    """Expand files/directories into a sorted list of .py files.

    Explicit file arguments are always included; directories are walked
    recursively minus EXCLUDED_DIRS.
    """
    out: set[Path] = set()
    for p in paths:
        p = Path(p)
        if p.is_file():
            out.add(p)
        elif p.is_dir():
            for f in p.rglob("*.py"):
                if not any(part in EXCLUDED_DIRS for part in f.parts):
                    out.add(f)
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    return sorted(out)


def suppressed_rules_for_line(line: str) -> set[str] | None:
    """Rule IDs suppressed on this line; {"*"} for a blanket ignore;
    None when there is no suppression comment at all."""
    m = _SUPPRESS_RE.search(line)
    if m is None:
        return None
    if m.group(1) is None:
        return {"*"}
    return {tok.strip().upper() for tok in m.group(1).split(",") if tok.strip()}


@dataclass
class AnalysisResult:
    active: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    stale_baseline: list[tuple[str, str, str]] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    files_checked: int = 0

    @property
    def all_findings(self) -> list[Finding]:
        return self.active + self.suppressed + self.baselined

    @property
    def ok(self) -> bool:
        return not self.active and not self.errors


def analyze_paths(
    paths: list[str | Path],
    baseline: Baseline | None = None,
    rules: set[str] | None = None,
) -> AnalysisResult:
    """Run the rule engine over files/directories.

    ``rules`` restricts checking to a subset of rule IDs (default: all).
    Suppressions apply before the baseline, so a line can be cleaned up
    either way without double-counting.
    """
    result = AnalysisResult()
    raw: list[Finding] = []
    for f in iter_py_files(paths):
        path_str = str(f)
        try:
            source = f.read_text(encoding="utf-8")
            findings = check_source(source, path_str)
        except (SyntaxError, UnicodeDecodeError) as e:
            result.errors.append(f"{path_str}: {type(e).__name__}: {e}")
            continue
        result.files_checked += 1
        lines = source.splitlines()
        for finding in findings:
            if rules is not None and finding.rule not in rules:
                continue
            line = lines[finding.line - 1] if 0 < finding.line <= len(lines) else ""
            supp = suppressed_rules_for_line(line)
            if supp is not None and ("*" in supp or finding.rule in supp):
                result.suppressed.append(finding)
            else:
                raw.append(finding)
    if baseline is not None:
        result.active, result.baselined, result.stale_baseline = baseline.partition(raw)
    else:
        result.active = raw
    return result


def unknown_rules(requested: set[str]) -> set[str]:
    return requested - set(RULES)


def parse_ok(source: str) -> bool:
    try:
        ast.parse(source)
        return True
    except SyntaxError:
        return False
