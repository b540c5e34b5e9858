"""Baseline file support: grandfather known findings without suppressing
the rule globally.

Port of ``repro.analysis.baseline`` (stdlib only, as there).  The
baseline is a checked-in JSON file (default
``.repro-torch-analysis-baseline.json`` at the repo root).  Entries match on
``(rule, path, sha1-of-stripped-source-line)`` with a count, NOT on line
numbers, so unrelated edits that shift a grandfathered line do not break
the build.  Each entry carries a free-form ``note`` explaining why the
finding is acceptable — a baseline entry without a reason is just a
suppression with extra steps.

Workflow:

* ``python -m repro_torch.analysis <paths> --write-baseline`` regenerates the
  file from the current findings (notes on surviving entries are kept).
* A finding whose (rule, path, line-hash) is in the baseline is reported
  as *baselined* and does not fail the run.
* Baseline entries that no longer match anything are *stale*: the run
  still passes but prints them, so the file shrinks as debt is paid.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.rules import Finding

DEFAULT_BASELINE = ".repro-torch-analysis-baseline.json"
_VERSION = 1


def line_hash(source_line: str) -> str:
    return hashlib.sha1(source_line.strip().encode("utf-8")).hexdigest()[:16]


def _key(rule: str, path: str, digest: str) -> tuple[str, str, str]:
    return (rule, path.replace("\\", "/"), digest)


@dataclass
class Baseline:
    entries: Counter = field(default_factory=Counter)
    notes: dict[tuple[str, str, str], str] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        raw = json.loads(Path(path).read_text())
        if raw.get("version") != _VERSION:
            raise ValueError(f"unsupported baseline version in {path}: {raw.get('version')!r}")
        bl = cls()
        for e in raw.get("entries", []):
            key = _key(e["rule"], e["path"], e["hash"])
            bl.entries[key] += int(e.get("count", 1))
            if e.get("note"):
                bl.notes[key] = e["note"]
        return bl

    @classmethod
    def from_findings(cls, findings: list[Finding], notes: dict | None = None) -> "Baseline":
        bl = cls()
        for f in findings:
            bl.entries[_key(f.rule, f.path, line_hash(f.source_line))] += 1
        if notes:
            bl.notes.update(notes)
        return bl

    def save(self, path: str | Path):
        entries = []
        for (rule, fpath, digest), count in sorted(self.entries.items()):
            entry = {"rule": rule, "path": fpath, "hash": digest, "count": count}
            note = self.notes.get((rule, fpath, digest))
            if note:
                entry["note"] = note
            entries.append(entry)
        Path(path).write_text(
            json.dumps({"version": _VERSION, "entries": entries}, indent=2) + "\n"
        )

    def partition(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[tuple[str, str, str]]]:
        """Split findings into (active, baselined) and report stale entries.

        Matching consumes baseline counts, so a second occurrence of the
        same line in the same file needs count=2 in the baseline.
        """
        budget = Counter(self.entries)
        active: list[Finding] = []
        baselined: list[Finding] = []
        for f in findings:
            key = _key(f.rule, f.path, line_hash(f.source_line))
            if budget[key] > 0:
                budget[key] -= 1
                baselined.append(f)
            else:
                active.append(f)
        stale = sorted(key for key, left in budget.items() if left > 0)
        return active, baselined, stale
