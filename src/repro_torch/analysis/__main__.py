"""CLI: ``python -m repro_torch.analysis <paths>`` / console script ``repro-torch-analysis``.

Exit codes: 0 clean (or everything suppressed/baselined), 1 active
findings or unparseable files, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.engine import analyze_paths, unknown_rules
from repro_torch.analysis.rules import RULES


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-analysis",
        description="Static analysis of the PyTorch/CUDA port's own rules (RT001-RT005).",
    )
    p.add_argument("paths", nargs="*", help="files or directories to analyze")
    p.add_argument(
        "--baseline",
        default=None,
        metavar="PATH",
        help=f"baseline JSON (default: {DEFAULT_BASELINE} if it exists)",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="regenerate the baseline from current findings and exit 0",
    )
    p.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="RTnnn",
        help="restrict to specific rule IDs (repeatable)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--list-rules", action="store_true", help="print the rule catalogue")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule_id, desc in sorted(RULES.items()):
            print(f"{rule_id}: {desc}")
        return 0

    if not args.paths:
        print("error: no paths given (try: python -m repro_torch.analysis src/repro_torch chip_smoke.py tools tests)",
              file=sys.stderr)
        return 2

    rules = None
    if args.rule:
        rules = {r.upper() for r in args.rule}
        bad = unknown_rules(rules)
        if bad:
            print(f"error: unknown rule(s): {', '.join(sorted(bad))}", file=sys.stderr)
            return 2

    baseline_path = args.baseline
    if baseline_path is None and Path(DEFAULT_BASELINE).is_file():
        baseline_path = DEFAULT_BASELINE

    baseline = None
    if baseline_path is not None and Path(baseline_path).is_file() and not args.write_baseline:
        try:
            baseline = Baseline.load(baseline_path)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            print(f"error: bad baseline file {baseline_path}: {e}", file=sys.stderr)
            return 2

    try:
        result = analyze_paths(args.paths, baseline=baseline, rules=rules)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        out = baseline_path or DEFAULT_BASELINE
        prior_notes = {}
        if Path(out).is_file():
            try:
                prior_notes = Baseline.load(out).notes
            except (ValueError, KeyError, json.JSONDecodeError):
                pass
        Baseline.from_findings(result.active, notes=prior_notes).save(out)
        print(f"wrote {len(result.active)} finding(s) to {out}")
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "files_checked": result.files_checked,
                    "active": [f.__dict__ for f in result.active],
                    "suppressed": [f.__dict__ for f in result.suppressed],
                    "baselined": [f.__dict__ for f in result.baselined],
                    "stale_baseline": [list(k) for k in result.stale_baseline],
                    "errors": result.errors,
                    "ok": result.ok,
                },
                indent=2,
            )
        )
    else:
        for f in result.active:
            print(f.format())
        for err in result.errors:
            print(f"ERROR {err}")
        for rule, path, digest in result.stale_baseline:
            print(f"stale baseline entry: {rule} {path} ({digest})", file=sys.stderr)
        n_act, n_sup, n_bl = len(result.active), len(result.suppressed), len(result.baselined)
        print(
            f"{result.files_checked} file(s) checked: {n_act} active, "
            f"{n_sup} suppressed, {n_bl} baselined"
            + (f", {len(result.errors)} error(s)" if result.errors else ""),
            file=sys.stderr,
        )

    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
