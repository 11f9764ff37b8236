"""CLI: ``python -m repro_torch.analysis [--strict] [paths...]``.

Exit status: 0 when clean (no unwaived findings; under ``--strict``
additionally every waiver carries a reason), 1 otherwise.  ``--report``
writes the rule → count → waived summary JSON (the CI artifact
``ANALYSIS_report.json``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.core import PASS_REGISTRY, analyze


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Control-plane static analysis of the port (AST "
                    "invariant passes).")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files/directories to scan "
                             "(default: src/repro_torch)")
    parser.add_argument("--strict", action="store_true",
                        help="also fail on waivers without a -- reason")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule subset (default: all)")
    parser.add_argument("--tests-dir", default="tests",
                        help="test tree for oracle-parity cross-refs")
    parser.add_argument("--report", default=None, metavar="PATH",
                        help="write summary JSON (rule → count → waived)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the summary JSON to stdout instead of "
                             "human-readable findings")
    parser.add_argument("--list-rules", action="store_true",
                        help="list registered rules and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis import passes  # noqa: F401
        for rule in sorted(PASS_REGISTRY):
            print(f"{rule}: {PASS_REGISTRY[rule].description}")
        return 0

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        report = analyze(args.paths, tests_dir=args.tests_dir, rules=rules)
    except (ValueError, OSError, SyntaxError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.report:
        out = Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report.to_json(), indent=2) + "\n")

    if args.as_json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        for f in report.findings:
            print(f.format())
        for path, line, rs in report.reasonless_waivers:
            sev = "error" if args.strict else "warning"
            print(f"{path}:{line}: {sev}: waiver for {', '.join(rs)} "
                  f"has no '-- <reason>'")
        n_waived = len(report.waived)
        print(f"{report.files_scanned} files, "
              f"{len(report.rules_run)} rules: "
              f"{len(report.unwaived)} unwaived finding(s), "
              f"{n_waived} waived")
    return 0 if report.ok(strict=args.strict) else 1


if __name__ == "__main__":
    sys.exit(main())
