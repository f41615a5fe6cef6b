"""CLI: `python -m repro_torch.testing.fleetlint [--check] [--json FILE]
PATHS`, the port's copy of the JAX package's fleetlint CLI.

Exit codes: 0 clean, 1 findings, 2 usage error.  `--check` is the CI
spelling (identical semantics, named for intent); `--json FILE` writes
the machine-readable report the CI lint job uploads as an artifact.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.testing.fleetlint.engine import (check_module,
                                                  iter_python_files,
                                                  load_module, report_human,
                                                  report_json)
from repro_torch.testing.fleetlint.rules import default_rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.fleetlint",
        description="contract-enforcing static analysis for the port's "
                    "five planes (docs/static_analysis.md)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to lint")
    ap.add_argument("--check", action="store_true",
                    help="CI mode (same semantics; exit 1 on findings)")
    ap.add_argument("--json", metavar="FILE",
                    help="write the JSON report to FILE ('-' = stdout)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.name}: {r.contract}")
        return 0
    if not args.paths:
        ap.print_usage(sys.stderr)
        print("fleetlint: no paths given", file=sys.stderr)
        return 2

    findings, n_files = [], 0
    for path in iter_python_files(args.paths):
        mod = load_module(path, report_path=path.as_posix(),
                          rel=path.as_posix())
        if mod is None:
            continue
        n_files += 1
        findings.extend(check_module(mod, rules))

    if args.json:
        payload = report_json(findings, rules, n_files)
        if args.json == "-":
            print(payload)
        else:
            Path(args.json).write_text(payload + "\n")
    print(report_human(findings, rules, n_files))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
