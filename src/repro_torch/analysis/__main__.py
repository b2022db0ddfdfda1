"""``python -m repro_torch.analysis`` — the port's lint CLI and CI gate.

Default run reports every finding (baselined ones marked) and exits 0 —
the informational mode. ``--fail-on-new`` exits 1 when any finding is
NOT in the checked-in baseline — the CI gate. ``--write-baseline``
snapshots the current findings as the new baseline (reviewed like any
other diff). Exit 2: a path does not exist, or a file does not parse.
The runtime contract audit lives in ``repro_torch.analysis.audit`` and
runs from the tests and ``chip_smoke.py`` (it runs the programs), not
from this CLI.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.lint import (BASELINE_PATH, DEFAULT_ROOTS,
                                       default_paths, lint_paths,
                                       load_baseline, write_baseline)
from repro_torch.analysis.rules import get_rules
from repro_torch.analysis.rules.torch_rules import RUNTIME_ONLY


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lint over the port's averaging contracts and ground "
                    "rules")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: "
                         f"{' '.join(DEFAULT_ROOTS)})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH,
                    help="baseline JSON (default: the checked-in one)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (every finding is new)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="snapshot current findings into --baseline")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 on any finding not in the baseline "
                         "(the CI gate)")
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the full report as JSON")
    args = ap.parse_args(argv)

    rules = get_rules(None if args.rules is None
                      else [r.strip() for r in args.rules.split(",")])
    if args.list_rules:
        for r in sorted(rules.values(), key=lambda r: r.name):
            scope = f"  [paths: {r.paths}]" if r.paths else ""
            print(f"{r.name}{scope}\n    {r.summary}")
        for name, why in sorted(RUNTIME_ONLY.items()):
            print(f"{name}  [reference rule, run time only]\n    {why}")
        return 0

    roots = ([Path(p) for p in args.paths] if args.paths
             else default_paths())
    missing = [str(p) for p in roots if not p.exists()]
    if missing:
        print(f"error: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    report = lint_paths(roots, rules=rules, baseline=baseline)

    for f in report.findings:
        print(f)
    for f in report.baselined:
        print(f"{f}  (baselined)")
    for e in report.parse_errors:
        print(f"parse error: {e}", file=sys.stderr)

    if args.write_baseline:
        write_baseline(report.findings + report.baselined, args.baseline)
        print(f"baseline written: {args.baseline} "
              f"({len(report.findings) + len(report.baselined)} findings)")

    n_new, n_base = len(report.findings), len(report.baselined)
    status = "clean" if not (n_new or n_base) else \
        f"{n_new} new, {n_base} baselined"
    print(f"repro_torch.analysis: {report.files_checked} files, "
          f"{report.suppressed} suppressed, {status}")

    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report.as_dict(), indent=1)
                               + "\n")

    if report.parse_errors:
        return 2
    if args.fail_on_new and n_new and not args.write_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
