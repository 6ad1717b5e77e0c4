"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

The port's linter, with the reference's options, exit codes and JSON
keys.  Exit codes: 0 clean (or baseline-covered), 1 new findings or
parse errors, 2 usage errors.  ``--format=json`` emits a machine-readable
report.  The port's baseline is ``lint-baseline-torch.json`` at the
repository root (``--baseline lint-baseline-torch.json``); it runs on a
bare Python, with no ``torch`` installed.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.lint.engine import (
    all_rules,
    run_lint,
    write_baseline,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant linter (see "
                    "src/repro_torch/analysis/README.md)")
    p.add_argument("paths", nargs="*", default=["src/repro_torch"],
                   help="files or directories to lint "
                        "(default: src/repro_torch)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset (default: all)")
    p.add_argument("--baseline", default=None,
                   help="JSON baseline of accepted finding fingerprints")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to --baseline and exit 0")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name}: {rule.doc}")
        return 0
    rules = args.rules.split(",") if args.rules else None
    try:
        result = run_lint(args.paths or ["src/repro_torch"], rules=rules,
                          baseline=args.baseline)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        if not args.baseline:
            print("error: --write-baseline needs --baseline", file=sys.stderr)
            return 2
        write_baseline(args.baseline,
                       result.findings + result.baselined)
        print(f"wrote {len(result.findings) + len(result.baselined)} "
              f"fingerprint(s) to {args.baseline}")
        return 0

    if args.format == "json":
        print(json.dumps({
            "files": result.files,
            "findings": [f.to_json() for f in result.findings],
            "baselined": [f.to_json() for f in result.baselined],
            "suppressed": result.suppressed,
            "stale_baseline": result.stale_baseline,
            "errors": result.errors,
            "ok": result.ok,
        }, indent=2))
    else:
        for f in result.findings:
            print(f.render())
        for f in result.baselined:
            print(f"{f.render()} [baselined]")
        for e in result.errors:
            print(f"parse error: {e}", file=sys.stderr)
        for fp in result.stale_baseline:
            print(f"stale baseline entry (fixed? regenerate): {fp}",
                  file=sys.stderr)
        print(f"{result.files} file(s): {len(result.findings)} new, "
              f"{len(result.baselined)} baselined, "
              f"{result.suppressed} suppressed")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
