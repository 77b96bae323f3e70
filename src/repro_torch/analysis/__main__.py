"""CLI: ``python -m repro_torch.analysis [paths...] [--json] [--rules RL001,..]``.

Exit status is 0 when no findings, 1 when any rule fired, 2 for an unknown
rule — suitable for CI gating in both directions (clean tree passes,
seeded fixtures fail). The default paths are the port's own tree; a path
that does not exist yields nothing.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.core import all_rules, render_human, render_json, run

DEFAULT_PATHS = ["src/repro_torch", "benchmarks/torch"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: AST-based invariant checker for the port's serving stack",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=DEFAULT_PATHS,
        help=f"files or directories to check (default: {' '.join(DEFAULT_PATHS)})",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument(
        "--rules",
        default="",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule table and exit"
    )
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.id}  {rule.title}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            parser.error(f"unknown rules: {sorted(unknown)}")
        rules = [r for r in rules if r.id in wanted]

    findings = run(args.paths, rules=rules)
    print(render_json(findings) if args.json else render_human(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
