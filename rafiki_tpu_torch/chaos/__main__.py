"""CLI: ``python -m rafiki_tpu_torch.chaos run <scenario>|all`` / ``list``.

The port's own copy of ``rafiki_tpu/chaos/__main__.py``: runs recovery
scenarios against an in-process cluster and exits non-zero on any
failed invariant. The scenarios run on the CUDA card unless
``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from rafiki_tpu_torch.chaos.runner import SCENARIOS, format_report, run_scenarios

    parser = argparse.ArgumentParser(
        prog="python -m rafiki_tpu_torch.chaos",
        description="Deterministic fault-injection scenario runner")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("list", help="list scenarios")
    runp = sub.add_parser("run", help="run scenarios")
    runp.add_argument("scenarios", nargs="+", help="scenario names, or 'all'")
    runp.add_argument("--json", action="store_true",
                      help="machine-readable reports on stdout")
    runp.add_argument("--device", default=None,
                      help="where the trials train (default: the CUDA card; 'cpu' on request)")
    args = parser.parse_args(argv)

    if args.command == "list":
        for name in sorted(SCENARIOS):
            print(f"{name}\n    {SCENARIOS[name].description}")
        return 0

    names = sorted(SCENARIOS) if args.scenarios == ["all"] else args.scenarios
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"unknown scenarios: {unknown}; known: {sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    reports = run_scenarios(names, device=args.device)
    if args.json:
        print(json.dumps([r.to_dict() for r in reports], indent=2))
    else:
        for r in reports:
            print(format_report(r))
    failed = [r.name for r in reports if not r.passed]
    if failed:
        print(f"\nFAILED: {failed}", file=sys.stderr)
        return 1
    print(f"\nall {len(reports)} scenario(s) passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
