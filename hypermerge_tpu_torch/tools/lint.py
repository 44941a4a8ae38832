"""Run the static invariant linter over the port's tree.

    python -m hypermerge_tpu_torch.tools.lint [--json] [--all]
        [--rule RULE] [--env-table] [--guards-table] [paths...]

Checks the concurrency rules the repo used to enforce by comment
(analysis/linter.py): the declared lock hierarchy
(analysis/hierarchy.py), no blocking calls under the emission locks,
the NetworkPeer.try_send churn-safe-send idiom, the HM_* env-var
registry (analysis/envvars.py), the `subsystem.metric` telemetry
naming convention, and factory-made locks (so HM_LOCKDEP=1 runtime
lockdep sees every lock).

The tree is the port's: `hypermerge_tpu_torch/`, `bench_torch/` and
`chip_smoke.py`, with the README's "PyTorch/CUDA port" section holding
the generated tables. Exit status is nonzero when any UNSUPPRESSED
violation exists — tier-1 runs exactly this via
tests/test_torch_analysis.py. `--all` also
prints suppressed violations with their justifications; `--env-table`
prints the README markdown table generated from the registry.
"""

import argparse
import json
import sys
from pathlib import Path

from ..analysis import envvars, guards, linter


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "paths", nargs="*",
        help="files to lint (default: the whole tree)",
    )
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--all", action="store_true",
        help="also show suppressed violations (with justifications)",
    )
    ap.add_argument(
        "--rule", action="append", default=None, metavar="RULE",
        help=f"restrict to rule(s): {', '.join(linter.RULES)}",
    )
    ap.add_argument(
        "--env-table", action="store_true",
        help="print the README HM_* env-var markdown table and exit",
    )
    ap.add_argument(
        "--guards-table", action="store_true",
        help="print the README guard-map markdown table "
             "(analysis/guards.py) and exit",
    )
    args = ap.parse_args()

    if args.env_table:
        print(envvars.markdown_table())
        return 0
    if args.guards_table:
        print(guards.markdown_table())
        return 0

    root = linter.repo_root()
    if args.paths:
        viols = linter.lint_files(
            [str(Path(p).resolve()) for p in args.paths], root
        )
    else:
        viols = linter.lint_repo(root)
    if args.rule:
        viols = [v for v in viols if v.rule in args.rule]
    open_viols = linter.unsuppressed(viols)
    shown = viols if args.all else open_viols

    if args.json:
        print(
            json.dumps(
                {
                    "violations": [v._asdict() for v in shown],
                    "n_unsuppressed": len(open_viols),
                    "n_suppressed": len(viols) - len(open_viols),
                },
                indent=2,
            )
        )
    else:
        for v in sorted(shown, key=lambda v: (v.path, v.line)):
            print(v.format())
            if v.suppressed and v.justification:
                print(f"    justification: {v.justification}")
        n_sup = len(viols) - len(open_viols)
        print(
            f"{len(open_viols)} violation(s), {n_sup} suppressed"
            + ("" if args.all or not n_sup else " (--all to show)")
        )
    return 1 if open_viols else 0


if __name__ == "__main__":
    sys.exit(main())
