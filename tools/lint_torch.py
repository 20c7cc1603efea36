#!/usr/bin/env python
"""The port's lint CLI: run the static rules of ``repro_torch.analysis`` over
source paths (``tools/lint.py`` is the JAX package's).

Usage::

    python tools/lint_torch.py src/repro_torch            # report mode
    python tools/lint_torch.py --strict src/repro_torch   # CI mode
    python tools/lint_torch.py --list-rules

Exit codes: 0 clean, 1 violations (or, under ``--strict``, unparsable files
/ unjustified suppressions), 2 internal error.

``--strict`` requires every ``# repro-lint: disable=`` comment to carry a
``-- justification`` tail and fails on files it cannot parse. The rules are
``ast`` passes: nothing analyzed is imported, and neither torch nor a card
is needed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO_ROOT / "src"))

from repro_torch.analysis.core import all_rules, lint_paths  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro-lint-torch", description=__doc__)
    ap.add_argument("paths", nargs="*", type=Path, help="files or directories to lint")
    ap.add_argument("--strict", action="store_true",
                    help="CI mode: fail on unparsable files and on suppressions without a justification")
    ap.add_argument("--list-rules", action="store_true", help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.title}")
            print(f"      hint: {rule.hint}")
        return 0

    if not args.paths:
        ap.error("no paths given (try: tools/lint_torch.py src/repro_torch)")
    missing = [p for p in args.paths if not p.exists()]
    if missing:
        ap.error(f"no such path: {', '.join(str(p) for p in missing)}")

    result = lint_paths(args.paths)

    failed = False
    for violation in result.violations:
        print(violation.format())
        failed = True
    for err in result.errors:
        print(f"error: cannot parse {err}")
        if args.strict:
            failed = True
    if args.strict:
        for sup in result.suppressions:
            if not sup.justification:
                print(f"{sup.path}:{sup.line}: {sup.rule} suppressed without a justification "
                      "(--strict requires `-- reason` tails)")
                failed = True

    print(f"repro-lint-torch: {result.files_checked} file(s), {len(result.violations)} violation(s), "
          f"{len(result.suppressions)} suppression(s)"
          + (f", {len(result.errors)} parse error(s)" if result.errors else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
