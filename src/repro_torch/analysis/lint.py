"""CLI: `python -m repro_torch.analysis.lint [paths] [options]`, the port's
lint (the counterpart of `python -m repro.analysis.lint`).

Exit codes: 0 clean (or fully baselined in --check-baseline mode), 1 when
findings remain, 2 on usage errors.  `scripts/verify_torch.sh` runs
`python -m repro_torch.analysis.lint src/repro_torch --check-baseline`.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.engine import (
    diff_vs_baseline,
    lint_paths,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import NOT_PORTED, rule_catalog

__all__ = ["main"]

DEFAULT_BASELINE = "artifacts/torch_lint_baseline.json"
DEFAULT_PATHS = ["src/repro_torch"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description=(
            "Static parity/determinism contract linter of the PyTorch port "
            "(RPL002-RPL009, keyed on repro_torch/<pkg>/ paths)."
        ),
    )
    p.add_argument(
        "paths", nargs="*", default=DEFAULT_PATHS,
        help=f"files or directories to lint (default: {' '.join(DEFAULT_PATHS)})",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="findings report format (default: text)",
    )
    p.add_argument(
        "--baseline", default=DEFAULT_BASELINE,
        help=f"grandfather file (default: {DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--check-baseline", action="store_true",
        help=(
            "compare against the baseline: fail on findings not in it AND "
            "on stale baseline entries (the CI mode)"
        ),
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="write the current findings as the new baseline and exit 0",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for rule_id, title in sorted({**rule_catalog(), **NOT_PORTED}.items()):
            print(f"{rule_id}  {title}")
        return 0
    if args.check_baseline and args.write_baseline:
        print("--check-baseline and --write-baseline are mutually exclusive",
              file=sys.stderr)
        return 2

    result = lint_paths(list(args.paths))

    if args.write_baseline:
        payload = write_baseline(args.baseline, result.findings)
        print(
            f"wrote {args.baseline}: {len(payload['findings'])} grandfathered "
            f"finding identities over {result.files_scanned} files"
        )
        return 0

    if args.check_baseline:
        diff = diff_vs_baseline(result.findings, load_baseline(args.baseline))
        if args.format == "json":
            print(json.dumps(
                {
                    "files_scanned": result.files_scanned,
                    "new": [f.to_dict() for f in diff.new],
                    "stale_baseline": diff.stale,
                    "ok": diff.ok,
                },
                indent=2,
            ))
        else:
            for f in diff.new:
                print(f.render())
            for entry in diff.stale:
                print(
                    f"STALE baseline entry (violation fixed — remove it or "
                    f"rerun --write-baseline): {entry['rule']} {entry['path']} "
                    f"{entry['message']!r}"
                )
            status = "ok" if diff.ok else "FAIL"
            print(
                f"repro-torch-lint {status}: {result.files_scanned} files, "
                f"{len(diff.new)} new finding(s), {len(diff.stale)} stale "
                f"baseline entr(y/ies)"
            )
        return 0 if diff.ok else 1

    if args.format == "json":
        print(json.dumps(
            {
                "files_scanned": result.files_scanned,
                "findings": [f.to_dict() for f in result.findings],
                "ok": result.ok,
            },
            indent=2,
        ))
    else:
        for f in result.findings:
            print(f.render())
        print(
            f"repro-torch-lint {'ok' if result.ok else 'FAIL'}: "
            f"{result.files_scanned} files, {len(result.findings)} finding(s)"
        )
    return 0 if result.ok else 1


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
