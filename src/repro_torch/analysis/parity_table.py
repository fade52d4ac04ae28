"""Generate the port's parity-contract table in README.md from the registry.

The table between the `torch-parity-table` markers in README.md (the port's
section) is GENERATED from the `@parity_pair_torch` registrations on the
port's stacked functions — never edited by hand — so the documented
contract and the code cannot drift: change a registration, rerun this
module, commit both.  It never touches `docs/ARCHITECTURE.md`, whose
`parity-table` block belongs to `repro.analysis.parity_table`.

    python -m repro_torch.analysis.parity_table           # rewrite the block
    python -m repro_torch.analysis.parity_table --check   # freshness gate

`--check` exits 1 with a regeneration hint when the committed block
differs from the registry-rendered one, 2 when the markers are missing.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.registry import ParityEntry, load_registry

__all__ = ["MARK_BEGIN", "MARK_END", "main", "render_parity_table"]

DEFAULT_DOC = "README.md"

MARK_BEGIN = (
    "<!-- torch-parity-table:begin — generated by "
    "`python -m repro_torch.analysis.parity_table`; do not edit by hand -->"
)
MARK_END = "<!-- torch-parity-table:end -->"


def render_parity_table(registry: dict[str, ParityEntry] | None = None) -> str:
    """The markdown table body (no markers), one row per registration,
    sorted by the stacked function's qualname."""
    if registry is None:
        registry = load_registry()
    lines = [
        "| stacked function | serial reference | contract |",
        "|---|---|---|",
    ]
    for entry in sorted(registry.values(), key=lambda e: e.batched):
        lines.append(f"| `{entry.batched}` | `{entry.serial}` | {entry.contract()} |")
    return "\n".join(lines)


def _replace_block(doc: str, table: str) -> str:
    begin = doc.find(MARK_BEGIN)
    end = doc.find(MARK_END)
    if begin < 0 or end < 0 or end < begin:
        raise ValueError(
            f"torch-parity-table markers not found (need {MARK_BEGIN!r} … {MARK_END!r} in the document)"
        )
    return f"{doc[: begin + len(MARK_BEGIN)]}\n{table}\n{doc[end:]}"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.parity_table",
        description="Regenerate (or --check) the port's parity table from the @parity_pair_torch registry.",
    )
    p.add_argument("--doc", default=DEFAULT_DOC, help=f"document holding the marked block (default: {DEFAULT_DOC})")
    p.add_argument("--check", action="store_true",
                   help="verify the committed block matches the registry; exit 1 if not")
    p.add_argument("--print", dest="print_only", action="store_true",
                   help="print the rendered table to stdout and exit")
    args = p.parse_args(argv)

    table = render_parity_table()
    if args.print_only:
        print(table)
        return 0

    with open(args.doc, encoding="utf-8") as fh:
        doc = fh.read()
    try:
        updated = _replace_block(doc, table)
    except ValueError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2

    if args.check:
        if updated != doc:
            print(
                f"STALE: the port's parity table in {args.doc} does not match the "
                "@parity_pair_torch registry.\nRegenerate with: "
                "python -m repro_torch.analysis.parity_table",
                file=sys.stderr,
            )
            return 1
        print(f"parity table fresh: {len(load_registry())} registered pairs match {args.doc}")
        return 0

    if updated == doc:
        print(f"{args.doc} already up to date")
    else:
        with open(args.doc, "w", encoding="utf-8") as fh:
            fh.write(updated)
        print(f"rewrote the port's parity table in {args.doc}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
