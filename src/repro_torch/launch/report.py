"""Prints the §Dry-run / §Roofline tables from the per-cell JSON records that
`launch.dryrun` writes (the port of `repro.launch.report`).

    PYTHONPATH=src python -m repro_torch.launch.report artifacts/torch/dryrun

Thin adapter: the table builders live in `repro_torch.experiments.report`,
which renders the same tables into the port's EXPERIMENTS.md; this CLI
previews a directory of records (the reference's committed
`artifacts/dryrun/` renders the same way).
"""
from __future__ import annotations

import sys

from repro_torch.experiments.report import (  # noqa: F401  (re-exported, as the reference's)
    DEFAULT_DRYRUN_DIR,
    dryrun_summary,
    dryrun_table,
    fmt_e,
    fmt_gb,
    load_dryrun_records,
    normalize_dryrun_record,
    roofline_table,
)

__all__ = ["main"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else DEFAULT_DRYRUN_DIR
    recs = load_dryrun_records(out_dir)
    print("## §Dry-run\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single-pod 16×16)\n")
    print(roofline_table(recs))
    print("\n## Summary\n")
    print(dryrun_summary(recs))


if __name__ == "__main__":
    main()
