"""Sweep CLI — regenerates the paper's figure tables into the port's report.

    PYTHONPATH=src python -m repro_torch.experiments.run --grid paper
    PYTHONPATH=src python -m repro_torch.experiments.run --grid mini --device cpu \
        --md /tmp/EXPERIMENTS.mini.md --json /tmp/BENCH_sweep.mini.json

Writes `artifacts/torch/EXPERIMENTS.md` (§Calibration, §Perf, Fig. 5/7/8,
and a section for every stored secondary grid) and
`artifacts/torch/BENCH_sweep.json` (per-config records + comparisons) for
`--grid paper`; secondary grids (`ablation`, `meshscale`, `torus`,
`contention`, `backpressure`, `scale`, `faults`) store
`artifacts/torch/sweeps/<grid>.json`, which the next paper render folds in.
Every default path lies under `artifacts/torch/`, so the reference package's
committed outputs are never written over.  Traces are cached under
`--cache-dir`.  `python -m repro_torch.experiments.report --check` audits a
written report against its payloads without running anything.

The sweep runs where `--device` says: the CUDA device by default, which
must exist (there is no fallback to the host or to the numpy backend);
`--device cpu` runs the port on the host.  `--backend auto` is `torch`.

Interruption and resume: SIGTERM and Ctrl-C are trapped — every open unit
journal is flushed before the process exits 130.  Grids with a fault axis
(`--grid faults`/`minifaults`) run through the journaled resilience runner;
`--resume` reloads `artifacts/torch/journals/<grid>.json` and skips completed
units (byte-identical artifact).  Other grids resume through the cache:
every trace/traffic/shard write is atomic and fsync'd (`experiments.cache`),
so re-running an interrupted grid only recomputes what never reached disk.
"""
from __future__ import annotations

import argparse
import json
import os
import signal

from repro_torch import obs
from repro_torch.device import BACKENDS, resolve_device
from repro_torch.experiments.cache import DEFAULT_CACHE_DIR
from repro_torch.experiments.grid import GRIDS, grid_by_name
from repro_torch.experiments.journal import SweepJournal, flush_all_journals
from repro_torch.experiments.report import (
    DEFAULT_DRYRUN_DIR,
    DEFAULT_JSON,
    DEFAULT_MD,
    DEFAULT_PERF_DIR,
    DEFAULT_SWEEPS_DIR,
    OUT_DIR,
    RENDERABLE_SWEEP_GRIDS,
    save_sweep_artifact,
    write_bench_json,
    write_outputs,
)
from repro_torch.experiments.sweep import run_sweep

DEFAULT_JOURNAL_DIR = os.path.join(OUT_DIR, "journals")


def _export_obs(args, recorder) -> None:
    """Write the observability outputs (after ALL sweep artifacts are on
    disk: trace/metrics files are observability products, never inputs to
    the byte-compared pipeline).  Flight-recorder ring truncation is
    reported, never silent."""
    if args.trace_out:
        extra = recorder.counter_events_json() if recorder is not None else ()
        obs.export_chrome_trace(args.trace_out, extra_events=extra)
        wrote = [args.trace_out]
        if recorder is not None and recorder.summary()["tracks"]:
            heat_path = os.path.splitext(args.trace_out)[0] + ".heatmap.json"
            recorder.write_heatmap(heat_path)
            wrote.append(heat_path)
        if not args.quiet:
            msg = f"[obs] wrote {' and '.join(wrote)}"
            if recorder is not None and recorder.dropped_windows:
                msg += (
                    f"; flight recorder dropped {recorder.dropped_windows}"
                    " window(s) (ring full — raise FlightRecorder max_windows)"
                )
            print(msg)
    if args.metrics_out:
        obs.metrics.write_snapshot(args.metrics_out)
        if not args.quiet:
            print(f"[obs] wrote {args.metrics_out}")


def _run_faults_grid(grid, args) -> int:
    """Faults grids route to the journaled resilience runner instead of
    run_sweep; the payload lands in `<sweeps-dir>/<grid>.json` like any other
    secondary sweep artifact (rendered as §Resilience on the next paper run)."""
    from repro_torch.experiments.resilience import run_resilience

    journal_path = args.journal or os.path.join(DEFAULT_JOURNAL_DIR, f"{grid.name}.json")
    journal = SweepJournal(journal_path, grid.name, resume=args.resume)
    result = run_resilience(
        grid,
        cache_dir=None if args.no_cache else args.cache_dir,
        backend=args.backend,
        journal=journal,
        unit_timeout_s=args.config_timeout,
        progress=None if args.quiet else print,
        device=args.device,
    )
    os.makedirs(args.sweeps_dir, exist_ok=True)
    path = os.path.join(args.sweeps_dir, f"{grid.name}.json")
    with open(path, "w") as f:
        json.dump(result.to_dict(), f, indent=1)
    if not args.quiet:
        nq = len(result.quarantined)
        print(
            f"[sweep:{grid.name}] stored {path} ({len(result.records)} units"
            + (f", {nq} quarantined" if nq else "")
            + "); re-run `--grid paper` to render it into EXPERIMENTS.md"
        )
    return 0


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv: list[str] | None = None) -> int:
    # SIGTERM behaves like Ctrl-C: unwind through the KeyboardInterrupt
    # handlers of `_main` so open journals reach disk before the process
    # dies.  The caller's handler comes back when `main` returns.
    previous = signal.signal(signal.SIGTERM, _interrupt)
    try:
        return _main(argv)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _main(argv: list[str] | None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.experiments.run", description="batched experiment sweep"
    )
    ap.add_argument("--grid", default="paper", choices=sorted(GRIDS), help="named config grid")
    ap.add_argument("--scale", type=float, default=None, help="override the grid's workload scale")
    ap.add_argument(
        "--backend",
        default="auto",
        choices=list(BACKENDS),
        help="batched-eval backend (auto = torch; numpy is the float64 reference)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="where the traces and the torch backend run (default: the CUDA"
        " device, which must exist; `cpu` runs the port on the host)",
    )
    ap.add_argument(
        "--md",
        default=None,
        help=f"markdown report output path (default {DEFAULT_MD} for --grid"
        " paper; other grids only store their <sweeps-dir>/<grid>.json"
        " unless --md is given explicitly)",
    )
    ap.add_argument(
        "--json",
        default=None,
        help=f"machine-readable output path (default {DEFAULT_JSON} for"
        " --grid paper; see --md for other grids)",
    )
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR, help="trace/traffic cache")
    ap.add_argument(
        "--sweeps-dir",
        default=DEFAULT_SWEEPS_DIR,
        help="per-grid sweep artifact store rendered into EXPERIMENTS.md"
        " (§Ablation, §Mesh scaling, §Torus, §Contention, …)",
    )
    ap.add_argument("--no-cache", action="store_true", help="recompute everything")
    ap.add_argument(
        "--restarts",
        type=int,
        default=0,
        help="extra perturbed-init descents per searched placement config"
        " (stacked into the batched engine; 0 = single steepest descent)",
    )
    ap.add_argument(
        "--no-serial-check",
        action="store_true",
        help="skip the serial place/simulate reference loops: faster, but no"
        " §Perf ratios and no keep-the-better-H placement guard (results come"
        " from the batched engine alone)",
    )
    ap.add_argument("--dryrun-artifacts", default=DEFAULT_DRYRUN_DIR)
    ap.add_argument("--perf-artifacts", default=DEFAULT_PERF_DIR)
    ap.add_argument(
        "--resume",
        action="store_true",
        help="faults grids: reload the unit journal and skip completed units"
        " (byte-identical artifact vs an uninterrupted run)",
    )
    ap.add_argument(
        "--journal",
        default=None,
        help="unit-journal path for faults grids"
        f" (default {DEFAULT_JOURNAL_DIR}/<grid>.json)",
    )
    ap.add_argument(
        "--config-timeout",
        type=float,
        default=0.0,
        help="per-unit wall-time bound in seconds for faults grids; an"
        " over-budget unit is quarantined, not fatal (0 = unbounded)",
    )
    ap.add_argument(
        "--trace-out",
        default=None,
        help="write a Chrome-trace/Perfetto JSON (pipeline spans + NoC"
        " flight-recorder counter tracks; open in ui.perfetto.dev); a"
        " <stem>.heatmap.json per-phase link-utilization artifact rides"
        " along when the recorder captured any track",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        help="write the obs metrics snapshot JSON"
        " (comparable/non_comparable namespaces; schemas/metrics.schema.json)",
    )
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CUDA device and no --device: raise now

    recorder = None
    if args.trace_out:
        obs.enable_tracing()
        recorder = obs.FlightRecorder()

    grid = grid_by_name(args.grid, scale=args.scale)
    if grid.fault_rates is not None:
        try:
            rc = _run_faults_grid(grid, args)
        except KeyboardInterrupt:
            n = flush_all_journals()
            print(f"[sweep:{grid.name}] interrupted; flushed {n} journal(s) — resume with --resume")
            return 130
        _export_obs(args, recorder)
        return rc
    try:
        with obs.span("pipeline.sweep", grid=grid.name, backend=args.backend):
            sweep = run_sweep(
                grid,
                cache_dir=None if args.no_cache else args.cache_dir,
                backend=args.backend,
                measure_serial=not args.no_serial_check,
                placement_restarts=args.restarts,
                progress=None if args.quiet else print,
                recorder=recorder,
                device=args.device,
            )
    except KeyboardInterrupt:
        # The trace/shard cache is written atomically as the sweep goes, so
        # an interrupted run resumes by simply re-running: completed stages
        # hit, only in-flight work recomputes.
        flush_all_journals()
        print(f"[sweep:{grid.name}] interrupted; partial cache is on disk — just re-run")
        return 130
    with obs.span("pipeline.report", grid=grid.name):
        artifact = None
        if args.grid in RENDERABLE_SWEEP_GRIDS:
            artifact = save_sweep_artifact(sweep, args.sweeps_dir)
        # Secondary grids default to artifact-only runs: their tables land in
        # EXPERIMENTS.md on the next `--grid paper` render rather than
        # overwriting the paper report with a secondary grid's view.  Only an
        # explicit --md opts a secondary grid into the full report; --json
        # alone writes just the machine-readable payload.
        wrote = []
        if args.grid == "paper" or args.md is not None:
            md_path = args.md or DEFAULT_MD
            if args.json is not None:
                json_path = args.json
            elif args.grid == "paper":
                json_path = DEFAULT_JSON
            else:
                # A secondary grid given only --md must not clobber the paper
                # BENCH_sweep.json; pair the payload with the report path.
                json_path = os.path.splitext(md_path)[0] + ".json"
            md_path, json_path = write_outputs(
                sweep,
                md_path=md_path,
                json_path=json_path,
                dryrun_dir=args.dryrun_artifacts,
                perf_dir=args.perf_artifacts,
                sweeps_dir=args.sweeps_dir,
            )
            wrote += [md_path, json_path]
        elif args.json is not None:
            wrote.append(write_bench_json(sweep, args.json))
    _export_obs(args, recorder)
    if not args.quiet:
        n = len(sweep.records)
        if wrote:
            print(f"[sweep:{grid.name}] wrote {' and '.join(wrote)} ({n} configs)")
        elif artifact:
            print(
                f"[sweep:{grid.name}] stored {artifact} ({n} configs); re-run"
                " `--grid paper` to render it into EXPERIMENTS.md"
            )
        else:
            print(f"[sweep:{grid.name}] ran {n} configs (no outputs requested)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
