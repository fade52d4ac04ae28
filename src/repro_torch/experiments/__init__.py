"""Batched experiment-sweep subsystem.

One declarative grid (workload × algorithm × partitioner × placement ×
topology × mesh size) drives the whole paper evaluation:

  grid     — `GridSpec` / `SweepConfig` and the named grids (`paper`, `mini`,
             `ablation`, …) that expand into concrete configurations.
  cache    — content-hash cache for algorithm traces and traffic matrices so
             repeated sweeps skip re-tracing.
  batched  — the vectorized evaluation hot path: `simulate()` batched over all
             configurations at once (stacked `(n_configs, 4P, 4P)` tensors;
             float64 torch backend with a numpy reference backend).
  placement_batch — the stacked placement search.
  sweep    — orchestration: expand the grid, trace (cached), partition,
             place, batch-evaluate, pair proposed-vs-baseline rows into the
             paper's Fig. 5/7/8 comparisons.
  report   — renders sweep results into the port's EXPERIMENTS.md and
             BENCH_sweep.json (under `artifacts/torch/`), and `--check`.
  run      — CLI: `python -m repro_torch.experiments.run --grid paper`.
"""
from repro_torch.experiments.batched import (
    batched_weighted_hops,
    routing_operator,
    simulate_batch,
)
from repro_torch.experiments.cache import SweepCache
from repro_torch.experiments.grid import GRIDS, GridSpec, SweepConfig, grid_by_name
from repro_torch.experiments.sweep import SweepRecord, SweepResult, figure_comparisons, run_sweep

__all__ = [
    "GRIDS",
    "GridSpec",
    "SweepConfig",
    "grid_by_name",
    "SweepCache",
    "simulate_batch",
    "batched_weighted_hops",
    "routing_operator",
    "SweepRecord",
    "SweepResult",
    "run_sweep",
    "figure_comparisons",
]
