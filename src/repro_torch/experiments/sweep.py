"""Sweep orchestration: expand a grid, trace (cached), partition, place, and
batch-evaluate every configuration; pair proposed-vs-baseline rows into the
paper's Fig. 5/7/8 comparisons.

The per-config pipeline matches `repro_torch.core.mapping.map_graph` exactly —
partition → traffic → placement — but tracing goes through the content-hash
`SweepCache`, the per-config placement searches run as ONE stacked program
(`place_batch`: all O(n·S) swap/move deltas per step across every config at
once), and the final `simulate()` calls are replaced by one `simulate_batch`
over the whole grid.  When `measure_serial=True` the two replaced
one-config-at-a-time loops (serial `place` and serial `simulate`) are also
timed — and the serial placements' weighted hops H compared against the
batched engine's — so EXPERIMENTS.md §Perf can report both batching wins and
the H-parity guarantee on real sweep shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.degree import out_degrees, skew_stats
from repro_torch.core.placement import Placement, auto_mesh_for_parts, place
from repro_torch.core.simulator import SimParams, SimResult
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.experiments.batched import simulate_batch, simulate_serial
from repro_torch.experiments.cache import SweepCache
from repro_torch.experiments.grid import GridSpec, SweepConfig
from repro_torch.experiments.placement_batch import place_batch
from repro_torch.graph.generators import table2_workloads
from repro_torch.obs import peak_rss_mb, span

__all__ = [
    "SweepRecord",
    "SweepResult",
    "run_sweep",
    "figure_comparisons",
    "workload_stats",
    "register_sweep_metrics",
    "metrics_snapshot_for",
    "peak_rss_mb",
]

# Trace length per algorithm (same budget as benchmarks/): PageRank converges
# by L1 delta well before 40 sweeps at these scales; BFS/SSSP stop on an
# empty frontier.
TRACE_ITERS = {"pagerank": 40}
DEFAULT_TRACE_ITERS = 200


@dataclasses.dataclass(frozen=True)
class SweepRecord:
    """One evaluated configuration."""

    config: SweepConfig
    num_nodes: int
    num_edges: int
    num_iterations: int
    placement_method: str  # resolved method ("auto" → quad+2opt etc.)
    edge_balance: float
    phase_norm: dict[str, float]  # Fig. 3 phase bytes / graph bytes
    result: SimResult
    elapsed_us: float  # partition+traffic + batched placement/sim shares

    def to_dict(self) -> dict:
        return {
            **dataclasses.asdict(self.config),
            "key": self.config.key,
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "num_iterations": self.num_iterations,
            "placement_method": self.placement_method,
            "edge_balance": self.edge_balance,
            "phase_norm": self.phase_norm,
            "elapsed_us": self.elapsed_us,
            **{f"sim_{k}": v for k, v in dataclasses.asdict(self.result).items()},
        }


@dataclasses.dataclass
class SweepResult:
    grid: GridSpec
    records: list[SweepRecord]
    workload_stats: dict[str, dict]
    cache_stats: dict[str, int]
    timings: dict[str, float]
    backend: str
    placement_stats: dict = dataclasses.field(default_factory=dict)
    # Running process peak RSS (MiB) sampled after each pipeline stage
    # (peak_rss_mb): the §Scale memory column.
    memory: dict = dataclasses.field(default_factory=dict)
    # contention-pass payload; always None until the windowed NoC replay is in
    # this package.
    contention: dict | None = None
    # obs metrics snapshot for THIS sweep (stage timings, cache events,
    # placement stats, saturation bounds).  Deliberately absent from
    # `to_dict()`: its non_comparable namespace carries wall-clock, and the
    # sweep payload is byte-compared.  `report.py` renders §Perf from it.
    metrics_snapshot: dict | None = None
    # With `run_sweep(keep_artifacts=True)`: the in-memory objects behind the
    # records, in config order — {"traffics", "partitions", "topologies",
    # "placements", "num_iterations"} — for a caller that wants to evaluate
    # them again (another backend, another simulator).  Never serialised.
    artifacts: dict | None = None

    def to_dict(self) -> dict:
        return {
            "grid": dataclasses.asdict(self.grid),
            "backend": self.backend,
            "records": [r.to_dict() for r in self.records],
            "comparisons": figure_comparisons(self.records),
            "workload_stats": self.workload_stats,
            "cache_stats": self.cache_stats,
            "timings": self.timings,
            "placement_stats": self.placement_stats,
            "memory": self.memory,
            "contention": self.contention,
        }


def workload_stats(name: str, g) -> dict:
    s = skew_stats(out_degrees(g.src, g.num_nodes))
    return {
        "workload": name,
        "num_nodes": g.num_nodes,
        "num_edges": g.num_edges,
        "alpha": s.alpha,
        "frac_vertices_for_90pct_edges": s.frac_vertices_for_90pct_edges,
        "frac_edges_in_top10pct_vertices": s.frac_edges_in_top10pct_vertices,
        "gini": s.gini,
        "max_degree": s.max_degree,
        "mean_degree": s.mean_degree,
        "is_power_law": s.is_power_law,
    }


def run_sweep(
    grid: GridSpec,
    *,
    cache: SweepCache | None = None,
    cache_dir: str | None = None,
    backend: str = "auto",
    params: SimParams = SimParams(),
    measure_serial: bool = True,
    placement_restarts: int = 0,
    graphs: dict[str, object] | None = None,
    progress: Callable[[str], None] | None = None,
    recorder=None,
    device: str | torch.device | None = None,
    reduce_impl: str | None = None,
    keep_artifacts: bool = False,
) -> SweepResult:
    """Run every configuration of `grid` and return per-config records.

    `cache`/`cache_dir` control trace/traffic persistence (`None`+`None`
    recomputes everything).  `measure_serial` additionally runs the replaced
    per-config `place()`/`simulate()` loops for the §Perf batching
    comparisons — and, since the serial placements are then in hand, keeps
    the better-H placement per config (False skips that guard: results come
    from the batched engine alone).
    `placement_restarts` stacks that many extra perturbed-init descents per
    searched config into the batched engine (basin diversity; see
    `place_batch`).
    `graphs` supplies pre-built workload graphs (name → HostGraph) so callers
    that already generated them (benchmarks/common.py) don't pay generation
    twice; the caller is responsible for them matching `grid.scale`/`seed`.
    `device` is where the vertex engine traces and where the torch backend
    of placement and simulation runs: `None` is the CUDA device and raises
    without one.  `reduce_impl` is handed to the vertex engine (see
    `graph.vertex_program`); a caller-supplied `cache` keeps its own.
    `keep_artifacts` attaches the traffics, partitions, topologies and final
    placements to the result (`SweepResult.artifacts`).

    Not in this package yet, each raising `NotImplementedError`: the windowed
    contention pass (`grid.contention`), the flight recorder (`recorder=`)
    and fault injection (`grid.fault_rates`) — all three ride on the windowed
    NoC replay, which a later slice of the port brings.
    """
    for what, asked in (
        ("grid.contention=True (the windowed contention pass)", grid.contention),
        ("recorder= (the NoC flight recorder)", recorder is not None),
        ("grid.fault_rates (fault injection)", bool(grid.fault_rates)),
    ):
        if asked:
            raise NotImplementedError(
                f"{what} needs the windowed NoC replay (nocsim.batch / nocsim.credit / "
                "faults), which a later slice of the port brings"
            )
    t_start = obs.now_s()
    say = progress or (lambda _msg: None)
    dev = resolve_device(device)
    if cache is None:
        cache = SweepCache(cache_dir, device=dev, reduce_impl=reduce_impl)
    configs = grid.expand()
    backend = resolve_backend(backend)

    say(f"[sweep:{grid.name}] {len(configs)} configs, backend={backend}")
    memory = {"start_mb": peak_rss_mb()}
    # Graphs are keyed (workload, scale): single-scale grids have one scale
    # for every config, multi-scale grids (`grid.scales`) regenerate each
    # workload per scale.  A caller-supplied `graphs` dict (name → graph)
    # serves every scale — its single-scale contract is documented above.
    with span("sweep.graphs", cat="sweep", grid=grid.name) as sp:
        used_pairs = sorted({(c.workload, c.scale) for c in configs})
        used_names = tuple(sorted({w for w, _ in used_pairs}))
        gmap: dict[tuple[str, float], object] = {}
        if graphs is not None:
            missing = set(used_names) - graphs.keys()
            if missing:
                raise ValueError(f"unknown workloads in grid: {sorted(missing)}")
            gmap = {(w, s): graphs[w] for w, s in used_pairs}
        else:
            for s in sorted({s for _, s in used_pairs}):
                names = tuple(w for w, s2 in used_pairs if s2 == s)
                gen = table2_workloads(scale=s, seed=grid.seed, names=names)
                missing = set(names) - gen.keys()
                if missing:
                    raise ValueError(f"unknown workloads in grid: {sorted(missing)}")
                for w in names:
                    gmap[(w, s)] = gen[w]
        multi_scale = grid.scales is not None
        wl_stats = {
            (f"{w}@s{s:g}" if multi_scale else w): workload_stats(w, g)
            for (w, s), g in gmap.items()
        }
        sp.annotate(workloads=len(gmap))
    t_graphs = sp.duration_s
    memory["graphs_mb"] = peak_rss_mb()

    # ---- traces (content-hash cached; one per workload × algorithm × scale) -
    with span("sweep.trace", cat="sweep", grid=grid.name) as sp:
        traces = {}
        for w, a, s in sorted({(c.workload, c.algorithm, c.scale) for c in configs}):
            traces[(w, a, s)] = cache.trace(
                gmap[(w, s)], a, max_iterations=TRACE_ITERS.get(a, DEFAULT_TRACE_ITERS)
            )
            say(f"[sweep:{grid.name}] traced {w}/{a}@s{s:g}: {traces[(w, a, s)].num_iterations} iters")
        sp.annotate(traces=len(traces))
    t_trace = sp.duration_s
    memory["trace_mb"] = peak_rss_mb()

    # ---- per-config partition → traffic ------------------------------------
    with span("sweep.partition_traffic", cat="sweep", grid=grid.name, configs=len(configs)) as sp:
        partitions: dict[tuple, object] = {}
        traffics, parts_list, topologies, per_config_us = [], [], [], []
        for c in configs:
            tc0 = obs.now_s()
            g = gmap[(c.workload, c.scale)]
            pkey = (c.workload, c.scale, c.partitioner, c.num_parts)
            part = partitions.get(pkey)
            if part is None:
                part = partitions[pkey] = cache.partition(g, c.partitioner, c.num_parts)
            traffics.append(
                cache.traffic(
                    g,
                    part,
                    traces[(c.workload, c.algorithm, c.scale)],
                    layout="dense" if grid.traffic_edge_block is None else "auto",
                    edge_block=grid.traffic_edge_block,
                )
            )
            parts_list.append(part)
            topologies.append(auto_mesh_for_parts(c.num_parts, c.topology))
            per_config_us.append((obs.now_s() - tc0) * 1e6)
    t_pt = sp.duration_s
    memory["partition_traffic_mb"] = peak_rss_mb()

    # ---- batched placement search (the second vectorized hot path) ---------
    with span("sweep.placement", cat="sweep", grid=grid.name) as sp:
        placements, pstats = place_batch(
            traffics,
            parts_list,
            topologies,
            methods=[c.placement for c in configs],
            seeds=[c.seed for c in configs],
            restarts=placement_restarts,
            backend=backend,
            device=dev,
        )
    t_placement = sp.duration_s
    memory["placement_mb"] = peak_rss_mb()
    placement_stats = pstats.as_dict()
    say(
        f"[sweep:{grid.name}] placement: {pstats.batched_configs} searched "
        f"({pstats.greedy_constructed} greedy-constructed, stacked), "
        f"{pstats.torus_constructed} torus-constructed (no search), "
        f"{pstats.serial_configs} constructive/serial, {pstats.groups} shape group(s)"
    )
    t_placement_serial = None
    if measure_serial and configs:
        with span("sweep.placement_serial", cat="sweep", grid=grid.name) as sp:
            serial_placements = [
                place(t, p, topo, method=c.placement, seed=c.seed)
                for c, t, p, topo in zip(configs, traffics, parts_list, topologies)
            ]
        t_placement_serial = sp.duration_s
        # H-parity record AND structural guarantee: steepest descent and the
        # randomized serial search converge to different local optima of the
        # same neighbourhood, so neither dominates by construction — since
        # the serial placements are in hand anyway, keep the better of the
        # two per config.  `h_worse_than_serial_configs` counts the engine's
        # raw losses *before* substitution (0 on every committed grid).
        ratios = [
            b.weighted_hops(t.bytes_matrix) / max(s.weighted_hops(t.bytes_matrix), 1e-12)
            for b, s, t in zip(placements, serial_placements, traffics)
        ]
        placement_stats["h_vs_serial_max_ratio"] = float(max(ratios))
        placement_stats["h_worse_than_serial_configs"] = int(
            sum(r > 1.0 + 1e-9 for r in ratios)
        )
        placements = [
            s if r > 1.0 + 1e-9 else b
            for b, s, r in zip(placements, serial_placements, ratios)
        ]
        say(
            f"[sweep:{grid.name}] batched placement {t_placement*1e3:.1f} ms vs "
            f"serial loop {t_placement_serial*1e3:.1f} ms "
            f"({t_placement_serial/max(t_placement, 1e-12):.1f}x), "
            f"H ratio max {placement_stats['h_vs_serial_max_ratio']:.4f}"
        )

    # ---- batched evaluation (the vectorized hot path) ----------------------
    iters = np.array(
        [traces[(c.workload, c.algorithm, c.scale)].num_iterations for c in configs]
    )
    with span("sweep.simulate", cat="sweep", grid=grid.name, pass_="warmup") as sp:
        results = simulate_batch(
            traffics, placements, params=params, num_iterations=iters, backend=backend,
            device=dev,
        )
    t_batched = sp.duration_s
    if configs:
        # The first call pays one-time costs (routing-operator construction
        # and its copy to the device); report the steady-state cost.
        with span("sweep.simulate", cat="sweep", grid=grid.name, pass_="steady") as sp:
            simulate_batch(
                traffics, placements, params=params, num_iterations=iters, backend=backend,
                device=dev,
            )
        t_batched = sp.duration_s
    t_serial_loop = None
    if measure_serial and configs:
        with span("sweep.simulate_serial", cat="sweep", grid=grid.name) as sp:
            simulate_serial(traffics, placements, params=params, num_iterations=iters)
        t_serial_loop = sp.duration_s
        say(
            f"[sweep:{grid.name}] batched eval {t_batched*1e3:.1f} ms vs "
            f"serial loop {t_serial_loop*1e3:.1f} ms "
            f"({t_serial_loop/max(t_batched, 1e-12):.1f}x)"
        )

    memory["batched_eval_mb"] = peak_rss_mb()
    shared_us = (t_batched + t_placement) * 1e6 / max(1, len(configs))
    records = []
    for c, traffic, placement, res, cfg_us in zip(
        configs, traffics, placements, results, per_config_us
    ):
        g = gmap[(c.workload, c.scale)]
        graph_bytes = (g.num_edges * 2 + g.num_nodes) * 8  # ET + props @ 8B words
        records.append(
            SweepRecord(
                config=c,
                num_nodes=g.num_nodes,
                num_edges=g.num_edges,
                num_iterations=int(iters[len(records)]),
                placement_method=placement.method,
                edge_balance=partitions[
                    (c.workload, c.scale, c.partitioner, c.num_parts)
                ].edge_balance(),
                phase_norm=traffic.normalized_by(graph_bytes),
                result=res,
                elapsed_us=cfg_us + shared_us,
            )
        )

    # The windowed contention pass of the reference package comes with a later
    # slice (refused at the top of this function); the payload keeps its keys.
    contention = None
    t_contention = None

    memory["final_mb"] = peak_rss_mb()
    timings = {
        "graphs_s": t_graphs,
        "trace_s": t_trace,
        "partition_traffic_s": t_pt,
        "placement_s": t_placement,
        "placement_serial_s": t_placement_serial,
        "batched_eval_s": t_batched,
        "serial_eval_s": t_serial_loop,
        "contention_s": t_contention,
        "total_s": obs.now_s() - t_start,
    }
    result = SweepResult(
        grid=grid,
        records=records,
        workload_stats=wl_stats,
        cache_stats=cache.stats.as_dict(),
        timings=timings,
        backend=backend,
        placement_stats=placement_stats,
        memory=memory,
        contention=contention,
    )
    if keep_artifacts:
        result.artifacts = {
            "traffics": traffics,
            "partitions": parts_list,
            "topologies": topologies,
            "placements": placements,
            "num_iterations": iters,
        }
    # Global registry feeds `--metrics-out`; the ATTACHED snapshot comes from
    # a private registry so §Perf renders exactly this sweep's numbers even
    # when several sweeps share a process (counters would otherwise
    # accumulate across runs).
    register_sweep_metrics(result)
    metrics_snapshot_for(result)
    return result


def register_sweep_metrics(result: SweepResult, reg=None) -> None:
    """Absorb a sweep's ad-hoc stat dicts into the obs metrics registry.

    Namespace placement is the determinism contract (`obs.metrics`):
    wall-clock stage timings, peak RSS, and cache hit/miss/retry events are
    `non_comparable`; placement descent statistics and the nocsim
    saturation bound are pure functions of the inputs and land in
    `comparable`."""
    reg = reg if reg is not None else obs.metrics.get_registry()
    gname = result.grid.name
    stage = reg.gauge("sweep.stage_seconds", non_comparable=True)
    for k, v in result.timings.items():
        if v is not None:
            stage.set(v, grid=gname, stage=k[:-2] if k.endswith("_s") else k)
    mem = reg.gauge("sweep.peak_rss_mb", non_comparable=True)
    for k, v in result.memory.items():
        mem.set(v, grid=gname, stage=k[:-3] if k.endswith("_mb") else k)
    cache_events = reg.counter("cache.events", non_comparable=True)
    for k, v in result.cache_stats.items():
        cache_events.inc(v, grid=gname, kind=k)
    pl_stats = reg.gauge("placement.stats")
    pl_seconds = reg.gauge("placement.seconds", non_comparable=True)
    for k, v in result.placement_stats.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.endswith("_s"):
            pl_seconds.set(float(v), grid=gname, stat=k[:-2])
        else:
            pl_stats.set(float(v), grid=gname, stat=k)
    if result.contention is not None:
        sat = reg.gauge("nocsim.saturation_bytes_per_s")
        for rec in result.contention["records"]:
            v = rec.get("saturation_bytes_per_s")
            if v is not None:
                sat.set(
                    v,
                    grid=gname,
                    key=rec["key"],
                    routing=rec["routing"],
                    flow_control=rec.get("flow_control", "open"),
                )


def metrics_snapshot_for(result: SweepResult) -> dict:
    """The sweep's metrics snapshot — the attached one when `run_sweep`
    produced it, else built fresh into a private registry (deserialized or
    hand-constructed results)."""
    snap = result.metrics_snapshot
    if snap is None:
        reg = obs.metrics.MetricsRegistry()
        register_sweep_metrics(result, reg)
        snap = reg.snapshot()
        result.metrics_snapshot = snap
    return snap


def figure_comparisons(records: list[SweepRecord]) -> list[dict]:
    """Pair each proposed-scheme record with the baseline record of the same
    (workload, algorithm, topology, parts) cell — the ratios behind the
    paper's Figs. 5/7/8 (`core.simulator.compare` semantics, computed from
    the batched results)."""
    cells: dict[tuple, dict[str, SweepRecord]] = {}
    for r in records:
        c = r.config
        # scale is a cell axis so multi-scale grids pair proposed-vs-baseline
        # within each scale; single-scale grids have one scale throughout and
        # keep their historical cells.
        cell = cells.setdefault(
            (c.workload, c.algorithm, c.topology, c.num_parts, c.scale), {}
        )
        cell["baseline" if c.is_baseline else f"{c.partitioner}+{c.placement}"] = r
    out = []
    for (workload, alg, topo, parts, scale), cell in sorted(cells.items()):
        base = cell.get("baseline")
        if base is None:
            continue
        for scheme, rec in sorted(cell.items()):
            if scheme == "baseline":
                continue
            opt, b = rec.result, base.result
            out.append(
                {
                    "workload": workload,
                    "algorithm": alg,
                    "topology": topo,
                    "num_parts": parts,
                    "scale": scale,
                    "scheme": scheme,
                    "avg_hops_optimized": opt.avg_hops,
                    "avg_hops_baseline": b.avg_hops,
                    "hop_decrease": b.avg_hops / opt.avg_hops if opt.avg_hops else float("inf"),
                    "speedup": opt.speedup_over(b),
                    "energy_ratio": opt.energy_ratio_over(b),
                    "time_optimized_s": opt.exec_time_s,
                    "time_baseline_s": b.exec_time_s,
                    "energy_optimized_j": opt.energy_j,
                    "energy_baseline_j": b.energy_j,
                    "elapsed_us": rec.elapsed_us + base.elapsed_us,
                }
            )
    return out
