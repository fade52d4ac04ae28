"""The journaled `--grid faults` runner: graceful degradation, measured.

One *unit* is a (workload, algorithm, topology, parts, fault_rate) cell.
Per unit the runner builds the proposed and baseline mappings (the grid's
paired schemes), samples ONE shared `FaultSet` — seeded purely by the unit's
identity, never by the mapping, so both schemes face the same broken fabric
— and replays both through the degraded windowed simulator
(`repro_torch.faults.degraded`): pristine routes up to the failure window, detour
routes plus backlog redistribution after it.  The headline per unit is

    win = baseline contended T_network / proposed contended T_network

and §Resilience reports win *retention*: win(rate) / win(0) per cell, at the
grid's fault rates.  Fault-free units additionally run the tile-death
evacuation/repair experiment (`repro_torch.faults.repair`) on an over-provisioned
router grid, with the stacked `repair_batch` engine cross-checked against
the serial reference on every run.

Backends: the float64 numpy replay is the reference of record (its results
fill the records); `backend="auto"` or `"torch"` also replays every unit on
the torch steppers on `device` and records the numpy↔torch relative
difference on the contended T_network (`backend_parity_rel`), and runs the
repair cross-check through the torch `repair_batch`.  `device=None` is the
CUDA device and raises without one; the vertex-engine traces run there on
every backend.

Crash safety: every completed unit is checkpointed to a `SweepJournal`
(atomic fsync'd JSON) before the next one starts; a journal opened with
`resume=True` skips journaled units, and because each unit's payload is a
pure function of its config and seed (no wall-clock, no process state; the
records come from the float64 numpy reference) the resumed artifact is
byte-identical to an uninterrupted run.  A unit that raises or exceeds
`unit_timeout_s` lands on the quarantine list instead of killing the sweep;
quarantined units are retried on the next resume.

Set `REPRO_FAULTS_UNIT_DELAY` (seconds) to sleep after each unit's journal
flush — the crash-resume test's kill window.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch.core.noc import Mesh2D
from repro_torch.core.placement import auto_mesh_for_parts, place, symmetrize_weights
from repro_torch.core.simulator import SimParams
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.experiments.cache import SweepCache
from repro_torch.experiments.grid import GridSpec
from repro_torch.experiments.journal import SweepJournal, UnitTimeout, unit_timeout
from repro_torch.experiments.placement_batch import repair_batch
from repro_torch.experiments.sweep import DEFAULT_TRACE_ITERS, TRACE_ITERS
from repro_torch.faults.degraded import PARITY_RTOL, build_degraded_schedule, degraded_batch
from repro_torch.faults.model import sample_link_faults, sample_tile_faults
from repro_torch.faults.repair import evacuate_placement, repair_descend, repair_placement
from repro_torch.faults.routing import degraded_distance_matrix
from repro_torch.graph.generators import table2_workloads
from repro_torch.nocsim.model import NocSimParams
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span

__all__ = [
    "ResilienceResult",
    "run_resilience",
    "unit_ids",
    "fault_seed",
    "register_resilience_metrics",
]

# Repair experiment knobs: descent budgets reported per fault-free unit, and
# the fraction of routers the over-provisioned repair grid adds as spares.
REPAIR_BUDGETS = (0, 8, 32)

# Scalars of one NocSimResult that enter a unit record (json-safe subset).
_SCHEME_FIELDS = (
    "t_network_contended_s",
    "t_drain_s",
    "t_serialization_s",
    "contention_excess",
    "mean_queue_delay_s",
    "p99_latency_s",
    "peak_window_util",
    "backlogged_window_frac",
)


def fault_seed(workload: str, topology: str, parts: int, rate: float) -> int:
    """Deterministic per-unit fault seed: a pure function of the unit's
    identity (NOT of the mapping — both schemes share the fabric), stable
    across processes (sha256, not the salted builtin hash)."""
    blob = f"{workload}/{topology}/P{parts}@r{rate:g}".encode()
    return int(hashlib.sha256(blob).hexdigest()[:8], 16)


def unit_ids(grid: GridSpec) -> list[str]:
    """Every unit id of the grid, in run order."""
    return [
        f"{w}/{a}/{t}/P{p}@r{r:g}"
        for w in grid.workloads
        for a in grid.algorithms
        for t in grid.topologies
        for p in grid.parts
        for r in (grid.fault_rates or ())
    ]


@dataclasses.dataclass
class ResilienceResult:
    grid: GridSpec
    records: list[dict]  # one per completed unit, run order
    repair: list[dict]  # repair-ledger rows (fault-free units only)
    quarantined: dict[str, dict]
    backend: str
    backend_parity_max_rel: float | None
    fail_window: int
    noc_params: NocSimParams
    # Cache stats stay OUT of to_dict(): a resumed run traces less than an
    # uninterrupted one, and the artifact must be byte-identical either way.
    # The rule lives in the metrics layer now — `register_resilience_metrics`
    # files them under the snapshot's `non_comparable` namespace (alongside
    # resumed/computed unit counts), so the byte-comparison exclusion is
    # structural rather than per-caller convention.
    cache_stats: dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        """The faults.json payload (deterministic: no wall-clock, records in
        run order, quarantine keyed/sorted by unit id)."""
        return {
            "grid": dataclasses.asdict(self.grid),
            "backend": self.backend,
            "faults": {
                "records": self.records,
                "repair": self.repair,
                "quarantined": {
                    k: self.quarantined[k] for k in sorted(self.quarantined)
                },
                "backend_parity_max_rel": self.backend_parity_max_rel,
                "parity_rtol": PARITY_RTOL,
                "fail_window": self.fail_window,
                "noc_params": dataclasses.asdict(self.noc_params),
            },
        }


def _scheme_record(result) -> dict:
    d = dataclasses.asdict(result)
    return {k: float(d[k]) for k in _SCHEME_FIELDS}


def _repair_grid(parts: int) -> Mesh2D:
    """Over-provisioned router grid for the tile-death experiment: the auto
    mesh plus one extra column of spares (the auto mesh has exactly 4·parts
    routers — zero headroom, so ANY tile death would be unrecoverable)."""
    auto = auto_mesh_for_parts(parts, "mesh2d")
    return Mesh2D(auto.kx, auto.ky + 1)


def _run_repair(
    traffic, partition, placement_method: str, parts: int, seed: int,
    backend: str, device: torch.device,
) -> list[dict]:
    """The fault-free unit's tile-death ledger: place on the over-provisioned
    grid, kill tiles, evacuate, then repair at each budget.  The stacked
    `repair_batch` engine (on `backend`, `device`) re-runs the largest budget
    and must reproduce the serial repair bit-for-bit (recorded as
    `batch_parity`)."""
    topo = _repair_grid(parts)
    placement = place(traffic, partition, topo, method=placement_method)
    num_dead = max(2, topo.num_nodes // 18)
    faults = sample_tile_faults(topo, num_dead, seed=seed)
    w = traffic.bytes_matrix
    rows = []
    for budget in REPAIR_BUDGETS:
        _repaired, report = repair_placement(placement, w, faults, budget=budget)
        rows.append(
            {
                "budget": budget,
                "router_grid": [topo.kx, topo.ky],
                "num_spares": topo.num_nodes - traffic.num_logical,
                **report.to_dict(),
            }
        )
    # Cross-check the stacked engine once per unit: re-run the largest budget
    # through repair_batch from the same evacuated seed and require
    # bit-identical sites vs the serial reference descent.
    d_deg = degraded_distance_matrix(topo, faults)
    blocked = np.zeros(topo.num_nodes, dtype=bool)
    blocked[list(faults.dead_tiles)] = True
    evac = evacuate_placement(placement, w, faults)
    batch_sites, _stats = repair_batch(
        [w], [d_deg], [evac], [blocked], max_steps=max(REPAIR_BUDGETS),
        backend=backend, device=device,
    )
    serial_site, _steps = repair_descend(
        symmetrize_weights(w), d_deg, evac, blocked, max(REPAIR_BUDGETS)
    )
    parity = bool(np.array_equal(batch_sites[0], serial_site))
    for r in rows:
        r["batch_parity"] = parity
    return rows


def run_resilience(
    grid: GridSpec,
    *,
    cache: SweepCache | None = None,
    cache_dir: str | None = None,
    backend: str = "auto",
    params: SimParams = SimParams(),
    noc_params: NocSimParams = NocSimParams(),
    journal: SweepJournal | None = None,
    unit_timeout_s: float = 0.0,
    progress=None,
    device: str | torch.device | None = None,
    graphs: dict[str, object] | None = None,
) -> ResilienceResult:
    """Run (or resume) every unit of a faults grid.  `journal` supplies the
    resume state; completed units are served from it verbatim — the artifact
    of a resumed run is byte-identical to an uninterrupted one.  `backend`
    is "numpy" (the reference alone) or "torch"/"auto" (the reference and
    the torch replay on `device`, `None` being the CUDA device).  `graphs`
    supplies pre-built workload graphs (name → HostGraph), as in
    `run_sweep`; the caller is responsible for them matching `grid.scale`
    and `grid.seed`."""
    if not grid.fault_rates:
        raise ValueError(f"grid {grid.name!r} has no fault_rates axis")
    say = progress or (lambda _msg: None)
    dev = resolve_device(device)
    use_torch = resolve_backend(backend) == "torch"
    if cache is None:
        cache = SweepCache(cache_dir, device=dev)
    schemes = grid.schemes()
    if len(schemes) != 2 or schemes[-1] != ("random", "random"):
        raise ValueError(
            "faults grids pair exactly (proposed, baseline=random+random)"
            f" schemes; got {schemes}"
        )
    (prop_pt, prop_pl), (base_pt, base_pl) = schemes

    if graphs is None:
        graphs = table2_workloads(scale=grid.scale, seed=grid.seed, names=grid.workloads)
    unit_delay = float(os.environ.get("REPRO_FAULTS_UNIT_DELAY", "0") or 0)
    fail_window = noc_params.windows // 2
    records: list[dict] = []
    repair_rows: list[dict] = []
    parity_max: float | None = None
    units_resumed = units_computed = 0

    for w_name in grid.workloads:
        g = graphs[w_name]
        for alg in grid.algorithms:
            trace = None  # traced lazily: a fully-journaled resume never traces
            for topo_name in grid.topologies:
                for parts in grid.parts:
                    for rate in grid.fault_rates:
                        uid = f"{w_name}/{alg}/{topo_name}/P{parts}@r{rate:g}"
                        if journal is not None and journal.has(uid):
                            rec = journal.get(uid)
                            records.append(rec["record"])
                            repair_rows.extend(rec.get("repair", []))
                            p = rec["record"].get("backend_parity_rel")
                            if p is not None:
                                parity_max = max(parity_max or 0.0, p)
                            units_resumed += 1
                            say(f"[faults:{grid.name}] {uid} (journaled)")
                            continue
                        if trace is None:
                            trace = cache.trace(
                                g, alg, max_iterations=TRACE_ITERS.get(alg, DEFAULT_TRACE_ITERS)
                            )
                        try:
                            with span(
                                "faults.unit", cat="faults", unit=uid,
                                fault_rate=rate, parts=parts,
                            ) as usp, unit_timeout(unit_timeout_s):
                                rec, unit_repair, parity = _run_unit(
                                    uid,
                                    g,
                                    trace,
                                    cache,
                                    workload=w_name,
                                    algorithm=alg,
                                    topology=topo_name,
                                    parts=parts,
                                    rate=rate,
                                    schemes=((prop_pt, prop_pl), (base_pt, base_pl)),
                                    params=params,
                                    noc_params=noc_params,
                                    fail_window=fail_window,
                                    use_torch=use_torch,
                                    device=dev,
                                    seed=grid.seed,
                                )
                        except KeyboardInterrupt:
                            raise
                        except (UnitTimeout, Exception) as e:  # noqa: BLE001
                            if journal is not None:
                                journal.quarantine_unit(uid, e)
                            say(f"[faults:{grid.name}] {uid} QUARANTINED: {e}")
                            continue
                        usp.annotate(
                            num_dead_links=rec["num_dead_links"], win=rec["win"]
                        )
                        units_computed += 1
                        if parity is not None:
                            parity_max = max(parity_max or 0.0, parity)
                        records.append(rec)
                        repair_rows.extend(unit_repair)
                        if journal is not None:
                            journal.record(uid, {"record": rec, "repair": unit_repair})
                        say(
                            f"[faults:{grid.name}] {uid} win "
                            f"{rec['win']:.2f}x ({rec['num_dead_links']} dead links)"
                        )
                        if unit_delay > 0:
                            time.sleep(unit_delay)

    result = ResilienceResult(
        grid=grid,
        records=records,
        repair=repair_rows,
        quarantined=dict(journal.quarantine) if journal is not None else {},
        backend="numpy+torch" if (use_torch and parity_max is not None) else "numpy",
        backend_parity_max_rel=parity_max,
        fail_window=fail_window,
        noc_params=noc_params,
        cache_stats=cache.stats.as_dict(),
    )
    if journal is not None:
        journal.close()
    register_resilience_metrics(result, resumed=units_resumed, computed=units_computed)
    return result


def register_resilience_metrics(
    result: ResilienceResult, *, resumed: int = 0, computed: int = 0, reg=None
) -> None:
    """File the faults runner's counts with the metrics registry.

    Namespace placement IS the byte-comparison rule (see `obs.metrics`):
    unit totals and the quarantine count are pure functions of the grid and
    appear in the committed artifact, so they are `comparable`; cache
    hit/miss/retry events and the resumed-vs-computed split depend on how
    many times the run was interrupted and are `non_comparable`."""
    reg = reg if reg is not None else obs_metrics.get_registry()
    gname = result.grid.name
    units = reg.gauge("faults.units")
    units.set(len(result.records), grid=gname, kind="completed")
    units.set(len(result.quarantined), grid=gname, kind="quarantined")
    units.set(len(result.repair), grid=gname, kind="repair_rows")
    runs = reg.counter("faults.unit_runs", non_comparable=True)
    if resumed:
        runs.inc(resumed, grid=gname, kind="resumed")
    if computed:
        runs.inc(computed, grid=gname, kind="computed")
    cache_events = reg.counter("cache.events", non_comparable=True)
    for k, v in result.cache_stats.items():
        cache_events.inc(v, grid=gname, kind=k)


def _run_unit(
    uid: str,
    g,
    trace,
    cache: SweepCache,
    *,
    workload: str,
    algorithm: str,
    topology: str,
    parts: int,
    rate: float,
    schemes,
    params: SimParams,
    noc_params: NocSimParams,
    fail_window: int,
    use_torch: bool,
    device: torch.device,
    seed: int,
) -> tuple[dict, list[dict], float | None]:
    """One unit: both schemes on one shared degraded fabric."""
    (prop_pt, prop_pl), (base_pt, base_pl) = schemes
    topo = auto_mesh_for_parts(parts, topology)
    fseed = fault_seed(workload, topology, parts, rate)
    faults = sample_link_faults(topo, rate, seed=fseed)

    traffics, placements = [], []
    for pt, pl in ((prop_pt, prop_pl), (base_pt, base_pl)):
        part = cache.partition(g, pt, parts)
        t = cache.traffic(g, part, trace)
        traffics.append(t)
        placements.append(place(t, part, topo, method=pl, seed=seed))
    faultsets = [faults, faults]
    schedules = [
        build_degraded_schedule(
            t, p, f, noc_params=noc_params, params=params, fail_window=fail_window
        )
        for t, p, f in zip(traffics, placements, faultsets)
    ]
    iters = trace.num_iterations
    res_np = degraded_batch(
        traffics,
        placements,
        faultsets,
        noc_params=noc_params,
        params=params,
        num_iterations=iters,
        backend="numpy",
        schedules=schedules,
    )
    parity = None
    if use_torch:
        res_torch = degraded_batch(
            traffics,
            placements,
            faultsets,
            noc_params=noc_params,
            params=params,
            num_iterations=iters,
            backend="torch",
            schedules=schedules,
            device=device,
        )
        parity = max(
            abs(t.t_network_contended_s - n.t_network_contended_s)
            / max(abs(n.t_network_contended_s), 1e-300)
            for t, n in zip(res_torch, res_np)
        )
    prop, base = res_np
    rec = {
        "unit_id": uid,
        "workload": workload,
        "algorithm": algorithm,
        "topology": topology,
        "num_parts": parts,
        "fault_rate": rate,
        "fault_seed": fseed,
        "num_dead_links": faults.num_dead_links(),
        "num_links": int(schedules[0].schedule.num_links),
        "num_detoured_flows": int(schedules[0].num_detoured_flows),
        "detour_stretch": float(schedules[0].detour_stretch),
        "proposed": {"scheme": f"{prop_pt}+{prop_pl}", **_scheme_record(prop)},
        "baseline": {"scheme": f"{base_pt}+{base_pl}", **_scheme_record(base)},
        "win": base.t_network_contended_s / max(prop.t_network_contended_s, 1e-300),
        "backend_parity_rel": parity,
    }
    unit_repair: list[dict] = []
    if rate == 0.0:
        part = cache.partition(g, prop_pt, parts)
        t = cache.traffic(g, part, trace)
        rows = _run_repair(
            t, part, prop_pl, parts, fseed + 1,
            backend="torch" if use_torch else "numpy", device=device,
        )
        for r in rows:
            r.update(
                unit_id=uid, workload=workload, topology=topology, num_parts=parts
            )
        unit_repair = rows
    return rec, unit_repair, parity
