"""Declarative sweep grids: the config space behind every paper figure.

A `GridSpec` is the cross product
    workload × algorithm × (partitioner, placement) × topology × mesh size
expanded into frozen `SweepConfig` cells.  The paper's figures compare the
proposed scheme (powerlaw partition + optimised placement) against the
randomized baseline on the same (workload, algorithm, topology, parts) cell,
so the named `paper` grid pairs the two schemes; `ablation` crosses the
scheme axes fully (e.g. powerlaw partition under random placement).
"""
from __future__ import annotations

import dataclasses
import itertools

__all__ = ["SweepConfig", "GridSpec", "GRIDS", "grid_by_name", "PAPER_SCALE"]

# Offline container default: Table 2 graphs regenerated as R-MAT at 1% of the
# published |V|/|E| (skew is scale-invariant under R-MAT; EXPERIMENTS.md
# §Calibration reports the measured skew at the scale used).
PAPER_SCALE = 0.01


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One fully-specified experiment cell."""

    workload: str  # Table-2 graph name (graph.generators.WORKLOADS)
    algorithm: str  # bfs | sssp | pagerank
    partitioner: str  # core.partition.PARTITIONERS key
    placement: str  # core.placement.place method (auto|random|quad|greedy|...)
    topology: str  # mesh2d | fbutterfly | torus2d | torus3d (exact routing)
    num_parts: int  # engines; NoC has 4·num_parts routers
    scale: float = PAPER_SCALE
    seed: int = 0
    # True on configs expanded from a multi-scale grid (GridSpec.scales):
    # the scale then disambiguates the key.  Single-scale grids keep the
    # historical key format, so committed artifacts stay stable.
    scale_in_key: bool = False

    @property
    def key(self) -> str:
        base = (
            f"{self.workload}/{self.algorithm}/{self.partitioner}+{self.placement}"
            f"/{self.topology}/P{self.num_parts}"
        )
        return f"{base}@s{self.scale:g}" if self.scale_in_key else base

    @property
    def is_baseline(self) -> bool:
        """The paper's baseline configuration: random partition + random map."""
        return self.partitioner == "random" and self.placement == "random"


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Axes of one sweep.  `pair_schemes=True` zips (partitioners, placements)
    into matched schemes instead of crossing them (the paper's proposed-vs-
    baseline comparison); False takes the full product (ablations)."""

    name: str
    workloads: tuple[str, ...]
    algorithms: tuple[str, ...]
    partitioners: tuple[str, ...]
    placements: tuple[str, ...]
    topologies: tuple[str, ...] = ("mesh2d",)
    parts: tuple[int, ...] = (16,)
    scale: float = PAPER_SCALE
    pair_schemes: bool = True
    seed: int = 0
    # True → run_sweep follows the batched evaluation with the windowed
    # contention pass (repro_torch.nocsim): every config × routing arm through the
    # stacked queue simulator, numpy↔jax parity recorded in the payload.
    contention: bool = False
    # Multi-scale axis (`--grid scale`): when set, the cross product gains a
    # workload-scale dimension and every cell key carries its scale suffix;
    # None keeps the single `scale` above (and the historical keys).
    scales: tuple[float, ...] | None = None
    # When set, run_sweep routes traffic extraction through the sparse
    # streaming path (`SweepCache.traffic(layout="auto", edge_block=...)`):
    # per-edge transients bounded at O(edge_block) and the cache persisted as
    # content-hashed shards instead of one whole-matrix file.
    traffic_edge_block: int | None = None
    # Resilience axis (`--grid faults`): fractions of the NoC's unidirectional
    # links to kill (seeded, connectivity-preserving — repro.faults).  When
    # set, run.py routes the grid to the journaled resilience runner
    # (`repro_torch.experiments.resilience.run_resilience`) instead of `run_sweep`;
    # the runner pairs the proposed and baseline schemes itself, one shared
    # FaultSet per (workload, topology, parts, rate) unit.
    fault_rates: tuple[float, ...] | None = None
    # Backpressure axis (`--grid backpressure`): per-link buffer depths (in
    # units of one window's service) for the closed-loop credit arm
    # (repro_torch.nocsim.credit).  When set, the contention pass adds one credit
    # record set per depth per routing arm plus the infinite-credit
    # convergence audit (credit @ depth=inf must reproduce the open-loop
    # records bit-identically on numpy, ≤1e-6 on jax — gated by
    # `report --check`).  Requires `contention=True`.
    buffer_depths: tuple[float, ...] | None = None

    def schemes(self) -> tuple[tuple[str, str], ...]:
        if self.pair_schemes:
            return tuple(zip(self.partitioners, self.placements))
        return tuple(itertools.product(self.partitioners, self.placements))

    def scale_axis(self) -> tuple[float, ...]:
        return self.scales if self.scales is not None else (self.scale,)

    def expand(self) -> list[SweepConfig]:
        return [
            SweepConfig(
                workload=w,
                algorithm=a,
                partitioner=pt,
                placement=pl,
                topology=t,
                num_parts=p,
                scale=s,
                seed=self.seed,
                scale_in_key=self.scales is not None,
            )
            for w, a, (pt, pl), t, p, s in itertools.product(
                self.workloads,
                self.algorithms,
                self.schemes(),
                self.topologies,
                self.parts,
                self.scale_axis(),
            )
        ]

    @property
    def num_configs(self) -> int:
        return (
            len(self.workloads)
            * len(self.algorithms)
            * len(self.schemes())
            * len(self.topologies)
            * len(self.parts)
            * len(self.scale_axis())
        )


_TABLE2 = ("amazon", "soc-pokec", "wiki", "ljournal")
_ALGS = ("bfs", "sssp", "pagerank")
_PROPOSED_VS_BASELINE = dict(
    partitioners=("powerlaw", "random"), placements=("auto", "random"), pair_schemes=True
)

GRIDS: dict[str, GridSpec] = {
    # Figs. 5/7/8: all Table-2 workloads × all algorithms × both topologies,
    # proposed scheme vs the randomized baseline, 16 engines (8×8 NoC).
    "paper": GridSpec(
        name="paper",
        workloads=_TABLE2,
        algorithms=_ALGS,
        topologies=("mesh2d", "fbutterfly"),
        parts=(16,),
        **_PROPOSED_VS_BASELINE,
    ),
    # CI-sized 3-config sweep (scripts/verify.sh): one workload, one
    # algorithm, proposed (under both searched placements) vs baseline on a
    # tiny graph.  Placement is pinned to quad/greedy+2opt — "auto" would
    # route this 16-shard instance to the exact MILP, which is minutes of
    # HiGHS for no extra fidelity in CI.  The powerlaw+greedy scheme exists
    # so CI exercises the batched greedy *construction* path, not just the
    # quad one (asserted in scripts/verify.sh).
    "mini": GridSpec(
        name="mini",
        workloads=("amazon",),
        algorithms=("bfs",),
        partitioners=("powerlaw", "powerlaw", "random"),
        placements=("quad", "greedy", "random"),
        topologies=("mesh2d",),
        parts=(4,),
        scale=0.001,
        pair_schemes=True,
    ),
    # Scheme ablation: full partitioner × placement product at two mesh sizes
    # (e.g. powerlaw partition under random placement isolates Algorithm 2
    # from Algorithms 3/4).
    "ablation": GridSpec(
        name="ablation",
        workloads=("amazon", "wiki"),
        algorithms=("pagerank",),
        partitioners=("powerlaw", "hash", "random"),
        placements=("auto", "random"),
        topologies=("mesh2d",),
        parts=(8, 16),
        pair_schemes=False,
    ),
    # Mesh-size scaling of the proposed scheme's gains.
    "meshscale": GridSpec(
        name="meshscale",
        workloads=("amazon", "soc-pokec"),
        algorithms=("pagerank",),
        topologies=("mesh2d", "fbutterfly"),
        parts=(9, 16, 25),
        **_PROPOSED_VS_BASELINE,
    ),
    # Wrap-link gains: mesh2d vs torus2d (exact wraparound X-Y routing) on
    # the same cells, at two mesh sizes, under three schemes:
    #   powerlaw+greedy — the same search on both topologies (quad would
    #     serve mesh2d but not the torus, making the comparison about
    #     methods instead of links); every searched config goes through the
    #     batched greedy construction (the stacked path at C ≫ 1).
    #   powerlaw+auto   — the constructive arm: "auto" resolves to the
    #     torus-native wrap-aware layout on torus2d (torus_quad, NO search)
    #     and to quad+2opt on mesh2d; §Torus compares its torus2d H against
    #     powerlaw+greedy's to show construction beats search for free.
    #   random+random   — the paper baseline.
    # Windowed NoC contention (repro_torch.nocsim): proposed scheme vs baseline on
    # mesh2d, torus2d AND the 3-D pod fabric (torus3d, 4×4×4 routers at 16
    # engines) with the phase-resolved injection profile, both routing arms
    # (dimension-ordered vs minimal-adaptive two-choice) — quantifies the
    # hotspot-formation / queueing effects the analytic serialization term
    # misses and how much of the paper's win survives smarter routing
    # (EXPERIMENTS.md §Contention).
    "contention": GridSpec(
        name="contention",
        workloads=("amazon", "soc-pokec"),
        algorithms=("pagerank", "bfs"),
        topologies=("mesh2d", "torus2d", "torus3d"),
        parts=(16,),
        contention=True,
        **_PROPOSED_VS_BASELINE,
    ),
    # Closed-loop backpressure (`--grid backpressure`): the credit arm
    # (repro_torch.nocsim.credit) over a per-link buffer-depth axis on the
    # §Contention cells, all three torus/mesh fabrics incl. the 3-D pod.
    # §Backpressure reports how much of the open-loop contended win the
    # proposed scheme retains once finite buffers gate injection (tree
    # saturation / head-of-line blocking), per depth and routing arm.
    "backpressure": GridSpec(
        name="backpressure",
        workloads=("amazon", "soc-pokec"),
        algorithms=("pagerank",),
        topologies=("mesh2d", "torus2d", "torus3d"),
        parts=(16,),
        contention=True,
        buffer_depths=(0.5, 1.0, 2.0, 4.0, 8.0),
        **_PROPOSED_VS_BASELINE,
    ),
    # Published-workload-size scaling (`--grid scale`): the sparse-first
    # pipeline (streamed traffic extraction, sharded traffic cache) on the
    # heaviest Table-2 social graph at 5×–25× the default 1% scale —
    # soc-pokec at scale 0.25 is ~7.7M edges, where whole-edge-list
    # transients start to matter.  Proposed vs baseline scheme per scale;
    # §Scale in EXPERIMENTS.md reports the per-stage wall time and the
    # process peak RSS recorded after every pipeline stage.
    "scale": GridSpec(
        name="scale",
        workloads=("soc-pokec",),
        algorithms=("pagerank",),
        topologies=("mesh2d",),
        parts=(16,),
        scales=(0.05, 0.1, 0.25),
        traffic_edge_block=1 << 20,
        **_PROPOSED_VS_BASELINE,
    ),
    # Graceful degradation (`--grid faults`): the §Contention cells replayed
    # on fabrics with 0–10% of links killed mid-replay (seeded,
    # connectivity-preserving; detour routing + backlog redistribution at the
    # failure window) — §Resilience reports how much of the proposed scheme's
    # contended win survives each fault rate, plus the tile-death
    # evacuation/repair ledger at rate 0.  Runs through the journaled,
    # crash-resumable unit runner (`--resume`).
    "faults": GridSpec(
        name="faults",
        workloads=("amazon", "soc-pokec"),
        algorithms=("pagerank",),
        topologies=("mesh2d", "torus2d"),
        parts=(16,),
        contention=True,
        fault_rates=(0.0, 0.01, 0.02, 0.05, 0.10),
        **_PROPOSED_VS_BASELINE,
    ),
    # CI-sized faults grid (scripts/verify.sh + tests/test_crash_resume.py):
    # one workload/algorithm on a tiny graph, fault-free + one faulted rate.
    # Placement pinned to quad for the same reason as `mini`: "auto" would
    # route the 16-shard instance to the exact MILP.
    "minifaults": GridSpec(
        name="minifaults",
        workloads=("amazon",),
        algorithms=("bfs",),
        partitioners=("powerlaw", "random"),
        placements=("quad", "random"),
        topologies=("mesh2d",),
        parts=(4,),
        scale=0.001,
        contention=True,
        fault_rates=(0.0, 0.05),
        pair_schemes=True,
    ),
    # CI-sized backpressure grid (scripts/verify.sh): the minifaults cells
    # with the credit arm at two depths — asserts in CI that the closed-loop
    # stepper ran, held parity, and passed the infinite-credit audit.
    "minicredit": GridSpec(
        name="minicredit",
        workloads=("amazon",),
        algorithms=("bfs",),
        partitioners=("powerlaw", "random"),
        placements=("quad", "random"),
        topologies=("mesh2d",),
        parts=(4,),
        scale=0.001,
        contention=True,
        buffer_depths=(1.0, 4.0),
        pair_schemes=True,
    ),
    "torus": GridSpec(
        name="torus",
        workloads=("amazon", "soc-pokec"),
        algorithms=_ALGS,
        partitioners=("powerlaw", "powerlaw", "random"),
        placements=("greedy", "auto", "random"),
        topologies=("mesh2d", "torus2d"),
        parts=(16, 25),
        pair_schemes=True,
    ),
}


def grid_by_name(name: str, *, scale: float | None = None) -> GridSpec:
    try:
        grid = GRIDS[name]
    except KeyError:
        raise ValueError(f"unknown grid {name!r}; options: {sorted(GRIDS)}") from None
    if scale is not None:
        # An explicit override pins multi-scale grids to the one scale too
        # (scales=None), e.g. `--grid scale --scale 0.1` for the verify.sh
        # memory-budget guard.
        grid = dataclasses.replace(grid, scale=scale, scales=None)
    return grid
