"""Placement evacuation and bounded incremental repair after tile deaths.

When tiles die, the shards they hosted must move.  The ROADMAP's
"incremental re-placement as a service" framing: rather than re-running the
full placement search (seconds at sweep scale), evacuate the displaced
shards greedily and spend a *bounded* number of best-move descent steps
repairing the surviving layout — reporting how much of the full-research
quality each budget buys.

Three H values per repair (all under the DEGRADED distance metric, i.e.
hops over surviving links — `repro_torch.faults.routing.degraded_distance_matrix`):

  * `h_evacuated` — the surviving layout after greedy evacuation only
    (budget 0): each displaced shard, heaviest incident traffic first, takes
    the free live router minimising its traffic-weighted distance to the
    shards already placed.
  * `h_repaired`  — after `budget` steps of steepest-descent repair seeded
    from the evacuated layout.  The descent replicates
    `core.placement.two_opt_best_move`'s exact selection semantics (dense
    `swap_delta_matrix` / `move_delta_matrix` deltas, flat argmin tie-break,
    a move wins only when strictly smaller, `BEST_MOVE_TOL` convergence)
    with two fault-layer changes: distances are degraded and dead tiles are
    marked occupied so no shard can move onto them.  The stacked batch
    counterpart is `repro_torch.experiments.placement_batch.repair_batch`
    (bit-parity asserted in tests/test_faults_repair.py).
  * `h_full`      — the full-research comparator: a from-scratch hub-first
    constructive layout on the surviving fabric refined by an unbounded
    (default `default_max_steps`) descent; what a full re-place would buy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import (
    BEST_MOVE_TOL,
    Placement,
    default_max_steps,
    move_delta_matrix,
    swap_delta_matrix,
    symmetrize_weights,
)
from repro_torch.faults.model import FaultSet
from repro_torch.faults.routing import degraded_distance_matrix

__all__ = [
    "RepairReport",
    "evacuate_placement",
    "repair_descend",
    "repair_placement",
    "full_research_layout",
]


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """One repair experiment's ledger (all H under degraded distances)."""

    num_dead_tiles: int
    num_displaced: int
    budget: int
    steps_used: int
    h_pre_fault: float  # surviving layout valued as if no tile died (pristine d)
    h_evacuated: float
    h_repaired: float
    h_full: float
    # (h_evacuated - h_repaired) / (h_evacuated - h_full): 0 = evacuation
    # only, 1 = the budget recovered everything a full re-place would; can
    # exceed 1 when the bounded repair beats the from-scratch layout.
    recovery_frac: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _weighted_hops(w: np.ndarray, d: np.ndarray, site: np.ndarray) -> float:
    return float((w * d[np.ix_(site, site)]).sum())


def evacuate_placement(
    placement: Placement, weights: np.ndarray, faults: FaultSet
) -> np.ndarray:
    """Greedy evacuation: displaced shards (those sitting on dead tiles),
    ordered by descending incident traffic (ties by shard index), each take
    the free LIVE router minimising Σ_k w[i,k]·d_deg(t, site_k) over the
    currently-placed shards.  Returns the repaired site array (surviving
    shards keep their routers).  Deterministic — no rng."""
    w = symmetrize_weights(weights)
    d = degraded_distance_matrix(placement.topology, faults)
    site = placement.site.copy()
    n = site.size
    num_sites = placement.topology.num_nodes
    dead = np.zeros(num_sites, dtype=bool)
    dead[list(faults.dead_tiles)] = True
    displaced = np.nonzero(dead[site])[0]
    if displaced.size == 0:
        return site
    incident = w[displaced].sum(axis=1)
    displaced = displaced[np.lexsort((displaced, -incident))]
    placed = np.ones(n, dtype=bool)
    placed[displaced] = False
    occupied = np.zeros(num_sites, dtype=bool)
    occupied[site[placed]] = True
    for i in displaced:
        cost = w[i, placed] @ d[np.ix_(site[placed], np.arange(num_sites))]
        cost = np.where(occupied | dead, np.inf, cost)
        t = int(cost.argmin())
        if not np.isfinite(cost[t]):
            raise ValueError("no free live router left for evacuation")
        site[i] = t
        occupied[t] = True
        placed[i] = True
    return site


def repair_descend(
    w: np.ndarray,
    d: np.ndarray,
    site: np.ndarray,
    blocked: np.ndarray,
    max_steps: int,
) -> tuple[np.ndarray, int]:
    """Bounded steepest descent on a (possibly degraded) distance matrix with
    `blocked` routers treated as permanently occupied — the serial reference
    `repro_torch.experiments.placement_batch.repair_batch` must match bit-for-bit
    (identical delta kernels, argmin tie-breaks and accept rules as
    `two_opt_best_move`'s dense branch).  Returns (site, steps_used)."""
    site = np.asarray(site, dtype=np.int64).copy()
    n = site.size
    num_sites = d.shape[0]
    occupied = np.asarray(blocked, dtype=bool).copy()
    occupied[site] = True
    steps = 0
    for _ in range(max_steps):
        ds = swap_delta_matrix(w, d, site)
        np.fill_diagonal(ds, np.inf)
        best_swap = int(ds.argmin())
        i_s, j_s = divmod(best_swap, n)
        best = ds[i_s, j_s]
        i_m = t_m = -1
        if not occupied.all():
            dm = move_delta_matrix(w, d, site)
            dm[:, occupied] = np.inf
            best_move = int(dm.argmin())
            i_m, t_m = divmod(best_move, num_sites)
            if dm[i_m, t_m] < best:
                best = dm[i_m, t_m]
            else:
                i_m = -1
        if best >= BEST_MOVE_TOL:
            break
        steps += 1
        if i_m >= 0:
            occupied[site[i_m]] = False
            occupied[t_m] = True
            site[i_m] = t_m
        else:
            site[i_s], site[j_s] = site[j_s], site[i_s]
    return site, steps


def full_research_layout(
    w: np.ndarray, d: np.ndarray, blocked: np.ndarray, n: int
) -> np.ndarray:
    """From-scratch constructive layout on the surviving fabric: shards in
    descending incident-weight order (the power-law hubs first), each to the
    free live router minimising cost against the already-placed set; hubs
    gravitate to the degraded fabric's most-central routers because the first
    shard takes the minimal-row-sum live site.  Deterministic."""
    num_sites = d.shape[0]
    live = ~np.asarray(blocked, dtype=bool)
    order = np.lexsort((np.arange(n), -w.sum(axis=1)))
    site = np.full(n, -1, dtype=np.int64)
    occupied = np.asarray(blocked, dtype=bool).copy()
    centrality = np.where(live, d.sum(axis=1), np.inf)
    placed: list[int] = []
    for i in order:
        if not placed:
            t = int(centrality.argmin())
        else:
            pl = np.array(placed, dtype=np.int64)
            cost = w[i, pl] @ d[np.ix_(site[pl], np.arange(num_sites))]
            cost = np.where(occupied, np.inf, cost)
            t = int(cost.argmin())
        if occupied[t] or not live[t]:
            raise ValueError("no free live router for full-research layout")
        site[i] = t
        occupied[t] = True
        placed.append(i)
    return site


def repair_placement(
    placement: Placement,
    weights: np.ndarray,
    faults: FaultSet,
    *,
    budget: int,
) -> tuple[Placement, RepairReport]:
    """Evacuate + repair one placement after `faults` kill tiles.  Returns
    the repaired `Placement` (method tagged `+repair`) and the ledger the
    §Resilience repair table renders.  `budget` bounds the descent steps;
    the full-research comparator always runs to `default_max_steps`."""
    w = symmetrize_weights(weights)
    d_deg = degraded_distance_matrix(placement.topology, faults)
    d_pre = placement.topology.distance_matrix().astype(np.float64)
    num_sites = placement.topology.num_nodes
    blocked = np.zeros(num_sites, dtype=bool)
    blocked[list(faults.dead_tiles)] = True
    evac = evacuate_placement(placement, weights, faults)
    repaired, steps = repair_descend(w, d_deg, evac, blocked, budget)
    full = full_research_layout(w, d_deg, blocked, evac.size)
    full, _ = repair_descend(w, d_deg, full, blocked, default_max_steps(evac.size))
    h_evac = _weighted_hops(w, d_deg, evac) / 2.0
    h_rep = _weighted_hops(w, d_deg, repaired) / 2.0
    h_full = _weighted_hops(w, d_deg, full) / 2.0
    gap = h_evac - h_full
    report = RepairReport(
        num_dead_tiles=len(faults.dead_tiles),
        num_displaced=int(np.sum(blocked[placement.site])),
        budget=budget,
        steps_used=steps,
        h_pre_fault=_weighted_hops(w, d_pre, placement.site) / 2.0,
        h_evacuated=h_evac,
        h_repaired=h_rep,
        h_full=h_full,
        recovery_frac=float((h_evac - h_rep) / gap) if gap > 0 else 1.0,
    )
    return (
        Placement(placement.topology, repaired, placement.method + "+repair"),
        report,
    )
