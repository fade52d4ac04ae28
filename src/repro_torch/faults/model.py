"""The fault model: which links and tiles of a fabric are dead or derated.

A `FaultSet` is a frozen, hashable description of one degraded fabric state:

  * `dead_links`   — unidirectional link keys (`c_from + c_to`, the same
    2·ndim tuples `Topology.route_links` emits) that carry no traffic.  The
    samplers below always kill a physical cable whole (both directions), but
    the routing layer handles asymmetric deaths too.
  * `derated_links` — surviving links running at a fraction γ ∈ (0, 1) of
    nominal bandwidth (γ = 1 entries are dropped at construction).
  * `dead_tiles`   — router indices (into `topology.coords()`) that are gone
    entirely; every link touching a dead tile is implicitly dead and no
    shard may be placed there.

Samplers are deterministic in their seed and *connectivity-preserving*: a
candidate kill that would disconnect any pair of surviving routers is
skipped, so detour routing (`repro_torch.faults.routing`) always has a path and
the degraded sweep never manufactures an unreachable fabric.  Deterministic
seeding is what makes the journaled `--grid faults` sweep resumable
bit-identically: the fault set of a unit is a pure function of its seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.noc import Topology

__all__ = ["FaultSet", "sample_link_faults", "sample_tile_faults"]

LinkKey = tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FaultSet:
    """One fabric's fault state (frozen + hashable: routing caches key on it)."""

    dead_links: frozenset[LinkKey] = frozenset()
    # Sorted (link_key, gamma) pairs — a hashable mapping link → bandwidth
    # fraction.  Use `derate_of` / `derated` to consume it.
    derated_links: tuple[tuple[LinkKey, float], ...] = ()
    dead_tiles: frozenset[int] = frozenset()

    def __post_init__(self):
        object.__setattr__(self, "dead_links", frozenset(self.dead_links))
        object.__setattr__(self, "dead_tiles", frozenset(int(t) for t in self.dead_tiles))
        der = []
        for key, gamma in self.derated_links:
            gamma = float(gamma)
            if not (0.0 < gamma <= 1.0):
                raise ValueError(f"derate factor {gamma} outside (0, 1] for link {key}")
            if gamma < 1.0:
                der.append((tuple(key), gamma))
        object.__setattr__(self, "derated_links", tuple(sorted(der)))

    @property
    def is_empty(self) -> bool:
        return not (self.dead_links or self.derated_links or self.dead_tiles)

    @property
    def derated(self) -> dict[LinkKey, float]:
        return dict(self.derated_links)

    def derate_of(self, key: LinkKey) -> float:
        return self.derated.get(tuple(key), 1.0)

    def num_dead_links(self) -> int:
        return len(self.dead_links)

    def describe(self) -> str:
        return (
            f"{len(self.dead_links)} dead links, {len(self.derated_links)} derated,"
            f" {len(self.dead_tiles)} dead tiles"
        )


def _physical_links(topology: Topology) -> list[LinkKey]:
    """Every unidirectional link key of the fabric, from the routing operator's
    shared link-id universe (sorted: deterministic sampling order)."""
    from repro_torch.nocsim.routes import route_operators

    ops = route_operators(topology)
    if ops is None:
        raise ValueError(
            f"topology {topology.name!r} has no exact routing model; fault"
            " injection needs the per-link universe"
        )
    return sorted(ops.link_keys)


def _coord_index(topology: Topology) -> dict[tuple[int, ...], int]:
    return {tuple(c): i for i, c in enumerate(topology.coords())}


def _connected(topology: Topology, dead_links: set[LinkKey], dead_tiles: set[int]) -> bool:
    """Are all surviving tiles mutually reachable over surviving links?
    Links die in both directions together here (the samplers' invariant), so
    an undirected BFS suffices."""
    lookup = _coord_index(topology)
    ndim = topology.coords().shape[1]
    adj: dict[int, list[int]] = {}
    for key in _physical_links(topology):
        if key in dead_links:
            continue
        u, v = lookup[key[:ndim]], lookup[key[ndim:]]
        if u in dead_tiles or v in dead_tiles:
            continue
        adj.setdefault(u, []).append(v)
    alive = [i for i in range(topology.num_nodes) if i not in dead_tiles]
    if not alive:
        return True
    seen = {alive[0]}
    frontier = [alive[0]]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj.get(u, ()):
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return len(seen) == len(alive)


def sample_link_faults(
    topology: Topology,
    rate: float,
    *,
    seed: int = 0,
    derate_frac: float = 0.0,
    derate_gamma: float = 0.5,
) -> FaultSet:
    """Kill ~`rate` of the fabric's unidirectional links, whole cables at a
    time (both directions), preserving connectivity.

    Candidate cables are shuffled by the seeded rng and killed greedily; a
    cable whose death would disconnect the surviving fabric is skipped (so
    very high rates saturate at the fabric's connectivity limit rather than
    failing).  `derate_frac` additionally derates that fraction of the
    *surviving* cables to `derate_gamma`× bandwidth.  rate = 0 and
    derate_frac = 0 return the canonical empty FaultSet."""
    if not (0.0 <= rate < 1.0):
        raise ValueError(f"fault rate {rate} outside [0, 1)")
    links = _physical_links(topology)
    ndim = topology.coords().shape[1]
    cables = sorted({tuple(sorted((k, k[ndim:] + k[:ndim]))) for k in links})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(cables))
    target_uni = int(round(rate * len(links)))
    dead: set[LinkKey] = set()
    for idx in order:
        if len(dead) >= target_uni:
            break
        a, b = cables[idx]
        trial = dead | {a, b}
        if _connected(topology, trial, set()):
            dead = trial
    derated: list[tuple[LinkKey, float]] = []
    if derate_frac > 0.0:
        survivors = [c for c in cables if c[0] not in dead]
        n_der = int(round(derate_frac * len(survivors)))
        for idx in rng.permutation(len(survivors))[:n_der]:
            a, b = survivors[idx]
            derated += [(a, derate_gamma), (b, derate_gamma)]
    return FaultSet(dead_links=frozenset(dead), derated_links=tuple(derated))


def sample_tile_faults(
    topology: Topology,
    num_dead: int,
    *,
    seed: int = 0,
    protected: tuple[int, ...] = (),
) -> FaultSet:
    """Kill `num_dead` tiles (and implicitly every incident link), preserving
    connectivity of the survivors and never touching `protected` routers.
    Candidates are shuffled by the seeded rng; a tile whose death would
    disconnect the surviving fabric is skipped."""
    if num_dead < 0:
        raise ValueError("num_dead must be >= 0")
    rng = np.random.default_rng(seed)
    prot = set(int(p) for p in protected)
    candidates = [i for i in range(topology.num_nodes) if i not in prot]
    order = rng.permutation(len(candidates))
    dead: set[int] = set()
    for idx in order:
        if len(dead) >= num_dead:
            break
        trial = dead | {candidates[idx]}
        if len(trial) >= topology.num_nodes:
            continue
        if _connected(topology, set(), trial):
            dead = trial
    return FaultSet(dead_tiles=frozenset(dead))
