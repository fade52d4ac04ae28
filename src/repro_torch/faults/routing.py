"""Detour-capable routing on a faulted fabric.

Contract (property-tested across all four topologies in
tests/test_faults_routing.py):

  * a returned route never traverses a dead link or touches a dead tile;
  * with an empty `FaultSet` the route is BIT-IDENTICAL to
    `Topology.route_links` (the pristine dimension-ordered route) — the
    fault layer costs nothing when there are no faults;
  * route length ≥ the fault-free distance (dimension-order permutations are
    minimal; the BFS fallback is the shortest *surviving* path, which can
    only be longer).

Strategy: try every dimension traversal order (the natural ascending order
first, so the clean case short-circuits to the pristine route), and fall
back to a deterministic BFS over the surviving links when every minimal
dimension-ordered route crosses a fault.  The BFS adjacency comes from the
routing operator's shared link-id universe (`nocsim.routes.route_operators`),
so every detour link the degraded simulator is asked to load exists in its
(L, N·N) incidence space.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

from repro_torch.core.noc import Topology
from repro_torch.faults.model import FaultSet, LinkKey

__all__ = [
    "route_links_faulty",
    "degraded_distance_matrix",
    "surviving_link_keys",
    "effective_dead_links",
]


@functools.lru_cache(maxsize=64)
def _link_universe(topology: Topology) -> tuple[LinkKey, ...]:
    from repro_torch.nocsim.routes import route_operators

    ops = route_operators(topology)
    if ops is None:
        raise ValueError(
            f"topology {topology.name!r} has no exact routing model; fault-aware"
            " routing needs the per-link universe"
        )
    return ops.link_keys


@functools.lru_cache(maxsize=256)
def effective_dead_links(topology: Topology, faults: FaultSet) -> frozenset[LinkKey]:
    """Dead links plus every link incident to a dead tile — the set a route
    must avoid."""
    dead = set(faults.dead_links)
    if faults.dead_tiles:
        coords = topology.coords()
        ndim = coords.shape[1]
        dead_coords = {tuple(coords[t]) for t in faults.dead_tiles}
        for key in _link_universe(topology):
            if key[:ndim] in dead_coords or key[ndim:] in dead_coords:
                dead.add(key)
    return frozenset(dead)


@functools.lru_cache(maxsize=256)
def _surviving_adjacency(
    topology: Topology, faults: FaultSet
) -> dict[int, tuple[tuple[int, LinkKey], ...]]:
    """node index → sorted (neighbor index, link key) over surviving links
    between live tiles.  Sorted neighbors make the BFS detours deterministic
    (independent of set/dict iteration order)."""
    coords = topology.coords()
    ndim = coords.shape[1]
    lookup = {tuple(c): i for i, c in enumerate(coords)}
    dead = effective_dead_links(topology, faults)
    adj: dict[int, list[tuple[int, LinkKey]]] = {}
    for key in _link_universe(topology):
        if key in dead:
            continue
        u, v = lookup[key[:ndim]], lookup[key[ndim:]]
        if u in faults.dead_tiles or v in faults.dead_tiles:
            continue
        adj.setdefault(u, []).append((v, key))
    return {u: tuple(sorted(nb)) for u, nb in adj.items()}


def surviving_link_keys(topology: Topology, faults: FaultSet) -> tuple[LinkKey, ...]:
    """The live link keys of the faulted fabric, in link-universe order."""
    dead = effective_dead_links(topology, faults)
    return tuple(k for k in _link_universe(topology) if k not in dead)


def _bfs_route(
    topology: Topology,
    faults: FaultSet,
    src: int,
    dst: int,
) -> list[LinkKey] | None:
    """Deterministic shortest surviving path src → dst as a link-key list
    (None = unreachable).  Plain BFS with sorted neighbor expansion: the
    first path found is the lexicographically-least shortest path."""
    if src == dst:
        return []
    adj = _surviving_adjacency(topology, faults)
    prev: dict[int, tuple[int, LinkKey]] = {src: (-1, ())}
    frontier = [src]
    while frontier and dst not in prev:
        nxt = []
        for u in frontier:
            for v, key in adj.get(u, ()):
                if v not in prev:
                    prev[v] = (u, key)
                    nxt.append(v)
        frontier = nxt
    if dst not in prev:
        return None
    route: list[LinkKey] = []
    node = dst
    while node != src:
        node, key = prev[node]
        route.append(key)
    route.reverse()
    return route


def route_links_faulty(
    topology: Topology,
    c0: tuple[int, ...],
    c1: tuple[int, ...],
    faults: FaultSet,
) -> list[LinkKey]:
    """The detour-capable `Topology.route_links`: pristine dimension-ordered
    route when it survives (bit-identical to the fault-free route for an
    empty FaultSet), else the first clean alternative dimension order (still
    minimal), else the deterministic shortest surviving path (BFS).  Raises
    when an endpoint tile is dead or no surviving path exists (the samplers
    in `repro_torch.faults.model` never produce a disconnected fabric)."""
    c0, c1 = tuple(c0), tuple(c1)
    if faults.is_empty:
        return topology.route_links(c0, c1)
    if faults.dead_tiles:
        coords = topology.coords()
        dead_coords = {tuple(coords[t]) for t in faults.dead_tiles}
        if c0 in dead_coords or c1 in dead_coords:
            raise ValueError(f"routing endpoint on a dead tile: {c0} -> {c1}")
    if c0 == c1:
        return []
    dead = effective_dead_links(topology, faults)
    ndim = len(c0)
    # Ascending order first == the natural dimension order == route_links,
    # so a clean natural route is returned verbatim.
    for order in itertools.permutations(range(ndim)):
        route = topology.route_links_ordered(c0, c1, order)
        if route is None:
            break
        if not any(link in dead for link in route):
            return route
    lookup = {tuple(c): i for i, c in enumerate(topology.coords())}
    route = _bfs_route(topology, faults, lookup[c0], lookup[c1])
    if route is None:
        raise ValueError(
            f"no surviving route {c0} -> {c1} under {faults.describe()}"
        )
    return route


def degraded_distance_matrix(topology: Topology, faults: FaultSet) -> np.ndarray:
    """(N, N) float64 hop counts over the surviving fabric: BFS distances on
    surviving links between live tiles.  Rows/columns of dead tiles are 0.0
    (NOT inf: the repair kernels' `w @ d` matmuls would turn 0·inf into NaN;
    dead tiles are excluded by the occupancy mask instead, see
    `repro_torch.faults.repair`).  Raises if any live pair is unreachable.  With an
    empty FaultSet this equals `topology.distance_matrix()` exactly."""
    n = topology.num_nodes
    if faults.is_empty:
        return topology.distance_matrix().astype(np.float64)
    adj = _surviving_adjacency(topology, faults)
    alive = [i for i in range(n) if i not in faults.dead_tiles]
    d = np.zeros((n, n), dtype=np.float64)
    for src in alive:
        dist = {src: 0}
        frontier = [src]
        depth = 0
        while frontier:
            depth += 1
            nxt = []
            for u in frontier:
                for v, _key in adj.get(u, ()):
                    if v not in dist:
                        dist[v] = depth
                        nxt.append(v)
            frontier = nxt
        for dst in alive:
            if dst not in dist:
                raise ValueError(
                    f"surviving fabric disconnected ({src} -/-> {dst}) under"
                    f" {faults.describe()}"
                )
            d[src, dst] = dist[dst]
    return d
