"""Network-on-chip topology models (paper §2.2/Fig. 1 and §5.3/Algorithm 4).

Each topology exposes the hop-count metric Algorithm 4 minimises plus enough
structure (links, bisection) for the trace-driven simulator.  `Torus3D` is the
TPU-ICI adaptation: a pod's ICI fabric is a wrap-around torus, so placement of
logical shards on physical chips is the same optimisation problem the paper
solves for its 2-D mesh.
"""
from __future__ import annotations

import abc
import dataclasses
import itertools

import numpy as np

__all__ = [
    "Topology",
    "Mesh2D",
    "FlattenedButterfly",
    "Torus2D",
    "Torus3D",
    "topology_by_name",
    "dimension_ordered_links",
]


class Topology(abc.ABC):
    """A NoC topology: a set of router coordinates and a hop-count metric."""

    name: str

    @property
    @abc.abstractmethod
    def num_nodes(self) -> int: ...

    @abc.abstractmethod
    def coords(self) -> np.ndarray:
        """(num_nodes, ndim) int array of router coordinates."""

    @abc.abstractmethod
    def distance_matrix(self) -> np.ndarray:
        """(num_nodes, num_nodes) hop counts between routers."""

    @abc.abstractmethod
    def num_links(self) -> int:
        """Unidirectional link count (for serialization-throughput modelling)."""

    def route_links(
        self, c0: tuple[int, ...], c1: tuple[int, ...]
    ) -> list[tuple[int, ...]] | None:
        """Ordered unidirectional links (c_from + c_to, a 2·ndim int tuple) of
        the deterministic dimension-ordered route c0 → c1, or None when the
        topology has no exact per-link routing model (the simulator then
        falls back to the uniform-spread approximation).

        This is the single source of truth for link loads: the serial
        simulator (`core.simulator._per_link_peak_load`), the batched routing
        operator (`experiments.batched.routing_operator`) and the windowed
        contention simulator (`repro_torch.nocsim.routes`) all consume it, so the
        paths cannot drift apart.  len(route_links(a, b)) equals
        distance_matrix()[a, b] for every topology that implements it.
        """
        return self.route_links_ordered(c0, c1, None)

    def route_links_ordered(
        self, c0: tuple[int, ...], c1: tuple[int, ...], order: tuple[int, ...] | None
    ) -> list[tuple[int, ...]] | None:
        """`route_links` with an explicit dimension traversal order (`None` =
        the topology's natural order, e.g. X-then-Y).  Minimal-adaptive
        routing arms (`repro_torch.nocsim`) choose per flow between the natural and
        the reversed order; every order yields a minimal route, so
        len(route_links_ordered(a, b, o)) == distance_matrix()[a, b] for any
        permutation `o`.  Returns None when no exact routing model exists."""
        return None

    def distance(self, i: int, j: int) -> int:
        return int(self.distance_matrix()[i, j])

    def average_distance(self) -> float:
        d = self.distance_matrix()
        n = d.shape[0]
        if n < 2:
            return 0.0
        return float(d.sum() / (n * (n - 1)))


def _ring_route(a: int, b: int, k: int) -> tuple[int, int]:
    """(step, hops) along a k-ring taking the shorter way; ties (diff == k/2)
    break toward the increasing direction so routing stays deterministic."""
    fwd = (b - a) % k
    bwd = (a - b) % k
    return (1, fwd) if fwd <= bwd else (-1, bwd)


def dimension_ordered_links(
    c0: tuple[int, ...],
    c1: tuple[int, ...],
    dims: tuple[int, ...],
    *,
    wrap: bool,
    order: tuple[int, ...] | None = None,
) -> list[tuple[int, ...]]:
    """Deterministic dimension-ordered route on a k-ary mesh (`wrap=False`)
    or torus (`wrap=True`): traverse the dimensions in `order` (default
    ascending, i.e. X-Y[-Z]), stepping one link at a time; on a torus each
    dimension takes the shorter ring direction (ties toward increasing).
    Links are (c_from + c_to) 2·ndim tuples.  Hop count per dimension is
    |Δ| (mesh) or min(Δ, k − Δ) (torus) — exactly the corresponding
    `distance_matrix` metric, so link loads and byte-hops agree for every
    traversal order."""
    order = tuple(range(len(dims))) if order is None else tuple(order)
    pos = list(c0)
    links: list[tuple[int, ...]] = []
    for dim in order:
        a, b, k = pos[dim], c1[dim], dims[dim]
        if wrap:
            step, hops = _ring_route(a, b, k)
        else:
            step, hops = (1 if b >= a else -1), abs(b - a)
        for _ in range(hops):
            nxt = list(pos)
            nxt[dim] = (pos[dim] + step) % k if wrap else pos[dim] + step
            links.append(tuple(pos) + tuple(nxt))
            pos = nxt
    return links


def _cached(fn):
    attr = "_cache_" + fn.__name__

    def wrapper(self):
        val = getattr(self, attr, None)
        if val is None:
            val = fn(self)
            object.__setattr__(self, attr, val)
        return val

    return wrapper


@dataclasses.dataclass(frozen=True)
class Mesh2D(Topology):
    """k_x × k_y 2-D mesh; hop count = L1 distance (paper Alg. 4 line 5)."""

    kx: int
    ky: int
    name: str = "mesh2d"

    @property
    def num_nodes(self) -> int:
        return self.kx * self.ky

    @_cached
    def coords(self) -> np.ndarray:
        return np.array(list(itertools.product(range(self.kx), range(self.ky))), dtype=np.int64)

    @_cached
    def distance_matrix(self) -> np.ndarray:
        c = self.coords()
        return np.abs(c[:, None, :] - c[None, :, :]).sum(-1)

    def num_links(self) -> int:
        return 2 * ((self.kx - 1) * self.ky + self.kx * (self.ky - 1))

    def route_links_ordered(self, c0, c1, order):
        return dimension_ordered_links(c0, c1, (self.kx, self.ky), wrap=False, order=order)


@dataclasses.dataclass(frozen=True)
class FlattenedButterfly(Topology):
    """Flattened butterfly: routers in the same row or column are directly
    connected, so hop count = (#differing coordinates) ∈ {0, 1, 2}.

    NOTE: the paper's Algorithm 4 line 6 prints the same L1 formula as the
    mesh — a typo; the standard flattened-butterfly metric (Kim et al.,
    ISCA'07) is one hop per differing dimension, which also matches the
    paper's Fig. 7 observation that FB gains are smaller (1.8–1.9×) because
    the baseline's routes are already short.
    """

    kx: int
    ky: int
    name: str = "fbutterfly"

    @property
    def num_nodes(self) -> int:
        return self.kx * self.ky

    @_cached
    def coords(self) -> np.ndarray:
        return np.array(list(itertools.product(range(self.kx), range(self.ky))), dtype=np.int64)

    @_cached
    def distance_matrix(self) -> np.ndarray:
        c = self.coords()
        return (c[:, None, :] != c[None, :, :]).sum(-1)

    def num_links(self) -> int:
        # Every row is a clique of ky routers; every column a clique of kx.
        row_links = self.kx * (self.ky * (self.ky - 1))
        col_links = self.ky * (self.kx * (self.kx - 1))
        return row_links + col_links

    def route_links_ordered(self, c0, c1, order):
        # Direct link per differing dimension, traversed in `order` (natural:
        # X first, then Y at x1) — row/column cliques make each hop one link.
        order = (0, 1) if order is None else tuple(order)
        pos = list(c0)
        links = []
        for dim in order:
            if pos[dim] != c1[dim]:
                nxt = list(pos)
                nxt[dim] = c1[dim]
                links.append(tuple(pos) + tuple(nxt))
                pos = nxt
        return links


@dataclasses.dataclass(frozen=True)
class Torus2D(Topology):
    """2-D torus (wrap-around mesh)."""

    kx: int
    ky: int
    name: str = "torus2d"

    @property
    def num_nodes(self) -> int:
        return self.kx * self.ky

    @_cached
    def coords(self) -> np.ndarray:
        return np.array(list(itertools.product(range(self.kx), range(self.ky))), dtype=np.int64)

    @_cached
    def distance_matrix(self) -> np.ndarray:
        c = self.coords()
        diff = np.abs(c[:, None, :] - c[None, :, :])
        dims = np.array([self.kx, self.ky])
        return np.minimum(diff, dims - diff).sum(-1)

    def num_links(self) -> int:
        return 2 * 2 * self.num_nodes  # 2 dims × 2 directions × nodes

    def route_links_ordered(self, c0, c1, order):
        return dimension_ordered_links(c0, c1, (self.kx, self.ky), wrap=True, order=order)


@dataclasses.dataclass(frozen=True)
class Torus3D(Topology):
    """TPU-pod ICI fabric: 3-D wrap-around torus (e.g. v4 pod 16×16×(z))."""

    kx: int
    ky: int
    kz: int
    name: str = "torus3d"

    @property
    def num_nodes(self) -> int:
        return self.kx * self.ky * self.kz

    @_cached
    def coords(self) -> np.ndarray:
        return np.array(
            list(itertools.product(range(self.kx), range(self.ky), range(self.kz))),
            dtype=np.int64,
        )

    @_cached
    def distance_matrix(self) -> np.ndarray:
        c = self.coords()
        diff = np.abs(c[:, None, :] - c[None, :, :])
        dims = np.array([self.kx, self.ky, self.kz])
        return np.minimum(diff, dims - diff).sum(-1)

    def num_links(self) -> int:
        return 3 * 2 * self.num_nodes

    def route_links_ordered(self, c0, c1, order):
        # Wrap-aware X-Y-Z dimension-ordered routing on the pod fabric: the
        # shorter ring direction per dimension, matching distance_matrix — so
        # the simulator and the batched routing operator get exact per-link
        # loads on TPU-ICI instead of the uniform-spread fallback.
        return dimension_ordered_links(
            c0, c1, (self.kx, self.ky, self.kz), wrap=True, order=order
        )


def topology_by_name(name: str, *dims: int) -> Topology:
    table = {
        "mesh2d": Mesh2D,
        "fbutterfly": FlattenedButterfly,
        "torus2d": Torus2D,
        "torus3d": Torus3D,
    }
    try:
        cls = table[name]
    except KeyError:
        raise ValueError(f"unknown topology {name!r}; options: {sorted(table)}") from None
    return cls(*dims)
