"""Graph partitioning onto engines (paper §5.1, Algorithm 2) plus baselines.

The paper's scheme ("power-law aware"):
  1. Sort vertices by out-degree, descending (the power-law sort).
  2. Distribute the sorted vertices cyclically over engines (modulo
     scheduling) — every engine gets an equal slice of hubs and of tail
     vertices, which load-balances edge mass.
  3. Source-cut the edge list: an edge lives with its source vertex's engine,
     so each engine's Edge Table holds the out-edges of "its" vertices and the
     edges of hub vertices end up spread across engines.
  4. Capacity spill: if an engine's edge shard exceeds `max_size`, its
     lowest-degree sources are re-homed to the least-loaded engine
     ("while u.size < u.maxsize" in Algorithm 2).
  5. Every engine gets `rank = min(sorted-position of its vertices)` which
     links the four data-structure shards of the same vertex slice
     (Algorithm 3 keys f_ij off equal rank).

Baselines implemented for the paper's comparison: random, contiguous-range
and hash (id % P, i.e. cyclic *without* the degree sort).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.degree import out_degrees

__all__ = [
    "Partition",
    "powerlaw_partition",
    "random_partition",
    "range_partition",
    "hash_partition",
    "partition_by_name",
    "PARTITIONERS",
]


@dataclasses.dataclass(frozen=True)
class Partition:
    """A vertex + edge assignment onto `num_parts` engines.

    vertex_part[v] = engine owning vertex v's property/temp slot.
    edge_part[e]   = engine owning edge e's Edge Table / eprop slot.
    rank[p]        = the paper's rank field for engine p (min sorted-position
                     of any vertex it owns; ties the four shards together).
    order[i]       = vertex id at sorted-position i (degree desc) — identity
                     for partitioners that do not sort.
    """

    num_parts: int
    vertex_part: np.ndarray
    edge_part: np.ndarray
    rank: np.ndarray
    order: np.ndarray
    name: str

    @property
    def num_nodes(self) -> int:
        return self.vertex_part.size

    @property
    def num_edges(self) -> int:
        return self.edge_part.size

    def edge_counts(self) -> np.ndarray:
        return np.bincount(self.edge_part, minlength=self.num_parts)

    def vertex_counts(self) -> np.ndarray:
        return np.bincount(self.vertex_part, minlength=self.num_parts)

    def edge_balance(self) -> float:
        """max/mean edge load — 1.0 is perfect balance."""
        counts = self.edge_counts()
        mean = counts.mean() if counts.size else 0.0
        return float(counts.max() / mean) if mean > 0 else 1.0


def _ranks_from_assignment(order: np.ndarray, vertex_part: np.ndarray, num_parts: int) -> np.ndarray:
    """rank[p] = min sorted-position among vertices assigned to engine p."""
    pos = np.empty(order.size, dtype=np.int64)
    pos[order] = np.arange(order.size)
    rank = np.full(num_parts, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(rank, vertex_part, pos)
    rank[rank == np.iinfo(np.int64).max] = 0
    return rank


def powerlaw_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    max_size: int | None = None,
    balance_slack: float = 1.05,
) -> Partition:
    """Algorithm 2: degree-sorted cyclic vertex assignment + source-cut edges.

    `max_size` caps a part's edge count (the paper's u.maxsize, i.e. the 1 MB
    engine CAM).  Default: balance_slack × ceil(M/P).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    deg = out_degrees(src, num_nodes)
    # Step 1-2: sort by degree desc (stable → deterministic) and deal cyclically.
    order = np.argsort(-deg, kind="stable")
    vertex_part = np.empty(num_nodes, dtype=np.int32)
    vertex_part[order] = np.arange(num_nodes, dtype=np.int32) % num_parts
    # Step 3: source-cut.
    edge_part = vertex_part[src]
    # Step 4: capacity spill.  Cyclic dealing of a power-law degree sequence is
    # already near-balanced; the spill handles adversarial tails (one vertex
    # with > max_size out-edges keeps its first max_size edges and spills the
    # rest round-robin, which is what a fixed-capacity CAM forces).
    num_edges = src.size
    if max_size is None:
        max_size = int(np.ceil(balance_slack * num_edges / num_parts)) if num_parts else num_edges
    counts = np.bincount(edge_part, minlength=num_parts).astype(np.int64)
    over = np.nonzero(counts > max_size)[0]
    if over.size:
        edge_part = edge_part.copy()
        free = max_size - counts  # negative for overfull parts
        # Collect spilled edge indices: from each overfull part drop the edges of
        # its lowest-degree sources first (hubs stay put — they were placed first).
        spilled: list[np.ndarray] = []
        for p in over:
            idx = np.nonzero(edge_part == p)[0]
            # order the part's edges by source degree ascending → spill tail first
            idx = idx[np.argsort(deg[src[idx]], kind="stable")]
            n_spill = counts[p] - max_size
            spilled.append(idx[:n_spill])
            free[p] = 0
        spill_idx = np.concatenate(spilled)
        # Refill least-loaded parts round-robin.
        targets = np.nonzero(free > 0)[0]
        slots = np.repeat(targets, free[targets])
        if slots.size < spill_idx.size:
            raise ValueError(
                f"max_size={max_size} too small: {spill_idx.size} spilled edges, "
                f"{slots.size} free slots"
            )
        edge_part[spill_idx] = slots[: spill_idx.size].astype(edge_part.dtype)
    rank = _ranks_from_assignment(order, vertex_part, num_parts)
    return Partition(num_parts, vertex_part, edge_part, rank, order, "powerlaw")


def random_partition(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, num_parts: int, *, seed: int = 0
) -> Partition:
    """Paper's baseline: uniform random vertex assignment, source-cut edges."""
    rng = np.random.default_rng(seed)
    vertex_part = rng.integers(0, num_parts, size=num_nodes, dtype=np.int32)
    edge_part = vertex_part[np.asarray(src, dtype=np.int64)]
    order = np.arange(num_nodes, dtype=np.int64)
    rank = _ranks_from_assignment(order, vertex_part, num_parts)
    return Partition(num_parts, vertex_part, edge_part, rank, order, "random")


def range_partition(src: np.ndarray, dst: np.ndarray, num_nodes: int, num_parts: int) -> Partition:
    """Contiguous id ranges (GraphMAT/Pregel default)."""
    chunk = -(-num_nodes // num_parts)
    vertex_part = (np.arange(num_nodes, dtype=np.int64) // chunk).astype(np.int32)
    edge_part = vertex_part[np.asarray(src, dtype=np.int64)]
    order = np.arange(num_nodes, dtype=np.int64)
    rank = _ranks_from_assignment(order, vertex_part, num_parts)
    return Partition(num_parts, vertex_part, edge_part, rank, order, "range")


def hash_partition(src: np.ndarray, dst: np.ndarray, num_nodes: int, num_parts: int) -> Partition:
    """id % P — cyclic without the degree sort (ablates Algorithm 2's step 1)."""
    vertex_part = (np.arange(num_nodes, dtype=np.int64) % num_parts).astype(np.int32)
    edge_part = vertex_part[np.asarray(src, dtype=np.int64)]
    order = np.arange(num_nodes, dtype=np.int64)
    rank = _ranks_from_assignment(order, vertex_part, num_parts)
    return Partition(num_parts, vertex_part, edge_part, rank, order, "hash")


PARTITIONERS = {
    "powerlaw": powerlaw_partition,
    "random": random_partition,
    "range": range_partition,
    "hash": hash_partition,
}


def partition_by_name(
    name: str, src: np.ndarray, dst: np.ndarray, num_nodes: int, num_parts: int, **kw
) -> Partition:
    try:
        fn = PARTITIONERS[name]
    except KeyError:
        raise ValueError(f"unknown partitioner {name!r}; options: {sorted(PARTITIONERS)}") from None
    return fn(src, dst, num_nodes, num_parts, **kw)
