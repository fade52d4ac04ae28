"""Fanout neighbour sampler (GraphSAGE-style) for minibatch GNN training.

The JAX package's numpy code (`repro.graph.sampler`), carried over as it is,
so that a seed gives bit-equal minibatches in both packages.

`sample` returns a local subgraph: unique sampled vertices (seeds first),
edge endpoints re-indexed into that local id space — the layout
`data.pipeline.GraphBatcher.sampled_batches` pads to static shapes for the
minibatch_lg cells.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import Csr, HostGraph

__all__ = ["MiniBatch", "NeighborSampler"]


@dataclasses.dataclass
class MiniBatch:
    node_ids: np.ndarray  # (n,) global vertex ids; seeds occupy [:num_seeds]
    src: np.ndarray  # (e,) local indices into node_ids
    dst: np.ndarray  # (e,)
    num_seeds: int
    labels: np.ndarray | None = None

    @property
    def batch_size(self) -> int:
        return self.num_seeds


class NeighborSampler:
    """Deterministic (seeded) with-replacement fanout sampler over CSR."""

    def __init__(self, g: HostGraph, fanouts: tuple[int, ...], *, seed: int = 0):
        self.g = g
        self.csr: Csr = g.csr()
        self.fanouts = tuple(int(f) for f in fanouts)
        self.rng = np.random.default_rng(seed)
        self._deg = np.diff(self.csr.indptr)

    def sample(self, seed_ids: np.ndarray, labels: np.ndarray | None = None) -> MiniBatch:
        seeds = np.unique(np.asarray(seed_ids, dtype=np.int64))
        frontier = seeds
        srcs: list[np.ndarray] = []
        dsts: list[np.ndarray] = []
        for f in self.fanouts:
            n = frontier.size
            deg = self._deg[frontier]
            draws = self.rng.integers(0, 1 << 62, size=(n, f)) % np.maximum(deg, 1)[:, None]
            pos = self.csr.indptr[frontier][:, None] + draws
            pos = np.minimum(pos, max(self.csr.indices.size - 1, 0))
            nbrs = self.csr.indices[pos] if self.csr.indices.size else np.zeros((n, f), np.int64)
            ok = np.broadcast_to(deg[:, None] > 0, nbrs.shape)
            # message direction: neighbour → frontier vertex
            srcs.append(nbrs[ok])
            dsts.append(np.repeat(frontier, f).reshape(n, f)[ok])
            frontier = np.unique(nbrs[ok])
        src_g = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        dst_g = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
        # local id space: seeds first, then the other sampled vertices
        others = np.setdiff1d(np.unique(np.concatenate([src_g, dst_g])), seeds)
        node_ids = np.concatenate([seeds, others])
        lookup = np.full(self.g.num_nodes, -1, dtype=np.int64)
        lookup[node_ids] = np.arange(node_ids.size)
        return MiniBatch(
            node_ids=node_ids,
            src=lookup[src_g].astype(np.int32),
            dst=lookup[dst_g].astype(np.int32),
            num_seeds=int(seeds.size),
            labels=labels,
        )

    def batches(self, batch_nodes: int, *, num_batches: int, labels: np.ndarray | None = None):
        """Epoch iterator: shuffled seed batches of exactly `batch_nodes`."""
        order = self.rng.permutation(self.g.num_nodes)
        for b in range(num_batches):
            lo = (b * batch_nodes) % self.g.num_nodes
            idx = np.take(order, np.arange(lo, lo + batch_nodes), mode="wrap")
            mb_labels = None if labels is None else labels[np.unique(idx)]
            yield self.sample(idx, mb_labels)
