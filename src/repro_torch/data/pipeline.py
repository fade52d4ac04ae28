"""Deterministic synthetic data pipelines, and the step that puts a batch on
the device.

`host_slice`, `TokenPipeline`, `RecsysPipeline`, `GraphBatcher` and
`Prefetcher` are the JAX package's numpy code (`repro.data.pipeline`),
carried over as it is, so that a seed gives bit-equal batches in both
packages:

  * token LM batches  — Zipf-distributed token ids (vocab access skew is the
    LM analogue of degree skew).
  * recsys batches    — per-feature Zipf(α≈1.1) sparse ids over million-row
    tables: the hot-row distribution hub replication exploits.
  * graph batches     — a `HostGraph` (R-MAT from `graph.generators`) with
    features and labels planted on its degrees, full-batch, fanout-sampled
    (`graph.sampler.NeighborSampler`) or a block-diagonal batch of small
    random graphs.

`Prefetcher` gains `close()`, which stops its thread.  `to_device` is the
port's own: numpy batches become tensors on the device, through pinned host
memory and without blocking on a CUDA device; an `EllBlocks` (GIN's
`batch["ell"]`, made on its device by `models.gnn.batch_ell`) passes through
as it is.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import typing

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.structs import EllBlocks

__all__ = ["host_slice", "TokenPipeline", "RecsysPipeline", "GraphBatcher", "Prefetcher", "to_device"]


def host_slice(global_batch: int, process_index: int, process_count: int) -> tuple[int, int]:
    """[start, size) of this host's slice of the global batch."""
    per = global_batch // process_count
    return process_index * per, per


@dataclasses.dataclass
class TokenPipeline:
    """Zipf token stream: batch dict {tokens, labels, valid}."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            # Zipf over the vocab, clipped; labels are next-token shifted
            toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len + 1))
            # modulo (not clip) keeps rank-1 the hottest token without piling
            # the tail onto one clip bucket
            toks = ((toks - 1) % self.vocab).astype(np.int32)
            yield {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
                "valid": np.ones((self.batch, self.seq_len), bool),
            }


@dataclasses.dataclass
class RecsysPipeline:
    """Criteo-shaped batches with Zipf sparse ids (the hot-row skew)."""

    n_dense: int
    n_sparse: int
    rows_per_table: int
    batch: int
    multi_hot: int = 1
    seed: int = 0
    zipf_a: float = 1.1

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        shape = (
            (self.batch, self.n_sparse)
            if self.multi_hot == 1
            else (self.batch, self.n_sparse, self.multi_hot)
        )
        while True:
            ids = rng.zipf(self.zipf_a, size=shape)
            ids = ((ids - 1) % self.rows_per_table).astype(np.int32)
            dense = rng.standard_normal((self.batch, self.n_dense)).astype(np.float32)
            # click through a planted linear model so training can learn
            w = np.linspace(-1, 1, self.n_dense)
            labels = (dense @ w + 0.1 * rng.standard_normal(self.batch) > 0).astype(np.float32)
            yield {"dense": dense, "sparse_ids": ids, "labels": labels}


class GraphBatcher:
    """Static-shape GNN batches from a HostGraph (full-batch or sampled)."""

    def __init__(self, g, *, d_feat: int, n_classes: int, seed: int = 0):
        self.g = g
        self.d_feat = d_feat
        self.n_classes = n_classes
        self.rng = np.random.default_rng(seed)
        # deterministic synthetic features/labels planted on graph structure
        deg = g.out_degrees().astype(np.float32)
        basis = self.rng.standard_normal((d_feat,)).astype(np.float32)
        self.x = np.outer(np.log1p(deg), basis) + 0.1 * self.rng.standard_normal(
            (g.num_nodes, d_feat)
        ).astype(np.float32)
        self.labels = (np.log1p(deg) * n_classes / max(np.log1p(deg).max(), 1e-6)).astype(
            np.int32
        ) % n_classes

    def full_batch(self, *, pad_edges: int | None = None, train_frac: float = 0.6) -> dict:
        g = self.g
        e = g.num_edges
        pad = pad_edges or e
        src = np.full(pad, g.num_nodes, np.int32)
        dst = np.full(pad, g.num_nodes, np.int32)
        src[:e], dst[:e] = g.src, g.dst
        mask = np.zeros(pad, bool)
        mask[:e] = True
        train_mask = self.rng.random(g.num_nodes) < train_frac
        return {
            "x": self.x,
            "src": src,
            "dst": dst,
            "edge_mask": mask,
            "node_mask": np.ones(g.num_nodes, bool),
            "labels": self.labels,
            "train_mask": train_mask,
        }

    def sampled_batches(self, sampler, batch_nodes: int, *, num_batches: int,
                        pad_nodes: int, pad_edges: int):
        """Minibatch training: fanout-sampled subgraphs padded to static shape."""
        for mb in sampler.batches(batch_nodes, num_batches=num_batches, labels=self.labels):
            n, e = mb.node_ids.size, mb.src.size
            if n > pad_nodes or e > pad_edges:
                raise ValueError(f"sample exceeds pad: nodes {n}>{pad_nodes} or edges {e}>{pad_edges}")
            x = np.zeros((pad_nodes, self.d_feat), np.float32)
            x[:n] = self.x[mb.node_ids]
            src = np.full(pad_edges, pad_nodes, np.int32)
            dst = np.full(pad_edges, pad_nodes, np.int32)
            src[:e], dst[:e] = mb.src, mb.dst
            emask = np.zeros(pad_edges, bool)
            emask[:e] = True
            nmask = np.zeros(pad_nodes, bool)
            nmask[:n] = True
            labels = np.zeros(pad_nodes, np.int32)
            labels[:n] = self.labels[mb.node_ids]
            seed_mask = np.zeros(pad_nodes, bool)
            seed_mask[: mb.num_seeds] = True  # sampler puts seeds first
            yield {
                "x": x, "src": src, "dst": dst, "edge_mask": emask,
                "node_mask": nmask, "labels": labels, "train_mask": seed_mask,
            }

    def molecule_batch(self, n_graphs: int, nodes_per: int, edges_per: int) -> dict:
        """Block-diagonal batch of small random graphs (graph classification)."""
        N, E = n_graphs * nodes_per, n_graphs * edges_per
        src = np.zeros(E, np.int32)
        dst = np.zeros(E, np.int32)
        gids = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
        for gi in range(n_graphs):
            s = self.rng.integers(0, nodes_per, edges_per) + gi * nodes_per
            d = self.rng.integers(0, nodes_per, edges_per) + gi * nodes_per
            src[gi * edges_per : (gi + 1) * edges_per] = s
            dst[gi * edges_per : (gi + 1) * edges_per] = d
        x = self.rng.standard_normal((N, self.d_feat)).astype(np.float32)
        labels = self.rng.integers(0, self.n_classes, n_graphs).astype(np.int32)
        return {
            "x": x, "src": src, "dst": dst,
            "edge_mask": np.ones(E, bool), "node_mask": np.ones(N, bool),
            "graph_ids": gids, "labels": labels,
        }


class Prefetcher:
    """Background-thread prefetch queue (host-side straggler absorption)."""

    def __init__(self, it: typing.Iterable[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    break
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread: it finishes the item in hand and exits."""
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._t.join()


def to_device(batch: dict, device: str | torch.device | None = None) -> dict:
    """The batch's arrays as tensors on `device` (None: the card), dtypes
    kept (bool and int32 too).  To a CUDA device each array goes through
    pinned host memory and is copied without blocking, on the current
    stream.  An `EllBlocks` is passed through untouched."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, EllBlocks):
            out[k] = v
            continue
        t = torch.as_tensor(v)
        if dev.type == "cuda":
            out[k] = t.pin_memory().to(dev, non_blocking=True)
        else:
            out[k] = t.to(dev)
    return out
