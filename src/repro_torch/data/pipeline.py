"""Deterministic synthetic data pipelines, and the step that puts a batch on
the device.

`host_slice`, `TokenPipeline`, `RecsysPipeline` and `Prefetcher` are the
JAX package's numpy code (`repro.data.pipeline`), carried over as it is, so
that a seed gives bit-equal batches in both packages:

  * token LM batches  — Zipf-distributed token ids (vocab access skew is the
    LM analogue of degree skew).
  * recsys batches    — per-feature Zipf(α≈1.1) sparse ids over million-row
    tables: the hot-row distribution hub replication exploits.

`Prefetcher` gains `close()`, which stops its thread.  `to_device` is the
port's own: numpy batches become tensors on the device, through pinned host
memory and without blocking on a CUDA device.  `GraphBatcher` comes with the
GNN slice (ROADMAP.md Queue A 8).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import typing

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["host_slice", "TokenPipeline", "RecsysPipeline", "Prefetcher", "to_device"]


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
    kept.  To a CUDA device each array goes through pinned host memory and
    is copied without blocking, on the current stream."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if dev.type == "cuda":
            out[k] = t.pin_memory().to(dev, non_blocking=True)
        else:
            out[k] = t.to(dev)
    return out
