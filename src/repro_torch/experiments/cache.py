"""Content-hash cache for algorithm traces and traffic matrices.

Tracing (run_traced: a Python loop of device sweeps recording per-edge
activity) dominates sweep wall time, and every figure re-uses the same
(workload, algorithm) trace under several partitioner/topology settings.
The cache keys on the *content* of the inputs — a digest of the edge list
plus the full parameterisation — so a regenerated-but-identical graph hits,
and any change to the generator, scale, seed or algorithm misses.

Two levels:
  trace   (graph, algorithm, max_iterations, source)         → TraceResult
  traffic (graph, trace, partitioner, parts, model, packet)  → TrafficMatrix

Entries are .npz files under `root/` named by the hex digest; `stats` counts
hits/misses so tests (and the §Perf table) can show cache effectiveness.

Sharded traffic (`traffic(..., edge_block=...)`): instead of one whole-matrix
file, the per-edge-block COO contributions (`core.traffic.edge_block_coo`)
and the vertex contribution are persisted as individual shard files
`<key>.shard<k>.npz`, each carrying a sha256 of its own payload bytes.
Shards are streamed from disk one at a time and merged through the same
integer-exact COO accumulator the in-memory streaming path uses, so the
result is bit-identical to `traffic_from_partition(edge_block=...)`.  A
missing, truncated, or hash-mismatched shard invalidates only itself: that
one block is recomputed and rewritten while every other shard still hits.
`edge_block=None` keeps the historical single-file path byte-for-byte.

Crash safety: every cache write (trace, traffic, shard) goes through
`_atomic_savez` — same-directory temp file, `fsync` of the payload, then
`os.replace` — so a `kill -9` mid-write can never leave a torn entry behind
(the journaled `--resume` sweep path leans on this: an interrupted run's
cache is always either absent or whole).  Shard reads and writes retry
transient `OSError`s with exponential backoff (`CacheStats.shard_retries`
counts them); content failures — bad zip, hash mismatch — are never retried,
they just recompute the block.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import weakref

import numpy as np
import torch

from repro_torch.core.partition import Partition, partition_by_name
from repro_torch.core.traffic import (
    DENSE_MATERIALIZE_MAX,
    SparseTraffic,
    TrafficMatrix,
    edge_block_coo,
    traffic_from_partition,
    vertex_block_coo,
)
from repro_torch.graph.algorithms import ALGORITHMS, prepare_graph
from repro_torch.graph.structs import HostGraph
from repro_torch.graph.vertex_program import TraceResult, run_traced

__all__ = ["SweepCache", "CacheStats", "graph_digest", "DEFAULT_CACHE_DIR"]

# Where a caller that wants persistence should keep this package's cache.  It
# is a directory of its own: a trace made by this package's engine (PageRank
# summed through the ELL kernel) must not be served to, or from, the JAX
# package's cache, and the trace key below names the engine for the same
# reason.
DEFAULT_CACHE_DIR = os.path.join("artifacts", "torch", "sweep_cache")
TRACE_ENGINE = "repro_torch"


def graph_digest(g: HostGraph) -> str:
    """Content hash of a COO graph (shape + edge list + weights)."""
    h = hashlib.sha256()
    h.update(f"n={g.num_nodes};e={g.num_edges}".encode())
    h.update(np.ascontiguousarray(g.src, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.dst, dtype=np.int64).tobytes())
    if g.weight is not None:
        h.update(np.ascontiguousarray(g.weight, dtype=np.float32).tobytes())
    return h.hexdigest()


def _key(kind: str, meta: dict) -> str:
    blob = json.dumps({"kind": kind, **meta}, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclasses.dataclass
class CacheStats:
    trace_hits: int = 0
    trace_misses: int = 0
    traffic_hits: int = 0
    traffic_misses: int = 0
    shard_hits: int = 0  # sharded-traffic blocks served from disk
    shard_misses: int = 0  # blocks recomputed (absent, truncated, or bad hash)
    shard_retries: int = 0  # transient-OSError retries across shard reads+writes

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


# Transient-IO retry policy for shard reads/writes: attempts and the base of
# the exponential backoff (0.02 s, 0.04 s, ... between tries).
SHARD_IO_ATTEMPTS = 3
SHARD_IO_BACKOFF_S = 0.02


def _retrying(op, stats: CacheStats | None = None):
    """Run `op`, retrying transient `OSError`s with exponential backoff; any
    other exception (corrupt zip, missing key, ...) propagates immediately —
    content failures are the caller's recompute path, not a retry."""
    delay = SHARD_IO_BACKOFF_S
    for attempt in range(SHARD_IO_ATTEMPTS):
        try:
            return op()
        except OSError:
            if attempt == SHARD_IO_ATTEMPTS - 1:
                raise
            if stats is not None:
                stats.shard_retries += 1
            time.sleep(delay)
            delay *= 2.0


def _atomic_savez(path: str, **arrays) -> None:
    """Crash-safe .npz write: same-directory temp name (keeping the .npz
    suffix `savez` would otherwise append), `fsync` of the payload, then
    `os.replace` — no reader ever sees a partial file, and a crash mid-write
    leaves any previous entry intact."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _shard_sha(keys: np.ndarray, vals: np.ndarray, total: float) -> str:
    """Content hash of one shard's payload (what `_load_shard` verifies)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(keys, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(vals, dtype=np.float64).tobytes())
    h.update(np.float64(total).tobytes())
    return h.hexdigest()


def _read_shard_payload(path: str) -> tuple[np.ndarray, np.ndarray, float, str]:
    with np.load(path) as z:
        return (
            np.asarray(z["keys"], dtype=np.int64),
            np.asarray(z["vals"], dtype=np.float64),
            float(z["total"]),
            str(z["sha"]),
        )


def _load_shard(
    path: str, stats: CacheStats | None = None
) -> tuple[np.ndarray, np.ndarray, float] | None:
    """Read one shard file; `None` means "recompute this block": the file is
    missing, unreadable (truncated/corrupt zip), structurally wrong, or its
    stored content hash does not match the payload.  Transient `OSError`s are
    retried before the shard is given up on."""
    if not os.path.exists(path):
        return None
    try:
        keys, vals, total, stored = _retrying(lambda: _read_shard_payload(path), stats)
    except Exception:  # BadZipFile, KeyError, OSError, pickle refusal, ...
        return None
    if stored != _shard_sha(keys, vals, total):
        return None
    return keys, vals, total


class SweepCache:
    """Disk-backed content-hash cache.  `root=None` disables persistence
    (everything is recomputed; stats still count misses)."""

    def __init__(
        self,
        root: str | os.PathLike | None,
        *,
        device: str | torch.device | None = None,
        reduce_impl: str | None = None,
    ):
        """`device` and `reduce_impl` are handed to `run_traced` on a trace
        miss (`device=None` is the CUDA device, as everywhere in the package)."""
        self.device = device
        self.reduce_impl = reduce_impl
        self.root = os.fspath(root) if root is not None else None
        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
        self.stats = CacheStats()
        self._graph_digests: dict[int, str] = {}  # id(graph) memo per process

    # ------------------------------------------------------------------ util
    def _digest_of(self, g: HostGraph) -> str:
        """Per-object digest memo.  Keyed by id(), which is only safe while
        the graph is alive — a finalizer evicts the entry on collection so a
        recycled id can never return another graph's digest."""
        key = id(g)
        d = self._graph_digests.get(key)
        if d is None:
            d = graph_digest(g)
            try:
                weakref.finalize(g, self._graph_digests.pop, key, None)
            except TypeError:  # not weakref-able: skip the memo entirely
                return d
            self._graph_digests[key] = d
        return d

    def _path(self, key: str) -> str | None:
        return None if self.root is None else os.path.join(self.root, key + ".npz")

    # ----------------------------------------------------------------- trace
    def trace(
        self,
        g: HostGraph,
        algorithm: str,
        *,
        source: int = 0,
        max_iterations: int = 200,
    ) -> TraceResult:
        """Load or compute the communication trace of `algorithm` on `g`.
        The cache's `reduce_impl` speaks of sum-reduce only, so it reaches the
        engine (and the key) for a sum program and no other."""
        program = ALGORITHMS[algorithm]()
        reduce_impl = self.reduce_impl if program.reduce_kind == "sum" else None
        key = _key(
            "trace",
            {
                "graph": self._digest_of(g),
                "alg": algorithm,
                "source": source,
                "max_iterations": max_iterations,
                "engine": TRACE_ENGINE,
                "reduce_impl": reduce_impl or "default",
            },
        )
        path = self._path(key)
        if path is not None and os.path.exists(path):
            with np.load(path) as z:
                self.stats.trace_hits += 1
                return TraceResult(
                    props=z["props"],
                    num_iterations=int(z["num_iterations"]),
                    edge_activity=z["edge_activity"],
                    vertex_activity=z["vertex_activity"],
                    frontier_sizes=list(z["frontier_sizes"]),
                )
        self.stats.trace_misses += 1
        prepared = prepare_graph(algorithm, g)
        tr = run_traced(
            prepared,
            program,
            source=source,
            max_iterations=max_iterations,
            reduce_impl=reduce_impl,
            device=self.device,
        )
        if path is not None:
            _atomic_savez(
                path,
                props=tr.props,
                num_iterations=np.int64(tr.num_iterations),
                edge_activity=tr.edge_activity,
                vertex_activity=tr.vertex_activity,
                frontier_sizes=np.asarray(tr.frontier_sizes, dtype=np.int64),
            )
        return tr

    # --------------------------------------------------------------- traffic
    def traffic(
        self,
        g: HostGraph,
        partition: Partition,
        trace: TraceResult,
        *,
        model: str = "paper",
        packet_bytes: int = 8,
        layout: str = "dense",
        edge_block: int | None = None,
    ) -> TrafficMatrix | SparseTraffic:
        """Load or compute the shard-to-shard traffic matrix for one config.

        `edge_block=None` (default) keeps the historical single whole-matrix
        .npz per key.  Setting it switches to per-block shard files streamed
        from disk (module docstring) — bit-identical result, O(block)+O(nnz)
        resident instead of the file-sized whole.  `layout` follows
        `traffic_from_partition`: "dense", "sparse", or "auto"."""
        if layout not in ("dense", "sparse", "auto"):
            raise ValueError(f"unknown layout {layout!r}; options: dense|sparse|auto")
        meta = {
            "graph": self._digest_of(g),
            "partition": hashlib.sha256(
                partition.vertex_part.tobytes() + partition.edge_part.tobytes()
            ).hexdigest(),
            "parts": partition.num_parts,
            "activity": hashlib.sha256(trace.edge_activity.tobytes()).hexdigest(),
            "model": model,
            "packet_bytes": packet_bytes,
        }
        if edge_block is not None:
            return self._traffic_sharded(
                g, partition, trace, meta, model, packet_bytes, layout, int(edge_block)
            )
        key = _key("traffic", meta)
        path = self._path(key)
        if path is not None and os.path.exists(path):
            with np.load(path) as z:
                self.stats.traffic_hits += 1
                t = TrafficMatrix(
                    num_parts=int(z["num_parts"]),
                    bytes_matrix=z["bytes_matrix"],
                    phase_bytes={k: float(z[f"phase_{k}"]) for k in ("process", "reduce", "apply")},
                )
                return self._as_layout(t, layout)
        self.stats.traffic_misses += 1
        t = traffic_from_partition(
            partition,
            g.src,
            g.dst,
            edge_activity=trace.edge_activity,
            vertex_activity=trace.vertex_activity,
            packet_bytes=packet_bytes,
            model=model,
        )
        if path is not None:
            _atomic_savez(
                path,
                num_parts=np.int64(t.num_parts),
                bytes_matrix=t.bytes_matrix,
                **{f"phase_{k}": np.float64(v) for k, v in t.phase_bytes.items()},
            )
        return self._as_layout(t, layout)

    @staticmethod
    def _as_layout(t: TrafficMatrix, layout: str) -> TrafficMatrix | SparseTraffic:
        if layout == "sparse" or (
            layout == "auto" and t.num_logical > DENSE_MATERIALIZE_MAX
        ):
            return t.to_sparse()
        return t

    def _traffic_sharded(
        self,
        g: HostGraph,
        partition: Partition,
        trace: TraceResult,
        meta: dict,
        model: str,
        packet_bytes: int,
        layout: str,
        edge_block: int,
    ) -> TrafficMatrix | SparseTraffic:
        """Streamed shard path: ceil(E/edge_block) edge shards plus one vertex
        shard, each independently verified (content hash), recomputed on any
        failure, and merged through the integer-exact COO accumulator —
        bit-identical to `traffic_from_partition(edge_block=edge_block)`."""
        from repro_torch.core.traffic import _COOAccumulator

        step = max(edge_block, 1)
        meta = {**meta, "edge_block": step}
        key = _key("traffic-shards", meta)
        e_total = int(np.asarray(g.src).size)
        v_total = int(partition.num_nodes)
        n = 4 * partition.num_parts

        def shard_path(k: int) -> str | None:
            return (
                None
                if self.root is None
                else os.path.join(self.root, f"{key}.shard{k:05d}.npz")
            )

        def resolve(k: int, compute) -> tuple[np.ndarray, np.ndarray, float]:
            path = shard_path(k)
            if path is not None:
                cached = _load_shard(path, self.stats)
                if cached is not None:
                    self.stats.shard_hits += 1
                    return cached
            self.stats.shard_misses += 1
            keys, vals, total = compute()
            if path is not None:
                _retrying(
                    lambda: _atomic_savez(
                        path,
                        keys=keys,
                        vals=vals,
                        total=np.float64(total),
                        sha=np.str_(_shard_sha(keys, vals, total)),
                    ),
                    self.stats,
                )
            return keys, vals, total

        acc = _COOAccumulator()
        w_sum = 0.0
        n_edge_shards = (e_total + step - 1) // step
        for k in range(n_edge_shards):
            lo, hi = k * step, min((k + 1) * step, e_total)
            keys_b, vals_b, total_b = resolve(
                k,
                lambda lo=lo, hi=hi: edge_block_coo(
                    partition,
                    g.src,
                    g.dst,
                    edge_activity=trace.edge_activity,
                    packet_bytes=packet_bytes,
                    model=model,
                    lo=lo,
                    hi=hi,
                ),
            )
            acc.add(keys_b, vals_b)
            w_sum += total_b
        keys_v, vals_v, wv_sum = resolve(
            n_edge_shards,
            lambda: vertex_block_coo(
                partition,
                vertex_activity=trace.vertex_activity,
                packet_bytes=packet_bytes,
                lo=0,
                hi=v_total,
            ),
        )
        acc.add(keys_v, vals_v)

        keep = acc.vals != 0.0
        keys, vals = acc.keys[keep], acc.vals[keep]
        sparse = SparseTraffic(
            num_parts=partition.num_parts,
            rows=keys // n,
            cols=keys % n,
            vals=vals,
            phase_bytes={
                "process": 2.0 * w_sum,
                "reduce": 2.0 * w_sum,
                "apply": float(wv_sum),
            },
        )
        if layout == "sparse" or (layout == "auto" and n > DENSE_MATERIALIZE_MAX):
            return sparse
        return sparse.to_dense()

    # -------------------------------------------------------------- partition
    def partition(
        self, g: HostGraph, partitioner: str, num_parts: int, **kw
    ) -> Partition:
        """Partitions are cheap to recompute; kept here only so sweep code has
        one entry point per derived artifact (no disk round-trip)."""
        return partition_by_name(partitioner, g.src, g.dst, g.num_nodes, num_parts, **kw)
