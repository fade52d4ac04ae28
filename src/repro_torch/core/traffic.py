"""Traffic-matrix extraction (paper §4 Fig. 3 and the f_ij of Algorithms 3/4).

The four in-memory structures are, per the paper's data flow (§2.3/§4):

  Process phase : ET[part(e)]      → vprop[part(dst)]   (neighbour lookup)
                  vprop[part(dst)] → eprop[part(e)]     (property value back)
  Reduce phase  : eprop[part(e)]   → vtemp[part(dst)]   (temp update)
                  ET[part(e)]      → vtemp[part(dst)]   (neighbour read)
  Apply phase   : vtemp[part(v)]   → vprop[part(v)]     (local, negligible)

Each logical shard (structure, part) is a node in the topology-mapping
problem; `bytes_matrix` carries the measured bytes between shards so the
placement can be solved either with the paper's binary f_ij (equal-rank
pairs, Algorithm 3) or traffic-weighted (our beyond-paper variant).

Sparse-first representation.  The shard-to-shard matrix is (4P, 4P); at the
paper grid's P = 16 that is 64×64 and dense is the right call, but the
structure pairs of §4 populate only O(P) to O(P²) of it and nothing
downstream needs the zeros — so `traffic_from_partition(layout=...)` can
return a `SparseTraffic` (COO) instead, and the per-edge accumulation can
stream over edge *blocks* (`edge_block`) so the transient id/weight arrays
never exceed one block regardless of |E|.  Parity contract (property-tested
in tests/test_sparse_traffic.py): traffic bytes are integer-valued float64
(iteration counts × packet bytes), and sums of integers below 2^53 are exact
in float64 under ANY association — so the sparse/blocked accumulation is
bit-identical to the dense `np.bincount` path, not merely close.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partition import Partition

__all__ = [
    "STRUCTS",
    "ET",
    "VPROP",
    "VTEMP",
    "EPROP",
    "TrafficMatrix",
    "SparseTraffic",
    "DENSE_MATERIALIZE_MAX",
    "edge_block_coo",
    "vertex_block_coo",
    "traffic_from_partition",
]

# Structure indices; order matches the paper's index field 1..4.
STRUCTS = ("et", "vprop", "vtemp", "eprop")
ET, VPROP, VTEMP, EPROP = range(4)

# layout="auto" materializes the dense (4P, 4P) matrix up to this many logical
# shards (4P); past it the COO form is returned instead.  64 parts → n = 256
# is still < 1 MB dense, so the hatch is generous; the sparse form exists for
# the part counts the published workloads imply, not for the paper grid.
DENSE_MATERIALIZE_MAX = 1024


@dataclasses.dataclass(frozen=True)
class TrafficMatrix:
    """Bytes moved between the 4×P logical shards of one execution."""

    num_parts: int
    bytes_matrix: np.ndarray  # (4P, 4P) float64 bytes
    phase_bytes: dict[str, float]  # process/reduce/apply totals (Fig. 3)

    @property
    def num_logical(self) -> int:
        return 4 * self.num_parts

    def logical_id(self, struct: int, part: int) -> int:
        return struct * self.num_parts + part

    def struct_of(self, logical: int) -> int:
        return logical // self.num_parts

    def part_of(self, logical: int) -> int:
        return logical % self.num_parts

    def total_bytes(self) -> float:
        return float(self.bytes_matrix.sum())

    def symmetrized(self) -> np.ndarray:
        m = self.bytes_matrix
        return m + m.T

    def binary_fij(self, partition: Partition) -> np.ndarray:
        """The paper's Algorithm 3 adjacency: f_ij = 1 iff equal rank and
        one endpoint is a {ET, eprop} shard, the other a {vprop, vtemp} shard.

        With one rank per part (our Partition construction) "equal rank"
        reduces to "equal part", giving the 4 pairs per part the paper draws
        in Fig. 4.
        """
        n = self.num_logical
        f = np.zeros((n, n), dtype=np.float64)
        for p in range(self.num_parts):
            for a in (ET, EPROP):
                for b in (VPROP, VTEMP):
                    i = self.logical_id(a, p)
                    j = self.logical_id(b, p)
                    f[i, j] = f[j, i] = 1.0
        return f

    def normalized_by(self, denom_bytes: float) -> dict[str, float]:
        """Phase bytes normalised by the graph size (paper Fig. 3 y-axis)."""
        return {k: v / denom_bytes for k, v in self.phase_bytes.items()}

    def to_sparse(self) -> "SparseTraffic":
        """COO view of the same traffic (zero entries dropped)."""
        rows, cols = np.nonzero(self.bytes_matrix)
        return SparseTraffic(
            num_parts=self.num_parts,
            rows=rows.astype(np.int64),
            cols=cols.astype(np.int64),
            vals=self.bytes_matrix[rows, cols].astype(np.float64),
            phase_bytes=dict(self.phase_bytes),
        )


@dataclasses.dataclass(frozen=True)
class SparseTraffic:
    """COO form of `TrafficMatrix`: only the nonzero shard-pair flows.

    `rows`/`cols` are logical-shard ids sorted by flat key rows·4P + cols
    (unique pairs), `vals` the bytes — the canonical order `np.nonzero` of the
    dense matrix would produce, so `to_dense().to_sparse()` round-trips
    bit-exactly.  Carries the same id helpers as the dense form; consumers
    that need the full matrix (the default small-n pipeline) call
    `to_dense()`, consumers that scale with nnz (H evaluation, top-k swap
    candidates, shard caching) read the triplets directly.
    """

    num_parts: int
    rows: np.ndarray  # (nnz,) int64 logical source shard
    cols: np.ndarray  # (nnz,) int64 logical destination shard
    vals: np.ndarray  # (nnz,) float64 bytes
    phase_bytes: dict[str, float]

    @property
    def num_logical(self) -> int:
        return 4 * self.num_parts

    @property
    def nnz(self) -> int:
        return int(self.vals.size)

    def logical_id(self, struct: int, part: int) -> int:
        return struct * self.num_parts + part

    def struct_of(self, logical: int) -> int:
        return logical // self.num_parts

    def part_of(self, logical: int) -> int:
        return logical % self.num_parts

    def total_bytes(self) -> float:
        return float(self.vals.sum())

    def normalized_by(self, denom_bytes: float) -> dict[str, float]:
        """Phase bytes / graph bytes — same contract as the dense form."""
        return {k: v / denom_bytes for k, v in self.phase_bytes.items()}

    def to_dense(self) -> TrafficMatrix:
        """Materialize the (4P, 4P) matrix (the small-n escape hatch)."""
        n = self.num_logical
        m = np.zeros((n, n), dtype=np.float64)
        m[self.rows, self.cols] = self.vals
        return TrafficMatrix(
            num_parts=self.num_parts,
            bytes_matrix=m,
            phase_bytes=dict(self.phase_bytes),
        )

    def to_csr(self):
        """scipy CSR of the bytes (for operator-style consumers)."""
        from scipy import sparse

        n = self.num_logical
        return sparse.csr_matrix((self.vals, (self.rows, self.cols)), shape=(n, n))

    def symmetrized_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals) of m + mᵀ with summed duplicates, sorted by
        flat key — the sparse counterpart of `TrafficMatrix.symmetrized`."""
        n = self.num_logical
        rows = np.concatenate([self.rows, self.cols])
        cols = np.concatenate([self.cols, self.rows])
        vals = np.concatenate([self.vals, self.vals])
        flat = rows * n + cols
        keys, inv = np.unique(flat, return_inverse=True)
        out = np.bincount(inv, weights=vals, minlength=keys.size)
        return keys // n, keys % n, out


class _COOAccumulator:
    """Streaming (key → Σ weight) accumulator over int64 flat keys.

    Each `add` bincounts one block's contributions over its *present* keys
    only (never n² storage) and merges into the running triplet set via one
    `np.unique` — O(nnz log nnz) per merge, nnz ≤ (4P)².  Exactness: the
    weights are integer-valued (counts × packet bytes), so the re-association
    across blocks is bit-exact vs the dense single-pass bincount."""

    def __init__(self) -> None:
        self.keys = np.empty(0, dtype=np.int64)
        self.vals = np.empty(0, dtype=np.float64)

    def add(self, flat: np.ndarray, w: np.ndarray) -> None:
        if flat.size == 0:
            return
        keys, inv = np.unique(flat, return_inverse=True)
        sums = np.bincount(inv, weights=w, minlength=keys.size)
        merged = np.concatenate([self.keys, keys])
        merged_vals = np.concatenate([self.vals, sums])
        self.keys, inv2 = np.unique(merged, return_inverse=True)
        self.vals = np.bincount(inv2, weights=merged_vals, minlength=self.keys.size)


def _accumulate(matrix: np.ndarray, from_ids: np.ndarray, to_ids: np.ndarray, w: np.ndarray) -> None:
    n = matrix.shape[0]
    flat = from_ids.astype(np.int64) * n + to_ids.astype(np.int64)
    matrix.reshape(-1)[:] += np.bincount(flat, weights=w, minlength=n * n)


def edge_block_coo(
    partition: Partition,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    edge_activity: np.ndarray | None,
    packet_bytes: int,
    model: str,
    lo: int,
    hi: int,
) -> tuple[np.ndarray, np.ndarray, float]:
    """COO contribution of edges [lo, hi): the four Process/Reduce flows of
    that block merged to unique flat keys (row·4P + col).  Returns
    (keys, vals, w_sum) with w_sum = Σ block weights (so process_bytes =
    reduce_bytes = 2·Σ w_sum over blocks).  One edge block is independently
    recomputable — the unit of both the streaming accumulation in
    `traffic_from_partition` and the disk shards in
    `repro_torch.experiments.cache`."""
    P = partition.num_parts
    n = 4 * P
    src = np.asarray(src, dtype=np.int64)[lo:hi]
    dst = np.asarray(dst, dtype=np.int64)[lo:hi]
    if edge_activity is None:
        w = np.full(src.size, float(packet_bytes), dtype=np.float64)
    else:
        w = np.asarray(edge_activity[lo:hi], dtype=np.float64) * packet_bytes
    ep = partition.edge_part[lo:hi].astype(np.int64)
    sp = partition.vertex_part[src].astype(np.int64)
    dp = partition.vertex_part[dst].astype(np.int64)
    et = ET * P + ep
    eprop = EPROP * P + ep
    vprop = VPROP * P + sp
    vtemp = VTEMP * P + (ep if model == "paper" else dp)
    acc = _COOAccumulator()
    acc.add(et * n + vprop, w)
    acc.add(vprop * n + eprop, w)
    acc.add(eprop * n + vtemp, w)
    acc.add(et * n + vtemp, w)
    return acc.keys, acc.vals, float(w.sum())


def vertex_block_coo(
    partition: Partition,
    *,
    vertex_activity: np.ndarray | None,
    packet_bytes: int,
    lo: int,
    hi: int,
) -> tuple[np.ndarray, np.ndarray, float]:
    """COO contribution of vertices [lo, hi): the Apply phase's local
    vtemp→vprop flow.  Returns (keys, vals, wv_sum)."""
    P = partition.num_parts
    n = 4 * P
    if vertex_activity is None:
        wv = np.full(hi - lo, float(packet_bytes), dtype=np.float64)
    else:
        wv = np.asarray(vertex_activity[lo:hi], dtype=np.float64) * packet_bytes
    vp = partition.vertex_part[lo:hi].astype(np.int64)
    acc = _COOAccumulator()
    acc.add((VTEMP * P + vp) * n + (VPROP * P + vp), wv)
    return acc.keys, acc.vals, float(wv.sum())


def _resolve_layout(layout: str, num_logical: int) -> str:
    if layout not in ("dense", "sparse", "auto"):
        raise ValueError(f"unknown layout {layout!r}; options: dense|sparse|auto")
    if layout != "auto":
        return layout
    return "dense" if num_logical <= DENSE_MATERIALIZE_MAX else "sparse"


def traffic_from_partition(
    partition: Partition,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    edge_activity: np.ndarray | None = None,
    vertex_activity: np.ndarray | None = None,
    packet_bytes: int = 8,
    model: str = "paper",
    layout: str = "dense",
    edge_block: int | None = None,
) -> TrafficMatrix | SparseTraffic:
    """Build the shard-to-shard traffic matrix for one algorithm execution.

    edge_activity[e]   = number of iterations edge e carried a message
                         (1.0 everywhere ≡ one full sweep, e.g. one PR iter).
    vertex_activity[v] = number of iterations vertex v was applied.

    model="paper"  — the paper's communication structure (Algorithm 3's
        f_ij): each engine's four structure shards exchange the phase flows
        *within the rank*.  Source-cut partitioning makes the Process reads
        rank-local by construction (edge (u,v) lives with u's vprop); the
        Reduce delivery is rank-local under GRAM-style duplicated-vtemp
        book-keeping, which the paper adopts (§4 notes the extra traffic of
        parallel-reduce book-keeping separately).  This is the model behind
        Figs. 5/7/8 and what `benchmarks/` reproduces.
    model="cross"  — Reduce delivery routed to the *destination vertex's*
        part (no vtemp duplication).  Adds the data-dependent all-to-all
        component; used by the Level-B DeviceMapper and by hub-replication
        accounting (DESIGN.md §2).

    layout="dense" returns a `TrafficMatrix`, "sparse" a `SparseTraffic`,
    "auto" picks dense while 4P ≤ DENSE_MATERIALIZE_MAX.  `edge_block`
    streams the per-edge accumulation in blocks of that many edges, bounding
    transient memory at O(edge_block) instead of O(|E|); bytes are
    integer-valued so the blocked result is bit-identical (module docstring).
    """
    if model not in ("paper", "cross"):
        raise ValueError(f"unknown traffic model {model!r}")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    P = partition.num_parts
    n = 4 * P
    layout = _resolve_layout(layout, n)

    if layout == "dense" and edge_block is None:
        # Historical single-pass path, kept verbatim: the golden fixtures
        # were produced by it and the blocked path is parity-tested against it.
        if edge_activity is None:
            edge_activity = np.ones(src.size, dtype=np.float64)
        if vertex_activity is None:
            vertex_activity = np.ones(partition.num_nodes, dtype=np.float64)
        w = np.asarray(edge_activity, dtype=np.float64) * packet_bytes

        ep = partition.edge_part.astype(np.int64)  # part of the edge (source-cut)
        sp = partition.vertex_part[src].astype(np.int64)  # part of the src vertex
        dp = partition.vertex_part[dst].astype(np.int64)  # part of the dst vertex

        matrix = np.zeros((n, n), dtype=np.float64)
        et_ids = ET * P + ep
        eprop_ids = EPROP * P + ep
        # Process reads the *source* property (Table 1: eProp = u.Prop ⊕ edge);
        # source-cut ⇒ part(u) == part(e) except for capacity-spilled edges.
        vprop_read_ids = VPROP * P + sp
        # Reduce delivers to the destination's temp: rank-local under the paper's
        # duplicated-vtemp model, destination part under the cross model.
        vtemp_ids = VTEMP * P + (ep if model == "paper" else dp)

        # Process: ET→vprop lookup, vprop→eprop value.
        _accumulate(matrix, et_ids, vprop_read_ids, w)
        _accumulate(matrix, vprop_read_ids, eprop_ids, w)
        process_bytes = 2.0 * w.sum()
        # Reduce: eprop→vtemp update, ET→vtemp neighbour read.
        _accumulate(matrix, eprop_ids, vtemp_ids, w)
        _accumulate(matrix, et_ids, vtemp_ids, w)
        reduce_bytes = 2.0 * w.sum()
        # Apply: vtemp→vprop, local per active vertex (same part → zero/short
        # hops after co-placement, but the bytes exist and are reported, Fig. 3).
        wv = np.asarray(vertex_activity, dtype=np.float64) * packet_bytes
        vpart = partition.vertex_part.astype(np.int64)
        _accumulate(matrix, VTEMP * P + vpart, VPROP * P + vpart, wv)
        apply_bytes = float(wv.sum())

        return TrafficMatrix(
            num_parts=P,
            bytes_matrix=matrix,
            phase_bytes={
                "process": float(process_bytes),
                "reduce": float(reduce_bytes),
                "apply": apply_bytes,
            },
        )

    # Streaming path: edges (then vertices) in blocks through the COO
    # accumulator; transients are O(block), the accumulator O(nnz ≤ (4P)²).
    # `edge_block_coo`/`vertex_block_coo` are the same per-block units the
    # disk-shard cache (`repro_torch.experiments.cache`) persists, so the cached
    # merge and this in-memory merge share one code path.
    acc = _COOAccumulator()
    e_total = int(src.size)
    step = e_total if edge_block is None else max(int(edge_block), 1)
    w_sum = 0.0
    for start in range(0, e_total, max(step, 1)):
        keys_b, vals_b, w_b = edge_block_coo(
            partition,
            src,
            dst,
            edge_activity=edge_activity,
            packet_bytes=packet_bytes,
            model=model,
            lo=start,
            hi=min(start + step, e_total),
        )
        acc.add(keys_b, vals_b)
        w_sum += w_b
    v_total = int(partition.num_nodes)
    wv_sum = 0.0
    for start in range(0, v_total, max(step, 1)):
        keys_b, vals_b, wv_b = vertex_block_coo(
            partition,
            vertex_activity=vertex_activity,
            packet_bytes=packet_bytes,
            lo=start,
            hi=min(start + step, v_total),
        )
        acc.add(keys_b, vals_b)
        wv_sum += wv_b

    keep = acc.vals != 0.0  # canonical form: explicit zeros dropped, as to_sparse()
    keys, vals = acc.keys[keep], acc.vals[keep]
    sparse = SparseTraffic(
        num_parts=P,
        rows=keys // n,
        cols=keys % n,
        vals=vals,
        phase_bytes={
            "process": 2.0 * w_sum,
            "reduce": 2.0 * w_sum,
            "apply": wv_sum,
        },
    )
    return sparse if layout == "sparse" else sparse.to_dense()
