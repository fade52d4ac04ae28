"""Synthetic graph generators matched to the paper's workloads (Table 2).

The container is offline, so the four SNAP graphs are regenerated as R-MAT /
Chung-Lu power-law graphs with the published |V|, |E| and a power-law slope
matched to typical SNAP measurements.  `table2_workloads()` returns the four
paper graphs (scaled by `scale` so tests/benchmarks can run the full pipeline
at laptop size with identical statistics); `verify` in tests asserts the
Fig. 4 skew property (≤10 % of vertices cover ≥90 % of edges) holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import HostGraph

__all__ = ["rmat", "chung_lu", "uniform_random", "grid2d", "WORKLOADS", "table2_workloads"]


def rmat(
    num_nodes: int,
    num_edges: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
    name: str = "rmat",
) -> HostGraph:
    """R-MAT (Chakrabarti et al., SDM'04) — the Graph500 power-law generator.

    Recursive quadrant sampling, vectorised over all edges × levels at once.
    Self-loops kept (SNAP graphs have none, but they are <1e-5 of edges and
    harmless to every consumer here); duplicates kept (multigraph semantics,
    matching edge-list accelerators which store every edge row).
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(2, num_nodes))))
    probs = np.array([a, b, c, 1.0 - a - b - c])
    weights = 1 << np.arange(scale - 1, -1, -1, dtype=np.int64)
    src = np.empty(num_edges, dtype=np.int64)
    dst = np.empty(num_edges, dtype=np.int64)
    # chunked so the (edges × scale) quadrant matrix never exceeds ~1.5 GB
    # (62M-edge Table-2-scale graphs would otherwise need 30+ GB transients)
    chunk = max(1, (1 << 26) // max(scale, 1) * 8)
    for lo in range(0, num_edges, chunk):
        hi = min(lo + chunk, num_edges)
        # quadrant choice per (edge, level): 0=TL,1=TR,2=BL,3=BR
        q = rng.choice(4, size=(hi - lo, scale), p=probs).astype(np.int8)
        src[lo:hi] = ((q >= 2).astype(np.int64) * weights).sum(1) % num_nodes
        dst[lo:hi] = ((q % 2).astype(np.int64) * weights).sum(1) % num_nodes
    w = rng.uniform(1.0, 8.0, size=num_edges).astype(np.float32) if weighted else None
    return HostGraph(num_nodes, src, dst, w, name)


def chung_lu(
    num_nodes: int,
    num_edges: int,
    *,
    alpha: float = 2.1,
    seed: int = 0,
    weighted: bool = False,
    name: str = "chung_lu",
) -> HostGraph:
    """Chung-Lu: endpoints sampled ∝ a target power-law degree sequence with
    exponent `alpha` — gives direct control of Eq. 1's slope."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    w = ranks ** (-1.0 / (alpha - 1.0))  # Zipf weights → power-law degrees
    p = w / w.sum()
    src = rng.choice(num_nodes, size=num_edges, p=p)
    dst = rng.choice(num_nodes, size=num_edges, p=p)
    wts = rng.uniform(1.0, 8.0, size=num_edges).astype(np.float32) if weighted else None
    return HostGraph(num_nodes, src.astype(np.int64), dst.astype(np.int64), wts, name)


def uniform_random(
    num_nodes: int, num_edges: int, *, seed: int = 0, weighted: bool = False, name: str = "uniform"
) -> HostGraph:
    """Erdős–Rényi-style uniform endpoints — the no-skew control case."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    w = rng.uniform(1.0, 8.0, size=num_edges).astype(np.float32) if weighted else None
    return HostGraph(num_nodes, src, dst, w, name)


def grid2d(nx: int, ny: int, *, name: str = "grid2d") -> HostGraph:
    """Regular 4-neighbour grid (GraphCast-style near-regular mesh control)."""
    ids = np.arange(nx * ny).reshape(nx, ny)
    src, dst = [], []
    src.append(ids[:-1, :].ravel()), dst.append(ids[1:, :].ravel())
    src.append(ids[1:, :].ravel()), dst.append(ids[:-1, :].ravel())
    src.append(ids[:, :-1].ravel()), dst.append(ids[:, 1:].ravel())
    src.append(ids[:, 1:].ravel()), dst.append(ids[:, :-1].ravel())
    return HostGraph(nx * ny, np.concatenate(src), np.concatenate(dst), None, name)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    num_nodes: int
    num_edges: int
    description: str


# Paper Table 2.
WORKLOADS = (
    WorkloadSpec("amazon", 304_000, 4_300_000, "Purchasing Network"),
    WorkloadSpec("soc-pokec", 1_600_000, 30_600_000, "Social Network"),
    WorkloadSpec("wiki", 1_800_000, 28_500_000, "Hyperlinks of Wikipedia"),
    WorkloadSpec("ljournal", 5_400_000, 78_000_000, "Live Journal"),
)


def table2_workloads(
    *,
    scale: float = 1.0,
    seed: int = 0,
    weighted: bool = False,
    names: tuple[str, ...] | None = None,
) -> dict[str, HostGraph]:
    """The paper's four workloads at `scale` (1.0 = published size).

    Benchmarks and the experiment sweep default to scale=0.01 so a full
    BFS/SSSP/PR sweep stays inside the CPU container budget; statistics
    (α, skew) are scale-invariant under R-MAT so the mapping results transfer
    — EXPERIMENTS.md §Calibration reports both the scale used and the
    measured skew vs. Fig. 4.

    `names` restricts generation to those workloads (large-scale sweeps must
    not pay for graphs they never use); each graph's seed stays tied to its
    Table-2 position, so a filtered subset is bit-identical to slicing the
    full dict.
    """
    out = {}
    for i, wl in enumerate(WORKLOADS):
        if names is not None and wl.name not in names:
            continue
        n = max(64, int(wl.num_nodes * scale))
        e = max(256, int(wl.num_edges * scale))
        out[wl.name] = rmat(n, e, seed=seed + i, weighted=weighted, name=wl.name)
    return out
