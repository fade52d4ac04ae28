"""Power-law degree analysis (paper §4, Eq. 1 and Fig. 4).

The paper's observation: vertex out-degree follows n(d) ∝ 1/d^α, so a small
fraction of vertices carries most edges.  Everything downstream (Algorithm 2's
degree sort, hub replication) keys off the statistics computed here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "out_degrees",
    "in_degrees",
    "fit_power_law",
    "skew_stats",
    "SkewStats",
    "hub_set",
]


def out_degrees(src: np.ndarray, num_nodes: int) -> np.ndarray:
    """Out-degree of every vertex from a COO edge list's source column."""
    return np.bincount(np.asarray(src, dtype=np.int64), minlength=num_nodes)


def in_degrees(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    return np.bincount(np.asarray(dst, dtype=np.int64), minlength=num_nodes)


def fit_power_law(degrees: np.ndarray) -> float:
    """Least-squares fit of α in n(d) ∝ d^{-α} on the log-log degree histogram.

    Matches the paper's Eq. 1: d = degree, n(d) = #vertices with degree d.
    Degree-0 vertices are excluded (log undefined); histogram bins with zero
    count are excluded for the same reason.
    """
    degrees = np.asarray(degrees)
    degrees = degrees[degrees > 0]
    if degrees.size == 0:
        return 0.0
    counts = np.bincount(degrees)
    ds = np.nonzero(counts)[0]
    ds = ds[ds > 0]
    if ds.size < 2:
        return 0.0
    x = np.log(ds.astype(np.float64))
    y = np.log(counts[ds].astype(np.float64))
    # alpha is the negative slope of log n(d) vs log d.
    slope, _ = np.polyfit(x, y, 1)
    return float(-slope)


@dataclasses.dataclass(frozen=True)
class SkewStats:
    """Summary of edge-mass concentration (paper Fig. 4)."""

    alpha: float
    # Fraction of vertices (sorted by degree desc) that own >= 90% of edges.
    frac_vertices_for_90pct_edges: float
    # Fraction of edges owned by the top 10% of vertices.
    frac_edges_in_top10pct_vertices: float
    gini: float
    max_degree: int
    mean_degree: float

    @property
    def is_power_law(self) -> bool:
        """Heuristic gate used by the mapper to decide hub replication."""
        return self.frac_vertices_for_90pct_edges < 0.5 and self.alpha > 0.5


def skew_stats(degrees: np.ndarray) -> SkewStats:
    degrees = np.asarray(degrees, dtype=np.int64)
    total = int(degrees.sum())
    n = degrees.size
    if total == 0 or n == 0:
        return SkewStats(0.0, 1.0, 0.0, 0.0, 0, 0.0)
    sorted_desc = np.sort(degrees)[::-1]
    cum = np.cumsum(sorted_desc)
    k90 = int(np.searchsorted(cum, 0.9 * total) + 1)
    top10 = max(1, n // 10)
    frac_edges_top10 = float(cum[top10 - 1]) / total
    # Gini over the degree distribution (Lorenz-curve form).
    sorted_asc = sorted_desc[::-1].astype(np.float64)
    idx = np.arange(1, n + 1, dtype=np.float64)
    gini = float((2.0 * (idx * sorted_asc).sum()) / (n * sorted_asc.sum()) - (n + 1.0) / n)
    return SkewStats(
        alpha=fit_power_law(degrees),
        frac_vertices_for_90pct_edges=k90 / n,
        frac_edges_in_top10pct_vertices=frac_edges_top10,
        gini=gini,
        max_degree=int(sorted_desc[0]),
        mean_degree=total / n,
    )


def hub_set(degrees: np.ndarray, edge_coverage: float = 0.5, max_frac: float = 0.05) -> np.ndarray:
    """Smallest set of highest-degree vertices covering `edge_coverage` of edges.

    Capped at `max_frac` of all vertices — under power law the cap rarely binds;
    for near-regular graphs (e.g. GraphCast's icosahedral mesh) it keeps the
    replication budget bounded.  Returns vertex ids sorted by degree desc.
    """
    degrees = np.asarray(degrees, dtype=np.int64)
    order = np.argsort(-degrees, kind="stable")
    cum = np.cumsum(degrees[order])
    total = max(1, int(cum[-1]))
    k = int(np.searchsorted(cum, edge_coverage * total) + 1)
    k = min(k, max(1, int(max_frac * degrees.size)))
    return order[:k]
