"""The paper's three workload algorithms as VertexPrograms (Table 1, torch
callables) plus host-side reference implementations for correctness tests.

Table 1 (paper):
  BFS      : process eProp = u.Prop + 1       reduce min   apply min
  SSSP     : process eProp = u.Prop + weight  reduce min   apply min
  PageRank : process eProp = u.Prop/outdeg    reduce sum   apply a·temp + base
             (the paper's table abbreviates the standard damped PR update;
             we implement the standard form, damping a=0.85, base=(1−a)/N)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import HostGraph
from repro_torch.graph.vertex_program import VertexProgram

__all__ = ["bfs_program", "sssp_program", "pagerank_program", "ALGORITHMS",
           "prepare_graph", "pagerank_edge_weights", "fma_f32",
           "reference_bfs", "reference_sssp", "reference_pagerank"]


def _dist_init(num_nodes: int, source: int, device: torch.device):
    props = torch.full((num_nodes + 1,), float("inf"), dtype=torch.float32, device=device)
    props[source] = 0.0
    active = torch.zeros(num_nodes + 1, dtype=torch.bool, device=device)
    active[source] = True
    return props, active


def bfs_program() -> VertexProgram:
    return VertexProgram(
        name="bfs",
        reduce_kind="min",
        process=lambda p, w, aux: p + 1.0,
        apply=lambda prop, temp, aux: torch.minimum(prop, temp),
        init=_dist_init,
        frontier="delta",
    )


def sssp_program() -> VertexProgram:
    return VertexProgram(
        name="sssp",
        reduce_kind="min",
        process=lambda p, w, aux: p + w,
        apply=lambda prop, temp, aux: torch.minimum(prop, temp),
        init=_dist_init,
        frontier="delta",
    )


def fma_f32(a: float, x: torch.Tensor, c: torch.Tensor | float) -> torch.Tensor:
    """`a·x + c` for float32 `x`, rounded once to float32, on any device.

    The reference package's PageRank update `base + damping * temp` is one
    fused multiply-add in the code XLA's CPU backend emits (it contracts the
    product into the sum), so its trace carries FMA bits; two roundings
    differ in the last place of about a fifth of the vertices, and the trace
    counts a vertex as active when its value changes at all.  Here the
    product is exact in float64 (24 × 24 significant bits), TwoSum gives the
    error of the float64 sum, and rounding that sum to odd before the float32
    rounding makes the two roundings one (Boldo & Melquiond, 2008: valid for
    53 ≥ 24 + 2 bits)."""
    p = x.double() * float(np.float32(a))
    c64 = torch.as_tensor(c, dtype=torch.float64, device=x.device)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # p + c == s + err exactly
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def pagerank_program(damping: float = 0.85) -> VertexProgram:
    def init(num_nodes: int, source: int, device: torch.device):
        props = torch.full((num_nodes + 1,), 1.0 / num_nodes, dtype=torch.float32, device=device)
        active = torch.ones(num_nodes + 1, dtype=torch.bool, device=device)
        active[-1] = False
        return props, active

    def make_aux(g: HostGraph):
        outdeg = np.maximum(g.out_degrees(), 1).astype(np.float32)
        return {"inv_outdeg": np.concatenate([1.0 / outdeg, [0.0]]).astype(np.float32),
                "base": np.float32((1.0 - damping) / g.num_nodes)}

    def process(p, w, aux):
        # message = u.prop / outdeg(u); inv_outdeg gathered via closure-free
        # trick: process receives src props already gathered, so the engine
        # multiplies by inv_outdeg at apply-side instead — we fold it into the
        # props themselves: props stored as rank/outdeg would change Table 1
        # semantics, so the aux carries the gathered factor via `w` channel
        # when the graph is unweighted.  The program declares this product
        # (`process_kind` below), so the engine may run the sum as an SpMM.
        return p * w

    def apply(prop, temp, aux):
        return fma_f32(damping, temp, aux["base"])

    return VertexProgram(
        name="pagerank",
        reduce_kind="sum",
        process=process,
        apply=apply,
        init=init,
        make_aux=make_aux,
        frontier="all",
        tol=1e-5,
        process_kind="weighted_product",
    )


def pagerank_edge_weights(g: HostGraph) -> HostGraph:
    """PR messages need u.prop/outdeg(u); with the engine's process(src_prop,
    edge_weight) signature the 1/outdeg factor rides the edge weight."""
    inv = 1.0 / np.maximum(g.out_degrees(), 1).astype(np.float32)
    return HostGraph(g.num_nodes, g.src, g.dst, inv[g.src], g.name + "_pr")


ALGORITHMS = {
    "bfs": bfs_program,
    "sssp": sssp_program,
    "pagerank": pagerank_program,
}


def prepare_graph(name: str, g: HostGraph) -> HostGraph:
    """Per-algorithm graph preprocessing (PR folds 1/outdeg into weights)."""
    if name == "pagerank":
        return pagerank_edge_weights(g)
    if name == "sssp" and g.weight is None:
        rng = np.random.default_rng(0)
        return HostGraph(
            g.num_nodes, g.src, g.dst, rng.uniform(1.0, 8.0, g.num_edges).astype(np.float32), g.name
        )
    return g


# ----------------------------- references ---------------------------------


def reference_bfs(g: HostGraph, source: int = 0) -> np.ndarray:
    """Frontier BFS on the host CSR — oracle for tests."""
    csr = g.csr()
    dist = np.full(g.num_nodes, np.inf)
    dist[source] = 0.0
    frontier = [source]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in csr.neighbors(u):
                if dist[v] == np.inf:
                    dist[v] = d
                    nxt.append(int(v))
        frontier = nxt
    return dist


def reference_sssp(g: HostGraph, source: int = 0) -> np.ndarray:
    """Dijkstra via scipy.sparse.csgraph — oracle for tests.

    scipy's COO→CSR conversion *sums* parallel edges, which would corrupt a
    multigraph; dedup to the minimum parallel edge first (vectorised).
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    w = (g.weight if g.weight is not None else np.ones(g.num_edges)).astype(np.float64)
    key = g.src.astype(np.int64) * g.num_nodes + g.dst.astype(np.int64)
    order = np.lexsort((w, key))
    key_s, w_s = key[order], w[order]
    first = np.ones(key_s.size, dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]  # sorted by (key, w) → first = min w
    rows = (key_s[first] // g.num_nodes).astype(np.int64)
    cols = (key_s[first] % g.num_nodes).astype(np.int64)
    vals = w_s[first]
    m = csr_matrix((vals, (rows, cols)), shape=(g.num_nodes, g.num_nodes))
    return dijkstra(m, directed=True, indices=source)


def reference_pagerank(g: HostGraph, damping: float = 0.85, iters: int = 200, tol=1e-5) -> np.ndarray:
    n = g.num_nodes
    outdeg = np.maximum(g.out_degrees(), 1).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = pr[g.src] / outdeg[g.src]
        agg = np.bincount(g.dst, weights=contrib, minlength=n)
        new = (1.0 - damping) / n + damping * agg
        if np.abs(new - pr).sum() <= tol:
            pr = new
            break
        pr = new
    return pr
