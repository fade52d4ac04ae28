"""Shard placement onto NoC coordinates (paper §5.2 Algorithm 3, §5.3 Algorithm 4).

The optimisation: assign each logical shard (structure, part) to a router so
that the hop-weighted traffic  H = Σ_ij f_ij · dist(site_i, site_j)  is
minimal — the objective the paper derives from the power-law degree skew of
Eq. 1 (a few hub shards carry most f_ij, so collapsing *their* routes is
where the Fig. 7 2–5× speedup comes from).  This is a quadratic assignment
problem; the paper calls it an ILP — we provide the standard linearised MILP
(exact, small instances, via scipy/HiGHS), the paper's regular constructive
layout (Algorithm 3 / Fig. 4), torus-native constructive layouts
(`torus_quad_placement` / `torus_columnar_placement`: wrap-aware quads and
hub columns that cluster the power-law hub parts around the coordinate seam
— the quad variant beats greedy+2-opt on torus2d with no search at all), a
traffic-weighted greedy + 2-opt for large meshes, a brute-force oracle for
tests, and the
randomized baseline the paper compares against (Fig. 5).

Delta-kernel math (the shared heart of every search path here and of the
batched engine in `repro_torch.experiments.placement_batch`):

* `symmetrize_weights` folds the directed f_ij into w = f + fᵀ (zero
  diagonal) so H = ½ Σ_ij w_ij·d(site_i, site_j) ranges over ordered pairs
  and every ΔH below is exact for the undirected objective.
* `swap_delta_matrix` — with A[i, j] = Σ_k w[i, k]·d(site_j, site_k) (one
  (n,n)·(n,n) matmul), the H-change of swapping shards i and j is
  Δswap(i, j) = A[i,j] + A[j,i] + 2·w_ij·d(site_i, site_j) − A[i,i] − A[j,j];
  the 2·w_ij·d_ij term restores the pair's own cross term, which the stale
  site array drops from both sides (d[s, s] = 0).
* `move_delta_matrix` — Δmove(i, t) = (w @ d[:, site]ᵀ)[i, t] − A[i, i]:
  the H-change of relocating shard i to router t, one (n,n)·(n,S) matmul.

`two_opt` probes one random candidate per iteration against the scalar forms
of these deltas (the paper-era reference search); `two_opt_best_move`
evaluates all O(n²) swaps + O(n·S) moves per step and applies the single
best (steepest descent to a full 2-opt local optimum); the batched engine
runs that identical recursion stacked over every sweep config at once.
`greedy_placement` builds the *initial* layout the searches refine — its
seeding rule lives in `greedy_seed` so the serial and batched constructors
cannot drift.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.noc import FlattenedButterfly, Mesh2D, Topology, Torus2D, Torus3D
from repro_torch.core.partition import Partition
from repro_torch.core.traffic import EPROP, ET, VPROP, VTEMP, TrafficMatrix

__all__ = [
    "Placement",
    "auto_mesh_for_parts",
    "random_placement",
    "columnar_placement",
    "quad_placement",
    "part_traffic_weights",
    "torus_quad_cells",
    "torus_hub_columns",
    "torus_cell_site_table",
    "torus_quad_placement",
    "torus_columnar_placement",
    "greedy_seed",
    "greedy_placement",
    "symmetrize_weights",
    "swap_delta_matrix",
    "move_delta_matrix",
    "sparse_weighted_hops",
    "swap_candidates_topk",
    "swap_delta_pairs",
    "default_max_steps",
    "two_opt",
    "two_opt_best_move",
    "two_opt_topk",
    "ilp_placement",
    "brute_force_placement",
    "resolve_method",
    "place",
]


@dataclasses.dataclass(frozen=True)
class Placement:
    """site[n] = router index (into topology.coords()) of logical shard n."""

    topology: Topology
    site: np.ndarray  # (num_logical,) int
    method: str

    def __post_init__(self):
        s = np.asarray(self.site)
        if np.unique(s).size != s.size:
            raise ValueError("placement assigns two shards to one router")
        if s.size > self.topology.num_nodes:
            raise ValueError("more shards than routers")

    def weighted_hops(self, weights: np.ndarray) -> float:
        """Σ_ij w_ij · dist(site_i, site_j) — Algorithm 4's objective H."""
        d = self.topology.distance_matrix()
        s = self.site
        return float((weights * d[np.ix_(s, s)]).sum())

    def average_hops(self, weights: np.ndarray) -> float:
        total_w = float(weights.sum())
        if total_w == 0:
            return 0.0
        return self.weighted_hops(weights) / total_w

    def coords_of(self, logical: int) -> np.ndarray:
        return self.topology.coords()[self.site[logical]]


def auto_mesh_for_parts(num_parts: int, topology: str = "mesh2d") -> Topology:
    """Smallest near-square mesh (near-cubic torus3d) with ≥ 4·P routers
    (one per shard)."""
    n = 4 * num_parts
    if topology == "torus3d":
        # Near-cubic factorization n = kx·ky·kz: kx the largest divisor
        # ≤ n^(1/3), then ky·kz near-square on the remainder (e.g. 64 →
        # 4×4×4, 16 → 2×2×4).
        kx = max(k for k in range(1, int(round(n ** (1 / 3))) + 1) if n % k == 0)
        rest = n // kx
        ky = int(math.isqrt(rest))
        while rest % ky:
            ky -= 1
        return Torus3D(kx, ky, rest // ky)
    kx = int(math.isqrt(n))
    while n % kx:
        kx -= 1
    ky = n // kx
    if kx == 1 and n > 2:  # prime 4P can't happen (4P divisible by 4) but guard
        kx, ky = 2, (n + 1) // 2
    cls = {"mesh2d": Mesh2D, "fbutterfly": FlattenedButterfly, "torus2d": Torus2D}[topology]
    return cls(kx, ky)


def random_placement(num_logical: int, topology: Topology, *, seed: int = 0) -> Placement:
    """Paper baseline: randomized mapping of shards to routers (Fig. 5)."""
    rng = np.random.default_rng(seed)
    site = rng.permutation(topology.num_nodes)[:num_logical]
    return Placement(topology, site, "random")


def _site_lookup(topology: Topology) -> dict[tuple[int, ...], int]:
    return {tuple(c): i for i, c in enumerate(topology.coords())}


def columnar_placement(num_parts: int, topology: Topology) -> Placement:
    """Algorithm 3's regular layout (paper Fig. 4): structures in rows.

    Ranks occupy consecutive columns (x); structures occupy fixed rows (y):
    ET on the top row band, eprop on the bottom band, vprop/vtemp in the
    interior — satisfying the paper's constraints (index1: y high, index4:
    y low, index2/3 interior).  Ranks wrap column-major when P > kx.
    """
    kx, ky = topology.kx, topology.ky  # type: ignore[attr-defined]
    if kx * ky < 4 * num_parts:
        raise ValueError("mesh too small")
    bands = ky // 4
    if bands == 0:
        raise ValueError("columnar layout needs ky >= 4")
    lookup = _site_lookup(topology)
    site = np.empty(4 * num_parts, dtype=np.int64)
    # Row bands bottom→top: eprop, vtemp, vprop, ET (transfer-heavy pairs
    # (ET,vprop) and (eprop,vtemp) land in adjacent bands).
    band_of = {EPROP: 0, VTEMP: 1, VPROP: 2, ET: 3}
    for p in range(num_parts):
        x = p % kx
        sub = p // kx  # row inside the band when P > kx
        if sub >= bands:
            raise ValueError("mesh too small for columnar layout")
        for struct, band in band_of.items():
            y = band * bands + sub
            site[struct * num_parts + p] = lookup[(x, y)]
    return Placement(topology, site, "columnar")


# Within-cell structure offsets shared by the quad layouts: ET adjacent to
# vprop and vtemp; eprop adjacent to vprop and vtemp (the heavy Fig. 3 pairs).
_QUAD_OFFSET = {ET: (0, 0), VPROP: (0, 1), VTEMP: (1, 0), EPROP: (1, 1)}


def quad_placement(num_parts: int, topology: Topology) -> Placement:
    """Each rank's four shards in a 2×2 quad, quads tiled in snake order.

    On a 2-D mesh every communicating pair sits at L1 distance 1, which is the
    information-theoretic floor (distinct routers) — this is what the ILP
    converges to and is our default constructive optimum.
    """
    kx, ky = topology.kx, topology.ky  # type: ignore[attr-defined]
    if kx * ky < 4 * num_parts or kx < 2 or ky < 2:
        raise ValueError("mesh too small")
    qx, qy = kx // 2, ky // 2
    if qx * qy < num_parts:
        raise ValueError("not enough 2x2 quads")
    lookup = _site_lookup(topology)
    site = np.empty(4 * num_parts, dtype=np.int64)
    for p in range(num_parts):
        gx, gy = p % qx, p // qx
        if gy % 2 == 1:  # snake rows keep consecutive ranks adjacent
            gx = qx - 1 - gx
        for struct, (dx, dy) in _QUAD_OFFSET.items():
            site[struct * num_parts + p] = lookup[(2 * gx + dx, 2 * gy + dy)]
    return Placement(topology, site, "quad")


def _ring_adjacent_pairs(k: int) -> list[tuple[int, int]]:
    """Disjoint wrap-adjacent index pairs on a k-ring, the seam pair first:
    (k−1, 0), (1, 2), (3, 4), …  — ⌊k/2⌋ pairs (one interior index is left
    over when k is odd).  Leading with the seam pair is what makes the torus
    layouts below wrap-aware: the hub quad/columns span the coordinate seam,
    which only a torus can make adjacent."""
    pairs = [(k - 1, 0)]
    a = 1
    while a + 1 <= k - 2:
        pairs.append((a, a + 1))
        a += 2
    return pairs


def _ring_distance(a: int, b: int, k: int) -> int:
    d = abs(a - b)
    return min(d, k - d)


def part_traffic_weights(w2: np.ndarray, num_parts: int) -> np.ndarray:
    """Per-part incident traffic from doubled (…, 4P, 4P) shard weights:
    pw[…, p] = Σ over the 4 shards of part p of their total row weight.
    Leading batch dimensions pass through unchanged — the serial constructors
    here and the stacked constructor in
    `repro_torch.experiments.placement_batch.torus_construct_batch` call this SAME
    reduction (identical summation tree per config), so the hub orderings —
    and therefore the layouts — cannot drift between the two paths."""
    n = w2.shape[-1]
    shaped = w2.reshape(*w2.shape[:-2], 4, num_parts, n)
    return shaped.sum(axis=(-3, -1))


def torus_quad_cells(kx: int, ky: int) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """Wrap-aware 2×2 quad cells of a kx×ky torus in hub-first order.

    Each cell is ((xa, xb), (ya, yb)) — two wrap-adjacent columns × two
    wrap-adjacent rows.  The first cell is the SEAM quad ((kx−1, 0),
    (ky−1, 0)): its four routers occupy the corners of the coordinate map yet
    are pairwise torus-adjacent, which no mesh cell can be.  Cells are sorted
    by torus distance from that seam anchor (ties broken by grid index), so
    assigning parts heaviest-first clusters the hub quads around the seam —
    wrap-adjacent across it — and pushes light parts toward the antipode."""
    xp = _ring_adjacent_pairs(kx)
    yp = _ring_adjacent_pairs(ky)
    cells = []
    for gy, (ya, yb) in enumerate(yp):
        for gx, (xa, xb) in enumerate(xp):
            dist = _ring_distance(xa, kx - 1, kx) + _ring_distance(ya, ky - 1, ky)
            cells.append((dist, gx, gy, ((xa, xb), (ya, yb))))
    cells.sort(key=lambda c: c[:3])
    return [c[3] for c in cells]


def torus_hub_columns(kx: int) -> list[int]:
    """Column indices of a kx-ring in hub-first order: 0, then alternating
    outward by ring distance (1, kx−1, 2, kx−2, …).  Consecutive entries stay
    within ring distance 1 of the already-used set, so heavy columns cluster
    around column 0 — wrap-adjacent across the seam (column kx−1 sits next to
    column 0 only on a torus)."""
    return sorted(range(kx), key=lambda x: (_ring_distance(x, 0, kx), x))


def torus_cell_site_table(topology: Topology, method: str = "torus_quad") -> np.ndarray:
    """(num_cells, 4) router ids of a torus-native constructive layout: row =
    hub-ranked cell, column = structure index (ET, vprop, vtemp, eprop).

    The SINGLE source of the torus layouts' geometry: the serial constructors
    below index it with their hub part order, and the stacked constructor
    (`repro_torch.experiments.placement_batch.torus_construct_batch`) stacks these
    tables across configs — so the two paths share every site, bit for bit.
    """
    if not isinstance(topology, Torus2D):
        raise ValueError(f"{method} placement needs a Torus2D topology")
    kx, ky = topology.kx, topology.ky
    rows: list[list[int]] = []
    lookup = _site_lookup(topology)
    if method == "torus_quad":
        if kx < 2 or ky < 2:
            raise ValueError("torus too small for 2x2 quads")
        for xs, ys in torus_quad_cells(kx, ky):
            rows.append(
                [lookup[(xs[dx], ys[dy])] for _, (dx, dy) in sorted(_QUAD_OFFSET.items())]
            )
    elif method == "torus_columnar":
        bands = ky // 4
        if bands == 0:
            raise ValueError("columnar layout needs ky >= 4")
        # Row bands bottom→top: eprop, vtemp, vprop, ET (as in
        # columnar_placement) — when 4 | ky the ET top band is also adjacent
        # to the eprop bottom band through the y wrap.
        band_of = {EPROP: 0, VTEMP: 1, VPROP: 2, ET: 3}
        for sub in range(bands):
            for x in torus_hub_columns(kx):
                rows.append(
                    [lookup[(x, band_of[s] * bands + sub)] for s in range(4)]
                )
    else:
        raise ValueError(f"unknown torus layout {method!r}")
    return np.array(rows, dtype=np.int64)


def _torus_hub_order(num_parts: int, weights: np.ndarray | None) -> np.ndarray:
    """Parts in descending incident-traffic order (stable; identity without
    weights) — which part gets which hub-ranked cell."""
    if weights is None:
        return np.arange(num_parts)
    w = np.asarray(weights, dtype=np.float64)
    return np.argsort(-part_traffic_weights(w + w.T, num_parts), kind="stable")


def _assemble_torus_layout(
    topology: Topology, method: str, num_parts: int, weights: np.ndarray | None
) -> Placement:
    table = torus_cell_site_table(topology, method)
    if len(table) < num_parts:
        raise ValueError(f"torus too small for {method} layout of {num_parts} parts")
    order = _torus_hub_order(num_parts, weights)
    site = np.empty(4 * num_parts, dtype=np.int64)
    for rank, p in enumerate(order):
        for struct in range(4):
            site[struct * num_parts + p] = table[rank, struct]
    return Placement(topology, site, method)


def torus_quad_placement(
    num_parts: int, topology: Topology, weights: np.ndarray | None = None
) -> Placement:
    """Torus-native constructive quad layout (the mesh `quad_placement`
    rethought under the wrap metric — ROADMAP "Torus-aware constructive
    layouts").

    Every part's four shards land in one wrap-adjacent 2×2 cell (all
    communicating intra-part pairs at torus distance 1, the constructive
    optimum), cells come from `torus_quad_cells` (seam quad first, then by
    torus distance from it), and parts are assigned heaviest-first by
    `part_traffic_weights` — so the hub parts that dominate the power-law
    f_ij sit clustered around the seam, wrap-adjacent across it.  Pure
    construction: no search follows (`place` returns it as-is), yet on every
    torus-grid config it beats greedy+2-opt H (asserted in
    tests/test_core_placement.py; measured in EXPERIMENTS.md §Torus).
    """
    return _assemble_torus_layout(topology, "torus_quad", num_parts, weights)


def torus_columnar_placement(
    num_parts: int, topology: Topology, weights: np.ndarray | None = None
) -> Placement:
    """Torus-native Algorithm-3 layout: `columnar_placement`'s row bands with
    rank columns assigned hub-first in `torus_hub_columns` order, so the
    heavy-traffic parts occupy columns clustered around the seam (column
    kx−1 is wrap-adjacent to column 0).

    Explicit-only (never an "auto" route): like the paper's mesh columnar
    layout it is a regular reference layout, not a search replacement — its
    H trails greedy+2-opt.  The ET-band/eprop-band y-seam adjacency holds
    when ky is a multiple of 4 (otherwise the top ky % 4 rows are unused and
    sit between the bands)."""
    return _assemble_torus_layout(topology, "torus_columnar", num_parts, weights)


def greedy_seed(doubled_weights: np.ndarray, d: np.ndarray) -> tuple[int, int]:
    """Greedy construction's seeding rule: (heaviest shard, mesh centroid).
    Takes the doubled w + wᵀ weights and the (S, S) distance matrix.  Shared
    by `greedy_placement` and the batched constructor
    (`repro_torch.experiments.placement_batch.greedy_construct_batch`) so the two
    paths cannot drift."""
    return int(doubled_weights.sum(1).argmax()), int(d.sum(1).argmin())


def greedy_placement(weights: np.ndarray, topology: Topology, *, seed: int = 0) -> Placement:
    """Traffic-weighted greedy: place shards in order of connectivity to the
    already-placed set, each at the router minimising added weighted hops
    (argmax-connectivity insertion, argmin-cost site — the constructive half
    of Algorithm 4).  Scales to thousands of shards (vectorised over
    candidate routers).  This is the serial reference for
    `repro_torch.experiments.placement_batch.greedy_construct_batch`, which runs
    the identical recursion stacked over sweep configs (bit-parity asserted
    in tests/test_placement_batch.py).
    """
    w = np.asarray(weights, dtype=np.float64)
    w = w + w.T
    n = w.shape[0]
    d = topology.distance_matrix().astype(np.float64)
    num_sites = topology.num_nodes
    placed_site = np.full(n, -1, dtype=np.int64)
    free = np.ones(num_sites, dtype=bool)
    # accumulated cost-to-placed for every (node, site): updated incrementally.
    cost = np.zeros((n, num_sites), dtype=np.float64)
    placed_mask = np.zeros(n, dtype=bool)
    first, center = greedy_seed(w, d)
    order_rng = np.random.default_rng(seed)
    cur, cur_site = first, center
    for _ in range(n):
        placed_site[cur] = cur_site
        placed_mask[cur] = True
        free[cur_site] = False
        cost += np.outer(w[:, cur], d[cur_site])
        if placed_mask.all():
            break
        conn = w[:, placed_mask].sum(1)
        conn[placed_mask] = -np.inf
        nxt = int(conn.argmax())
        if not np.isfinite(conn[nxt]) or conn[nxt] <= 0:
            unplaced = np.nonzero(~placed_mask)[0]
            nxt = int(order_rng.choice(unplaced))
        c = cost[nxt].copy()
        c[~free] = np.inf
        cur, cur_site = nxt, int(c.argmin())
    return Placement(topology, placed_site, "greedy")


def symmetrize_weights(weights: np.ndarray) -> np.ndarray:
    """w + wᵀ with a zero diagonal — the form every search kernel expects
    (H = ½ Σ_ij w_sym[i,j]·d[site_i, site_j] over ordered pairs)."""
    w = np.asarray(weights, dtype=np.float64)
    w = w + w.T
    np.fill_diagonal(w, 0.0)
    return w


def swap_delta_matrix(w: np.ndarray, d: np.ndarray, site: np.ndarray) -> np.ndarray:
    """ΔH of *every* pairwise site swap at once.

    `w` symmetric zero-diagonal (n, n), `d` (S, S), `site` (n,).  Entry
    (i, j) is the exact change in H = `Placement.weighted_hops(raw_weights)`
    (the undirected objective Σ_{i<j} w_ij·d(site_i, site_j) over the
    symmetrized w) from swapping the sites of shards i and j (diagonal = 0).
    Derivation: with
    A[i, j] = Σ_k w[i, k]·d(site_j, site_k) (cost of i evaluated at j's site
    against the *stale* site array), the swapped pair omits its own cross
    term on both sides (d[s, s] = 0), so adding the swap-invariant
    2·w_ij·d(site_i, site_j) correction makes the test exact:

        Δ(i, j) = A[i, j] + A[j, i] + 2·w_ij·d_ij − A[i, i] − A[j, j]

    One (n, n)·(n, n) matmul — the vectorized form of the serial two_opt
    probe, shared by `two_opt_best_move` and the batched placement engine.
    """
    dss = d[np.ix_(site, site)]
    a = w @ dss  # A[i, j]: cost of shard i at shard j's site
    diag = np.diagonal(a)
    delta = a + a.T + 2.0 * w * dss - diag[:, None] - diag[None, :]
    np.fill_diagonal(delta, 0.0)
    return delta


def move_delta_matrix(w: np.ndarray, d: np.ndarray, site: np.ndarray) -> np.ndarray:
    """ΔH of moving each shard to *every* router at once: entry (i, t) is the
    exact change in H from relocating shard i to router t with all other
    shards fixed (column site_i = 0).  The caller masks occupied routers.
    One (n, n)·(n, S) matmul — the vectorized free-site probe of two_opt."""
    cost_all = w @ d[:, site].T  # (n, S): cost of shard i at router t
    cur = cost_all[np.arange(site.size), site]
    return cost_all - cur[:, None]


# ---------------------------------------------------------------------------
# sparse-first kernels: H from COO triplets, top-k candidate swaps, and
# blocked (memory-bounded) forms of the delta evaluation.  Parity contract
# (see core.traffic's module docstring): traffic weights are integer-valued
# bytes and hop distances are integers, so every re-association below —
# gather-sums instead of dense sums, einsum pair-dots instead of gemm rows,
# row-blocked gemms instead of one gemm — is bit-exact against the dense
# kernels, not merely close (property-tested in tests/test_sparse_traffic.py).
# ---------------------------------------------------------------------------


def sparse_weighted_hops(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, d: np.ndarray, site: np.ndarray
) -> float:
    """H = Σ_nz vals·d(site_rows, site_cols) by gather — the O(nnz) form of
    `Placement.weighted_hops` for COO traffic (`SparseTraffic` triplets),
    never materializing the (n, n) weights or the (n, n) site-distance
    gather."""
    site = np.asarray(site, dtype=np.int64)
    r = site[np.asarray(rows, dtype=np.int64)]
    c = site[np.asarray(cols, dtype=np.int64)]
    return float((np.asarray(vals, dtype=np.float64) * d[r, c]).sum())


def swap_candidates_topk(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, num_logical: int, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Candidate swap pairs from the sparse traffic structure: the k shards
    with the heaviest incident traffic (the power-law hubs of Eq. 1 — where
    essentially all of the improvable H lives) paired with every shard.

    Returns (pi, pj) with pi < pj, deduplicated, in lexicographic order —
    the same scan order `np.argmin` uses over the upper triangle of the full
    delta matrix, so a restricted search that covers all pairs (k ≥ n)
    breaks ties identically to `two_opt_best_move`.  O(k·n) candidates
    instead of the O(n²) dense delta matrix."""
    incident = np.bincount(
        np.asarray(rows, dtype=np.int64), weights=vals, minlength=num_logical
    ) + np.bincount(np.asarray(cols, dtype=np.int64), weights=vals, minlength=num_logical)
    k = max(1, min(int(k), num_logical))
    hubs = np.argsort(-incident, kind="stable")[:k]
    pi = np.repeat(hubs, num_logical)
    pj = np.tile(np.arange(num_logical, dtype=np.int64), k)
    lo, hi = np.minimum(pi, pj), np.maximum(pi, pj)
    keep = lo != hi
    flat = np.unique(lo[keep] * num_logical + hi[keep])
    return flat // num_logical, flat % num_logical


def swap_delta_pairs(
    w: np.ndarray, d: np.ndarray, site: np.ndarray, pi: np.ndarray, pj: np.ndarray
) -> np.ndarray:
    """Exact ΔH of the given candidate swaps only — `swap_delta_matrix`'s
    formula evaluated at O(|pairs|·n) work and O(|pairs| + n·S) memory
    instead of the full (n, n) matrix (the top-k search path)."""
    site = np.asarray(site, dtype=np.int64)
    pi = np.asarray(pi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    dsite = d[site]  # (n, S): d(site_k, t) for every router t
    diag = _diag_cost(w, dsite, site)
    out = np.empty(pi.size, dtype=np.float64)
    # Pair blocks keep the (n, block) gathers bounded; each pair's delta is
    # independent, so blocking cannot change any value.
    for start in range(0, pi.size, _DIAG_BLOCK):
        sl = slice(start, min(start + _DIAG_BLOCK, pi.size))
        bi, bj = pi[sl], pj[sl]
        a_ij = np.einsum("pk,kp->p", w[bi], dsite[:, site[bj]])
        a_ji = np.einsum("pk,kp->p", w[bj], dsite[:, site[bi]])
        dij = d[site[bi], site[bj]]
        out[sl] = a_ij + a_ji + 2.0 * w[bi, bj] * dij - diag[bi] - diag[bj]
    return out


# Internal row-block size for the memory-bounded kernels below: transients
# stay O(_DIAG_BLOCK · n) instead of the (n, n) site-distance gather.
_DIAG_BLOCK = 256


def _diag_cost(w: np.ndarray, dsite: np.ndarray, site: np.ndarray) -> np.ndarray:
    """diag[i] = A[i, i] = Σ_k w[i, k]·d(site_k, site_i), computed in row
    blocks (each row's dot is independent, so the block size cannot change
    the result)."""
    n = site.size
    diag = np.empty(n, dtype=np.float64)
    for start in range(0, n, _DIAG_BLOCK):
        sl = slice(start, min(start + _DIAG_BLOCK, n))
        diag[sl] = np.einsum("bk,kb->b", w[sl], dsite[:, site[sl]])
    return diag


def two_opt(
    placement: Placement,
    weights: np.ndarray,
    *,
    iters: int = 2000,
    seed: int = 0,
    include_free_sites: bool = True,
) -> Placement:
    """Pairwise-swap hill climbing on H; also tries moves into free routers.

    One random candidate per iteration (the paper-era reference search).  The
    accept tests are the scalar forms of `swap_delta_matrix` /
    `move_delta_matrix`; `two_opt_best_move` and the batched engine
    (`repro_torch.experiments.placement_batch`) evaluate the same deltas for the
    whole candidate set per step instead.
    """
    w = symmetrize_weights(weights)
    d = placement.topology.distance_matrix().astype(np.float64)
    site = placement.site.copy()
    n = site.size
    rng = np.random.default_rng(seed)
    occupied = np.zeros(placement.topology.num_nodes, dtype=np.int64) - 1
    occupied[site] = np.arange(n)

    def node_cost(i: int, s: int) -> float:
        return float(w[i] @ d[s, site])

    for _ in range(iters):
        i = int(rng.integers(n))
        if include_free_sites and rng.random() < 0.5:
            t = int(rng.integers(placement.topology.num_nodes))
            if occupied[t] >= 0:
                continue
            # scalar move_delta_matrix[i, t] < 0
            if node_cost(i, t) < node_cost(i, site[i]):
                occupied[site[i]] = -1
                occupied[t] = i
                site[i] = t
        else:
            j = int(rng.integers(n))
            if i == j:
                continue
            si, sj = site[i], site[j]
            # scalar swap_delta_matrix[i, j] < 0 (see its docstring for why
            # the 2·w_ij·d_ij correction makes the stale-site test exact)
            before = node_cost(i, si) + node_cost(j, sj)
            after = node_cost(i, sj) + node_cost(j, si) + 2.0 * w[i, j] * d[si, sj]
            if after < before:
                site[i], site[j] = sj, si
                occupied[si], occupied[sj] = j, i
    return Placement(placement.topology, site, placement.method + "+2opt")


# Accept a move only if it improves H by more than this (absolute bytes·hops);
# guards best-move descent against fp-noise cycling at convergence.
BEST_MOVE_TOL = -1e-9


def default_max_steps(n: int) -> int:
    """Step budget for best-move descent at problem size n — converges in
    < 2n steps in practice.  Shared by `two_opt_best_move` and the batched
    engine so their default budgets (and the bit-parity between them that
    tests assert) cannot drift."""
    return 4 * n + 16


def _best_candidates_blocked(
    w: np.ndarray,
    d: np.ndarray,
    site: np.ndarray,
    occupied: np.ndarray,
    block: int,
    include_free_sites: bool,
) -> tuple[int, int, float, int, int, float]:
    """One step's (best swap, best move) streamed over row blocks: transients
    are O(block·max(n, S)) instead of the (n, n) delta + gather matrices.

    Scans row blocks in ascending order tracking the strictly-smallest value
    — exactly `np.argmin`'s first-occurrence-in-row-major tie-break — so in
    the integer-valued weight domain (where the blocked gemms are bit-exact,
    see the sparse-kernel banner above) the selected candidate is identical
    to the dense evaluation's."""
    n = site.size
    num_sites = d.shape[0]
    dsite = d[site]  # (n, S)
    diag = _diag_cost(w, dsite, site)
    best_swap, swap_val = -1, np.inf
    for start in range(0, n, block):
        sl = slice(start, min(start + block, n))
        b = sl.stop - sl.start
        a_rows = (w[sl] @ dsite)[:, site]  # A[i∈blk, j]
        a_cols = (w @ dsite[:, site[sl]]).T  # A[j, i∈blk] transposed to (b, n)
        dss_rows = dsite[sl][:, site]  # d(site_i, site_j) for i∈blk
        ds_b = a_rows + a_cols + 2.0 * w[sl] * dss_rows - diag[sl][:, None] - diag[None, :]
        ds_b[np.arange(b), np.arange(sl.start, sl.stop)] = np.inf
        k = int(ds_b.argmin())
        v = ds_b.reshape(-1)[k]
        if v < swap_val:
            swap_val = v
            ri, cj = divmod(k, n)
            best_swap = (sl.start + ri) * n + cj
    i_m = t_m = -1
    move_val = np.inf
    if include_free_sites and not occupied.all():
        for start in range(0, n, block):
            sl = slice(start, min(start + block, n))
            dm_b = w[sl] @ dsite - diag[sl][:, None]  # (b, S); d symmetric ⇒
            #                                           d[:, site].T == d[site]
            dm_b[:, occupied] = np.inf
            k = int(dm_b.argmin())
            v = dm_b.reshape(-1)[k]
            if v < move_val:
                move_val = v
                ri, t = divmod(k, num_sites)
                i_m, t_m = sl.start + ri, t
    i_s, j_s = divmod(best_swap, n) if best_swap >= 0 else (-1, -1)
    return i_s, j_s, swap_val, i_m, t_m, move_val


def two_opt_best_move(
    placement: Placement,
    weights: np.ndarray,
    *,
    max_steps: int | None = None,
    include_free_sites: bool = True,
    swap_block: int | None = None,
) -> Placement:
    """Steepest-descent two_opt: per step evaluate ALL O(n²) swaps and
    O(n·S) free-site moves via the delta matrices and apply the single best,
    until no candidate improves H (a full 2-opt local optimum) or the step
    budget runs out.  Deterministic (no RNG).  This is the serial reference
    for the batched engine (`repro_torch.experiments.placement_batch`), which runs
    the identical recursion stacked over configs.

    `swap_block` streams the per-step evaluation over row blocks of that
    size (O(block·max(n, S)) transients instead of the O(n²) delta matrix);
    with integer-valued weights the descent path — every chosen move — is
    bit-identical to the dense evaluation (tests/test_sparse_traffic.py)."""
    w = symmetrize_weights(weights)
    d = placement.topology.distance_matrix().astype(np.float64)
    site = placement.site.copy()
    n = site.size
    num_sites = placement.topology.num_nodes
    occupied = np.zeros(num_sites, dtype=bool)
    occupied[site] = True
    if max_steps is None:
        max_steps = default_max_steps(n)
    for _ in range(max_steps):
        if swap_block is not None:
            i_s, j_s, best, i_m, t_m, move_val = _best_candidates_blocked(
                w, d, site, occupied, max(1, int(swap_block)), include_free_sites
            )
            if move_val < best:
                best = move_val
            else:
                i_m = -1
        else:
            ds = swap_delta_matrix(w, d, site)
            np.fill_diagonal(ds, np.inf)
            best_swap = int(ds.argmin())
            i_s, j_s = divmod(best_swap, n)
            best = ds[i_s, j_s]
            i_m = t_m = -1
            if include_free_sites and not occupied.all():
                dm = move_delta_matrix(w, d, site)
                dm[:, occupied] = np.inf
                best_move = int(dm.argmin())
                i_m, t_m = divmod(best_move, num_sites)
                if dm[i_m, t_m] < best:
                    best = dm[i_m, t_m]
                else:
                    i_m = -1
        if best >= BEST_MOVE_TOL:
            break
        if i_m >= 0:
            occupied[site[i_m]] = False
            occupied[t_m] = True
            site[i_m] = t_m
        else:
            site[i_s], site[j_s] = site[j_s], site[i_s]
    return Placement(placement.topology, site, placement.method + "+2opt")


def two_opt_topk(
    placement: Placement,
    weights: np.ndarray,
    *,
    k: int | None = None,
    max_steps: int | None = None,
    include_free_sites: bool = True,
) -> Placement:
    """Steepest descent restricted to the top-k candidate swaps from the
    sparse traffic structure (`swap_candidates_topk`: the k heaviest-incident
    hub shards × every shard) plus the free-site moves — O(k·n) exact pair
    deltas per step (`swap_delta_pairs`) instead of the O(n²) matrix.

    With k ≥ n the candidate set is every pair and the search replays
    `two_opt_best_move` exactly (same lexicographic tie-break; asserted in
    tests/test_sparse_traffic.py); with k ≪ n it converges to a local
    optimum of the restricted hub neighbourhood, where the power-law skew of
    Eq. 1 concentrates the improvable H."""
    w = symmetrize_weights(weights)
    d = placement.topology.distance_matrix().astype(np.float64)
    site = placement.site.copy()
    n = site.size
    num_sites = placement.topology.num_nodes
    occupied = np.zeros(num_sites, dtype=bool)
    occupied[site] = True
    if max_steps is None:
        max_steps = default_max_steps(n)
    if k is None:
        k = max(8, int(math.isqrt(n)))
    rows, cols = np.nonzero(w)
    pi, pj = swap_candidates_topk(rows, cols, w[rows, cols], n, k)
    for _ in range(max_steps):
        deltas = swap_delta_pairs(w, d, site, pi, pj)
        p_best = int(deltas.argmin()) if deltas.size else -1
        best = deltas[p_best] if p_best >= 0 else np.inf
        i_m = t_m = -1
        if include_free_sites and not occupied.all():
            dm = move_delta_matrix(w, d, site)
            dm[:, occupied] = np.inf
            best_move = int(dm.argmin())
            i_m, t_m = divmod(best_move, num_sites)
            if dm[i_m, t_m] < best:
                best = dm[i_m, t_m]
            else:
                i_m = -1
        if best >= BEST_MOVE_TOL:
            break
        if i_m >= 0:
            occupied[site[i_m]] = False
            occupied[t_m] = True
            site[i_m] = t_m
        else:
            site[pi[p_best]], site[pj[p_best]] = site[pj[p_best]], site[pi[p_best]]
    return Placement(placement.topology, site, placement.method + "+2opt[topk]")


def ilp_placement(
    weights: np.ndarray,
    topology: Topology,
    *,
    time_limit: float = 60.0,
    max_logical: int = 24,
) -> Placement:
    """Algorithm 4 as an exact linearised MILP (HiGHS via scipy.optimize.milp).

    Variables: x[n,s] ∈ {0,1} assignment; y[k,s,t] ∈ [0,1] for every traffic
    pair k=(n,m), linearised with y ≥ x[n,s] + x[m,t] − 1.  Minimising
    Σ_k w_k Σ_st d(s,t)·y keeps y at the max(0, ·) envelope, so the relaxation
    of y is exact at binary x.  Practical to ~24 shards; larger instances
    should use greedy_placement + two_opt (the paper's regularity constraints
    make those near-optimal — validated against this ILP in tests).
    """
    from scipy import optimize, sparse

    w = np.asarray(weights, dtype=np.float64)
    w = np.triu(w + w.T, k=1)
    n = w.shape[0]
    if n > max_logical:
        raise ValueError(f"ILP capped at {max_logical} shards (got {n}); use greedy+2opt")
    S = topology.num_nodes
    d = topology.distance_matrix().astype(np.float64)
    pairs = [(i, j, w[i, j]) for i in range(n) for j in range(i + 1, n) if w[i, j] > 0]
    K = len(pairs)
    nx = n * S
    ny = K * S * S
    # objective
    c = np.zeros(nx + ny)
    for k, (_, _, wk) in enumerate(pairs):
        c[nx + k * S * S : nx + (k + 1) * S * S] = wk * d.reshape(-1)
    rows, cols, vals, lo, hi = [], [], [], [], []
    r = 0
    # each shard on exactly one router
    for i in range(n):
        for s in range(S):
            rows.append(r), cols.append(i * S + s), vals.append(1.0)
        lo.append(1.0), hi.append(1.0)
        r += 1
    # each router holds at most one shard
    for s in range(S):
        for i in range(n):
            rows.append(r), cols.append(i * S + s), vals.append(1.0)
        lo.append(0.0), hi.append(1.0)
        r += 1
    # linearisation y_kst >= x_is + x_jt - 1  ⇔  x_is + x_jt - y_kst <= 1
    for k, (i, j, _) in enumerate(pairs):
        for s in range(S):
            for t in range(S):
                yidx = nx + k * S * S + s * S + t
                rows += [r, r, r]
                cols += [i * S + s, j * S + t, yidx]
                vals += [1.0, 1.0, -1.0]
                lo.append(-np.inf), hi.append(1.0)
                r += 1
    A = sparse.csc_matrix((vals, (rows, cols)), shape=(r, nx + ny))
    constraints = optimize.LinearConstraint(A, np.array(lo), np.array(hi))
    integrality = np.concatenate([np.ones(nx), np.zeros(ny)])
    bounds = optimize.Bounds(np.zeros(nx + ny), np.ones(nx + ny))
    res = optimize.milp(
        c,
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit, "presolve": True},
    )
    if res.x is None:
        raise RuntimeError(f"MILP failed: {res.message}")
    x = res.x[:nx].reshape(n, S)
    site = x.argmax(1).astype(np.int64)
    return Placement(topology, site, "ilp")


def brute_force_placement(weights: np.ndarray, topology: Topology) -> Placement:
    """Exact search over all assignments — test oracle for tiny instances."""
    import itertools

    w = np.asarray(weights, dtype=np.float64)
    w = w + w.T
    n = w.shape[0]
    if topology.num_nodes > 9 or n > 9:
        raise ValueError("brute force limited to 9 routers")
    d = topology.distance_matrix().astype(np.float64)
    best, best_site = np.inf, None
    for perm in itertools.permutations(range(topology.num_nodes), n):
        s = np.array(perm)
        cost = float((w * d[np.ix_(s, s)]).sum())
        if cost < best:
            best, best_site = cost, s
    return Placement(topology, best_site, "brute")


def resolve_method(num_logical: int, num_parts: int, topology: Topology, method: str) -> str:
    """Resolve "auto" to a concrete placement method: the exact MILP for tiny
    instances, the torus-native constructive layouts on a torus, the quad
    layout when 2×2 quads fit the mesh family, traffic-weighted greedy
    otherwise.  Shared by `place` and the batched engine so the two paths
    always pick the same search for the same config."""
    if method != "auto":
        return method
    if num_logical <= 16 and topology.num_nodes <= 16:
        return "ilp"
    # Only the quad construction may REPLACE the search: torus_quad beats
    # greedy+2-opt on every fit case (property-tested), while torus_columnar
    # — like the mesh columnar layout — is a paper-faithful regular layout
    # that measures ~2× worse H than the search and stays explicit-only.
    if isinstance(topology, Torus2D) and _quad_fits(num_parts, topology):
        return "torus_quad"
    if isinstance(topology, (Mesh2D, FlattenedButterfly)) and _quad_fits(num_parts, topology):
        return "quad"
    return "greedy"


def place(
    traffic: TrafficMatrix,
    partition: Partition,
    topology: Topology,
    *,
    method: str = "auto",
    paper_faithful_fij: bool = False,
    seed: int = 0,
) -> Placement:
    """One-call placement front-end.

    paper_faithful_fij=True optimises the paper's binary equal-rank f_ij;
    False (default) optimises measured traffic bytes (our extension).
    method: auto | random | columnar | quad | torus_quad | torus_columnar |
    greedy | ilp.  The torus_* layouts are pure constructions — no 2-opt
    refinement follows (for torus_quad, H ≤ greedy+2-opt on torus fit cases
    anyway, which is what makes it the torus2d auto route; see
    torus_quad_placement).
    """
    weights = traffic.binary_fij(partition) if paper_faithful_fij else traffic.bytes_matrix
    n = traffic.num_logical
    method = resolve_method(n, traffic.num_parts, topology, method)
    if method == "random":
        return random_placement(n, topology, seed=seed)
    if method == "columnar":
        return columnar_placement(traffic.num_parts, topology)
    if method == "torus_quad":
        return torus_quad_placement(traffic.num_parts, topology, weights)
    if method == "torus_columnar":
        return torus_columnar_placement(traffic.num_parts, topology, weights)
    if method == "quad":
        return two_opt(quad_placement(traffic.num_parts, topology), weights, iters=500, seed=seed)
    if method == "greedy":
        return two_opt(greedy_placement(weights, topology, seed=seed), weights, seed=seed)
    if method == "ilp":
        return ilp_placement(weights, topology)
    raise ValueError(f"unknown placement method {method!r}")


def _quad_fits(num_parts: int, topology: Topology) -> bool:
    try:
        kx, ky = topology.kx, topology.ky  # type: ignore[attr-defined]
    except AttributeError:
        return False
    return kx >= 2 and ky >= 2 and (kx // 2) * (ky // 2) >= num_parts
