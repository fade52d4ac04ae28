"""Batched placement-search engine: the sweep's per-config `greedy/quad +
two_opt` Python loops (paper §5.2–5.3, Algorithms 3–4) replaced by stacked
tensor programs — both the greedy *construction* and the 2-opt *refinement*.

Refinement.  The serial search probes ONE random swap per iteration;
`two_opt_best_move` (core.placement) evaluates the H-delta of *all* O(n²)
swaps and O(n·S) free-site moves per step with two matmuls and applies the
single best.  This module runs that identical recursion stacked over every
sweep configuration at once:

  Dss[c]   = D[c][site[c, :, None], site[c, None, :]]          (C, n, n)
  A[c]     = W[c] @ Dss[c]                                     (C, n, n)
  Δswap[c] = A + Aᵀ + 2·W⊙Dss − diag(A) ⊕ diag(A)              (C, n, n)
  Δmove[c] = W[c] @ D[c][:, site[c]]ᵀ − diag(A)[:, :, None]    (C, n, S)

then per config applies the best improving candidate and repeats until every
config has converged to a full 2-opt local optimum (or the step budget runs
out).  (See `core.placement`'s module docstring for the delta-kernel
derivation — H is the hop-weighted traffic of the paper's Eq. 1 skew, the
quantity Fig. 7's 2–5× speedups are driven by.)

Construction (`greedy_construct_batch`).  The greedy initial layout the
search refines used to be a per-config Python loop over
`core.placement.greedy_placement` — irrelevant when `auto` resolves to the
quad layout (the paper grid), dominant when a grid pins `placement=greedy`
at large C (the torus grid).  The batched constructor runs the same
argmax-insertion recursion stacked over configs: per step, for all configs
at once,

  conn[c, i]  = Σ_{j placed} w2[c, i, j]      (argmax → next shard)
  cost[c, i, s] += w2[c, i, cur]·D[c, site_cur, s]   (argmin over free
                                                      sites → its router)

The numpy backend replays `greedy_placement` bit-exactly per config — same
summation trees, same tie-breaking, same seeded-RNG fallback for shards
with no connectivity to the placed set (asserted in
tests/test_placement_batch.py).  The torch backend runs the same recursion
as float64 tensors with the batch dimension written out and draws the
fallback from the same seeded host streams, so on integer-byte weights (where
float64 sums re-associate exactly) it gives the numpy backend's sites.

Construction (`torus_construct_batch`).  Torus2d "auto" configs don't
search at all: the wrap-aware quad layout (`core.placement.
torus_quad_placement`) already beats greedy+2-opt H on torus fit cases, so
`place_batch` assembles it stacked — one part-weight reduction + stable
argsort + scatter over all configs — with the same parity contract as the
greedy constructor (numpy bit-exact to the serial layouts; torch equal on
integer-byte weights).  The explicit-only `torus_columnar`
reference layout rides the same stacked engine.

Mirroring `simulate_batch`, configs are grouped by problem shape (n logical
shards, S routers) — each group is one stacked program; topologies may
differ inside a group (the per-config distance matrices are stacked).

Backends (via `resolve_backend`, like `simulate_batch`): "numpy" — float64
einsums, bit-identical to `two_opt_best_move` per config; "torch" — the same
recursion in float64 on the given device (`bmm` for the two products, a flat
`argmin` that returns the first minimum, one `active.any()` read per step),
with the numpy backend's accept tolerance `BEST_MOVE_TOL` and no rescaling:
on integer-byte weights it replays the numpy move sequence step for step.

Search quality: steepest descent converges to a local optimum of the same
swap+move neighbourhood the serial randomized search explores, and on paper-
grid shapes it is never worse at matched budgets (asserted in
tests/test_placement_batch.py; measured per sweep and recorded in
EXPERIMENTS.md §Perf).  `restarts > 0` stacks extra perturbed-init descents
into the batch dimension (argmin H per config) to harden against the rare
adversarial instance where a single steepest path lands high.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs

from repro_torch.core.noc import Topology
from repro_torch.core.partition import Partition
from repro_torch.core.placement import (
    BEST_MOVE_TOL,
    Placement,
    default_max_steps,
    greedy_seed,
    part_traffic_weights,
    quad_placement,
    place,
    resolve_method,
    symmetrize_weights,
    torus_cell_site_table,
)
from repro_torch.core.traffic import TrafficMatrix
from repro_torch.device import resolve_backend, resolve_device

__all__ = [
    "batch_descend",
    "greedy_construct_batch",
    "torus_construct_batch",
    "place_batch",
    "sparse_weighted_hops_batch",
    "swap_delta_pairs_batch",
    "PlacementBatchStats",
    "BATCH_SEARCH_METHODS",
    "BATCH_CONSTRUCT_METHODS",
]

# Serial counterpart of each stacked function (the pairing the reference
# package keeps in a decorator registry): stacked → (serial, contract).  The
# numpy backends are bit-identical per config; the torch backends equal them
# on integer-byte weights.
PARITY_PAIRS = {
    "greedy_construct_batch": ("repro_torch.core.placement.greedy_placement", "bit"),
    "torus_construct_batch": ("repro_torch.core.placement.torus_quad_placement", "bit"),
    "sparse_weighted_hops_batch": ("repro_torch.core.placement.sparse_weighted_hops", "bit"),
    "swap_delta_pairs_batch": ("repro_torch.core.placement.swap_delta_pairs", "bit"),
    "batch_descend": ("repro_torch.core.placement.two_opt_best_move", "bit"),
    "repair_batch": ("repro_torch.faults.repair.repair_descend", "bit"),
}

# Methods the batched engine searches; everything else (random, columnar, the
# exact MILP) goes through the serial `place` reference path.
BATCH_SEARCH_METHODS = frozenset({"quad", "greedy"})

# Torus-native constructive layouts: stacked across configs by
# `torus_construct_batch` — no descent follows (torus_quad already beats
# greedy+2-opt H on torus fit cases and is the torus2d auto route;
# torus_columnar is an explicit-only reference layout; see core.placement).
BATCH_CONSTRUCT_METHODS = frozenset({"torus_quad", "torus_columnar"})

# Marks a batched-engine result in `Placement.method` ("quad+2opt[batch]") —
# scripts/verify.sh and the sweep stats key off the engine having run.
BATCH_METHOD_SUFFIX = "+2opt[batch]"


@dataclasses.dataclass
class PlacementBatchStats:
    """What the engine did for one `place_batch` call (rendered in §Perf)."""

    batched_configs: int = 0
    serial_configs: int = 0
    greedy_constructed: int = 0  # configs whose init came from the batched
    #                              greedy constructor (vs quad / serial paths)
    torus_constructed: int = 0  # configs placed by the stacked torus-native
    #                             constructive layouts (no descent at all)
    groups: int = 0
    steps: int = 0  # total best-move steps across groups (max over configs)
    backend: str = "numpy"  # ","-joined when (n,S) groups resolve differently
    restarts: int = 0
    # Stage-time split (seconds): what the searched configs paid (stacked
    # greedy construction + steepest descent) vs what the torus-constructive
    # configs paid (layout assembly only) — the §Torus search-time saving.
    search_s: float = 0.0
    construct_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# batched greedy construction (Algorithm 4's constructive half, stacked)
# ---------------------------------------------------------------------------


def _greedy_construct_numpy(
    w2: np.ndarray, d: np.ndarray, seeds: list[int]
) -> np.ndarray:
    """Stacked argmax-insertion, bit-identical to `greedy_placement` per
    config: `w2` (C, n, n) doubled weights (w + wᵀ, diagonal kept — the
    serial constructor keeps it too), `d` (C, S, S) distances.  Per step the
    connectivity argmax, the cost update and the free-site argmin run for
    all C configs at once; summation trees match the serial loop's (placed
    columns gathered in ascending index order, cost accumulated in placement
    order), so ties break identically.  The no-connectivity fallback draws
    from per-config `default_rng(seed)` streams exactly as the serial loop
    does."""
    c, n, _ = w2.shape
    s_count = d.shape[1]
    cidx = np.arange(c)
    placed_site = np.full((c, n), -1, dtype=np.int64)
    placed_mask = np.zeros((c, n), dtype=bool)
    free = np.ones((c, s_count), dtype=bool)
    cost = np.zeros((c, n, s_count), dtype=np.float64)
    rngs = [np.random.default_rng(s) for s in seeds]
    seeded = [greedy_seed(w2[k], d[k]) for k in range(c)]  # the serial rule itself
    cur = np.array([f for f, _ in seeded], dtype=np.int64)
    cur_site = np.array([s for _, s in seeded], dtype=np.int64)
    for step in range(n):
        placed_site[cidx, cur] = cur_site
        placed_mask[cidx, cur] = True
        free[cidx, cur_site] = False
        cost += w2[cidx, :, cur][:, :, None] * d[cidx, cur_site][:, None, :]
        if step == n - 1:
            break
        # Placed columns in ascending index order (stable argsort of the
        # mask) — the same gather + last-axis reduction `w[:, placed_mask]
        # .sum(1)` performs serially, so fp ties cannot diverge.
        placed_cols = np.argsort(~placed_mask, axis=1, kind="stable")[:, : step + 1]
        gathered = np.take_along_axis(
            w2, np.broadcast_to(placed_cols[:, None, :], (c, n, step + 1)), axis=2
        )
        conn = gathered.sum(axis=2)
        conn[placed_mask] = -np.inf
        nxt = conn.argmax(axis=1)
        val = conn[cidx, nxt]
        for k in np.nonzero(~np.isfinite(val) | (val <= 0))[0]:
            unplaced = np.nonzero(~placed_mask[k])[0]
            nxt[k] = int(rngs[k].choice(unplaced))
        cand = cost[cidx, nxt]
        cand[~free] = np.inf
        cur, cur_site = nxt, cand.argmin(axis=1)
    return placed_site


def _f64(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(device)


def _i64(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _greedy_construct_torch(
    w2: np.ndarray, d: np.ndarray, seeds: list[int], device: torch.device
) -> np.ndarray:
    """`_greedy_construct_numpy` as float64 tensors on `device`: the batch
    dimension written out, a Python loop over the n insertions.  The
    connectivity vector is carried (`conn += w2[:, :, cur]`) instead of being
    re-gathered each step — the same value on integer-byte weights.  Each
    step brings the (C,) argmax and its value to the host so that the
    no-connectivity fallback draws from the same per-config
    `default_rng(seed)` streams as the numpy backend."""
    c, n, _ = w2.shape
    rngs = [np.random.default_rng(s) for s in seeds]
    seeded = [greedy_seed(w2[k], d[k]) for k in range(c)]  # the serial rule itself
    cur_h = np.array([f for f, _ in seeded], dtype=np.int64)
    placed_h = np.zeros((c, n), dtype=bool)
    w2_t, d_t = _f64(w2, device), _f64(d, device)
    s_count = d_t.shape[1]
    cidx = torch.arange(c, device=device)
    placed_site = torch.full((c, n), -1, dtype=torch.int64, device=device)
    placed_mask = torch.zeros((c, n), dtype=torch.bool, device=device)
    free = torch.ones((c, s_count), dtype=torch.bool, device=device)
    cost = torch.zeros((c, n, s_count), dtype=torch.float64, device=device)
    conn = torch.zeros((c, n), dtype=torch.float64, device=device)
    cur = _i64(cur_h, device)
    cur_site = _i64(np.array([s for _, s in seeded]), device)
    for step in range(n):
        placed_site[cidx, cur] = cur_site
        placed_mask[cidx, cur] = True
        placed_h[np.arange(c), cur_h] = True
        free[cidx, cur_site] = False
        w_cur = w2_t[cidx, :, cur]  # (C, n)
        cost += w_cur[:, :, None] * d_t[cidx, cur_site][:, None, :]
        if step == n - 1:
            break
        conn += w_cur
        masked = conn.masked_fill(placed_mask, -torch.inf)
        val, nxt = masked.max(dim=1)  # first maximum, like numpy's argmax
        val_h, nxt_h = val.cpu().numpy(), nxt.cpu().numpy().copy()
        for k in np.nonzero(~np.isfinite(val_h) | (val_h <= 0))[0]:
            unplaced = np.nonzero(~placed_h[k])[0]
            nxt_h[k] = int(rngs[k].choice(unplaced))
        cur_h = nxt_h
        cur = _i64(cur_h, device)
        cand = cost[cidx, cur].masked_fill(~free, torch.inf)
        cur_site = cand.argmin(dim=1)
    return placed_site.cpu().numpy()


def greedy_construct_batch(
    weights: list[np.ndarray] | np.ndarray,
    topologies: list[Topology],
    *,
    seeds: list[int] | int = 0,
    backend: str = "auto",
    device: str | torch.device | None = None,
) -> tuple[list[np.ndarray], str]:
    """Batched `greedy_placement` construction for C configs of identical
    (n, S) shape: `weights` raw (n, n) per config (doubled internally, like
    the serial constructor), `topologies` one per config (mixed topologies of
    equal size stack), `seeds` feed the per-config no-connectivity fallback
    streams.  Returns (site arrays in input order, backend used).  The numpy
    backend is bit-identical to `greedy_placement` per config; torch gives the
    same sites on integer-byte weights (see module docstring)."""
    w2 = np.stack(
        [np.asarray(w, dtype=np.float64) + np.asarray(w, dtype=np.float64).T for w in weights]
    )
    d = np.stack([t.distance_matrix().astype(np.float64) for t in topologies])
    seeds_l = [seeds] * w2.shape[0] if isinstance(seeds, int) else list(seeds)
    if len(seeds_l) != w2.shape[0]:
        raise ValueError("seeds must match the config count")
    backend = resolve_backend(backend)
    if backend == "torch":
        sites = _greedy_construct_torch(w2, d, seeds_l, resolve_device(device))
    else:
        sites = _greedy_construct_numpy(w2, d, seeds_l)
    return list(sites), backend


# ---------------------------------------------------------------------------
# batched torus-native construction (wrap-aware quads / hub columns, stacked)
# ---------------------------------------------------------------------------


def _torus_construct_numpy(w2: np.ndarray, cell_sites: np.ndarray) -> np.ndarray:
    """Stacked torus layout assembly, bit-identical to
    `core.placement.torus_quad_placement` / `torus_columnar_placement` per
    config: `w2` (C, n, n) doubled weights, `cell_sites` (C, P, 4) hub-ranked
    cell tables.  One stacked part-weight reduction (the same summation tree
    as the serial `part_traffic_weights` call), one stable argsort per
    config, one scatter."""
    c, n, _ = w2.shape
    p = n // 4
    pw = part_traffic_weights(w2, p)  # (C, P)
    orders = np.argsort(-pw, axis=1, kind="stable")
    site = np.empty((c, n), dtype=np.int64)
    cidx = np.arange(c)[:, None]
    for struct in range(4):
        site[cidx, struct * p + orders] = cell_sites[:, :, struct]
    return site


def _torus_construct_torch(
    w2: np.ndarray, cell_sites: np.ndarray, device: torch.device
) -> np.ndarray:
    """`_torus_construct_numpy` on `device`: one part-weight reduction, one
    stable argsort, one scatter over all configs."""
    c, n, _ = w2.shape
    p = n // 4
    pw = _f64(w2, device).reshape(c, 4, p, n).sum(dim=(1, 3))
    orders = torch.argsort(-pw, dim=1, stable=True)
    cells = _i64(cell_sites, device)
    site = torch.empty((c, n), dtype=torch.int64, device=device)
    cidx = torch.arange(c, device=device)[:, None]
    for struct in range(4):
        site[cidx, struct * p + orders] = cells[:, :, struct]
    return site.cpu().numpy()


def torus_construct_batch(
    weights: list[np.ndarray] | np.ndarray,
    topologies: list[Topology],
    *,
    methods: list[str] | str = "torus_quad",
    backend: str = "auto",
    device: str | torch.device | None = None,
) -> tuple[list[np.ndarray], str]:
    """Batched torus-native constructive layouts for C configs of identical
    (n = 4P) shape: `weights` raw (n, n) per config (doubled internally),
    `topologies` one Torus2D per config (mixed sizes of equal node count
    stack — each config's own `torus_cell_site_table` rides the batch),
    `methods` torus_quad | torus_columnar per config.  Returns (site arrays
    in input order, backend used).  Same parity contract as
    `greedy_construct_batch`: the numpy backend is bit-identical to the
    serial constructors per config; torch gives the same sites on
    integer-byte weights."""
    methods_l = [methods] * len(topologies) if isinstance(methods, str) else list(methods)
    if len(methods_l) != len(topologies):
        raise ValueError("methods must match the config count")
    w2 = np.stack(
        [np.asarray(w, dtype=np.float64) + np.asarray(w, dtype=np.float64).T for w in weights]
    )
    p = w2.shape[-1] // 4
    tables = []
    for topo, m in zip(topologies, methods_l):
        table = torus_cell_site_table(topo, m)
        if len(table) < p:
            raise ValueError(f"torus too small for {m} layout of {p} parts")
        tables.append(table[:p])
    cell_sites = np.stack(tables)
    backend = resolve_backend(backend)
    if backend == "torch":
        sites = _torus_construct_torch(w2, cell_sites, resolve_device(device))
    else:
        sites = _torus_construct_numpy(w2, cell_sites)
    return list(sites), backend


# ---------------------------------------------------------------------------
# sparse-first batched kernels: H from COO triplets and exact candidate-pair
# deltas, stacked over configs — numpy float64 reference (bit-exact to the
# serial `core.placement` kernels in the integer-byte domain, see that
# module's sparse-kernel banner) and a float64 torch path (equal on that
# domain).
# ---------------------------------------------------------------------------


def _pad_coo(
    coos: list[tuple[np.ndarray, np.ndarray, np.ndarray]]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-config COO triplets, padding nnz to the batch maximum with
    zero-weight (0, 0) entries (harmless: they gather d[site_0, site_0] = 0
    weighted by 0)."""
    nnz_max = max((r.size for r, _, _ in coos), default=0)
    c = len(coos)
    rows = np.zeros((c, max(nnz_max, 1)), dtype=np.int64)
    cols = np.zeros_like(rows)
    vals = np.zeros(rows.shape, dtype=np.float64)
    for k, (r, cc, v) in enumerate(coos):
        rows[k, : r.size] = r
        cols[k, : r.size] = cc
        vals[k, : r.size] = v
    return rows, cols, vals


def sparse_weighted_hops_batch(
    coos: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    sites: list[np.ndarray] | np.ndarray,
    topologies: list[Topology],
    *,
    backend: str = "auto",
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, str]:
    """Stacked `core.placement.sparse_weighted_hops`: per config a COO
    triplet (rows, cols, vals) — e.g. a `SparseTraffic`'s — a site array and
    a topology (equal router counts stack; mixed topologies fine).  Returns
    ((C,) H values, backend used).  The numpy backend matches the serial
    gather bit-for-bit; torch equals it on integer-byte traffic."""
    sites_a = np.stack([np.asarray(s, dtype=np.int64) for s in sites])
    d = np.stack([t.distance_matrix().astype(np.float64) for t in topologies])
    rows, cols, vals = _pad_coo(coos)
    backend = resolve_backend(backend)
    if backend == "torch":
        dev = resolve_device(device)
        st, rt, ct = _i64(sites_a, dev), _i64(rows, dev), _i64(cols, dev)
        cidx_t = torch.arange(st.shape[0], device=dev)[:, None]
        sr_t, sc_t = st.gather(1, rt), st.gather(1, ct)
        h = (_f64(vals, dev) * _f64(d, dev)[cidx_t, sr_t, sc_t]).sum(dim=1)
        return h.cpu().numpy(), backend
    cidx = np.arange(sites_a.shape[0])[:, None]
    sr = np.take_along_axis(sites_a, rows, axis=1)
    sc = np.take_along_axis(sites_a, cols, axis=1)
    return (vals * d[cidx, sr, sc]).sum(axis=1), backend


def _pair_deltas_torch(w, d, sites, pi, pj):
    """Stacked `swap_delta_pairs`: (C,n,n), (C,S,S), (C,n), (C,P), (C,P)."""
    cidx = torch.arange(sites.shape[0], device=sites.device)[:, None]
    dsite = d[cidx, sites]  # (C, n, S)
    dss = dsite.gather(2, sites[:, None, :].expand(-1, sites.shape[1], -1))  # (C, n, n)
    diag = torch.einsum("cik,cki->ci", w, dss)
    si, sj = sites.gather(1, pi), sites.gather(1, pj)  # (C, P)
    n = sites.shape[1]
    d_to_j = dsite.gather(2, sj[:, None, :].expand(-1, n, -1))  # (C, n, P)
    d_to_i = dsite.gather(2, si[:, None, :].expand(-1, n, -1))
    a_ij = torch.einsum("cpk,ckp->cp", w[cidx, pi], d_to_j)
    a_ji = torch.einsum("cpk,ckp->cp", w[cidx, pj], d_to_i)
    dij = d[cidx, si, sj]
    return a_ij + a_ji + 2.0 * w[cidx, pi, pj] * dij - diag.gather(1, pi) - diag.gather(1, pj)


def swap_delta_pairs_batch(
    weights: list[np.ndarray],
    topologies: list[Topology],
    sites: list[np.ndarray] | np.ndarray,
    pairs: list[tuple[np.ndarray, np.ndarray]],
    *,
    backend: str = "auto",
    device: str | torch.device | None = None,
) -> tuple[list[np.ndarray], str]:
    """Stacked `core.placement.swap_delta_pairs`: per config raw (n, n)
    weights (symmetrized internally), a topology, a site array and a
    candidate-pair set (pi, pj) — e.g. from `swap_candidates_topk`.  Pair
    counts are padded to the batch maximum with (0, 1) no-op entries and
    trimmed on return.  Returns (per-config delta arrays in input order,
    backend used)."""
    from repro_torch.core.placement import swap_delta_pairs

    w = np.stack([symmetrize_weights(wi) for wi in weights])
    d = np.stack([t.distance_matrix().astype(np.float64) for t in topologies])
    sites_a = np.stack([np.asarray(s, dtype=np.int64) for s in sites])
    p_max = max((p[0].size for p in pairs), default=0)
    backend = resolve_backend(backend)
    if backend == "torch":
        dev = resolve_device(device)
        pi = np.zeros((len(pairs), max(p_max, 1)), dtype=np.int64)
        pj = np.ones_like(pi)
        for k, (a, b) in enumerate(pairs):
            pi[k, : a.size] = a
            pj[k, : b.size] = b
        out = _pair_deltas_torch(
            _f64(w, dev), _f64(d, dev), _i64(sites_a, dev), _i64(pi, dev), _i64(pj, dev)
        ).cpu().numpy()
        return [out[k, : pairs[k][0].size] for k in range(len(pairs))], backend
    return [
        swap_delta_pairs(w[k], d[k], sites_a[k], pairs[k][0], pairs[k][1])
        for k in range(len(pairs))
    ], backend


# ---------------------------------------------------------------------------
# numpy backend: the reference stacked recursion
# ---------------------------------------------------------------------------


def _deltas_numpy(w: np.ndarray, d: np.ndarray, sites: np.ndarray, occ: np.ndarray):
    """(Δswap (C,n,n) with +inf diagonal, Δmove (C,n,S) with occupied cols
    +inf) for a stack of configs — the batched forms of
    `core.placement.swap_delta_matrix` / `move_delta_matrix`."""
    c_idx = np.arange(sites.shape[0])[:, None, None]
    dss = d[c_idx, sites[:, :, None], sites[:, None, :]]  # (C, n, n)
    a = w @ dss  # batched BLAS gemm (np.einsum would loop)
    diag = np.einsum("cii->ci", a)
    ds = a + a.transpose(0, 2, 1) + 2.0 * w * dss - diag[:, :, None] - diag[:, None, :]
    n = sites.shape[1]
    ds[:, np.arange(n), np.arange(n)] = np.inf
    g = d[c_idx, np.arange(d.shape[1])[None, :, None], sites[:, None, :]]  # (C, S, n)
    dm = w @ g.transpose(0, 2, 1) - diag[:, :, None]  # (C, n, S)
    dm[np.broadcast_to(occ[:, None, :], dm.shape)] = np.inf
    return ds, dm


def _best_blocked_numpy(
    w: np.ndarray, d: np.ndarray, sites: np.ndarray, occ: np.ndarray, block: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One step's (best swap flat index, value, best move flat index, value)
    per config, streamed over row blocks — the memory-bounded form of
    `_deltas_numpy` + argmin: transients are O(C·block·max(n, S)) instead of
    the full (C, n, n) + (C, n, S) delta stacks.  Row blocks scan in
    ascending order with a strict-< update, which is `argmin`'s
    first-occurrence row-major tie-break, so in the integer-byte weight
    domain the selected candidates are bit-identical to the dense path's."""
    c, n = sites.shape
    s_count = d.shape[1]
    cidx = np.arange(c)
    dsite = d[cidx[:, None], sites]  # (C, n, S): d(site_k, t)
    site_cols = sites[:, None, :]  # gather helper (C, 1, n)
    diag = np.empty((c, n), dtype=np.float64)
    for start in range(0, n, block):
        sl = slice(start, min(start + block, n))
        g = np.take_along_axis(
            dsite, np.broadcast_to(sites[:, None, sl], (c, n, sl.stop - sl.start)), axis=2
        )  # (C, n, b): d(site_k, site_i) for i∈blk
        diag[:, sl] = np.einsum("cbk,ckb->cb", w[:, sl], g)
    best_swap = np.zeros(c, dtype=np.int64)
    swap_val = np.full(c, np.inf)
    best_move = np.zeros(c, dtype=np.int64)
    move_val = np.full(c, np.inf)
    for start in range(0, n, block):
        sl = slice(start, min(start + block, n))
        b = sl.stop - sl.start
        q_b = w[:, sl] @ dsite  # (C, b, S): cost of i∈blk at every router
        a_rows = np.take_along_axis(q_b, np.broadcast_to(site_cols, (c, b, n)), axis=2)
        g = np.take_along_axis(
            dsite, np.broadcast_to(sites[:, None, sl], (c, n, b)), axis=2
        )  # (C, n, b)
        a_cols = (w @ g).transpose(0, 2, 1)  # (C, b, n): A[j, i∈blk]
        dss_rows = np.take_along_axis(
            dsite[:, sl], np.broadcast_to(site_cols, (c, b, n)), axis=2
        )
        ds_b = (
            a_rows
            + a_cols
            + 2.0 * w[:, sl] * dss_rows
            - diag[:, sl, None]
            - diag[:, None, :]
        )
        ds_b[:, np.arange(b), np.arange(sl.start, sl.stop)] = np.inf
        flat = ds_b.reshape(c, -1)
        k = flat.argmin(axis=1)
        v = flat[cidx, k]
        ri, cj = np.divmod(k, n)
        better = v < swap_val
        swap_val = np.where(better, v, swap_val)
        best_swap = np.where(better, (sl.start + ri) * n + cj, best_swap)
        dm_b = q_b - diag[:, sl, None]  # (C, b, S); d symmetric
        dm_b[np.broadcast_to(occ[:, None, :], dm_b.shape)] = np.inf
        flat = dm_b.reshape(c, -1)
        k = flat.argmin(axis=1)
        v = flat[cidx, k]
        ri, t = np.divmod(k, s_count)
        better = v < move_val
        move_val = np.where(better, v, move_val)
        best_move = np.where(better, (sl.start + ri) * s_count + t, best_move)
    return best_swap, swap_val, best_move, move_val


def _descend_numpy(
    w: np.ndarray, d: np.ndarray, sites: np.ndarray, max_steps: int,
    swap_block: int | None = None, blocked: np.ndarray | None = None,
) -> tuple[np.ndarray, int]:
    """Steepest-descent until every config converges; returns (sites, steps).
    Converged configs drop out of the stacked delta evaluation, so late steps
    only pay for the stragglers.  `swap_block` streams each step's candidate
    evaluation over row blocks (`_best_blocked_numpy`) instead of
    materializing the full delta stacks.  `blocked` (C, S) marks routers
    permanently occupied (dead tiles in the fault-repair path) — no shard may
    move onto them."""
    c, n = sites.shape
    s_count = d.shape[1]
    occ = np.zeros((c, s_count), dtype=bool)
    np.put_along_axis(occ, sites, True, axis=1)
    if blocked is not None:
        occ |= blocked
    active = np.ones(c, dtype=bool)
    steps = 0
    for _ in range(max_steps):
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        steps += 1
        if swap_block is not None:
            best_swap, swap_val, best_move, move_val = _best_blocked_numpy(
                w[idx], d[idx], sites[idx], occ[idx], max(1, int(swap_block))
            )
        else:
            ds, dm = _deltas_numpy(w[idx], d[idx], sites[idx], occ[idx])
            best_swap = ds.reshape(idx.size, -1).argmin(axis=1)
            best_move = dm.reshape(idx.size, -1).argmin(axis=1)
            swap_val = ds.reshape(idx.size, -1)[np.arange(idx.size), best_swap]
            move_val = dm.reshape(idx.size, -1)[np.arange(idx.size), best_move]
        for k, cfg in enumerate(idx):
            if min(swap_val[k], move_val[k]) >= BEST_MOVE_TOL:
                active[cfg] = False
                continue
            if move_val[k] < swap_val[k]:
                i, t = divmod(int(best_move[k]), s_count)
                occ[cfg, sites[cfg, i]] = False
                occ[cfg, t] = True
                sites[cfg, i] = t
            else:
                i, j = divmod(int(best_swap[k]), n)
                sites[cfg, i], sites[cfg, j] = sites[cfg, j], sites[cfg, i]
    return sites, steps


# ---------------------------------------------------------------------------
# torch backend: the same recursion with the batch dimension written out
# ---------------------------------------------------------------------------


def _descend_torch(
    w: np.ndarray, d: np.ndarray, sites: np.ndarray, max_steps: int,
    blocked: np.ndarray | None = None, *, device: torch.device,
) -> tuple[np.ndarray, int]:
    """`_descend_numpy` as float64 tensors on `device`, with its accept rule
    (`BEST_MOVE_TOL`) and no rescaling of the weights.  Every config is
    evaluated each step and a converged one is masked out of the update, so
    the only device→host read per step is `active.any()`.  `steps` counts
    like the numpy loop: the steps taken while any config was still active,
    the one that finds the last of them converged included."""
    c, n = sites.shape
    s_count = d.shape[1]
    occ_h = np.zeros((c, s_count), dtype=bool)
    np.put_along_axis(occ_h, sites, True, axis=1)
    if blocked is not None:
        occ_h |= blocked
    w_t, d_t, site = _f64(w, device), _f64(d, device), _i64(sites, device)
    occ = torch.from_numpy(occ_h).to(device)
    cfg = torch.arange(c, device=device)
    c_idx = cfg[:, None, None]
    ar_n = torch.arange(n, device=device)
    ar_s = torch.arange(s_count, device=device)[None, :, None]
    active = torch.ones(c, dtype=torch.bool, device=device)
    steps = 0
    for _ in range(max_steps):
        if not bool(active.any()):
            break
        steps += 1
        dss = d_t[c_idx, site[:, :, None], site[:, None, :]]  # (C, n, n)
        a = torch.bmm(w_t, dss)
        diag = torch.diagonal(a, dim1=1, dim2=2)
        ds = a + a.transpose(1, 2) + 2.0 * w_t * dss - diag[:, :, None] - diag[:, None, :]
        ds[:, ar_n, ar_n] = torch.inf
        g = d_t[c_idx, ar_s, site[:, None, :]]  # (C, S, n)
        dm = torch.bmm(w_t, g.transpose(1, 2)) - diag[:, :, None]  # (C, n, S)
        dm.masked_fill_(occ[:, None, :], torch.inf)
        swap_val, best_swap = ds.reshape(c, -1).min(dim=1)  # first minimum
        move_val, best_move = dm.reshape(c, -1).min(dim=1)
        active = active & (torch.minimum(swap_val, move_val) < BEST_MOVE_TOL)
        take_move = move_val < swap_val
        do_swap, do_move = active & ~take_move, active & take_move
        i_s, j_s = best_swap // n, best_swap % n
        s_i, s_j = site[cfg, i_s], site[cfg, j_s]
        site[cfg, i_s] = torch.where(do_swap, s_j, s_i)
        site[cfg, j_s] = torch.where(do_swap, s_i, s_j)
        i_m, t_m = best_move // s_count, best_move % s_count
        old = site[cfg, i_m]
        occ[cfg, old] = occ[cfg, old] & ~do_move
        occ[cfg, t_m] = occ[cfg, t_m] | do_move
        site[cfg, i_m] = torch.where(do_move, t_m, old)
    return site.cpu().numpy(), steps


# ---------------------------------------------------------------------------
# front-ends
# ---------------------------------------------------------------------------


def batch_descend(
    weights: list[np.ndarray] | np.ndarray,
    topologies: list[Topology],
    init_sites: list[np.ndarray] | np.ndarray,
    *,
    max_steps: int | None = None,
    backend: str = "auto",
    swap_block: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[list[np.ndarray], PlacementBatchStats]:
    """Run the stacked steepest descent for C configs of identical (n, S)
    shape.  `weights` raw (n, n) per config (symmetrized internally),
    `topologies` one per config (distance matrices are stacked, so mixed
    topologies of equal size batch together), `init_sites` (n,) per config.
    Returns refined site arrays in input order plus engine stats.

    `swap_block` streams the numpy reference's per-step candidate evaluation
    over row blocks (O(C·block·max(n, S)) transients, bit-identical descent
    path on integer-byte weights); the torch backend always evaluates the
    dense delta stacks, so a set `swap_block` forces the numpy backend."""
    w = np.stack([symmetrize_weights(wi) for wi in weights])
    d = np.stack([t.distance_matrix().astype(np.float64) for t in topologies])
    sites = np.stack([np.asarray(s, dtype=np.int64) for s in init_sites]).copy()
    n = sites.shape[1]
    if max_steps is None:
        max_steps = default_max_steps(n)
    if swap_block is not None:
        backend = "numpy"
    else:
        backend = resolve_backend(backend)
    if backend == "torch":
        out, steps = _descend_torch(w, d, sites, max_steps, device=resolve_device(device))
    else:
        out, steps = _descend_numpy(w, d, sites, max_steps, swap_block)
    stats = PlacementBatchStats(
        batched_configs=len(topologies), groups=1, steps=steps, backend=backend
    )
    return list(out), stats


def repair_batch(
    weights: list[np.ndarray] | np.ndarray,
    dists: list[np.ndarray] | np.ndarray,
    init_sites: list[np.ndarray] | np.ndarray,
    blocked: list[np.ndarray] | np.ndarray,
    *,
    max_steps: int,
    backend: str = "numpy",
    swap_block: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[list[np.ndarray], PlacementBatchStats]:
    """Stacked counterpart of `repro_torch.faults.repair.repair_descend`: C bounded
    repair descents in one batched program, seeded from the evacuated
    layouts.  Unlike `batch_descend` the distance matrices come in explicitly
    (they are DEGRADED hop counts over the surviving fabric, not
    `Topology.distance_matrix()`), and `blocked` (S,) per config marks the
    dead routers as permanently occupied.  The numpy backend replays the
    serial reference bit-for-bit on integer-byte weights
    and the torch backend gives the numpy backend's sites and step count
    there; `max_steps` is the repair budget — 0 returns the evacuated layouts
    unchanged."""
    w = np.stack([symmetrize_weights(wi) for wi in weights])
    d = np.stack([np.asarray(di, dtype=np.float64) for di in dists])
    sites = np.stack([np.asarray(s, dtype=np.int64) for s in init_sites]).copy()
    blk = np.stack([np.asarray(b, dtype=bool) for b in blocked])
    if swap_block is not None:
        backend = "numpy"
    else:
        backend = resolve_backend(backend)
    if backend == "torch":
        out, steps = _descend_torch(
            w, d, sites, max_steps, blocked=blk, device=resolve_device(device)
        )
    else:
        out, steps = _descend_numpy(w, d, sites, max_steps, swap_block, blocked=blk)
    stats = PlacementBatchStats(
        batched_configs=sites.shape[0], groups=1, steps=steps, backend=backend
    )
    return list(out), stats


def _perturbed(init: np.ndarray, topology: Topology, *, seed) -> np.ndarray:
    """Restart init: the primary init kicked by n/4 random transpositions
    (plus relocations into free routers when the mesh has spares).  Stays in
    the primary's basin's neighbourhood — a few descent steps to re-converge
    — while giving the argmin-H selection a genuinely different path, unlike
    a fully random init which costs ~n steps to descend."""
    rng = np.random.default_rng(seed)
    site = init.copy()
    n = site.size
    free = np.setdiff1d(np.arange(topology.num_nodes), site)
    rng.shuffle(free)
    for _ in range(max(2, n // 4)):
        if free.size and rng.random() < 0.25:
            i = int(rng.integers(n))
            t, free[0] = int(free[0]), site[i]
            site[i] = t
        else:
            i, j = rng.integers(n, size=2)
            site[i], site[j] = site[j], site[i]
    return site


def place_batch(
    traffics: list[TrafficMatrix],
    partitions: list[Partition],
    topologies: list[Topology],
    *,
    methods: list[str] | str = "auto",
    seeds: list[int] | int = 0,
    paper_faithful_fij: bool = False,
    max_steps: int | None = None,
    restarts: int = 0,
    backend: str = "auto",
    swap_block: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[list[Placement], PlacementBatchStats]:
    """Batched drop-in for the sweep's per-config `place(...)` loop.

    Per config the method is resolved exactly as `place` resolves it
    (`core.placement.resolve_method`); configs whose method lands in
    `BATCH_SEARCH_METHODS` are refined by the stacked steepest-descent engine
    (grouped by (n, S) problem shape), configs landing in
    `BATCH_CONSTRUCT_METHODS` (torus2d under "auto") get their torus-native
    layout from one stacked `torus_construct_batch` assembly per shape group
    — no descent, the `construct_s`-vs-`search_s` stage split in the stats —
    and everything else — random/columnar layouts, the exact MILP, odd
    topologies that only the constructive paths serve — falls through to the
    serial `place` reference.  `restarts` extra
    perturbed-init descents per config ride the same batch and the best H
    wins; the default 0 keeps the stage cost at one convergence (structured
    inits land in a 2-opt optimum within a few steps, and H-parity vs the
    serial search is measured per sweep), while restarts ≥ 1 buys basin
    diversity at ~n/4 extra steps per restart.

    Returns placements in input order plus `PlacementBatchStats`.
    """
    n_cfg = len(traffics)
    if not (n_cfg == len(partitions) == len(topologies)):
        raise ValueError("traffics, partitions, topologies must pair up")
    methods_l = [methods] * n_cfg if isinstance(methods, str) else list(methods)
    seeds_l = [seeds] * n_cfg if isinstance(seeds, int) else list(seeds)
    if not (n_cfg == len(methods_l) == len(seeds_l)):
        raise ValueError("methods/seeds must match the config count")

    results: list[Placement | None] = [None] * n_cfg
    stats = PlacementBatchStats(restarts=restarts)
    groups: dict[tuple[int, int], list[int]] = {}
    torus_groups: dict[tuple[int, int], list[int]] = {}
    weights_all: list[np.ndarray | None] = [None] * n_cfg
    resolved: list[str] = [""] * n_cfg
    for idx, (t, p, topo, m) in enumerate(zip(traffics, partitions, topologies, methods_l)):
        m = resolve_method(t.num_logical, t.num_parts, topo, m)
        resolved[idx] = m
        if m in BATCH_CONSTRUCT_METHODS:
            weights_all[idx] = t.binary_fij(p) if paper_faithful_fij else t.bytes_matrix
            torus_groups.setdefault((t.num_logical, topo.num_nodes), []).append(idx)
            continue
        if m not in BATCH_SEARCH_METHODS:
            results[idx] = place(
                t, p, topo, method=m, paper_faithful_fij=paper_faithful_fij, seed=seeds_l[idx]
            )
            stats.serial_configs += 1
            continue
        weights_all[idx] = t.binary_fij(p) if paper_faithful_fij else t.bytes_matrix
        groups.setdefault((t.num_logical, topo.num_nodes), []).append(idx)

    backends_used: set[str] = set()
    # Torus-native constructive configs: one stacked layout assembly per
    # (n, S) shape group, no descent — the search-time saving §Torus reports.
    for (_n, _s), idxs in torus_groups.items():
        t0 = obs.now_s()
        sites_out, cons_backend = torus_construct_batch(
            [weights_all[i] for i in idxs],
            [topologies[i] for i in idxs],
            methods=[resolved[i] for i in idxs],
            backend=backend,
            device=device,
        )
        stats.construct_s += obs.now_s() - t0
        backends_used.add(cons_backend)
        stats.backend = ",".join(sorted(backends_used))
        stats.torus_constructed += len(idxs)
        stats.groups += 1
        for i, s_arr in zip(idxs, sites_out):
            results[i] = Placement(
                topologies[i], np.asarray(s_arr, dtype=np.int64), resolved[i]
            )
    for (n, _s), idxs in groups.items():
        t_group = obs.now_s()
        # Initial layouts: quad configs use the O(n) constructive tiling per
        # config; greedy configs run ONE stacked argmax-insertion program for
        # the whole group (the former per-config greedy_placement loop).
        inits: dict[int, np.ndarray] = {
            i: quad_placement(traffics[i].num_parts, topologies[i]).site
            for i in idxs
            if resolved[i] == "quad"
        }
        greedy_idxs = [i for i in idxs if resolved[i] == "greedy"]
        if greedy_idxs:
            greedy_sites, cons_backend = greedy_construct_batch(
                [weights_all[i] for i in greedy_idxs],
                [topologies[i] for i in greedy_idxs],
                seeds=[seeds_l[i] for i in greedy_idxs],
                backend=backend,
                device=device,
            )
            inits.update(zip(greedy_idxs, greedy_sites))
            stats.greedy_constructed += len(greedy_idxs)
            backends_used.add(cons_backend)
        w_list, topo_list, init_list, owner = [], [], [], []
        for i in idxs:
            w_i = weights_all[i]
            init = inits[i]
            w_list.append(w_i)
            topo_list.append(topologies[i])
            init_list.append(init)
            owner.append(i)
            for r in range(restarts):
                w_list.append(w_i)
                topo_list.append(topologies[i])
                init_list.append(_perturbed(init, topologies[i], seed=(seeds_l[i], r, i)))
                owner.append(i)
        sites_out, gstats = batch_descend(
            w_list, topo_list, init_list, max_steps=max_steps, backend=backend,
            swap_block=swap_block, device=device,
        )
        stats.steps += gstats.steps
        backends_used.add(gstats.backend)
        stats.backend = ",".join(sorted(backends_used))
        stats.groups += 1
        stats.batched_configs += len(idxs)
        best_h: dict[int, float] = {}
        for s_arr, i in zip(sites_out, owner):
            pl = Placement(
                topologies[i],
                np.asarray(s_arr, dtype=np.int64),
                resolved[i] + BATCH_METHOD_SUFFIX,
            )
            h = pl.weighted_hops(weights_all[i])
            if i not in best_h or h < best_h[i]:
                best_h[i] = h
                results[i] = pl
        stats.search_s += obs.now_s() - t_group
    return results, stats  # type: ignore[return-value]
