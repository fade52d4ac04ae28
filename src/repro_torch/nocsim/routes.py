"""Route operators and routing-policy arms for the windowed NoC simulator.

A route operator is the sparse (L, N·N) matrix R with R[l, s·N + t] = 1 iff
unidirectional link l lies on the deterministic route s → t — the same
object `experiments.batched.routing_operator` builds, except that here the
natural-order (dimension-ordered, "dor") and reversed-order operators are
built together over ONE shared link-id space, so the two routing arms'
per-link loads are directly comparable and can be mixed per flow.

Both operators come from `Topology.route_links_ordered`, the single source
of truth for routing (core/noc.py), so the contended link loads cannot
drift from the analytic simulator's.

Routing arms:
  * ``dor``       — every flow takes the natural dimension-ordered route
                    (identical to `Topology.route_links`).
  * ``adaptive2`` — minimal-adaptive two-choice: per flow, pick the natural
                    or the reversed dimension order, whichever has the
                    lighter most-loaded link under the half-split load
                    estimate (each flow contributing ½ to both candidate
                    paths).  A static, deterministic approximation of
                    adaptive routing — both candidates are minimal, so hop
                    counts (and therefore byte-hops) are unchanged; only the
                    link-load *distribution* moves.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.noc import Topology

__all__ = ["RouteOperators", "route_operators", "assign_adaptive2", "ROUTING_POLICIES"]

ROUTING_POLICIES = ("dor", "adaptive2")

_OP_CACHE: dict[Topology, "RouteOperators | None"] = {}


@dataclasses.dataclass(frozen=True)
class RouteOperators:
    """Natural + reversed-order route operators over one link-id space."""

    link_keys: tuple[tuple[int, ...], ...]  # link id → (c_from + c_to) tuple
    nat: object  # scipy CSR (L, N·N): natural dimension order (== route_links)
    rev: object  # scipy CSR (L, N·N): reversed dimension order

    @property
    def num_links(self) -> int:
        return len(self.link_keys)


def _operator(topology: Topology, order, link_ids: dict) -> object:
    coords = topology.coords()
    n = topology.num_nodes
    rows: list[int] = []
    cols: list[int] = []
    for i, c0 in enumerate(coords):
        for j, c1 in enumerate(coords):
            if i == j:
                continue
            for key in topology.route_links_ordered(tuple(c0), tuple(c1), order):
                lid = link_ids.get(key)
                if lid is None:
                    lid = link_ids[key] = len(link_ids)
                rows.append(lid)
                cols.append(i * n + j)
    return rows, cols


def route_operators(topology: Topology) -> RouteOperators | None:
    """Build (cached per topology) the natural + reversed route operators, or
    None when the topology has no exact routing model (the contended
    simulator then refuses rather than silently approximating — the
    uniform-spread fallback has no per-link timeline to window)."""
    cached = _OP_CACHE.get(topology, "miss")
    if not isinstance(cached, str):
        return cached
    coords = topology.coords()
    origin = tuple(coords[0]) if len(coords) else ()
    if topology.route_links_ordered(origin, origin, None) is None:
        _OP_CACHE[topology] = None
        return None
    from scipy import sparse

    ndim = coords.shape[1]
    rev_order = tuple(range(ndim - 1, -1, -1))
    link_ids: dict[tuple[int, ...], int] = {}
    nat_rc = _operator(topology, None, link_ids)
    rev_rc = _operator(topology, rev_order, link_ids)
    n = topology.num_nodes
    shape = (len(link_ids), n * n)
    nat = sparse.csr_matrix(
        (np.ones(len(nat_rc[0])), nat_rc), shape=shape, dtype=np.float64
    )
    rev = sparse.csr_matrix(
        (np.ones(len(rev_rc[0])), rev_rc), shape=shape, dtype=np.float64
    )
    ops = RouteOperators(link_keys=tuple(link_ids), nat=nat, rev=rev)
    _OP_CACHE[topology] = ops
    return ops


def _per_flow_route_max(op, values: np.ndarray) -> np.ndarray:
    """max over each flow's route links of `values[l]` (0 for empty routes):
    the bottleneck-link estimate the two-choice assignment compares."""
    scaled = op.T.multiply(np.asarray(values, dtype=np.float64)[None, :])  # (N², L)
    return np.asarray(scaled.max(axis=1).todense()).ravel()


def assign_adaptive2(ops: RouteOperators, flow_bytes: np.ndarray) -> np.ndarray:
    """Two-choice route assignment for one config: `flow_bytes` is the
    flattened (N·N,) router-space bytes vector; returns a boolean (N·N,)
    mask, True where the flow takes the REVERSED dimension order.

    Deterministic: loads are estimated with every flow split half/half over
    both candidates, each flow then takes the candidate whose most-loaded
    link is strictly lighter (ties → natural order).  One balancing pass —
    cheap, vectorized, and config-independent of iteration order, so both
    nocsim backends consume the identical assignment."""
    flow_bytes = np.asarray(flow_bytes, dtype=np.float64)
    est = 0.5 * (ops.nat @ flow_bytes + ops.rev @ flow_bytes)  # (L,)
    cost_nat = _per_flow_route_max(ops.nat, est)
    cost_rev = _per_flow_route_max(ops.rev, est)
    return cost_rev < cost_nat
