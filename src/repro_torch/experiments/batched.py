"""Vectorized evaluation hot path: `simulate()` and placement scoring batched
over all sweep configurations at once.

The serial simulator (`repro_torch.core.simulator.simulate`) walks every traffic
flow in a Python loop to accumulate per-link loads — fine for one config,
dominant for a 48-config sweep.  Here the whole batch is evaluated with three
tensor contractions over stacked `(n_configs, 4P, 4P)` arrays:

  1. scatter each config's logical-shard traffic into *router space* using
     its placement:  B[c, site_i, site_j] = bytes[i, j]   (placements are
     injective, so this is a pure permutation-scatter);
  2. byte-hops:      bh[c]   = Σ_st B[c,s,t] · D[s,t]     (one einsum, D is
     the shared distance matrix of the batch's topology);
  3. link loads:     load[c] = B[c].reshape(-1) @ Rᵀ      (R is the routing
     operator: R[l, s·N+t] = 1 iff link l lies on the X-Y route s→t),
     peak[c] = max_l load[c,l].

Everything downstream of (bh, peak, total_bytes) is elementwise over the
batch.  The routing operator reproduces `_per_link_peak_load` exactly: X-Y
dimension-ordered stepping for 2-D coordinate meshes, direct per-dimension
links for the flattened butterfly, and the uniform-spread `byte_hops/links`
fallback for other topologies — so batched results equal the serial ones to
fp tolerance (tested in tests/test_experiments_sweep.py).

Backends: "numpy" (float64, bit-exact vs serial up to summation order) and
"torch" (the same three contractions as float64 tensors on the given device,
with the routing operator kept sparse).  Traffic bytes are integer-valued,
distances are integers and the routing operator is 0/1, all far below 2**53,
so the float64 sums re-associate exactly: total bytes, byte-hops and the peak
link load are bit-equal between the two backends.  "auto" is "torch".
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.analysis.registry import parity_pair_torch
from repro_torch.core.noc import Topology
from repro_torch.core.placement import Placement
from repro_torch.core.simulator import SimParams, SimResult
from repro_torch.core.traffic import SparseTraffic, TrafficMatrix
from repro_torch.device import resolve_backend, resolve_device

__all__ = [
    "routing_operator",
    "scatter_to_router_space",
    "simulate_batch",
    "simulate_serial",
    "batched_weighted_hops",
    "resolve_backend",
]

def routing_operator(topology: Topology):
    """(num_links, N·N) sparse CSR operator mapping a router-space bytes
    matrix to per-link loads, built from the same `Topology.route_links`
    model the serial simulator uses (X-Y mesh stepping, flattened-butterfly
    direct links, wraparound torus stepping) — so batched and serial link
    loads cannot drift apart.  Sparse because a route touches only
    `hops(s,t)` of the L links (~0.5 % of entries on an 8×8 mesh) — the
    dense matmul was the batch hot spot.

    The operator itself is the natural-order half of the pair
    `repro_torch.nocsim.routes.route_operators` builds (one builder, one cache —
    the windowed contention simulator shares it); links only the reversed
    order uses carry zero load under this operator and cannot be the peak.
    Returns None for topologies with no exact route_links — none of the
    built-in four since Torus3D gained wrap-aware dimension-ordered routing
    — which the batched path approximates with the uniform spread, like the
    serial one.
    """
    from repro_torch.nocsim.routes import route_operators

    ops = route_operators(topology)
    return None if ops is None else ops.nat


def scatter_to_router_space(
    traffic: TrafficMatrix | SparseTraffic, placement: Placement
) -> np.ndarray:
    """(N, N) bytes between *routers* under `placement` (N = topology nodes).
    Accepts the COO form directly (scatters only the nonzeros — the pairs are
    unique by construction, so the result equals the dense scatter)."""
    n = placement.topology.num_nodes
    out = np.zeros((n, n), dtype=np.float64)
    s = placement.site
    if isinstance(traffic, SparseTraffic):
        out[s[traffic.rows], s[traffic.cols]] = traffic.vals
    else:
        out[np.ix_(s, s)] = traffic.bytes_matrix
    return out


def _results_from_scalars(
    total_bytes: np.ndarray,
    byte_hops: np.ndarray,
    peak_link: np.ndarray,
    num_parts: int,
    num_iterations: np.ndarray,
    params: SimParams,
) -> list[SimResult]:
    """The elementwise tail of `simulate()` over the batch, in float64."""
    total_bytes = np.asarray(total_bytes, dtype=np.float64)
    byte_hops = np.asarray(byte_hops, dtype=np.float64)
    peak_link = np.asarray(peak_link, dtype=np.float64)
    it = np.asarray(num_iterations, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg_hops = np.where(total_bytes > 0, byte_hops / total_bytes, 0.0)
    total_packets = total_bytes / params.packet_bytes
    per_engine_packets = total_packets / max(1, num_parts)
    t_compute = (
        it * 2 * params.cam_search_cycles / params.engine_freq_hz
        + per_engine_packets / params.alu_lanes / params.engine_freq_hz
    )
    t_sf = per_engine_packets * avg_hops * params.hop_latency_s
    t_serial = peak_link / params.link_bandwidth_bytes_per_s
    t_latency = it * avg_hops * params.hop_latency_s
    t_network = np.maximum(t_sf, t_serial) + t_latency
    exec_time = t_compute + t_network
    e_network = (
        byte_hops * params.e_per_hop_per_byte_j
        + total_packets * (avg_hops + 1.0) * params.e_router_per_packet_j
    )
    searches = it * 2 * num_parts
    e_compute = searches * params.e_cam_search_j + total_packets * params.e_alu_per_op_j
    energy = e_network + e_compute + params.e_static_w * exec_time
    return [
        SimResult(
            exec_time_s=float(exec_time[c]),
            energy_j=float(energy[c]),
            avg_hops=float(avg_hops[c]),
            total_bytes=float(total_bytes[c]),
            byte_hops=float(byte_hops[c]),
            t_compute_s=float(t_compute[c]),
            t_network_s=float(t_network[c]),
            t_serialization_s=float(t_serial[c]),
            e_network_j=float(e_network[c]),
            e_compute_j=float(e_compute[c]),
        )
        for c in range(total_bytes.size)
    ]


def _contract_numpy(stack: np.ndarray, dist: np.ndarray, routing):
    total_bytes = stack.sum(axis=(1, 2))
    byte_hops = np.einsum("cst,st->c", stack, dist)
    if routing is not None:
        loads = routing @ stack.reshape(stack.shape[0], -1).T  # (L, C)
        peak = loads.max(axis=0) if loads.shape[0] else np.zeros(stack.shape[0])
    else:
        peak = None
    return total_bytes, byte_hops, peak


def _contract_numpy_blocked(stack: np.ndarray, dist: np.ndarray, routing, block: int):
    """`_contract_numpy` streamed over column blocks of the flattened (s, t)
    pair axis: total-bytes, byte-hops and link-load accumulation each touch
    O(C·block) (plus one (L, C) loads accumulator) per step instead of the
    full C·N² flat stack at once.  Traffic bytes are integer-valued and the
    routing operator is 0/1, so the per-block partial sums re-associate
    bit-exactly (see core.traffic's module docstring); `peak` is a max and
    unaffected by chunking."""
    c = stack.shape[0]
    flat = stack.reshape(c, -1)
    m = flat.shape[1]
    dflat = dist.reshape(-1)
    total_bytes = np.zeros(c, dtype=np.float64)
    byte_hops = np.zeros(c, dtype=np.float64)
    loads = (
        np.zeros((routing.shape[0], c), dtype=np.float64) if routing is not None else None
    )
    for start in range(0, m, block):
        sl = slice(start, min(start + block, m))
        total_bytes += flat[:, sl].sum(axis=1)
        byte_hops += flat[:, sl] @ dflat[sl]
        if routing is not None:
            loads += routing[:, sl] @ flat[:, sl].T
    if routing is None:
        peak = None
    elif loads.shape[0]:
        peak = loads.max(axis=0)
    else:
        peak = np.zeros(c)
    return total_bytes, byte_hops, peak


# torch.sparse_csr_tensor copies of the (cached-forever) scipy routing
# operators, keyed by (object id, device) — safe because nocsim.routes._OP_CACHE
# pins the scipy objects (routing_operator returns the cached pair's natural
# half).
_TORCH_ROUTING: dict[tuple[int, str], torch.Tensor] = {}


def _torch_routing(routing, device: torch.device) -> torch.Tensor:
    key = (id(routing), str(device))
    op = _TORCH_ROUTING.get(key)
    if op is None:
        csr = routing.tocsr()
        with warnings.catch_warnings():
            # torch announces once per process that sparse CSR is in beta
            warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
            op = _TORCH_ROUTING[key] = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int64)),
                torch.from_numpy(csr.indices.astype(np.int64)),
                torch.from_numpy(csr.data.astype(np.float64)),
                size=csr.shape,
                device=device,
                check_invariants=False,
            )
    return op


def _contract_torch(stack: np.ndarray, dist: np.ndarray, routing, device: torch.device):
    """`_contract_numpy` as float64 tensors on `device`; the link loads go
    through the sparse routing operator (L, N·N) @ (N·N, C), then a row max."""
    B = torch.from_numpy(np.ascontiguousarray(stack, dtype=np.float64)).to(device)
    D = torch.from_numpy(np.ascontiguousarray(dist, dtype=np.float64)).to(device)
    total = B.sum((1, 2))
    bh = torch.einsum("cst,st->c", B, D)
    peak = None
    if routing is not None:
        if routing.shape[0]:
            flat_t = B.reshape(B.shape[0], -1).T.contiguous()  # (N·N, C)
            loads = _torch_routing(routing, device) @ flat_t  # (L, C)
            peak = loads.max(dim=0).values.cpu().numpy()
        else:
            peak = np.zeros(stack.shape[0])
    return total.cpu().numpy(), bh.cpu().numpy(), peak


@parity_pair_torch(
    serial="repro_torch.core.simulator.simulate",
    kind="rel",
    tol=1e-12,
    note="equal per config (same routing model via `Topology.route_links`); "
    "total_bytes, byte_hops and the peak link load bit-equal on integer-byte "
    "traffic, the rest within 1e-12 relative on both backends "
    "(tests/test_torch_batched.py)",
)
def simulate_batch(
    traffics: list[TrafficMatrix | SparseTraffic],
    placements: list[Placement],
    *,
    params: SimParams = SimParams(),
    num_iterations: np.ndarray | list[int] | int = 1,
    backend: str = "auto",
    pair_block: int | None = None,
    device: str | torch.device | None = None,
) -> list[SimResult]:
    """Batched `simulate()`: one SimResult per (traffic, placement) pair.

    Pairs are grouped by (topology, num_parts) — each group shares one
    distance matrix and one routing operator — and each group is evaluated
    with the three stacked contractions described in the module docstring.
    Results are returned in input order and match the serial simulator to fp
    tolerance (float64-exact on both backends).  `device` is read by the
    torch backend only: `None` means the CUDA device and raises without one.

    Traffics may be `SparseTraffic` (scattered from the COO directly).
    `pair_block` streams the contractions over column blocks of that many
    (s, t) router pairs (`_contract_numpy_blocked`) — bit-identical on the
    integer-byte domain and numpy-only, so setting it forces the numpy
    backend.
    """
    if len(traffics) != len(placements):
        raise ValueError("traffics and placements must pair up")
    n = len(traffics)
    iters = np.broadcast_to(np.asarray(num_iterations, dtype=np.int64), (n,))
    backend = "numpy" if pair_block is not None else resolve_backend(backend)
    if backend == "torch":
        dev = resolve_device(device)

        def contract(stack, dist, routing):
            return _contract_torch(stack, dist, routing, dev)

    else:
        contract = _contract_numpy

    groups: dict[tuple, list[int]] = {}
    for idx, (t, p) in enumerate(zip(traffics, placements)):
        groups.setdefault((p.topology, t.num_parts), []).append(idx)

    results: list[SimResult | None] = [None] * n
    for (topology, num_parts), idxs in groups.items():
        stack = np.stack(
            [scatter_to_router_space(traffics[i], placements[i]) for i in idxs]
        )
        dist = topology.distance_matrix().astype(np.float64)
        routing = routing_operator(topology)
        if pair_block is not None:
            total_bytes, byte_hops, peak = _contract_numpy_blocked(
                stack, dist, routing, max(1, int(pair_block))
            )
        else:
            total_bytes, byte_hops, peak = contract(stack, dist, routing)
        if peak is None:  # serial fallback: uniform spread over all links
            nlinks = max(1, topology.num_links())
            peak = byte_hops / nlinks
        for pos, res in zip(
            idxs,
            _results_from_scalars(total_bytes, byte_hops, peak, num_parts, iters[idxs], params),
        ):
            results[pos] = res
    return results  # type: ignore[return-value]


def simulate_serial(
    traffics: list[TrafficMatrix],
    placements: list[Placement],
    *,
    params: SimParams = SimParams(),
    num_iterations: np.ndarray | list[int] | int = 1,
) -> list[SimResult]:
    """The one-config-at-a-time loop the batch path replaces (reference +
    §Perf timing baseline)."""
    from repro_torch.core.simulator import simulate

    n = len(traffics)
    iters = np.broadcast_to(np.asarray(num_iterations, dtype=np.int64), (n,))
    return [
        simulate(t, p, params=params, num_iterations=int(it))
        for t, p, it in zip(traffics, placements, iters)
    ]


def batched_weighted_hops(
    weights: np.ndarray,
    sites: np.ndarray,
    topology: Topology,
    *,
    backend: str = "auto",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Placement scoring H = Σ_ij w_ij · dist(site_i, site_j) for a stack of
    placements at once: `weights` is (C, n, n) (or (n, n), broadcast over the
    site stack), `sites` is (C, n).  Returns (C,) scores — equal to
    `Placement.weighted_hops` per row."""
    sites = np.asarray(sites, dtype=np.int64)
    if sites.ndim != 2:
        raise ValueError("sites must be (n_configs, n_logical)")
    weights = np.asarray(weights, dtype=np.float64)
    if weights.ndim == 2:
        weights = np.broadcast_to(weights, (sites.shape[0],) + weights.shape)
    dist = topology.distance_matrix().astype(np.float64)
    if resolve_backend(backend) == "torch":
        dev = resolve_device(device)
        st = torch.from_numpy(sites).to(dev)
        d = torch.from_numpy(dist).to(dev)[st[:, :, None], st[:, None, :]]
        w = torch.from_numpy(np.ascontiguousarray(weights)).to(dev)
        return torch.einsum("cij,cij->c", w, d).cpu().numpy()
    d = dist[sites[:, :, None], sites[:, None, :]]
    return np.einsum("cij,cij->c", weights, d)
