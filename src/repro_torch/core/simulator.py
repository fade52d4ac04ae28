"""Trace-driven latency/energy simulator for the spatial accelerator (paper §3, §6).

Models the paper's evaluation: a grid of CAM-based Graph Engines (GRAM node
config, Fig. 6) joined by a NoC (Table 3: 1 GHz, 8-byte packets, 1 ns/hop,
4-port 2-D mesh; engines run at 100 MHz per §6.1).  The simulator consumes
*measured* traffic (bytes between logical shards from an executed algorithm
trace) plus a placement, and produces per-iteration execution time and energy:

  T_iter  = T_compute + T_network
  T_network = latency term  (avg hops × (T_r + T_w) for the packet window)
            + serialization term (peak link load / link bandwidth)
  E = E_network (Σ bytes × hops × e_hop) + E_compute (CAM search + ALU)

Constants besides Table 3 come from the paper's cited modelling tools
(NVSim-CAM / Destiny / ORION / CACTI) at the granularity the paper reports;
they cancel in the speedup/energy *ratios* the paper plots (Figs. 7/8), which
are driven by the hop-count distribution — the quantity our placement changes.

The analytic network term is contention-blind (one aggregate peak-link
serialization bound); `simulate(contention=NocSimParams(...))` swaps in the
windowed contention simulator (`repro_torch.nocsim`) for hotspot-formation,
queueing and routing-policy effects — see EXPERIMENTS.md §Contention.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import Placement
from repro_torch.core.traffic import TrafficMatrix

__all__ = ["SimParams", "SimResult", "simulate", "compare"]


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Table 3 (+ GRAM engine constants the paper adopts from [2,10-13])."""

    # NoC (Table 3)
    noc_freq_hz: float = 1e9
    packet_bytes: int = 8
    hop_latency_s: float = 1e-9  # T_r + T_w per hop at 1 GHz
    ports: int = 4
    # Engine (GRAM [2], §6.1: spatial architecture at 100 MHz)
    engine_freq_hz: float = 100e6
    cam_search_cycles: float = 4.0  # parallel CAM search over the engine's shard
    alu_lanes: float = 128.0  # post-processing width (one 1024-bit MAT row / 8B)
    engine_capacity_bytes: int = 1 << 20  # 1 MB
    word_bits: int = 64
    # Energy (calibrated; see EXPERIMENTS.md §Calibration — NVSim-CAM/ORION
    # themselves are not available offline, so per-event constants are set to
    # reproduce the paper's reported baseline energy *composition*; ratios are
    # then driven by the hop-count distribution, as in the paper)
    e_per_hop_per_byte_j: float = 1.2e-12  # link+router traversal energy
    e_router_per_packet_j: float = 0.6e-12
    e_cam_search_j: float = 3.0e-9  # one full-shard parallel search
    e_alu_per_op_j: float = 0.4e-12
    e_static_w: float = 0.02  # leakage of the whole grid

    @property
    def link_bandwidth_bytes_per_s(self) -> float:
        # one packet-width flit per cycle per link
        return self.packet_bytes * self.noc_freq_hz


@dataclasses.dataclass(frozen=True)
class SimResult:
    exec_time_s: float
    energy_j: float
    avg_hops: float
    total_bytes: float
    byte_hops: float
    t_compute_s: float
    t_network_s: float
    t_serialization_s: float
    e_network_j: float
    e_compute_j: float
    # Set only when `simulate(contention=...)` ran the windowed NoC
    # simulator (repro_torch.nocsim): the contended replacement of t_network_s
    # (t_network_s itself keeps the analytic value for comparability;
    # exec_time_s/energy then use the contended term).
    t_network_contended_s: float | None = None

    def speedup_over(self, other: "SimResult") -> float:
        return other.exec_time_s / self.exec_time_s

    def energy_ratio_over(self, other: "SimResult") -> float:
        return other.energy_j / self.energy_j


def _per_link_peak_load(
    traffic: TrafficMatrix, placement: Placement, params: SimParams
) -> tuple[float, float]:
    """(byte_hops, peak_bytes_on_one_link) under the topology's exact routing.

    Per-link byte loads come from `Topology.route_links` — X-Y dimension-
    ordered stepping on the mesh, direct per-dimension links on the flattened
    butterfly, wraparound shortest-direction stepping on the 2-D/3-D tori —
    and fall back to a uniform-spread approximation for topologies without
    an exact routing model (none of the built-in four, all of which now
    implement `route_links_ordered`).
    """
    topo = placement.topology
    coords = topo.coords()
    m = traffic.bytes_matrix
    s = placement.site
    ii, jj = np.nonzero(m)
    w = m[ii, jj]
    ci, cj = coords[s[ii]], coords[s[jj]]
    # exact per-flow hop counts from the topology metric:
    d = topo.distance_matrix()[np.ix_(s, s)]
    flow_hops = d[ii, jj].astype(np.float64)
    byte_hops = float((w * flow_hops).sum())
    origin = tuple(coords[0]) if len(coords) else ()
    if topo.route_links(origin, origin) is not None:
        link_load: dict[tuple[int, ...], float] = {}
        for c0, c1, bytes_ in zip(ci, cj, w):
            for key in topo.route_links(tuple(c0), tuple(c1)):
                link_load[key] = link_load.get(key, 0.0) + float(bytes_)
        peak = max(link_load.values(), default=0.0)
    else:
        total_bytes = float(w.sum())
        nlinks = max(1, topo.num_links())
        peak = byte_hops / nlinks if nlinks else total_bytes
    return byte_hops, peak


def simulate(
    traffic: TrafficMatrix,
    placement: Placement,
    *,
    params: SimParams = SimParams(),
    num_iterations: int = 1,
    active_edges_per_iter: float | None = None,
    contention: object | None = None,
) -> SimResult:
    """Simulate one full execution whose aggregate traffic is `traffic`.

    `traffic` carries bytes already summed over iterations (edge_activity);
    num_iterations only affects the latency term (one network window and one
    compute window per iteration) and static energy integration.

    `contention` — a `repro_torch.nocsim.NocSimParams` — replaces the analytic
    network term with the windowed contention simulator's: T_network becomes
    max(t_sf, contended drain) + latency + mean queueing delay, recorded in
    `t_network_contended_s` (t_network_s keeps the analytic value so the two
    models stay comparable side by side).  In the uncongested limit the
    contended term equals the analytic one (property-tested in
    tests/test_nocsim.py).  Imported lazily: nocsim sits above core.
    """
    m = traffic.bytes_matrix
    total_bytes = float(m.sum())
    byte_hops, peak_link = _per_link_peak_load(traffic, placement, params)
    avg_hops = byte_hops / total_bytes if total_bytes else 0.0
    total_packets = total_bytes / params.packet_bytes

    # --- time ---
    # Compute: the CAM searches its whole shard in parallel (the paper's
    # premise: "CAMs allow faster search ... in the fast execution, the
    # on-chip traffic becomes a bottleneck"), once per phase per iteration;
    # ALU post-processing is row-parallel over `alu_lanes`.
    P = traffic.num_parts
    per_engine_packets = total_packets / max(1, P)
    t_compute = (
        num_iterations * 2 * params.cam_search_cycles / params.engine_freq_hz
        + per_engine_packets / params.alu_lanes / params.engine_freq_hz
    )
    # Network: the paper's Eq. 2 — store-and-forward, T = H × (T_r + T_w) per
    # packet.  Engines inject serially through their NIC, all engines in
    # parallel → per-engine occupancy = Σ packets × hops × per-hop latency.
    # Link contention can exceed that bound: the bottleneck link must drain
    # its bytes at link bandwidth; take the max of the two.
    t_sf = per_engine_packets * avg_hops * params.hop_latency_s
    t_serial = peak_link / params.link_bandwidth_bytes_per_s
    t_latency = num_iterations * avg_hops * params.hop_latency_s  # head latency
    t_network = max(t_sf, t_serial) + t_latency
    t_network_contended = None
    if contention is not None:
        from repro_torch.nocsim import simulate_contended  # lazy: nocsim sits above core

        noc = simulate_contended(
            traffic,
            placement,
            noc_params=contention,
            params=params,
            num_iterations=num_iterations,
        )
        t_network_contended = noc.t_network_contended_s
    exec_time = t_compute + (
        t_network if t_network_contended is None else t_network_contended
    )

    # --- energy ---
    e_network = (
        byte_hops * params.e_per_hop_per_byte_j
        + total_packets * (avg_hops + 1.0) * params.e_router_per_packet_j
    )
    searches = num_iterations * 2 * traffic.num_parts  # 2 phases × P engines
    e_compute = searches * params.e_cam_search_j + total_packets * params.e_alu_per_op_j
    e_static = params.e_static_w * exec_time
    return SimResult(
        exec_time_s=exec_time,
        energy_j=e_network + e_compute + e_static,
        avg_hops=avg_hops,
        total_bytes=total_bytes,
        byte_hops=byte_hops,
        t_compute_s=t_compute,
        t_network_s=t_network,
        t_serialization_s=t_serial,
        e_network_j=e_network,
        e_compute_j=e_compute,
        t_network_contended_s=t_network_contended,
    )


def compare(
    traffic: TrafficMatrix,
    optimized: Placement,
    baseline: Placement,
    *,
    params: SimParams = SimParams(),
    num_iterations: int = 1,
) -> dict[str, float]:
    """Paper Figs. 5/7/8 in one call: hop decrease, speedup, energy ratio."""
    opt = simulate(traffic, optimized, params=params, num_iterations=num_iterations)
    base = simulate(traffic, baseline, params=params, num_iterations=num_iterations)
    return {
        "avg_hops_optimized": opt.avg_hops,
        "avg_hops_baseline": base.avg_hops,
        "hop_decrease": base.avg_hops / opt.avg_hops if opt.avg_hops else float("inf"),
        "speedup": opt.speedup_over(base),
        "energy_ratio": opt.energy_ratio_over(base),
        "time_optimized_s": opt.exec_time_s,
        "time_baseline_s": base.exec_time_s,
        "energy_optimized_j": opt.energy_j,
        "energy_baseline_j": base.energy_j,
    }
