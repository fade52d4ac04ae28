"""End-to-end mapping pipeline: graph → partition → traffic → placement.

`map_graph` is the paper's full §5 flow in one call; `DeviceMapper` is the
TPU-level adaptation (Level B in DESIGN.md): it treats the flattened device
mesh of a pod as the NoC, uses the same partitioner to shard a graph over
devices, and the same placement objective to choose which logical shard lands
on which physical chip — the permutation it returns is applied to device
orderings before `jax.sharding` sees them, so `shard_map` collectives run over
neighbouring chips for the heavy flows.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import placement as placement_lib
from repro_torch.core.degree import out_degrees, skew_stats
from repro_torch.core.noc import Topology, Torus2D, Torus3D
from repro_torch.core.partition import Partition, partition_by_name
from repro_torch.core.placement import Placement, auto_mesh_for_parts
from repro_torch.core.replication import ReplicationPlan, plan_replication
from repro_torch.core.simulator import SimParams, SimResult, compare, simulate
from repro_torch.core.traffic import TrafficMatrix, traffic_from_partition

__all__ = ["GraphMapping", "map_graph", "DeviceMapper"]


@dataclasses.dataclass(frozen=True)
class GraphMapping:
    """Everything the simulator / distributed engine needs for one graph."""

    partition: Partition
    traffic: TrafficMatrix
    placement: Placement
    replication: ReplicationPlan | None
    topology: Topology

    def simulate(self, **kw) -> SimResult:
        return simulate(self.traffic, self.placement, **kw)

    def compare_to(self, baseline: "GraphMapping", **kw) -> dict[str, float]:
        return compare(self.traffic, self.placement, baseline.placement, **kw)


def map_graph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    topology: Topology | None = None,
    partitioner: str = "powerlaw",
    placement_method: str = "auto",
    paper_faithful_fij: bool = False,
    edge_activity: np.ndarray | None = None,
    traffic_model: str = "paper",
    with_replication: bool = False,
    seed: int = 0,
) -> GraphMapping:
    """Paper §5 end to end.  partitioner/placement_method select baselines:
    partitioner='random' + placement_method='random' is the paper's baseline
    configuration; the defaults are the paper's proposed scheme.
    """
    if topology is None:
        topology = auto_mesh_for_parts(num_parts)
    part = partition_by_name(partitioner, src, dst, num_nodes, num_parts)
    traffic = traffic_from_partition(
        part, src, dst, edge_activity=edge_activity, model=traffic_model
    )
    placement = placement_lib.place(
        traffic,
        part,
        topology,
        method=placement_method,
        paper_faithful_fij=paper_faithful_fij,
        seed=seed,
    )
    repl = None
    if with_replication:
        fij = traffic.binary_fij(part)
        avg = placement.average_hops(traffic.bytes_matrix)
        repl = plan_replication(part, src, dst, edge_activity=edge_activity, avg_hops=max(avg, 1.0))
        if not repl.worthwhile:
            repl = None
    return GraphMapping(part, traffic, placement, repl, topology)


class DeviceMapper:
    """Applies the paper's mapping to a JAX device mesh (Level B).

    The pod's chips form a physical torus; a graph sharded over `n_devices`
    engines has one *merged* shard per device (on TPU the four structures
    live in one HBM, so the placement problem collapses from 4P shards on 4P
    routers to P merged shards on P chips, with inter-shard weights =
    Σ structure-to-structure traffic between the parts).  The permutation
    minimises Σ bytes × ICI-hops, exactly Algorithm 4 with merged nodes.
    """

    def __init__(self, mesh_shape: tuple[int, ...], *, wrap: bool = True):
        if len(mesh_shape) == 2:
            self.topology: Topology = Torus2D(*mesh_shape) if wrap else _mesh2d(*mesh_shape)
        elif len(mesh_shape) == 3:
            self.topology = Torus3D(*mesh_shape)
        else:
            raise ValueError(f"unsupported mesh shape {mesh_shape}")
        self.mesh_shape = tuple(mesh_shape)
        self.num_devices = int(np.prod(mesh_shape))

    def merged_traffic(self, traffic: TrafficMatrix) -> np.ndarray:
        """Collapse (4 structures × P parts) → (P parts) shard traffic."""
        P = traffic.num_parts
        m = traffic.bytes_matrix.reshape(4, P, 4, P)
        merged = m.sum(axis=(0, 2))
        np.fill_diagonal(merged, 0.0)  # intra-device bytes are HBM, not ICI
        return merged

    def device_permutation(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int,
        *,
        partitioner: str = "powerlaw",
        edge_activity: np.ndarray | None = None,
        seed: int = 0,
    ) -> tuple[np.ndarray, Partition, float, float]:
        """Returns (perm, partition, hops_opt, hops_identity) where perm[p] is
        the physical device index for logical shard p.  hops_* are the
        byte-weighted average ICI hop counts for the optimised and the
        identity (default device order) mappings.
        """
        part = partition_by_name(partitioner, src, dst, num_nodes, self.num_devices)
        traffic = traffic_from_partition(
            part, src, dst, edge_activity=edge_activity, model="cross"
        )
        merged = self.merged_traffic(traffic)
        greedy = placement_lib.greedy_placement(merged, self.topology, seed=seed)
        # Steepest-descent refinement: converges to a full 2-opt local optimum
        # in far fewer steps than the 4000 random probes it replaced.
        placed = placement_lib.two_opt_best_move(greedy, merged)
        identity = Placement(self.topology, np.arange(self.num_devices), "identity")
        hops_opt = placed.average_hops(merged)
        hops_id = identity.average_hops(merged)
        if hops_opt >= hops_id:  # never regress vs the default order
            placed = identity
            hops_opt = hops_id
        return placed.site.copy(), part, hops_opt, hops_id

    def describe(self, src: np.ndarray, dst: np.ndarray, num_nodes: int) -> dict[str, float]:
        deg = out_degrees(src, num_nodes)
        stats = skew_stats(deg)
        perm, part, h_opt, h_id = self.device_permutation(src, dst, num_nodes)
        return {
            "alpha": stats.alpha,
            "edge_balance": part.edge_balance(),
            "ici_hops_optimized": h_opt,
            "ici_hops_identity": h_id,
            "ici_hop_reduction": h_id / h_opt if h_opt else 1.0,
        }


def _mesh2d(kx: int, ky: int):
    from repro_torch.core.noc import Mesh2D

    return Mesh2D(kx, ky)
