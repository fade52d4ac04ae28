"""Paper core: power-law-aware partitioning, placement and NoC simulation.

Public API re-exports — see DESIGN.md §3 for the inventory.
"""
from repro_torch.core.degree import SkewStats, fit_power_law, hub_set, in_degrees, out_degrees, skew_stats
from repro_torch.core.mapping import DeviceMapper, GraphMapping, map_graph
from repro_torch.core.noc import FlattenedButterfly, Mesh2D, Topology, Torus2D, Torus3D, topology_by_name
from repro_torch.core.partition import (
    PARTITIONERS,
    Partition,
    hash_partition,
    partition_by_name,
    powerlaw_partition,
    random_partition,
    range_partition,
)
from repro_torch.core.placement import (
    Placement,
    auto_mesh_for_parts,
    brute_force_placement,
    columnar_placement,
    greedy_placement,
    ilp_placement,
    place,
    quad_placement,
    random_placement,
    two_opt,
)
from repro_torch.core.replication import ReplicationPlan, plan_replication
from repro_torch.core.simulator import SimParams, SimResult, compare, simulate
from repro_torch.core.traffic import EPROP, ET, STRUCTS, VPROP, VTEMP, TrafficMatrix, traffic_from_partition

__all__ = [k for k in dir() if not k.startswith("_")]
