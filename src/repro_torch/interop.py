"""State carried across from the JAX package, as plain numpy arrays and dicts.

This path has no weights; its state is graphs, ELL buckets, traces,
partitions, traffic and placements.  The caller converts the other package's
objects to numpy arrays and plain values (this module imports nothing of it)
and these functions build the port's own objects from them, so that both
packages can be made to compute on the same things.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.noc import topology_by_name
from repro_torch.core.partition import Partition
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import TrafficMatrix
from repro_torch.device import resolve_device
from repro_torch.graph.structs import EllBlocks, HostGraph
from repro_torch.graph.vertex_program import TraceResult

__all__ = ["host_graph", "ell_blocks", "trace_result", "partition", "traffic_matrix", "placement"]


def host_graph(num_nodes, src, dst, weight=None, name: str = "graph") -> HostGraph:
    return HostGraph(
        int(num_nodes),
        np.asarray(src),
        np.asarray(dst),
        None if weight is None else np.asarray(weight, dtype=np.float32),
        name,
    )


def ell_blocks(
    num_nodes, rows, cols, weights, widths, device: str | torch.device | None = None
) -> EllBlocks:
    """`rows`/`cols`/`weights` are per-bucket lists of numpy arrays (`weights`
    may be None); tensors are made on `device` with the port's dtypes."""
    dev = resolve_device(device)

    def to(arrays, np_dtype):
        return [torch.from_numpy(np.array(a, dtype=np_dtype)).to(dev) for a in arrays]

    return EllBlocks(
        int(num_nodes),
        to(rows, np.int32),
        to(cols, np.int32),
        None if weights is None else to(weights, np.float32),
        [int(w) for w in widths],
    )


def trace_result(*, props, num_iterations, edge_activity, vertex_activity, frontier_sizes) -> TraceResult:
    return TraceResult(
        props=np.asarray(props),
        num_iterations=int(num_iterations),
        edge_activity=np.asarray(edge_activity, dtype=np.float64),
        vertex_activity=np.asarray(vertex_activity, dtype=np.float64),
        frontier_sizes=[int(s) for s in frontier_sizes],
    )


def partition(*, num_parts, vertex_part, edge_part, rank, order, name) -> Partition:
    return Partition(
        int(num_parts),
        np.asarray(vertex_part),
        np.asarray(edge_part),
        np.asarray(rank),
        np.asarray(order),
        str(name),
    )


def traffic_matrix(*, num_parts, bytes_matrix, phase_bytes) -> TrafficMatrix:
    return TrafficMatrix(
        int(num_parts),
        np.asarray(bytes_matrix, dtype=np.float64),
        {str(k): float(v) for k, v in dict(phase_bytes).items()},
    )


def placement(topology_name: str, shape, site, method: str) -> Placement:
    """`shape` is the topology's constructor dimensions, e.g. (8, 8)."""
    topo = topology_by_name(topology_name, *[int(k) for k in shape])
    return Placement(topo, np.asarray(site, dtype=np.int64), str(method))
