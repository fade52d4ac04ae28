"""State carried across from the JAX package, as plain numpy arrays and dicts.

The paper path's state is graphs, ELL buckets, traces, partitions, traffic
and placements; the LM path's is the transformer's weights; the GNN path's is
the four GNNs' weights; the recsys path's is dcn-v2's weights.  The caller
converts the other package's objects to numpy arrays and plain values (this
module imports nothing of it) and these functions build the port's own
objects from them, so that both packages can be made to compute on the same
things.
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
from repro_torch.models.gnn import GnnConfig, param_shapes
from repro_torch.models.recsys import DcnConfig
from repro_torch.models.transformer import TransformerConfig, layer_shapes

__all__ = ["host_graph", "ell_blocks", "trace_result", "partition", "traffic_matrix", "placement",
           "transformer_params", "gnn_params", "recsys_params"]


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


def transformer_params(tree: dict, cfg: TransformerConfig, device: str | torch.device | None = None) -> dict:
    """The JAX package's transformer params (`repro.models.transformer.
    init_params`), given as nested dicts of numpy arrays, as the port's
    params on `device`: the same layout and values, in `cfg.param_dtype`.
    Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    want = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        want["lm_head"] = (cfg.d_model, cfg.vocab)
    want_layers = {k: (cfg.n_layers, *s) for k, s in layer_shapes(cfg).items()}
    if set(tree) != set(want) | {"layers"} or set(tree["layers"]) != set(want_layers):
        raise ValueError(f"param tree keys {sorted(tree)} / {sorted(tree.get('layers', {}))} do not match {cfg.name}")

    def to(a, shape, name):
        a = np.array(a, dtype=np.float32)  # a writable copy
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, want {shape}")
        return torch.from_numpy(a).to(device=dev, dtype=cfg.param_dtype)

    out = {k: to(tree[k], s, k) for k, s in want.items()}
    out["layers"] = {k: to(tree["layers"][k], s, k) for k, s in want_layers.items()}
    return out


def _tree_to(node, shape, name: str, make):
    """`node` (nested dicts and lists of arrays) checked against `shape` (the
    same nesting with shape tuples at the leaves), each leaf passed through
    `make(array, name)`.  Raises on a missing, extra or misshapen leaf."""
    if isinstance(shape, dict):
        if not isinstance(node, dict) or set(node) != set(shape):
            raise ValueError(f"{name}: keys {sorted(node) if isinstance(node, dict) else node!r}, "
                             f"want {sorted(shape)}")
        return {k: _tree_to(node[k], s, f"{name}/{k}", make) for k, s in shape.items()}
    if isinstance(shape, list):
        if not isinstance(node, (list, tuple)) or len(node) != len(shape):
            raise ValueError(f"{name}: want a list of {len(shape)}")
        return [_tree_to(n, s, f"{name}/{i}", make) for i, (n, s) in enumerate(zip(node, shape))]
    a = np.array(node, dtype=np.float32)  # a writable copy
    if a.shape != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, want {tuple(shape)}")
    return make(a, name)


def gnn_params(tree: dict, cfg: GnnConfig, device: str | torch.device | None = None) -> dict:
    """The JAX package's GNN params (`repro.models.gnn.init_params`), given as
    nested dicts and lists of numpy arrays, as the port's params on `device`:
    the layout of `models.gnn.param_shapes(cfg)` (GIN's `eps` a 0-d tensor),
    in `cfg.param_dtype`.  Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    return _tree_to(tree, param_shapes(cfg), cfg.name,
                    lambda a, _: torch.from_numpy(a).to(device=dev, dtype=cfg.param_dtype))


def recsys_params(tree: dict, cfg: DcnConfig, device: str | torch.device | None = None) -> dict:
    """The JAX package's dcn-v2 params (`repro.models.recsys.init_params`),
    given as nested dicts and lists of numpy arrays, as the port's params on
    `device`: `tables`, `cross[i].{w,b}` (or `{u,v,b}` when `cfg.cross_rank`
    > 0), `mlp[i].{w,b}`, `out.{w,b}`, in `cfg.param_dtype` (biases float32,
    as `init_params` makes them).  Raises on a missing, extra or misshapen
    leaf."""
    dev = resolve_device(device)
    d0, r = cfg.d_input, cfg.cross_rank
    cross = {"w": (d0, d0), "b": (d0,)} if r == 0 else {"u": (d0, r), "v": (r, d0), "b": (d0,)}
    dims = [d0, *cfg.mlp_dims]
    want = {
        "tables": (cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim),
        "cross": [cross] * cfg.n_cross_layers,
        "mlp": [{"w": (a, b), "b": (b,)} for a, b in zip(dims[:-1], dims[1:])],
        "out": {"w": (cfg.mlp_dims[-1], 1), "b": (1,)},
    }

    def make(a, name):
        dtype = torch.float32 if name.endswith("/b") else cfg.param_dtype
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    return _tree_to(tree, want, cfg.name, make)
