"""graphcast — 16-layer encode-process-decode mesh GNN, d_hidden=512,
mesh_refinement=6 (capped per cell to mesh_nodes ≤ grid_nodes —
gnn.graphcast_mesh_plan), sum aggregation, n_vars=227.
[arXiv:2212.12794; unverified]"""
from repro_torch.configs.base import GnnArch

ARCH = GnnArch(
    name="graphcast",
    kind="graphcast",
    n_layers=16,
    d_hidden=512,
    mesh_refinement=6,
    n_vars=227,
    source="arXiv:2212.12794",
)
