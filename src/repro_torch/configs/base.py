"""Architecture configurations the port can run: the LM (dense and MoE), GNN
and recsys parts of `repro.configs.base`.

An `LmArch`, `GnnArch` or `RecsysArch` knows its published configuration
(`model_config()`, a GNN's for one `GNN_SHAPES` cell), a reduced
`smoke_config()` the CPU tests run, and `model_flops(cell)`, the useful-FLOPs
yardstick (6·N·D train / 2·N·D forward).  There is no dry-run case, no mesh
and no sharding here: those are multi-device work (ROADMAP.md Queue A 9), and
the dry-run's batch specs (`GnnArch.batch_specs`, ShapeDtypeStructs and
PartitionSpecs) belong to the tooling of Queue A 10.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import GnnConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.recsys import DcnConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "N_CLASSES_DEFAULT", "LmArch", "GnnArch",
           "RecsysArch"]

LM_SHAPES: dict[str, tuple[str, int, int]] = {
    # name: (step kind, seq_len, global_batch)
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("long_decode", 524_288, 1),
}

GNN_SHAPES: dict[str, dict] = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(
        n_nodes=232_965, n_edges=114_615_892, batch_nodes=1_024, fanout=(15, 10), d_feat=602
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=32),
}

RECSYS_SHAPES: dict[str, dict] = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

N_CLASSES_DEFAULT = 16  # synthetic label space for GNN cells


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class LmArch:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    moe: MoEConfig | None = None
    source: str = ""
    family: str = "lm"

    def model_config(self) -> TransformerConfig:
        """The published width and depth; activations bf16, params float32;
        MoE layers `impl="local"`."""
        return TransformerConfig(
            self.name,
            n_layers=self.n_layers,
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_ff=self.d_ff,
            vocab=self.vocab,
            d_head=self.d_head,
            moe=None if self.moe is None else dataclasses.replace(self.moe, impl="local"),
        )

    def smoke_config(self) -> TransformerConfig:
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(8, moe.num_experts), d_ff_expert=64,
                d_ff_shared=64 if moe.d_ff_shared else 0, impl="local",
            )
        return TransformerConfig(
            self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads)),
            d_ff=128,
            vocab=512,
            moe=moe,
            dtype=torch.float32,
        )

    def model_flops(self, cell: str) -> float:
        kind, seq, batch = LM_SHAPES[cell]
        n = self.model_config().num_active_params
        if kind == "train":
            return 6.0 * n * seq * batch
        if kind == "prefill":
            return 2.0 * n * seq * batch
        return 2.0 * n * batch  # decode: one token per sequence


@dataclasses.dataclass
class GnnArch:
    name: str
    kind: str  # gin | gat | pna | graphcast
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregators: tuple[str, ...] = ("sum",)
    scalers: tuple[str, ...] = ("identity",)
    mesh_refinement: int = 6
    n_vars: int = 227
    source: str = ""
    family: str = "gnn"

    def model_config(self, cell: str) -> GnnConfig:
        """The published width and depth at one `GNN_SHAPES` cell (its feature
        width; graph classification on `molecule`, regression for graphcast);
        float32 params and activations."""
        sh = GNN_SHAPES[cell]
        task = "graph_class" if cell == "molecule" else "node_class"
        d_out = N_CLASSES_DEFAULT
        if self.kind == "graphcast":
            task, d_out = "regression", self.n_vars
        return GnnConfig(
            self.name,
            self.kind,
            n_layers=self.n_layers,
            d_hidden=self.d_hidden,
            d_in=sh["d_feat"],
            d_out=d_out,
            task=task,
            n_heads=self.n_heads,
            aggregators=self.aggregators,
            scalers=self.scalers,
            mesh_refinement=self.mesh_refinement,
            n_vars=self.n_vars,
        )

    def smoke_config(self) -> GnnConfig:
        return GnnConfig(
            self.name + "-smoke", self.kind, n_layers=2, d_hidden=16, d_in=8,
            d_out=4, task="regression" if self.kind == "graphcast" else "node_class",
            n_heads=min(2, self.n_heads), aggregators=self.aggregators,
            scalers=self.scalers, n_vars=4,
        )

    def shape_cells(self) -> list[str]:
        return list(GNN_SHAPES)

    def model_flops(self, cell: str) -> float:
        sh = GNN_SHAPES[cell]
        cfg = self.model_config(cell)
        n_nodes = sh["n_nodes"] * sh.get("batch", 1)
        n_edges = sh["n_edges"] * sh.get("batch", 1)
        # 6 × (dense param-FLOPs on nodes + message FLOPs on edges)
        return 6.0 * (cfg.num_params * 1.0 * n_nodes / max(cfg.d_in, 1) + n_edges * self.d_hidden)

    def _node_edge_counts(self, cell: str, n_devices: int) -> tuple[int, int]:
        """(nodes, edges) of one batch of the cell, each rounded up to a
        multiple of `n_devices`."""
        sh = GNN_SHAPES[cell]
        if cell == "molecule":
            n = sh["n_nodes"] * sh["batch"]
            e = sh["n_edges"] * sh["batch"]
        elif cell == "minibatch_lg":
            seeds, (f1, f2) = sh["batch_nodes"], sh["fanout"]
            n = seeds * (1 + f1 + f1 * f2)
            e = seeds * (f1 + f1 * f2)
        else:
            n, e = sh["n_nodes"], sh["n_edges"]
        return _round_up(n, n_devices), _round_up(e, n_devices)


@dataclasses.dataclass
class RecsysArch:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    rows_per_table: int = 1_000_000
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    source: str = ""
    family: str = "recsys"

    def model_config(self) -> DcnConfig:
        """The published configuration; params and activations float32."""
        return DcnConfig(
            self.name,
            n_dense=self.n_dense,
            n_sparse=self.n_sparse,
            embed_dim=self.embed_dim,
            rows_per_table=self.rows_per_table,
            n_cross_layers=self.n_cross_layers,
            mlp_dims=self.mlp_dims,
        )

    def smoke_config(self) -> DcnConfig:
        return DcnConfig(
            self.name + "-smoke", n_dense=4, n_sparse=6, embed_dim=8,
            rows_per_table=128, n_cross_layers=2, mlp_dims=(32, 16),
        )

    def model_flops(self, cell: str) -> float:
        sh = RECSYS_SHAPES[cell]
        cfg = self.model_config()
        dense_params = cfg.num_params - cfg.n_sparse * cfg.rows_per_table * cfg.embed_dim
        per_ex = 2.0 * dense_params + 2.0 * cfg.n_sparse * cfg.embed_dim
        mult = 6.0 if sh.get("kind") == "train" else 2.0
        flops = mult * per_ex * sh["batch"]
        if sh.get("kind") == "retrieval":
            flops += 2.0 * sh["n_candidates"] * cfg.mlp_dims[-1] * sh["batch"]
        return flops
