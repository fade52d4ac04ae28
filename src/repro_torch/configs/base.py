"""Architecture configurations the port can run: the dense LM and the recsys
parts of `repro.configs.base`.

An `LmArch` or `RecsysArch` knows its published configuration
(`model_config()`), a reduced `smoke_config()` the CPU tests run, and
`model_flops(cell)`, the useful-FLOPs yardstick (6·N·D train / 2·N·D
forward).  There is no dry-run case, no mesh and no sharding here: those are
multi-device work (ROADMAP.md Queue A 9).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.recsys import DcnConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["LM_SHAPES", "RECSYS_SHAPES", "LmArch", "RecsysArch"]

LM_SHAPES: dict[str, tuple[str, int, int]] = {
    # name: (step kind, seq_len, global_batch)
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("long_decode", 524_288, 1),
}

RECSYS_SHAPES: dict[str, dict] = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}


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
    source: str = ""
    family: str = "lm"

    def model_config(self) -> TransformerConfig:
        """The published width and depth; activations bf16, params float32."""
        return TransformerConfig(
            self.name,
            n_layers=self.n_layers,
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_ff=self.d_ff,
            vocab=self.vocab,
            d_head=self.d_head,
        )

    def smoke_config(self) -> TransformerConfig:
        return TransformerConfig(
            self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads)),
            d_ff=128,
            vocab=512,
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
