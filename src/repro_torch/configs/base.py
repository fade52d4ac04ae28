"""Architecture configurations the port can run: the dense LM part of
`repro.configs.base`.

An `LmArch` knows its published configuration (`model_config()`), a reduced
`smoke_config()` the CPU tests run, and `model_flops(cell)`, the useful-FLOPs
yardstick (6·N·D train / 2·N·D forward).  There is no dry-run case, no mesh
and no sharding here: those are multi-device work (ROADMAP.md Queue A 9).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import TransformerConfig

__all__ = ["LM_SHAPES", "LmArch"]

LM_SHAPES: dict[str, tuple[str, int, int]] = {
    # name: (step kind, seq_len, global_batch)
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("long_decode", 524_288, 1),
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
