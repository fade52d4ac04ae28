"""Plain PyTorch version of EmbeddingBag: gather + masked weighted sum.

tables (T, V, D); ids (B, T, L) — entries outside [0, V) are padding (index
clamped, weight 0); weights optional (B, T, L).  Output (B, T, D) =
Σ_l w·tables[t, ids[b,t,l]], summed in fp32 and returned in the tables' type.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref"]


def embedding_bag_ref(tables: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    t, v, _ = tables.shape
    b, t2, _ = ids.shape
    if t != t2:
        raise ValueError(f"embedding_bag: {t} tables, ids for {t2}")
    ids = ids.to(tables.device).long()
    valid = (ids >= 0) & (ids < v)
    safe = ids.clamp(0, v - 1)
    rows = tables[torch.arange(t, device=tables.device)[None, :, None], safe]  # (B, T, L, D)
    w = valid.float()
    if weights is not None:
        w = w * weights.to(tables.device).float()
    return (rows.float() * w[..., None]).sum(dim=2).to(tables.dtype)
