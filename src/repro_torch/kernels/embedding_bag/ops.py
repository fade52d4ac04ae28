"""Dispatching wrapper for EmbeddingBag, differentiable in the tables and the
weights.

`embedding_bag` is the one entry point the models call.  Selection:
  impl="auto" → "cuda" for CUDA tables, "ref" for CPU tables
  impl="cuda" → the hand-written kernel `csrc/embedding_bag.cu`
  impl="ref"  → the plain version `ref.embedding_bag_ref`
Both routes run inside one `torch.autograd.Function`, as both run inside the
JAX package's `custom_vjp`; its backward mirrors `_bag_bwd` there and is
plain PyTorch on either route (the JAX backward is plain `jnp`, not a Pallas
kernel):
  d tables  = scatter-add of w · valid · g[b, t] into rows t·V + clamp(id) of a
              dense (T·V, D) buffer (`index_add_`).  Dense on purpose: AdamW's
              weight decay touches every row in the reference;
  d weights = ⟨tables[t, clamp(id)], g[b, t]⟩ · valid;
  no gradient for `ids`.
Nothing here catches a failure and falls back.  `embedding_bag.launches`
counts kernel launches (a plain integer); `kernel.py` adds one where it
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "IMPLS"]

IMPLS = ("auto", "cuda", "ref")


class _Bag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, ids, weights, impl):
        ctx.save_for_backward(tables, ids, weights)
        if impl == "ref":
            return embedding_bag_ref(tables, ids, weights)
        from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda

        return embedding_bag_cuda(tables, ids, weights)

    @staticmethod
    def backward(ctx, g):
        tables, ids, weights = ctx.saved_tensors
        t, v, d = tables.shape
        ids = ids.long()
        valid = (ids >= 0) & (ids < v)
        safe = ids.clamp(0, v - 1)
        w = valid.to(g.dtype)
        if weights is not None:
            w = w * weights.to(g.dtype)
        d_tables = d_weights = None
        if ctx.needs_input_grad[0]:
            contrib = g[:, :, None, :] * w[..., None]  # (B, T, L, D)
            flat = (torch.arange(t, device=ids.device)[None, :, None] * v + safe).reshape(-1)
            d_tables = torch.zeros((t * v, d), dtype=g.dtype, device=g.device)
            d_tables.index_add_(0, flat, contrib.reshape(-1, d))
            d_tables = d_tables.view(t, v, d).to(tables.dtype)
        if weights is not None and ctx.needs_input_grad[2]:
            rows = tables[torch.arange(t, device=ids.device)[None, :, None], safe].to(g.dtype)
            d_weights = (rows * g[:, :, None, :]).sum(-1) * valid.to(g.dtype)
        return d_tables, None, d_weights, None


def embedding_bag(
    tables: torch.Tensor,
    ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """tables (T, V, D); ids (B, T, L) (outside [0, V) ⇒ pad); weights (B, T, L)
    or None.  Returns (B, T, D) weighted bag sums in the tables' type.  The
    kernel's route takes int32 ids and float32 weights only."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {'|'.join(IMPLS)}")
    if impl == "auto":
        impl = "cuda" if tables.is_cuda else "ref"
    return _Bag.apply(tables, ids, weights, impl)


embedding_bag.launches = 0
