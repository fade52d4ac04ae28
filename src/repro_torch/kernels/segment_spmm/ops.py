"""Dispatching wrappers: one ELL bucket (`ell_spmm`) and the whole-graph
SpMM through the degree-binned ELL layout (`segment_spmm`).

`segment_spmm(x, ell)` computes every bucket and stores each row in vertex
order — the result equals `coo_spmm_ref` over the original edge list.  On the
card that is one launch of the fused kernel over `ell.work()`.

Dispatch rule: a CUDA tensor goes to the CUDA kernel, or raises; a CPU tensor
goes to the plain version.  Nothing here catches a failure and falls back.
`ell_spmm.launches` and `segment_spmm.launches` count kernel launches (plain
integers); `kernel.py` adds one where it launches.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import EllBlocks
from repro_torch.kernels.segment_spmm.ref import ell_spmm_ref, segment_spmm_ref

__all__ = ["segment_spmm", "ell_spmm"]

IMPLS = ("auto", "cuda", "ref")


def ell_spmm(
    x: torch.Tensor,
    cols: torch.Tensor,
    wts: torch.Tensor | None = None,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """One ELL bucket: out[i] = Σ_j wts[i,j]·x[cols[i,j]], cols outside [0, N)
    adding 0.  `impl="auto"`: the kernel for a CUDA `x`, `ref` for a CPU `x`.
    The kernel has no backward: on its route, `x` or `wts` requiring grad
    (with grad on) raises before anything else is checked."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {'|'.join(IMPLS)}")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return ell_spmm_ref(x, cols, wts)
    if torch.is_grad_enabled() and (x.requires_grad or (wts is not None and wts.requires_grad)):
        raise NotImplementedError(
            "ell_spmm: the CUDA kernel has no backward, and an input requires grad; "
            "use impl='ref' to differentiate (the kernel's backward is ROADMAP.md Queue B 4)"
        )
    from repro_torch.kernels.segment_spmm.kernel import ell_spmm_cuda

    return ell_spmm_cuda(x, cols, wts)


ell_spmm.launches = 0


def segment_spmm(x: torch.Tensor, ell: EllBlocks, *, impl: str = "auto") -> torch.Tensor:
    """x (N, D) → (N, D): out[v] = Σ_{(u→v)∈E} w·x[u] using the reversed-graph
    ELL (bucket rows are destination vertices, cols their in-neighbours).

    Every vertex with in-degree > 0 is a row of exactly one bucket, so each
    output row has one writer and no accumulation; a vertex with in-degree 0
    is in no bucket and its row is exactly 0.  `impl="auto"`: the fused kernel
    for a CUDA `x`, `ref` for a CPU `x`.  The kernel has no backward: on its
    route, `x` or the weights requiring grad (with grad on) raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {'|'.join(IMPLS)}")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return segment_spmm_ref(x, ell)
    if torch.is_grad_enabled() and (
        x.requires_grad or (ell.weights is not None and any(w.requires_grad for w in ell.weights))
    ):
        raise NotImplementedError(
            "segment_spmm: the CUDA kernel has no backward, and an input requires grad; "
            "use impl='ref' to differentiate (the kernel's backward is ROADMAP.md Queue B 4)"
        )
    from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda

    return segment_spmm_cuda(x, ell)


segment_spmm.launches = 0
