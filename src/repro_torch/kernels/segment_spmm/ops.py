"""Dispatching wrappers: one ELL bucket (`ell_spmm`) and the whole-graph
SpMM through the degree-binned ELL layout (`segment_spmm`).

`segment_spmm(x, ell)` computes every bucket and stores each row in vertex
order — the result equals `coo_spmm_ref` over the original edge list.  On the
card that is one launch of the fused kernel over `ell.work()`.  Its gradient
with respect to `x` is the same reduce over the transposed ELL
(`ell.transpose`): one more launch of the same kernel (`_SegmentSpmm`).  The
TPU kernel had no backward; the reference differentiates
`jax.ops.segment_sum` by autodiff.

Dispatch rule: a CUDA tensor goes to the CUDA kernel, or raises; a CPU tensor
goes to the plain version; a `meta` tensor (an explicit choice: a dry run
that counts, `launch.dryrun`) gets an output of the right shape and launches
nothing.  Nothing here catches a failure and falls back.  Under an active
`obs.cost.CostCounter` each reduce (forward or backward) and each
one-bucket call counts itself once, from the ELL's shapes
(`obs.cost.ell_reduce_cost`), and its route is not counted again.
`ell_spmm.launches` and `segment_spmm.launches` count kernel launches (plain
integers, the backward's launches included); `kernel.py` adds one where it
launches.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import EllBlocks
from repro_torch.kernels.segment_spmm.ref import ell_spmm_ref, segment_spmm_ref
from repro_torch.obs.cost import ell_reduce_cost, kernel_cost

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
    The one-bucket kernel has no backward: on its route, `x` or `wts`
    requiring grad (with grad on) raises before anything else is checked
    (`segment_spmm`, the whole reduce, has one)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {'|'.join(IMPLS)}")
    if impl == "auto":
        impl = "meta" if x.is_meta else "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return ell_spmm_ref(x, cols, wts)
    if torch.is_grad_enabled() and (x.requires_grad or (wts is not None and wts.requires_grad)):
        raise NotImplementedError(
            "ell_spmm: the one-bucket CUDA kernel has no backward, and an input requires grad; "
            "use impl='ref' to differentiate, or segment_spmm over the whole ELL with its transpose"
        )
    r, w = cols.shape
    d, item = x.shape[1], x.element_size()

    def cost():
        return 2.0 * r * w * d, x.dtype, r * w * 4 * (2 if wts is not None else 1) + r * w * d * item + r * d * item

    with kernel_cost("ell_spmm", cost):
        if impl == "meta":
            return x.new_empty((r, d))
        from repro_torch.kernels.segment_spmm.kernel import ell_spmm_cuda

        return ell_spmm_cuda(x, cols, wts)


ell_spmm.launches = 0


def segment_spmm(x: torch.Tensor, ell: EllBlocks, *, impl: str = "auto") -> torch.Tensor:
    """x (N, D) → (N, D): out[v] = Σ_{(u→v)∈E} w·x[u] using the reversed-graph
    ELL (bucket rows are destination vertices, cols their in-neighbours).

    Every vertex with in-degree > 0 is a row of exactly one bucket, so each
    output row has one writer and no accumulation; a vertex with in-degree 0
    is in no bucket and its row is exactly 0.  `impl="auto"`: the fused kernel
    for a CUDA `x`, `ref` for a CPU `x`; `impl="ref"` is plain PyTorch that
    autograd differentiates.  On the "auto"/"cuda" routes, with grad on and
    `x` requiring it, the call goes through `_SegmentSpmm`, whose backward is
    the reduce over `ell.transpose`; it raises if `ell` has no transpose, and
    raises for ELL weights that require grad (neither package differentiates
    an edge weight)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; options: {'|'.join(IMPLS)}")
    if impl == "ref":
        return segment_spmm_ref(x, ell)
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("segment_spmm(impl='cuda') takes CUDA tensors; the plain version is impl='ref'")
    if torch.is_grad_enabled():
        if ell.weights is not None and any(w.requires_grad for w in ell.weights):
            raise NotImplementedError(
                "segment_spmm: ELL weights that require grad; the gradient is taken with respect to x "
                "only (neither package differentiates an edge weight)"
            )
        if x.requires_grad:
            if ell.transpose is None:
                raise ValueError(
                    "segment_spmm: x requires grad, and the ELL has no transpose for the backward; "
                    "build it with gnn.batch_ell(..., transpose=True) or set ell.transpose = "
                    "build_ell(graph) beside build_ell(graph.reversed())"
                )
            return _SegmentSpmm.apply(x, ell)
    return _reduce(x, ell)


segment_spmm.launches = 0


def _reduce(x: torch.Tensor, ell: EllBlocks) -> torch.Tensor:
    """The whole reduce without autograd: the fused kernel for a CUDA `x`,
    the plain reader of the flat layout for a CPU `x`, an empty (N, D) for
    a `meta` `x`.  Counted here, once a reduce, on every route."""
    with kernel_cost("segment_spmm", lambda: _cost(x, ell)):
        if x.is_meta:
            return x.new_empty(x.shape)
        if not x.is_cuda:
            return segment_spmm_ref(x, ell).contiguous()
        from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda

        return segment_spmm_cuda(x, ell)


def _cost(x: torch.Tensor, ell: EllBlocks) -> tuple[float, torch.dtype, int]:
    flops, nbytes = ell_reduce_cost(x, ell)
    return flops, x.dtype, nbytes


class _SegmentSpmm(torch.autograd.Function):
    """The reduce with a backward: grad_x[u] = Σ_{u→v} w·grad_out[v], the
    reduce over `ell.transpose` (rows the sources).  A vertex of out-degree
    0 is in none of its buckets and gets a zero row."""

    @staticmethod
    def forward(ctx, x, ell):
        ctx.ell = ell
        return _reduce(x, ell)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        return _reduce(grad.contiguous(), ctx.ell.transpose), None
