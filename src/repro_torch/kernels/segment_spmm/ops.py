"""Dispatching wrapper: whole-graph SpMM through the degree-binned ELL path.

`segment_spmm(x, ell)` runs every ELL bucket through `ell_spmm` and stores the
bucket outputs back in vertex order — the result equals `coo_spmm_ref` over
the original edge list.

Dispatch rule: a CUDA tensor goes to the CUDA kernel, or raises; a CPU tensor
goes to the plain version.  Nothing here catches a failure and falls back.
`ell_spmm.launches` counts kernel launches (a plain integer); `kernel.py` adds
one where it launches.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import EllBlocks
from repro_torch.kernels.segment_spmm.ref import ell_spmm_ref

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

    Every real vertex sits in exactly one bucket, so the scatter-back is an
    indexed store (no accumulation); padded rows go to the sentinel row N."""
    n, d = x.shape
    out = torch.zeros((n + 1, d), dtype=x.dtype, device=x.device)  # +1 sentinel row
    for b in range(ell.num_buckets):
        cols = ell.cols[b]
        if cols.shape[0] == 0:
            continue
        wts = ell.weights[b] if ell.weights is not None else None
        part = ell_spmm(x, cols, wts, impl=impl)
        out[ell.scatter_rows(b)] = part  # padded rows → sentinel
    return out[:n]
