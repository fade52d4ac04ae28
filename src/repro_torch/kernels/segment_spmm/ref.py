"""Plain PyTorch versions of the degree-binned ELL SpMM (the Process/Reduce
hot loop: gather source properties → edge compute → segment-reduce at dst).

Two views of the same computation:
  * `ell_spmm_ref(x, cols, wts)` — one ELL bucket: for each ELL row i,
    out[i] = Σ_j wts[i,j] · x[cols[i,j]]  (cols outside [0, N) ⇒ padding).
  * `coo_spmm_ref(x, src, dst, w, n)` — arbitrary COO edge list via
    `index_add_` (the whole-graph oracle the ELL path must match after
    scatter-back).

Both accumulate in float32 and return `x.dtype`, like the kernel.  They serve
the CPU tests and the comparison on the card; with a card present nothing on
the main path calls them.
"""
from __future__ import annotations

import torch

__all__ = ["ell_spmm_ref", "coo_spmm_ref"]


def ell_spmm_ref(
    x: torch.Tensor, cols: torch.Tensor, wts: torch.Tensor | None = None
) -> torch.Tensor:
    """x (N, D); cols (R, W) with entries outside [0, N) ⇒ pad → (R, D)."""
    n = x.shape[0]
    cols = cols.long()
    valid = (cols >= 0) & (cols < n)
    safe = cols.clamp(0, n - 1)
    rows = x[safe].float()  # (R, W, D)
    w = valid.float()
    if wts is not None:
        w = w * wts.float()
    return (rows * w[..., None]).sum(dim=1).to(x.dtype)


def coo_spmm_ref(
    x: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor | None,
    num_nodes: int,
) -> torch.Tensor:
    """Σ_{e: dst[e]=v} w_e · x[src[e]] with sentinel (== num_nodes) padding."""
    src, dst = src.long(), dst.long()
    valid = (src < num_nodes) & (dst < num_nodes)
    msg = x[src.clamp(max=num_nodes - 1)].float()
    ww = valid.float()
    if w is not None:
        ww = ww * w.float()
    msg = msg * ww[:, None]
    out = torch.zeros((num_nodes + 1, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, dst.clamp(max=num_nodes), msg)
    return out[:num_nodes].to(x.dtype)
