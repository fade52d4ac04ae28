"""Plain PyTorch versions of the degree-binned ELL SpMM (the Process/Reduce
hot loop: gather source properties → edge compute → segment-reduce at dst).

Two views of the same computation:
  * `ell_spmm_ref(x, cols, wts)` — one ELL bucket: for each ELL row i,
    out[i] = Σ_j wts[i,j] · x[cols[i,j]]  (cols outside [0, N) ⇒ padding).
  * `segment_spmm_ref(x, ell)` — the whole graph as the fused kernel reads
    it: the flat layout and work table of `ell.work()`, item by item, each
    row stored to its vertex, vertices in no bucket 0.
  * `coo_spmm_ref(x, src, dst, w, n)` — arbitrary COO edge list via
    `index_add_` (the whole-graph oracle the ELL path must match).

Both accumulate in float32 and return `x.dtype`, like the kernel.  They serve
the CPU tests and the comparison on the card; with a card present nothing on
the main path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.graph.structs import EllBlocks

__all__ = ["ell_spmm_ref", "segment_spmm_ref", "coo_spmm_ref"]


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


def segment_spmm_ref(x: torch.Tensor, ell: EllBlocks) -> torch.Tensor:
    """x (N, D) → (N, D) in x's type, read through `ell.work()`: the items in
    table order, each run of items that continue one another (same width,
    rows and slots adjacent, as a bucket's items are) read as one block."""
    n, d = x.shape
    work = ell.work()
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    runs: list[list[int]] = []
    for row0, count, width, slot0 in work.items.tolist():
        last = runs[-1] if runs else None
        if last and last[2] == width and last[0] + last[1] == row0 and last[3] + last[1] * width == slot0:
            last[1] += count
        else:
            runs.append([row0, count, width, slot0])
    for row0, count, width, slot0 in runs:
        cols = work.cols[slot0 : slot0 + count * width].view(count, width)
        wts = None if work.weights is None else work.weights[slot0 : slot0 + count * width].view(count, width)
        rows = work.rows[row0 : row0 + count].long()
        real = rows < n  # padded rows carry the sentinel N
        out[rows[real]] = ell_spmm_ref(x, cols, wts)[real]
    out[work.zero_rows.long()] = 0
    return out


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
