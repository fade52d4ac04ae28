"""Graph containers: host-side COO/CSR plus device-ready padded layouts.

Message passing is edge-index gather + a segment reduce over these
structures.  Two device layouts, both torch tensors on an explicit device:

  * `EdgeList`  — COO (src, dst[, weight]), optionally padded to a fixed size
    with a validity mask.
  * `EllBlocks` — the power-law degree-binned ELL layout used by the
    segment_spmm kernel: after Algorithm 2's degree sort, rows are grouped
    into power-of-two degree buckets and each bucket stored dense
    (rows × bucket_width) with padding — the paper's CAM-friendly sorted
    layout.

Sentinel conventions: pad edges point at node `N`; ELL padding is
`cols == N`; padded ELL rows carry `rows == N`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["HostGraph", "EdgeList", "Csr", "EllBlocks", "to_device_edges", "build_ell"]


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """Immutable host-side COO graph (numpy)."""

    num_nodes: int
    src: np.ndarray  # (E,) int32/int64
    dst: np.ndarray  # (E,)
    weight: np.ndarray | None = None  # (E,) float32
    name: str = "graph"

    def __post_init__(self):
        assert self.src.shape == self.dst.shape
        if self.weight is not None:
            assert self.weight.shape == self.src.shape

    @property
    def num_edges(self) -> int:
        return int(self.src.size)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_nodes)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_nodes)

    def csr(self) -> "Csr":
        order = np.argsort(self.src, kind="stable")
        dst = self.dst[order]
        w = self.weight[order] if self.weight is not None else None
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.src, minlength=self.num_nodes), out=indptr[1:])
        return Csr(self.num_nodes, indptr, dst.astype(np.int64), w)

    def reversed(self) -> "HostGraph":
        return HostGraph(self.num_nodes, self.dst, self.src, self.weight, self.name + "_rev")

    def subgraph_edges(self, mask: np.ndarray, name: str | None = None) -> "HostGraph":
        return HostGraph(
            self.num_nodes,
            self.src[mask],
            self.dst[mask],
            None if self.weight is None else self.weight[mask],
            name or self.name,
        )


@dataclasses.dataclass(frozen=True)
class Csr:
    num_nodes: int
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,) neighbour ids, grouped by source
    weight: np.ndarray | None = None

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])


@dataclasses.dataclass
class EdgeList:
    """Device COO with static shape.  `valid` masks padding (pad edges point
    at node `num_nodes`'s sentinel slot — callers allocate N+1 rows or mask)."""

    num_nodes: int
    src: torch.Tensor  # (E_pad,) int32
    dst: torch.Tensor  # (E_pad,) int32
    valid: torch.Tensor  # (E_pad,) bool
    weight: torch.Tensor | None = None  # (E_pad,) float32

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])


def to_device_edges(
    g: HostGraph,
    *,
    pad_to: int | None = None,
    dtype: torch.dtype = torch.int32,
    device: str | torch.device | None = None,
) -> EdgeList:
    dev = resolve_device(device)
    e = g.num_edges
    pad_to = pad_to or e
    if pad_to < e:
        raise ValueError(f"pad_to={pad_to} < num_edges={e}")
    src = np.full(pad_to, g.num_nodes, dtype=np.int64)
    dst = np.full(pad_to, g.num_nodes, dtype=np.int64)
    valid = np.zeros(pad_to, dtype=bool)
    src[:e], dst[:e], valid[:e] = g.src, g.dst, True
    w = None
    if g.weight is not None:
        wfull = np.zeros(pad_to, dtype=np.float32)
        wfull[:e] = g.weight
        w = torch.from_numpy(wfull).to(dev)
    return EdgeList(
        g.num_nodes,
        torch.from_numpy(src).to(device=dev, dtype=dtype),
        torch.from_numpy(dst).to(device=dev, dtype=dtype),
        torch.from_numpy(valid).to(dev),
        w,
    )


@dataclasses.dataclass
class EllBlocks:
    """Degree-binned ELL: bucket b holds rows whose (power-law sorted) degree
    fits width[b]; `cols[b]` is (rows_b, width[b]) of neighbour ids with
    `num_nodes` as the padding sentinel, `rows[b]` the original vertex ids.

    Padding overhead is bounded by 2× per bucket (power-of-two widths) and in
    practice ~1.2× on power-law graphs because the degree sort makes buckets
    tight — the measured overhead is reported by `fill_fraction`.
    """

    num_nodes: int
    rows: list[torch.Tensor]  # int32 (rows_b,)
    cols: list[torch.Tensor]  # int32 (rows_b, width_b)
    weights: list[torch.Tensor] | None  # float32 (rows_b, width_b)
    widths: list[int]
    _scatter_rows: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_buckets(self) -> int:
        return len(self.widths)

    def scatter_rows(self, b: int) -> torch.Tensor:
        """Bucket b's `rows` as an int64 store index with padded rows sent to
        the sentinel row N (made once per bucket and kept)."""
        idx = self._scatter_rows.get(b)
        if idx is None:
            idx = self._scatter_rows[b] = self.rows[b].long().clamp(max=self.num_nodes)
        return idx

    def fill_fraction(self) -> float:
        real = sum(int((c != self.num_nodes).sum()) for c in self.cols)
        alloc = sum(int(c.numel()) for c in self.cols)
        return real / alloc if alloc else 1.0


def build_ell(
    g: HostGraph,
    *,
    min_width: int = 8,
    max_width: int | None = None,
    row_align: int = 8,
    device: str | torch.device | None = None,
) -> EllBlocks:
    """Bucket rows by out-degree into power-of-two widths (power-law binning)."""
    dev = resolve_device(device)
    csr = g.csr()
    deg = np.diff(csr.indptr)
    max_deg = int(deg.max()) if deg.size else 0
    if max_width is None:
        max_width = max(min_width, 1 << max(0, int(np.ceil(np.log2(max(1, max_deg))))))
    widths = []
    w = min_width
    while w < max_width:
        widths.append(w)
        w <<= 1
    widths.append(max_width)

    rows_out, cols_out, wts_out = [], [], []
    has_w = csr.weight is not None
    bucket_of = np.searchsorted(np.array(widths), np.maximum(deg, 1))
    bucket_of = np.minimum(bucket_of, len(widths) - 1)
    for b, width in enumerate(widths):
        vs = np.nonzero((bucket_of == b) & (deg > 0))[0]
        if vs.size == 0:
            rows_out.append(torch.zeros((0,), dtype=torch.int32, device=dev))
            cols_out.append(torch.zeros((0, width), dtype=torch.int32, device=dev))
            wts_out.append(torch.zeros((0, width), dtype=torch.float32, device=dev))
            continue
        n_rows = int(np.ceil(vs.size / row_align) * row_align)
        cols = np.full((n_rows, width), g.num_nodes, dtype=np.int64)
        wts = np.zeros((n_rows, width), dtype=np.float32)
        rows = np.full(n_rows, g.num_nodes, dtype=np.int64)
        rows[: vs.size] = vs
        # vectorised ragged gather: position (i, k) reads indices[indptr[v_i]+k]
        # when k < deg[v_i], else stays at the sentinel.
        pos = csr.indptr[vs][:, None] + np.arange(width)[None, :]
        mask = np.arange(width)[None, :] < deg[vs][:, None]
        pos = np.minimum(pos, csr.indices.size - 1)
        cols[: vs.size] = np.where(mask, csr.indices[pos], g.num_nodes)
        if has_w:
            wts[: vs.size] = np.where(mask, csr.weight[pos], 0.0)
        rows_out.append(torch.from_numpy(rows.astype(np.int32)).to(dev))
        cols_out.append(torch.from_numpy(cols.astype(np.int32)).to(dev))
        wts_out.append(torch.from_numpy(wts).to(dev))
    return EllBlocks(
        g.num_nodes,
        rows_out,
        cols_out,
        wts_out if has_w else None,
        widths,
    )
