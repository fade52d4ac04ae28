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

__all__ = ["HostGraph", "EdgeList", "Csr", "EllBlocks", "EllWork", "to_device_edges", "build_ell"]


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


# The fused reduce's work items (`EllWork.items`): a row of ELL_ITEM_SLOTS
# slots or more, or any row of width ELL_HUB_WIDTH or more (a hub), is an item
# of its own; narrower rows are cut into items of ELL_ITEM_SLOTS // width rows.
# `csrc/ell_spmm.cu` gives each item one block (kBlockRowW there is
# ELL_HUB_WIDTH).
ELL_ITEM_SLOTS = 2048
ELL_HUB_WIDTH = 1024


@dataclasses.dataclass(frozen=True)
class EllWork:
    """Every bucket of an `EllBlocks` in one flat layout, as one fused launch
    reads it.  Buckets follow each other in `rows` (row after row) and in
    `cols`/`weights` (row-major, each row `width` slots); `items` is (n_items,
    4) int64: first row (an index into `rows`), row count, width, offset of the
    first row's slots in `cols`/`weights`.  Items are in descending width, so
    hub rows start first; every real row of every bucket is in exactly one
    item.  `zero_rows` lists the vertices that are in no bucket (in-degree 0):
    their output row is 0."""

    rows: torch.Tensor  # int32 (Σ R_b,)
    cols: torch.Tensor  # int32 (Σ R_b·W_b,)
    weights: torch.Tensor | None  # float32 (Σ R_b·W_b,)
    items: torch.Tensor  # int64 (n_items, 4)
    zero_rows: torch.Tensor  # int32 (n_zero,)


def _work_items(counts: list[int], widths: list[int]) -> np.ndarray:
    row0 = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    slot0 = np.concatenate([[0], np.cumsum(np.asarray(counts, np.int64) * np.asarray(widths, np.int64))])
    items = []
    for b in sorted(range(len(widths)), key=lambda k: -widths[k]):
        w, r = widths[b], counts[b]
        per = 1 if w >= ELL_HUB_WIDTH else max(1, ELL_ITEM_SLOTS // w)
        for i in range(0, r, per):
            items.append((row0[b] + i, min(per, r - i), w, slot0[b] + i * w))
    return np.asarray(items, dtype=np.int64).reshape(-1, 4)


@dataclasses.dataclass
class EllBlocks:
    """Degree-binned ELL: bucket b holds rows whose (power-law sorted) degree
    fits width[b]; `cols[b]` is (rows_b, width[b]) of neighbour ids with
    `num_nodes` as the padding sentinel, `rows[b]` the original vertex ids.

    Padding overhead is bounded by 2× per bucket (power-of-two widths) and in
    practice ~1.2× on power-law graphs because the degree sort makes buckets
    tight — the measured overhead is reported by `fill_fraction`.

    `build_ell` stores every bucket in one flat buffer each for rows, cols and
    weights (the per-bucket tensors are views into them); `work()` returns
    that layout with its work table.

    `transpose`, where set, is the ELL of the same edges the other way round
    (rows the sources, cols the destinations, the same weights): the reduce
    over it is the transpose of the reduce over this one, which is what
    `segment_spmm`'s backward launches.
    """

    num_nodes: int
    rows: list[torch.Tensor]  # int32 (rows_b,)
    cols: list[torch.Tensor]  # int32 (rows_b, width_b)
    weights: list[torch.Tensor] | None  # float32 (rows_b, width_b)
    widths: list[int]
    _flat: tuple | None = dataclasses.field(default=None, repr=False, compare=False)
    _work: EllWork | None = dataclasses.field(default=None, repr=False, compare=False)
    transpose: "EllBlocks | None" = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def num_buckets(self) -> int:
        return len(self.widths)

    def work(self) -> EllWork:
        """The flat layout and work table of the fused reduce (made once and
        kept; from the flat buffers of `build_ell` without a copy, else by
        concatenating the buckets)."""
        if self._work is None:
            if self._flat is not None:
                rows, cols, wts = self._flat
            else:
                rows = torch.cat([r.reshape(-1) for r in self.rows])
                cols = torch.cat([c.reshape(-1) for c in self.cols])
                wts = None if self.weights is None else torch.cat([w.reshape(-1) for w in self.weights])
            counts = [int(r.shape[0]) for r in self.rows]
            items = torch.from_numpy(_work_items(counts, self.widths)).to(rows.device)
            in_bucket = torch.zeros(self.num_nodes + 1, dtype=torch.bool, device=rows.device)
            in_bucket[rows.long().clamp(0, self.num_nodes)] = True
            zero_rows = (~in_bucket[: self.num_nodes]).nonzero().reshape(-1).to(torch.int32)
            self._work = EllWork(rows, cols, wts, items, zero_rows)
        return self._work

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

    has_w = csr.weight is not None
    bucket_of = np.searchsorted(np.array(widths), np.maximum(deg, 1))
    bucket_of = np.minimum(bucket_of, len(widths) - 1)
    members = [np.nonzero((bucket_of == b) & (deg > 0))[0] for b in range(len(widths))]
    counts = [int(np.ceil(vs.size / row_align) * row_align) for vs in members]
    slots = [r * w for r, w in zip(counts, widths)]
    # one flat buffer each; bucket b's rows/cols/wts are views into them
    rows_flat = np.full(sum(counts), g.num_nodes, dtype=np.int32)
    cols_flat = np.full(sum(slots), g.num_nodes, dtype=np.int32)
    wts_flat = np.zeros(sum(slots), dtype=np.float32)
    r0 = s0 = 0
    for b, (vs, width) in enumerate(zip(members, widths)):
        if vs.size:
            rows_flat[r0 : r0 + vs.size] = vs
            # vectorised ragged gather: position (i, k) reads indices[indptr[v_i]+k]
            # when k < deg[v_i], else stays at the sentinel.
            pos = csr.indptr[vs][:, None] + np.arange(width)[None, :]
            mask = np.arange(width)[None, :] < deg[vs][:, None]
            pos = np.minimum(pos, csr.indices.size - 1)
            block = cols_flat[s0 : s0 + slots[b]].reshape(counts[b], width)
            block[: vs.size] = np.where(mask, csr.indices[pos], g.num_nodes)
            if has_w:
                wblock = wts_flat[s0 : s0 + slots[b]].reshape(counts[b], width)
                wblock[: vs.size] = np.where(mask, csr.weight[pos], 0.0)
        r0 += counts[b]
        s0 += slots[b]
    rows_t = torch.from_numpy(rows_flat).to(dev)
    cols_t = torch.from_numpy(cols_flat).to(dev)
    wts_t = torch.from_numpy(wts_flat).to(dev) if has_w else None
    rows_out, cols_out, wts_out = [], [], []
    r0 = s0 = 0
    for r, width, n_slots in zip(counts, widths, slots):
        rows_out.append(rows_t[r0 : r0 + r])
        cols_out.append(cols_t[s0 : s0 + n_slots].view(r, width))
        if has_w:
            wts_out.append(wts_t[s0 : s0 + n_slots].view(r, width))
        r0 += r
        s0 += n_slots
    return EllBlocks(
        g.num_nodes,
        rows_out,
        cols_out,
        wts_out if has_w else None,
        widths,
        _flat=(rows_t, cols_t, wts_t),
    )
