"""Halo-exchange message passing: the paper's partitioning applied to a GNN's
neighbour sum (the port of `repro.graph.halo`).

  * vertices are dealt by Algorithm 2 (degree-sorted cyclic: hubs spread
    evenly) onto the P engines of an `EngineMesh`;
  * edges are **destination-cut**: an edge lives with its destination's
    engine, so the segment sum is engine-local;
  * the only communication is the **halo exchange**: each engine sends the
    feature rows its peers' edges read, one `all_to_all` of a static
    (P, h_pair, d) buffer, bytes ∝ the partition's cut, not N·d·P.

`build_halo_plan` is host numpy with static shapes, bit-equal to the
reference's; `halo_extend` runs on the mesh's device.  Its backward is the
exchange's transpose (`EngineMesh.all_to_all` again) and the gather's: each
sent row's cotangent added back into the row it was read from, one peer at a
time in engine order (`_SendRows`), so a gradient has the same bits from run
to run, where `index_select`'s own backward adds with atomics in an order
that is not fixed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import powerlaw_partition
from repro_torch.graph.distributed import EngineMesh

__all__ = ["HaloPlan", "build_halo_plan", "halo_extend", "plan_sizes"]


@dataclasses.dataclass
class HaloPlan:
    """Static-shape graph layout for P engines, host numpy, a row an engine:
      send_idx (P, P, h_pair)  local row that engine q sends to peer p
                               (send_idx[q, p]; padded with n_local, which
                               sends a zero row)
      src_slot (P, e_local)    edge source in [0, n_local + P·h_pair]: local
                               slots, then halo slots grouped by source
                               owner; == ext_size ⇒ padding
      dst_slot (P, e_local)    edge destination in [0, n_local] (local;
                               == n_local ⇒ padding)
      slot_to_vertex (P, n_local)  inverse map (-1 = empty)
    """

    num_devices: int
    num_nodes: int
    n_local: int
    e_local: int
    h_pair: int
    send_idx: np.ndarray
    src_slot: np.ndarray
    dst_slot: np.ndarray
    slot_to_vertex: np.ndarray

    @property
    def ext_size(self) -> int:
        return self.n_local + self.num_devices * self.h_pair

    def halo_bytes_per_device(self, d_feat: int, itemsize: int = 4) -> int:
        return self.num_devices * self.h_pair * d_feat * itemsize


def build_halo_plan(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_devices: int,
    *,
    vertex_part: np.ndarray | None = None,
) -> HaloPlan:
    """Destination-cut + Algorithm-2 vertex partition → halo plan."""
    P = num_devices
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if vertex_part is None:
        vertex_part = powerlaw_partition(src, dst, num_nodes, P).vertex_part
    vpart = vertex_part.astype(np.int64)

    # local slot of every vertex (dense packing per part)
    order = np.lexsort((np.arange(num_nodes), vpart))
    counts = np.bincount(vpart, minlength=P)
    n_local = int(counts.max())
    slot = np.empty(num_nodes, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot[order] = np.arange(num_nodes) - np.repeat(offs, counts)
    slot_to_vertex = np.full((P, n_local), -1, dtype=np.int64)
    slot_to_vertex[vpart, slot] = np.arange(num_nodes)

    # destination-cut: edge owner = dst's engine
    eo = vpart[dst]
    eorder = np.argsort(eo, kind="stable")
    es, ed, eo_s = src[eorder], dst[eorder], eo[eorder]
    ecounts = np.bincount(eo_s, minlength=P)
    e_local = int(ecounts.max()) if ecounts.size else 1
    ecol = np.arange(src.size) - np.repeat(np.concatenate([[0], np.cumsum(ecounts)[:-1]]), ecounts)

    # halo: per (dst-owner p, src-owner q≠p) unique sources, as (p, q, src) keys
    sowner = vpart[es]
    remote = sowner != eo_s
    key = (eo_s[remote] * P + sowner[remote]) * num_nodes + es[remote]
    ukey, inv = np.unique(key, return_inverse=True)
    u_pq = ukey // num_nodes
    u_src = ukey % num_nodes
    pair_counts = np.bincount(u_pq, minlength=P * P)
    h_pair = int(pair_counts.max()) if pair_counts.size else 1
    h_pair = max(h_pair, 1)
    # position of each unique source within its (p, q) group
    pair_offs = np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
    u_pos = np.arange(ukey.size) - pair_offs[u_pq]

    # send tables: engine q sends slot(u_src) to p at halo position u_pos
    send_idx = np.full((P, P, h_pair), n_local, dtype=np.int32)  # pad → zero row
    send_idx[u_pq % P, u_pq // P, u_pos] = slot[u_src]

    # edge source slots: local → slot; remote → n_local + q·h_pair + pos
    src_slot = np.full((P, e_local), n_local + P * h_pair, dtype=np.int32)
    dst_slot = np.full((P, e_local), n_local, dtype=np.int32)
    local_edge = ~remote
    src_slot[eo_s[local_edge], ecol[local_edge]] = slot[es[local_edge]]
    # ext layout on owner p: [local | halo from q=0 | halo from q=1 | …]
    halo_slot = n_local + (u_pq % P) * h_pair + u_pos
    src_slot[eo_s[remote], ecol[remote]] = halo_slot[inv].astype(np.int32)
    dst_slot[eo_s, ecol] = slot[ed]

    return HaloPlan(
        num_devices=P,
        num_nodes=num_nodes,
        n_local=n_local,
        e_local=e_local,
        h_pair=h_pair,
        send_idx=send_idx.astype(np.int32),
        src_slot=src_slot,
        dst_slot=dst_slot,
        slot_to_vertex=slot_to_vertex,
    )


def halo_extend(x_local: torch.Tensor, send_idx: torch.Tensor, mesh: EngineMesh) -> torch.Tensor:
    """x_local (L, n_local, d), send_idx (L, P, h_pair) int64 → ext (L,
    n_local + P·h_pair, d) = [local rows | halo rows by source owner].

    Each local engine gathers the rows its peers asked for (the pad slot
    n_local gives a zero row); one `mesh.all_to_all` delivers every pair's
    rows."""
    L, n_local, d = x_local.shape
    _, p, h_pair = send_idx.shape
    xz = torch.cat([x_local, x_local.new_zeros((L, 1, d))], dim=1).reshape(L * (n_local + 1), d)
    flat = send_idx + (torch.arange(L, device=send_idx.device) * (n_local + 1))[:, None, None]
    recv = mesh.all_to_all(_SendRows.apply(xz, flat))
    return torch.cat([x_local, recv.reshape(L, p * h_pair, d)], dim=1)


class _SendRows(torch.autograd.Function):
    """rows (R, d) read at `flat` (L, P, h) → (L, P, h, d).  The backward adds
    the cotangent of every (engine, peer) block into the rows it was read
    from, one `index_add_` a peer, in peer order.  Within a block the rows
    are distinct (`build_halo_plan` takes them from `np.unique`; only the
    pad row, which reads zeros and gets no gradient, repeats), so no row is
    written twice in one call and the sums are the same on every run."""

    @staticmethod
    def forward(ctx, rows, flat):
        ctx.save_for_backward(flat)
        ctx.num_rows = rows.shape[0]
        return rows.index_select(0, flat.reshape(-1)).view(*flat.shape, rows.shape[1])

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        d = g.shape[-1]
        out = g.new_zeros((ctx.num_rows, d))
        for p in range(flat.shape[1]):
            out.index_add_(0, flat[:, p].reshape(-1), g[:, p].reshape(-1, d))
        return out, None


def plan_sizes(plan: HaloPlan) -> dict[str, int]:
    return {
        "num_devices": plan.num_devices,
        "num_nodes": plan.num_nodes,
        "n_local": plan.n_local,
        "e_local": plan.e_local,
        "h_pair": plan.h_pair,
        "ext_size": plan.ext_size,
    }
