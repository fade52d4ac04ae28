"""GIN forward by halo exchange over an engine mesh (the port of
`repro.models.gnn_dist`).

`gin_forward_halo` is `models.gnn.gin_forward` per engine: node features live
as (L, n_local, d) on the mesh's device (L local engines), and each layer does
one halo exchange (`graph.halo.halo_extend`: an `all_to_all` of the
partition's cut) and then an engine-local neighbour sum and MLP.  The sum goes
through `kernels.segment_spmm` over one ELL a plan (`halo_ell`): rows the
edges' `dst_slot`, columns their `src_slot` into the extended rows, stacked
block-diagonally over the local engines, so one launch a layer serves them
all.

Training differentiates it, as `jax.grad` does the reference through its
`shard_map`: the sum's gradient is the same kernel over the transposed ELL
(`shard_batch(..., transpose=True)` builds it, once a plan), the exchange's
is `halo_extend`'s backward, and the loss's fold over the mesh passes the
cotangent to every engine.  The weights are the same on every engine: each
engine reads them through `EngineMesh.enter`, so their gradients are the
engines' partial gradients summed in engine order (one device: the same
function; on "process_group" the whole gradient on every rank).
`batch_specs_halo` is the plan-layout batch at a plan's sizes (`halo.
plan_sizes`) as "meta" tensors of the reference's shapes and dtypes, which
`launch.perf`'s "halo" variant counts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.graph.distributed import EngineMesh, engine_sums
from repro_torch.graph.halo import HaloPlan, halo_extend
from repro_torch.graph.structs import EllBlocks, HostGraph, build_ell
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.models.gnn import GnnConfig, _mlp_apply
from repro_torch.train.pytree import tree_map

__all__ = ["pack_batch", "batch_specs_halo", "halo_ell", "shard_batch", "gin_forward_halo", "gin_halo_loss_fn"]


def pack_batch(plan: HaloPlan, x, labels, train_mask) -> dict:
    """Host-side: vertex-ordered arrays → plan layout (P-leading numpy)."""
    Pn, n_l = plan.num_devices, plan.n_local
    s2v = plan.slot_to_vertex
    ok = s2v >= 0
    d = x.shape[1]
    xb = np.zeros((Pn, n_l, d), np.float32)
    lb = np.zeros((Pn, n_l), np.int32)
    tm = np.zeros((Pn, n_l), bool)
    xb[ok] = x[s2v[ok]]
    lb[ok] = labels[s2v[ok]]
    tm[ok] = train_mask[s2v[ok]]
    return {
        "x": xb, "send_idx": plan.send_idx, "src_slot": plan.src_slot,
        "dst_slot": plan.dst_slot, "node_mask": ok, "labels": lb,
        "train_mask": tm,
    }


def batch_specs_halo(sizes: dict, d_feat: int, n_classes: int) -> dict:
    """The plan-layout batch (P-leading arrays) of a plan of `sizes`
    (`halo.plan_sizes`) as "meta" tensors of the reference's shapes and
    dtypes (`n_classes` is the reference's unused label width)."""
    pn, n_l, e_l, h = sizes["num_devices"], sizes["n_local"], sizes["e_local"], sizes["h_pair"]
    f32, i32, b_ = torch.float32, torch.int32, torch.bool

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "x": meta((pn, n_l, d_feat), f32),
        "send_idx": meta((pn, pn, h), i32),
        "src_slot": meta((pn, e_l), i32),
        "dst_slot": meta((pn, e_l), i32),
        "node_mask": meta((pn, n_l), b_),
        "labels": meta((pn, n_l), i32),
        "train_mask": meta((pn, n_l), b_),
    }


def halo_ell(src_slot: np.ndarray, dst_slot: np.ndarray, n_local: int, ext_size: int,
             device: torch.device, *, transpose: bool = False) -> EllBlocks:
    """The ELL of the local neighbour sums of L engines, from their (L,
    e_local) `src_slot`/`dst_slot`: engine l's rows are l·ext_size +
    dst_slot, its columns l·ext_size + src_slot, no weights; square, of
    L·ext_size vertices, so the reduce reads the stacked extended rows as
    they are.  Padded edges (dst_slot == n_local) are left out.
    `transpose`: also its `transpose`, the ELL of the same edges the other
    way (rows the extended source rows), which the sum's gradient reduces
    over."""
    L = src_slot.shape[0]
    keep = dst_slot < n_local
    base = np.arange(L, dtype=np.int64)[:, None] * ext_size
    g = HostGraph(L * ext_size, (base + src_slot)[keep], (base + dst_slot)[keep])
    ell = build_ell(g.reversed(), device=device)
    if transpose:
        ell.transpose = build_ell(g, device=device)
    return ell


def shard_batch(packed: dict, mesh: EngineMesh, *, transpose: bool = False) -> dict:
    """`pack_batch`'s arrays → the mesh's local engines' rows as tensors on
    its device (`send_idx` as int64), with `ell` = their `halo_ell`, built
    once a plan on the host (`transpose`: with its transpose, for
    training)."""
    dev = resolve_device(mesh.device)
    P, n_local = packed["x"].shape[:2]
    if P != mesh.num_engines:
        raise ValueError(f"the batch is packed for {P} engines, the mesh has {mesh.num_engines}")
    rows = mesh.local_engines
    out = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[rows])).to(dev) for k, v in packed.items()}
    out["send_idx"] = out["send_idx"].long()
    ext_size = n_local + P * packed["send_idx"].shape[2]
    out["ell"] = halo_ell(np.asarray(packed["src_slot"])[rows], np.asarray(packed["dst_slot"])[rows],
                          n_local, ext_size, dev, transpose=transpose)
    return out


def _per_engine(t: torch.Tensor, mesh: EngineMesh) -> torch.Tensor:
    """A weight as every local engine reads it (`EngineMesh.enter`): (L, …)
    for a matrix, (L, 1, …) for a vector or a scalar, so it broadcasts
    against (L, rows, d)."""
    lead = (1,) * max(1, 3 - t.dim())
    return mesh.enter(t.reshape(*lead, *t.shape))


def gin_forward_halo(params: dict, batch: dict, cfg: GnnConfig, mesh: EngineMesh) -> torch.Tensor:
    """`batch` from `shard_batch` (with `transpose=True` to differentiate);
    returns (L, n_local, d_out) logits of the local engines."""
    resolve_device(mesh.device)
    if cfg.kind != "gin":
        raise ValueError(f"gin_forward_halo runs GIN, not {cfg.kind!r}")
    ell = batch.get("ell")
    if ell is None:
        raise ValueError("gin_forward_halo needs batch['ell']: build the batch with shard_batch(packed, mesh)")
    params = tree_map(lambda t: _per_engine(t, mesh), params)
    h = batch["x"].to(cfg.dtype)
    L, n_local = h.shape[:2]
    ext_size = ell.num_nodes // L
    for lp in params["layers"]:
        ext = halo_extend(h, batch["send_idx"], mesh)  # (L, n_local + P·h_pair, d)
        agg = segment_spmm(ext.reshape(L * ext_size, -1), ell).view(L, ext_size, -1)[:, :n_local]
        eps = lp["eps"] if cfg.gin_eps_learnable else 0.0
        h = F.silu(_mlp_apply(lp["mlp"], (1.0 + eps) * h + agg))
    return torch.matmul(h, params["head"]["w"].to(h.dtype)) + params["head"]["b"].to(h.dtype)


def gin_halo_loss_fn(params: dict, batch: dict, cfg: GnnConfig, mesh: EngineMesh) -> torch.Tensor:
    """Masked cross-entropy over every engine's training nodes (sums folded
    over the mesh in engine order)."""
    logits = gin_forward_halo(params, batch, cfg, mesh).float()
    mask = (batch["train_mask"] & batch["node_mask"]).float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    total = mesh.psum(engine_sums((logz - gold) * mask))
    return total / torch.clamp_min(mesh.psum(engine_sums(mask)), 1.0)
