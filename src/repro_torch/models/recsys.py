"""DCN-v2 recommender: sparse embedding tables → cross network → MLP tower.

The port of `repro.models.recsys` for one device.  What carries over: the
config and its parameter count, the params' layout (one stacked table
`(T, V, D)`, `cross[i].{w,b}` or `{u,v,b}`, `mlp[i].{w,b}`, `out.{w,b}`,
weights used as `x @ w`), so the JAX package's params load one for one
(`repro_torch.interop.recsys_params`), and the dtype steps.  The lookup goes
through `kernels.embedding_bag` (the CUDA kernel for CUDA tables, differentiable
in the tables and the weights); `cfg.bag_impl` switches it to the plain
version.  `param_specs` is the reference's (`models.sharding.MeshRules`);
its activation constraints are not ported (there is no ambient mesh).

`lookup_impl="psum_model"` is the reference's sharded lookup on an engine
mesh (`forward(..., mesh=)`): the tables are held row-sharded over "model"
as one contiguous slab, `sharding.shard_tensor(tables, param_specs(cfg,
mesh)["tables"], mesh)`, (1, …, ep, T, V/ep, D) on "stacked"; the ids are
split over the data axes where the batch divides; each model shard gathers
the rows it owns and the partial bags are folded over "model" in engine
order.  The gathers of every local shard are one `embedding_bag` launch a
local data row over the slab seen as (ep·T, V/ep, D), each shard's ids
shifted by its first row: an id outside the shard falls outside [0, V/ep),
which the kernel adds as exactly 0 (the reference's masked local gather).
The table gradient is the bag's own backward into the local slab; it never
crosses the model axis.  Where the batch is split over the data axes, every
data row reads the same slab: it enters the lookup through
`EngineMesh.enter`, so its gradient is the data rows' partial gradients
summed in engine order (hence one launch a data row: each row's own
backward).  Without a mesh it raises (the reference falls back to the
gather).

Shapes (dcn-v2): n_dense=13, n_sparse=26, embed_dim=16, 1,000,000 rows a
table, 3 cross layers, MLP 1024-1024-512.  `retrieval_scores` scores queries
against (N, d) candidates as one matrix product, then `torch.topk`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models.layers import Initializer
from repro_torch.models.sharding import P, MeshRules, axis_if_divisible

__all__ = ["DcnConfig", "LOOKUP_IMPLS", "init_params", "param_specs", "embedding_lookup", "forward", "loss_fn",
           "user_tower", "retrieval_scores"]

LOOKUP_IMPLS = ("gather", "psum_model")


@dataclasses.dataclass(frozen=True)
class DcnConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    rows_per_table: int = 1_000_000
    multi_hot: int = 1  # ids per sparse feature (1 ⇒ plain gather)
    lookup_impl: str = "gather"  # "gather" | "psum_model" (sharded over a mesh's "model" axis)
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    cross_rank: int = 0  # 0 ⇒ full-rank W (DCN-v2 full); >0 ⇒ low-rank UV
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    hot_rows_replicated: int = 0
    bag_impl: str = "auto"  # ops.embedding_bag's impl for the lookup
    rules: MeshRules = dataclasses.field(default_factory=MeshRules)

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    @property
    def num_params(self) -> int:
        d0 = self.d_input
        cross = self.n_cross_layers * (
            d0 * d0 + 2 * d0 if self.cross_rank == 0 else 2 * d0 * self.cross_rank + 2 * d0
        )
        dims = [d0, *self.mlp_dims]
        mlp = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + self.mlp_dims[-1] + 1
        emb = self.n_sparse * self.rows_per_table * self.embed_dim
        return emb + cross + mlp


def init_params(cfg: DcnConfig, seed: int = 0, *, device: str | torch.device | None = None) -> dict:
    """Random params in the JAX package's layout, drawn from a `torch.Generator`
    seeded with `seed` on `device` (None: the card).  The draws differ from
    `jax.random`'s; to compute on the JAX package's weights, carry them over
    with `repro_torch.interop.recsys_params`."""
    ini = Initializer.seeded(seed, resolve_device(device))
    d0 = cfg.d_input
    params: dict = {
        "tables": ini.normal((cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim), 0.01, cfg.param_dtype),
    }
    cross = []
    for _ in range(cfg.n_cross_layers):
        if cfg.cross_rank == 0:
            cross.append({"w": ini.fan_in((d0, d0), cfg.param_dtype), "b": ini.zeros((d0,))})
        else:
            cross.append({
                "u": ini.fan_in((d0, cfg.cross_rank), cfg.param_dtype),
                "v": ini.fan_in((cfg.cross_rank, d0), cfg.param_dtype),
                "b": ini.zeros((d0,)),
            })
    params["cross"] = cross
    dims = [d0, *cfg.mlp_dims]
    params["mlp"] = [{"w": ini.fan_in((a, b), cfg.param_dtype), "b": ini.zeros((b,))}
                     for a, b in zip(dims[:-1], dims[1:])]
    params["out"] = {"w": ini.fan_in((cfg.mlp_dims[-1], 1), cfg.param_dtype), "b": ini.zeros((1,))}
    return params


def param_specs(cfg: DcnConfig, mesh=None) -> dict:
    r = cfg.rules
    row_ax = axis_if_divisible(cfg.rows_per_table, r.model, mesh)
    d0 = cfg.d_input
    specs: dict = {"tables": P(None, row_ax, None)}  # row-sharded tables
    specs["cross"] = [
        {"w": P(None, None), "b": P(None)}
        if cfg.cross_rank == 0
        else {"u": P(None, None), "v": P(None, None), "b": P(None)}
        for _ in range(cfg.n_cross_layers)
    ]
    dims = [d0, *cfg.mlp_dims]
    specs["mlp"] = [
        {"w": P(axis_if_divisible(a, r.fsdp, mesh), axis_if_divisible(b, r.model, mesh)),
         "b": P(axis_if_divisible(b, r.model, mesh))}
        for a, b in zip(dims[:-1], dims[1:])
    ]
    specs["out"] = {"w": P(None, None), "b": P(None)}
    return specs


# ------------------------------ lookup -------------------------------------


def embedding_lookup(cfg: DcnConfig, tables: torch.Tensor, ids, weights=None, *, mesh=None) -> torch.Tensor:
    """ids: (B, T) single-hot or (B, T, L) multi-hot → (B, T·D) bag features.
    "psum_model": `tables` is the row-sharded slab on `mesh`."""
    if cfg.lookup_impl not in LOOKUP_IMPLS:
        raise ValueError(f"unknown lookup_impl {cfg.lookup_impl!r}; options: {'|'.join(LOOKUP_IMPLS)}")
    ids = torch.as_tensor(ids, device=tables.device)
    weights = None if weights is None else torch.as_tensor(weights, device=tables.device)
    b = ids.shape[0]
    if ids.dim() == 2:  # single-hot = bag of length 1
        ids = ids[..., None]
        weights = None if weights is None else weights[..., None]
    if cfg.lookup_impl == "psum_model":
        emb = _lookup_psum_model(cfg, tables, ids, weights, mesh)
    else:
        emb = embedding_bag(tables, ids, weights, impl=cfg.bag_impl)  # (B, T, D)
    return emb.reshape(b, cfg.n_sparse * cfg.embed_dim)


def _lookup_psum_model(cfg: DcnConfig, tables: torch.Tensor, ids: torch.Tensor, weights, mesh) -> torch.Tensor:
    """The sharded lookup: one bag launch over the local shards, the partials
    folded over "model" in engine order.  tables: the slab, (local engines…,
    T, V/ep, D); ids, weights (B, T, L) whole on every process.  → (B, T, D)."""
    if mesh is None or "model" not in mesh.shape:
        raise ValueError("lookup_impl='psum_model' needs a mesh with the 'model' axis (forward(..., mesh=)); "
                         f"got {None if mesh is None else mesh.axis_names}")
    ep = mesh.shape["model"]
    t, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    if v % ep:
        raise ValueError(f"rows_per_table {v} must divide the model axis ({ep})")
    v_l = v // ep
    n, a = len(mesh.axis_names), mesh.axis_index("model")
    m_l = mesh.local_shape[a]
    want = tuple(m_l if i == a else 1 for i in range(n)) + (t, v_l, d)
    if tuple(tables.shape) != want:
        raise ValueError(f"psum_model takes the tables row-sharded on the mesh (shard_tensor(tables, "
                         f"param_specs(cfg, mesh)['tables'], mesh)): shape {want}, got {tuple(tables.shape)}")
    dp = [name for name in mesh.axis_names if name != "model"]
    b = ids.shape[0]
    split = b % int(np.prod([mesh.shape[name] for name in dp])) == 0
    if split:
        # this process's rows of the batch: (local data engines…, B_l, T, L); each reads the slab
        where = dict(zip(mesh.axis_names, mesh.local_slices()))
        lead, pick = [mesh.shape[name] for name in dp], tuple(where[name] for name in dp)
        tables = mesh.enter(tables, dp)
    else:  # the whole batch on every data engine, held once (data axes of size 1)
        lead, pick = [1] * len(dp), ()
    ids = ids.reshape(*lead, -1, *ids.shape[1:])[pick]
    if weights is not None:
        weights = weights.reshape(*lead, -1, *weights.shape[1:])[pick]
    lead, bl, L = ids.shape[:len(dp)], ids.shape[len(dp)], ids.shape[-1]
    rows = int(np.prod(lead))
    j0 = int(mesh.local_coords("model")[0])  # the local shards are model engines j0, j0 + 1, …
    lo = (torch.arange(m_l, dtype=ids.dtype, device=ids.device) + j0) * v_l
    shifted = (ids.reshape(-1, 1, t, L) - lo.view(1, m_l, 1, 1)).reshape(rows, bl, m_l * t, L).to(torch.int32)
    if weights is not None:
        weights = weights.reshape(-1, 1, t, L).expand(-1, m_l, t, L).reshape(rows, bl, m_l * t, L)
    # each local data row's copy of the slab, (m_l·T, V/ep, D), the local engines in (data…, model) order
    slabs = tables.movedim(a, n - 1).reshape(-1, m_l * t, v_l, d).unbind(0)
    part = torch.cat([embedding_bag(slab, shifted[r], None if weights is None else weights[r], impl=cfg.bag_impl)
                      for r, slab in enumerate(slabs)])  # (local rows, m_l·T, D): every local shard's partial bags
    part = part.view(*lead, bl, m_l, t, d).movedim(len(dp) + 1, len(dp)).movedim(len(dp), a)
    out = mesh.psum(part, "model")  # folded in engine order; a model axis of size 1
    if split:
        for i, name in enumerate(dp):
            out = mesh.all_gather(out, name, held=tuple(dp[:i]))  # every data row's bags, on every process
    return out.reshape(-1, t, d)


# ------------------------------ forward ------------------------------------


def _cross_layer(lp: dict, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if "w" in lp:
        xw = x @ lp["w"].to(x.dtype)
    else:
        xw = (x @ lp["u"].to(x.dtype)) @ lp["v"].to(x.dtype)
    return x0 * (xw + lp["b"].to(x.dtype)) + x


def _tower(params: dict, batch: dict, cfg: DcnConfig, weights, mesh) -> torch.Tensor:
    """Cross network then the MLP: (B, mlp_dims[-1])."""
    tables = params["tables"]
    dense = torch.as_tensor(batch["dense"], device=tables.device).to(cfg.dtype)
    emb = embedding_lookup(cfg, tables, batch["sparse_ids"], weights, mesh=mesh)
    x0 = torch.cat([dense, emb.to(cfg.dtype)], dim=-1)
    x = x0
    for lp in params["cross"]:
        x = _cross_layer(lp, x0, x)
    h = x
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"].to(h.dtype) + lp["b"].to(h.dtype))
    return h


def forward(params: dict, batch: dict, cfg: DcnConfig, *, mesh=None) -> torch.Tensor:
    """batch: dense (B, n_dense) fp32, sparse_ids (B, T[, L]) int32, optional
    sparse_weights (B, T[, L]) fp32 → logits (B,).  `mesh`: the engine mesh
    of lookup_impl="psum_model" (params["tables"] then its row-sharded slab)."""
    h = _tower(params, batch, cfg, batch.get("sparse_weights"), mesh)
    logit = h @ params["out"]["w"].to(h.dtype) + params["out"]["b"].to(h.dtype)
    return logit[:, 0]


def loss_fn(params: dict, batch: dict, cfg: DcnConfig, *, mesh=None) -> torch.Tensor:
    logits = forward(params, batch, cfg, mesh=mesh).float()
    labels = torch.as_tensor(batch["labels"], device=logits.device).float()
    # numerically-stable BCE-with-logits
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs())))


# ----------------------------- retrieval -----------------------------------


def user_tower(params: dict, batch: dict, cfg: DcnConfig, *, mesh=None) -> torch.Tensor:
    """Query embedding = the MLP tower's last hidden layer (B, mlp[-1])."""
    return _tower(params, batch, cfg, None, mesh)


def retrieval_scores(params: dict, batch: dict, candidates: torch.Tensor, cfg: DcnConfig, *,
                     top_k: int = 100, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Score `batch` queries against (N_cand, d) candidates — one matrix
    product, then the top `top_k` per query: (values, indices), both (B, k),
    values in fp32, best first."""
    u = user_tower(params, batch, cfg, mesh=mesh)  # (B, d)
    scores = u @ candidates.to(u.dtype).T  # (B, N_cand)
    vals, idx = torch.topk(scores.float(), top_k, dim=-1)
    return vals, idx
