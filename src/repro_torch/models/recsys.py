"""DCN-v2 recommender: sparse embedding tables → cross network → MLP tower.

The port of `repro.models.recsys` for one device.  What carries over: the
config and its parameter count, the params' layout (one stacked table
`(T, V, D)`, `cross[i].{w,b}` or `{u,v,b}`, `mlp[i].{w,b}`, `out.{w,b}`,
weights used as `x @ w`), so the JAX package's params load one for one
(`repro_torch.interop.recsys_params`), and the dtype steps.  The lookup goes
through `kernels.embedding_bag` (the CUDA kernel for CUDA tables, differentiable
in the tables and the weights); `cfg.bag_impl` switches it to the plain
version.  What does not: `lookup_impl="psum_model"` (the sharded lookup,
ROADMAP.md Queue A 9) raises, and `MeshRules` with its activation
constraints is not ported (identities on one device).

Shapes (dcn-v2): n_dense=13, n_sparse=26, embed_dim=16, 1,000,000 rows a
table, 3 cross layers, MLP 1024-1024-512.  `retrieval_scores` scores queries
against (N, d) candidates as one matrix product, then `torch.topk`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models.layers import Initializer

__all__ = ["DcnConfig", "init_params", "embedding_lookup", "forward", "loss_fn", "user_tower",
           "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class DcnConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    rows_per_table: int = 1_000_000
    multi_hot: int = 1  # ids per sparse feature (1 ⇒ plain gather)
    lookup_impl: str = "gather"  # "psum_model" is multi-device (not ported)
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    cross_rank: int = 0  # 0 ⇒ full-rank W (DCN-v2 full); >0 ⇒ low-rank UV
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    hot_rows_replicated: int = 0
    bag_impl: str = "auto"  # ops.embedding_bag's impl for the lookup

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


# ------------------------------ lookup -------------------------------------


def embedding_lookup(cfg: DcnConfig, tables: torch.Tensor, ids, weights=None) -> torch.Tensor:
    """ids: (B, T) single-hot or (B, T, L) multi-hot → (B, T·D) bag features."""
    if cfg.lookup_impl == "psum_model":
        raise NotImplementedError(
            "lookup_impl='psum_model' is the sharded multi-device lookup (ROADMAP.md Queue A 9)"
        )
    ids = torch.as_tensor(ids, device=tables.device)
    weights = None if weights is None else torch.as_tensor(weights, device=tables.device)
    b = ids.shape[0]
    if ids.dim() == 2:  # single-hot = bag of length 1
        ids = ids[..., None]
        weights = None if weights is None else weights[..., None]
    emb = embedding_bag(tables, ids, weights, impl=cfg.bag_impl)  # (B, T, D)
    return emb.reshape(b, cfg.n_sparse * cfg.embed_dim)


# ------------------------------ forward ------------------------------------


def _cross_layer(lp: dict, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if "w" in lp:
        xw = x @ lp["w"].to(x.dtype)
    else:
        xw = (x @ lp["u"].to(x.dtype)) @ lp["v"].to(x.dtype)
    return x0 * (xw + lp["b"].to(x.dtype)) + x


def _tower(params: dict, batch: dict, cfg: DcnConfig, weights) -> torch.Tensor:
    """Cross network then the MLP: (B, mlp_dims[-1])."""
    tables = params["tables"]
    dense = torch.as_tensor(batch["dense"], device=tables.device).to(cfg.dtype)
    emb = embedding_lookup(cfg, tables, batch["sparse_ids"], weights)
    x0 = torch.cat([dense, emb.to(cfg.dtype)], dim=-1)
    x = x0
    for lp in params["cross"]:
        x = _cross_layer(lp, x0, x)
    h = x
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"].to(h.dtype) + lp["b"].to(h.dtype))
    return h


def forward(params: dict, batch: dict, cfg: DcnConfig) -> torch.Tensor:
    """batch: dense (B, n_dense) fp32, sparse_ids (B, T[, L]) int32, optional
    sparse_weights (B, T[, L]) fp32 → logits (B,)."""
    h = _tower(params, batch, cfg, batch.get("sparse_weights"))
    logit = h @ params["out"]["w"].to(h.dtype) + params["out"]["b"].to(h.dtype)
    return logit[:, 0]


def loss_fn(params: dict, batch: dict, cfg: DcnConfig) -> torch.Tensor:
    logits = forward(params, batch, cfg).float()
    labels = torch.as_tensor(batch["labels"], device=logits.device).float()
    # numerically-stable BCE-with-logits
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs())))


# ----------------------------- retrieval -----------------------------------


def user_tower(params: dict, batch: dict, cfg: DcnConfig) -> torch.Tensor:
    """Query embedding = the MLP tower's last hidden layer (B, mlp[-1])."""
    return _tower(params, batch, cfg, None)


def retrieval_scores(params: dict, batch: dict, candidates: torch.Tensor, cfg: DcnConfig, *,
                     top_k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Score `batch` queries against (N_cand, d) candidates — one matrix
    product, then the top `top_k` per query: (values, indices), both (B, k),
    values in fp32, best first."""
    u = user_tower(params, batch, cfg)  # (B, d)
    scores = u @ candidates.to(u.dtype).T  # (B, N_cand)
    vals, idx = torch.topk(scores.float(), top_k, dim=-1)
    return vals, idx
