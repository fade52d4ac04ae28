"""GNN model zoo: GIN, GAT, PNA and a GraphCast-style encode-process-decode.

The port of `repro.models.gnn` for one device.  What carries over: the config
and its parameter count, the params' layout (`layers[i]` and `head` dicts of
`w*`/`b*`/`ln` and GIN's scalar `eps`, weights used as `x @ w`), so the JAX
package's params load one for one (`repro_torch.interop.gnn_params`), and
the forwards line for line: SiLU MLPs with a bias-free LayerNorm (eps 1e-6),
GAT's leaky-ReLU(0.2) edge softmax and head average, PNA's aggregators and
degree scalers, GraphCast's interaction blocks with residuals.  What does
not: `MeshRules`' activation constraints (identities on one device; the
rules themselves are `models.sharding`).  GIN over P engines by halo exchange
is `models.gnn_dist`; the vertex-centric engine over P engines is
`graph.distributed`.

Message passing is an edge-index gather and a segment reduce with static
shapes: padded edges point at the sentinel row N and are masked.  The
segment reduces are `index_add_` (sums) and `scatter_reduce_("amax" |
"amin", include_self=True)` into a buffer of −inf / +inf (max, min), each
into N + 1 rows with the sentinel row dropped after; an empty segment keeps
±inf, which the forwards map to 0 as the reference does.

GIN's neighbour sum is an SpMM, out[v] = Σ_{(u→v)} h[u]: with
`cfg.reduce_impl == "ell"` (the default) it goes through
`kernels.segment_spmm` over the degree-binned ELL of the batch's reversed,
unmasked edges (`batch_ell`, built once a batch and carried as
`batch["ell"]`): the CUDA kernel for a CUDA `h`, its plain version for a CPU
`h`.  Its gradient is the same reduce over the transposed ELL (the ELL of the
unreversed edges, `batch_ell(..., transpose=True)` carries it as
`batch["ell"].transpose`): a training step on the card launches the kernel
once a layer forward and once a layer backward but the first (the input
features need no gradient).  `"scatter"` is the reference's gather +
`index_add_`, kept for comparison in the port.  GAT's, PNA's and GraphCast's
sums stay `index_add_`/`scatter_reduce_`: they add per-edge features
(attention-weighted per head, or made by an edge MLP), not gathered node
rows, so they are not that SpMM.

Batch dict convention (tensors, static shapes):
  x          (N, d_in)   node features (grid features for graphcast)
  src, dst   (E,) int32  edge endpoints (< N valid, == N ⇒ padding)
  edge_mask  (E,) bool
  node_mask  (N,) bool
  labels     (N,) int32 node labels | (G,) graph labels | (N, d_out) targets
  train_mask (N,) bool   (node classification)
  graph_ids  (N,) int32  graph membership for batched small graphs
  ell        EllBlocks   GIN with reduce_impl="ell" only (`batch_ell`; its
                         `transpose` for training)
GraphCast adds mesh arrays — see `graphcast_forward`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.graph.structs import EllBlocks, HostGraph, build_ell
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.models.layers import Initializer

__all__ = [
    "GnnConfig",
    "param_shapes",
    "init_params",
    "batch_ell",
    "segment_softmax",
    "gin_sum",
    "gin_forward",
    "gat_forward",
    "pna_forward",
    "graphcast_forward",
    "forward",
    "loss_fn",
    "mesh_sizes_for_refinement",
    "graphcast_mesh_plan",
]

REDUCE_IMPLS = ("ell", "scatter")


@dataclasses.dataclass(frozen=True)
class GnnConfig:
    name: str
    kind: str  # "gin" | "gat" | "pna" | "graphcast"
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int  # n_classes or regression dims
    task: str = "node_class"  # node_class | graph_class | regression
    n_heads: int = 1
    aggregators: tuple[str, ...] = ("sum",)
    scalers: tuple[str, ...] = ("identity",)
    mean_log_degree: float = 1.5  # PNA δ (E[log(d+1)] over the train graphs)
    gin_eps_learnable: bool = True
    # graphcast only:
    mesh_refinement: int = 6
    n_vars: int = 227
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    reduce_impl: str = "ell"  # GIN's neighbour sum: "ell" (segment_spmm) | "scatter"

    @property
    def num_params(self) -> int:
        return sum(int(np.prod(s)) for s in _flat_shapes(param_shapes(self)))


def _flat_shapes(tree) -> list[tuple[int, ...]]:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _flat_shapes(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _flat_shapes(v)]
    return [tree]


# ------------------------------ shared ops ---------------------------------


def _seg_sum(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg.long(), data)


def _seg_extreme(data: torch.Tensor, seg: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """Segment max ("amax") or min ("amin"); an empty segment keeps ∓inf, as
    `jax.ops.segment_max`/`segment_min` give."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = torch.full((n, *data.shape[1:]), fill, dtype=data.dtype, device=data.device)
    idx = seg.long().view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce, include_self=True)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor, n: int, mask: torch.Tensor) -> torch.Tensor:
    """Numerically-stable softmax over edges grouped by `seg` (dst vertex);
    masked edges get 0."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    scores = torch.where(mask, scores, neg_inf)
    seg_max = _finite_or_zero(_seg_extreme(scores, seg, n, "amax"))
    ex = torch.where(mask, torch.exp(scores - seg_max[seg.long()]), torch.zeros_like(scores))
    denom = _seg_sum(ex, seg, n)
    return ex / torch.clamp_min(denom[seg.long()], 1e-16)


def _mlp_shapes(d_in: int, d_hidden: int, d_out: int, n_hidden: int = 1) -> dict:
    dims = [d_in] + [d_hidden] * n_hidden + [d_out]
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"w{i}"] = (a, b)
        shapes[f"b{i}"] = (b,)
    shapes["ln"] = (d_out,)
    return shapes


def _mlp_apply(p: dict, x: torch.Tensor, *, final_ln: bool = True) -> torch.Tensor:
    n = sum(1 for k in p if k.startswith("w"))
    h = x
    for i in range(n):
        h = torch.matmul(h, p[f"w{i}"].to(h.dtype)) + p[f"b{i}"].to(h.dtype)
        if i < n - 1:
            h = F.silu(h)
    if final_ln:
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + 1e-6) * p["ln"].to(h.dtype)
    return h


# ------------------------------- params ------------------------------------


def param_shapes(cfg: GnnConfig) -> dict:
    d, h = cfg.d_hidden, cfg.n_heads
    layers = []
    if cfg.kind == "gin":
        d_prev = cfg.d_in
        for _ in range(cfg.n_layers):
            layers.append({"mlp": _mlp_shapes(d_prev, d, d, n_hidden=1), "eps": ()})
            d_prev = d
        head = {"w": (d, cfg.d_out), "b": (cfg.d_out,)}
    elif cfg.kind == "gat":
        d_prev = cfg.d_in
        graph_task = cfg.task == "graph_class"
        for li in range(cfg.n_layers):
            last = li == cfg.n_layers - 1
            heads = h if (not last or graph_task) else 1
            width = d if (not last or graph_task) else cfg.d_out
            layers.append(
                {"w": (d_prev, heads * width), "a_src": (heads, width), "a_dst": (heads, width)}
            )
            d_prev = heads * width if not last else width
        # graph-level tasks pool node embeddings and classify (GAT paper uses
        # node tasks only; readout follows the GIN protocol)
        head = {"w": (d, cfg.d_out), "b": (cfg.d_out,)} if graph_task else {}
    elif cfg.kind == "pna":
        d_prev = cfg.d_in
        n_agg = len(cfg.aggregators) * len(cfg.scalers)
        for _ in range(cfg.n_layers):
            layers.append(
                {
                    "pre": _mlp_shapes(2 * d_prev, d, d, n_hidden=0),
                    "post": _mlp_shapes(n_agg * d + d_prev, d, d, n_hidden=0),
                }
            )
            d_prev = d
        head = {"w": (d, cfg.d_out), "b": (cfg.d_out,)}
    elif cfg.kind == "graphcast":
        enc = {
            "grid_embed": _mlp_shapes(cfg.d_in, d, d),
            "mesh_embed": _mlp_shapes(3, d, d),
            "e_g2m_embed": _mlp_shapes(4, d, d),
            "e_m2m_embed": _mlp_shapes(4, d, d),
            "e_m2g_embed": _mlp_shapes(4, d, d),
            "g2m_edge": _mlp_shapes(3 * d, d, d),
            "g2m_node": _mlp_shapes(2 * d, d, d),
        }
        for _ in range(cfg.n_layers):
            layers.append(
                {"m2m_edge": _mlp_shapes(3 * d, d, d), "m2m_node": _mlp_shapes(2 * d, d, d)}
            )
        head = {
            "m2g_edge": _mlp_shapes(3 * d, d, d),
            "m2g_node": _mlp_shapes(2 * d, d, d),
            "out": _mlp_shapes(d, d, cfg.d_out),
            **enc,
        }
    else:
        raise ValueError(f"unknown gnn kind {cfg.kind!r}")
    return {"layers": layers, "head": head}


def _init_tree(ini: Initializer, shapes, dtype, name: str = ""):
    if isinstance(shapes, dict):
        return {k: _init_tree(ini, v, dtype, k) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_init_tree(ini, v, dtype, name) for v in shapes]
    if shapes == () or name.startswith("b"):  # gin's eps; biases
        return ini.zeros(shapes, dtype)
    if len(shapes) == 1:  # layernorm scales
        return ini.ones(shapes, dtype)
    return ini.fan_in(shapes, dtype)


def init_params(cfg: GnnConfig, seed: int = 0, *, device: str | torch.device | None = None) -> dict:
    """Random params in the JAX package's layout, drawn from a `torch.Generator`
    seeded with `seed` on `device` (None: the card): fan-in normal matrices,
    LayerNorm scales 1, biases and GIN's `eps` 0.  The draws differ from
    `jax.random`'s; to compute on the JAX package's weights, carry them over
    with `repro_torch.interop.gnn_params`."""
    ini = Initializer.seeded(seed, resolve_device(device))
    return _init_tree(ini, param_shapes(cfg), cfg.param_dtype)


def batch_ell(batch: dict, *, device: str | torch.device | None = None, transpose: bool = False) -> EllBlocks:
    """The ELL that GIN's sum reads, for one batch: `build_ell` of the reversed
    graph of the batch's unmasked edges (rows are destinations, cols their
    sources), without weights, made on `device` (None: the card).  R-MAT
    multi-edges stay, each counted once, as the scatter route counts them.
    With `transpose` its `.transpose` is `build_ell` of the same edges
    unreversed (rows the sources), which the reduce's backward reads: a
    vertex of out-degree 0 is in none of its rows, and its hub rows are the
    vertices of high out-degree.  Host work (a CSR sort of the edges, twice
    with `transpose`): build it once a batch and carry it as `batch["ell"]`."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    mask = host(batch["edge_mask"]).astype(bool)
    g = HostGraph(int(batch["x"].shape[0]), host(batch["src"])[mask], host(batch["dst"])[mask])
    ell = build_ell(g.reversed(), device=device)
    if transpose:
        ell.transpose = build_ell(g, device=device)
    return ell


# ------------------------------ forwards -----------------------------------


def _pad_nodes(h: torch.Tensor) -> torch.Tensor:
    """Append the sentinel row (index N) that padded edges point at."""
    return torch.cat([h, h.new_zeros((1, *h.shape[1:]))], dim=0)


def gin_sum(h: torch.Tensor, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    """GIN's neighbour sum, out[v] = Σ_{(u→v) unmasked} h[u], by
    `cfg.reduce_impl`: "ell" through `segment_spmm` over `batch["ell"]`,
    "scatter" as the reference (gather, mask, `index_add_`)."""
    if cfg.reduce_impl == "ell":
        ell = batch.get("ell")
        if ell is None:
            raise ValueError("GIN with reduce_impl='ell' needs batch['ell']: build it once a batch "
                             "with repro_torch.models.gnn.batch_ell(batch, device=...)")
        return segment_spmm(h, ell)
    if cfg.reduce_impl != "scatter":
        raise ValueError(f"unknown reduce_impl {cfg.reduce_impl!r}; options: {'|'.join(REDUCE_IMPLS)}")
    n = h.shape[0]
    src, dst, emask = batch["src"].long(), batch["dst"], batch["edge_mask"]
    msg = _pad_nodes(h)[src] * emask[:, None].to(h.dtype)
    return _seg_sum(msg, dst, n + 1)[:n]


def gin_forward(params: dict, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    h = batch["x"].to(cfg.dtype)
    for lp in params["layers"]:
        agg = gin_sum(h, batch, cfg)
        eps = lp["eps"] if cfg.gin_eps_learnable else 0.0
        h = _mlp_apply(lp["mlp"], (1.0 + eps) * h + agg)
        h = F.silu(h)
    return h


def gat_forward(params: dict, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    h = batch["x"].to(cfg.dtype)
    n = h.shape[0]
    src, dst, emask = batch["src"].long(), batch["dst"].long(), batch["edge_mask"]
    n_layers = len(params["layers"])
    for li, lp in enumerate(params["layers"]):
        heads, width = lp["a_src"].shape
        wh = torch.matmul(h, lp["w"].to(h.dtype)).reshape(n, heads, width)
        whp = _pad_nodes(wh)
        s_src = torch.einsum("ehw,hw->eh", whp[src], lp["a_src"].to(h.dtype))
        s_dst = torch.einsum("ehw,hw->eh", whp[dst], lp["a_dst"].to(h.dtype))
        scores = F.leaky_relu(s_src + s_dst, 0.2)  # (E, H)
        alpha = segment_softmax(scores, dst, n + 1, emask[:, None])
        out = _seg_sum(whp[src] * alpha[..., None], dst, n + 1)[:n]  # (N, H, W)
        if li < n_layers - 1:
            h = F.elu(out).reshape(n, heads * width)
        else:
            h = out.mean(dim=1)  # final layer: average heads (GAT paper)
    return h


_PNA_DELTA_EPS = 1e-5


def pna_forward(params: dict, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    h = batch["x"].to(cfg.dtype)
    n = h.shape[0]
    src, dst, emask = batch["src"].long(), batch["dst"].long(), batch["edge_mask"]
    deg = _seg_sum(emask.to(cfg.dtype), dst, n + 1)[:n]
    log_deg = torch.log1p(deg)[:, None]
    delta = cfg.mean_log_degree
    m = emask[:, None]
    for lp in params["layers"]:
        hp = _pad_nodes(h)
        pre = _mlp_apply(lp["pre"], torch.cat([hp[src], hp[dst]], -1))  # (E, d)
        pre = pre * m.to(pre.dtype)
        aggs = []
        for a in cfg.aggregators:
            if a == "mean":
                s = _seg_sum(pre, dst, n + 1)[:n]
                aggs.append(s / torch.clamp_min(deg, 1.0)[:, None])
            elif a == "max":
                v = torch.where(m, pre, torch.full_like(pre, float("-inf")))
                aggs.append(_finite_or_zero(_seg_extreme(v, dst, n + 1, "amax")[:n]))
            elif a == "min":
                v = torch.where(m, pre, torch.full_like(pre, float("inf")))
                aggs.append(_finite_or_zero(_seg_extreme(v, dst, n + 1, "amin")[:n]))
            elif a == "std":
                s1 = _seg_sum(pre, dst, n + 1)[:n] / torch.clamp_min(deg, 1.0)[:, None]
                s2 = _seg_sum(pre**2, dst, n + 1)[:n] / torch.clamp_min(deg, 1.0)[:, None]
                aggs.append(torch.sqrt(torch.clamp_min(s2 - s1**2, 0.0) + _PNA_DELTA_EPS))
            elif a == "sum":
                aggs.append(_seg_sum(pre, dst, n + 1)[:n])
            else:
                raise ValueError(f"unknown aggregator {a!r}")
        scaled = []
        for agg in aggs:
            for sc in cfg.scalers:
                if sc == "identity":
                    scaled.append(agg)
                elif sc == "amplification":
                    scaled.append(agg * (log_deg / delta))
                elif sc == "attenuation":
                    scaled.append(agg * (delta / torch.clamp_min(log_deg, _PNA_DELTA_EPS)))
                else:
                    raise ValueError(f"unknown scaler {sc!r}")
        h = _mlp_apply(lp["post"], torch.cat([h] + scaled, -1))
        h = F.silu(h)
    return h


def _interaction(edge_mlp, node_mlp, h_src_nodes, h_dst_nodes, e, src, dst, emask, n_dst):
    """One InteractionNetwork block: edge update, aggregate, node update."""
    src, dst = src.long(), dst.long()
    sp = _pad_nodes(h_src_nodes)
    dp = _pad_nodes(h_dst_nodes)
    e_new = _mlp_apply(edge_mlp, torch.cat([e, sp[src], dp[dst]], -1)) + e
    agg = _seg_sum(e_new * emask[:, None].to(e_new.dtype), dst, n_dst + 1)[:n_dst]
    h_new = _mlp_apply(node_mlp, torch.cat([h_dst_nodes, agg], -1)) + h_dst_nodes
    return h_new, e_new


def graphcast_forward(params: dict, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    """GraphCast encode-process-decode.  Extra batch keys:
      mesh_x (M, 3); g2m_src/g2m_dst/g2m_feat/g2m_mask; m2m_*; m2g_*
      (g2m: src indexes grid, dst indexes mesh; m2g: src mesh, dst grid).
    Returns (N_grid, d_out) predictions."""
    head = params["head"]
    hg = _mlp_apply(head["grid_embed"], batch["x"].to(cfg.dtype))
    hm = _mlp_apply(head["mesh_embed"], batch["mesh_x"].to(cfg.dtype))
    n_grid, n_mesh = hg.shape[0], hm.shape[0]
    e_g2m = _mlp_apply(head["e_g2m_embed"], batch["g2m_feat"].to(cfg.dtype))
    e_m2m = _mlp_apply(head["e_m2m_embed"], batch["m2m_feat"].to(cfg.dtype))
    e_m2g = _mlp_apply(head["e_m2g_embed"], batch["m2g_feat"].to(cfg.dtype))
    # encoder: grid → mesh
    hm, _ = _interaction(
        head["g2m_edge"], head["g2m_node"], hg, hm, e_g2m,
        batch["g2m_src"], batch["g2m_dst"], batch["g2m_mask"], n_mesh,
    )
    # processor: n_layers of mesh GNN on the multimesh
    for lp in params["layers"]:
        hm, e_m2m = _interaction(
            lp["m2m_edge"], lp["m2m_node"], hm, hm, e_m2m,
            batch["m2m_src"], batch["m2m_dst"], batch["m2m_mask"], n_mesh,
        )
    # decoder: mesh → grid
    hg, _ = _interaction(
        head["m2g_edge"], head["m2g_node"], hm, hg, e_m2g,
        batch["m2g_src"], batch["m2g_dst"], batch["m2g_mask"], n_grid,
    )
    return _mlp_apply(head["out"], hg, final_ln=False)


def forward(params: dict, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    if cfg.kind == "gin":
        h = gin_forward(params, batch, cfg)
    elif cfg.kind == "gat":
        h = gat_forward(params, batch, cfg)
        if cfg.task != "graph_class":
            return h  # last layer already maps to classes (single-head avg)
    elif cfg.kind == "pna":
        h = pna_forward(params, batch, cfg)
    elif cfg.kind == "graphcast":
        return graphcast_forward(params, batch, cfg)
    else:
        raise ValueError(cfg.kind)
    w, b = params["head"]["w"].to(h.dtype), params["head"]["b"].to(h.dtype)
    if cfg.task == "graph_class":
        n_graphs = batch["labels"].shape[0]
        pooled = _seg_sum(h * batch["node_mask"][:, None].to(h.dtype), batch["graph_ids"], n_graphs)
        return torch.matmul(pooled, w) + b
    return torch.matmul(h, w) + b


def loss_fn(params: dict, batch: dict, cfg: GnnConfig) -> torch.Tensor:
    out = forward(params, batch, cfg)
    if cfg.task == "regression":
        tgt = batch["labels"].float()
        mask = batch["node_mask"].float()[:, None]
        return torch.sum(((out.float() - tgt) ** 2) * mask) / torch.clamp_min(mask.sum() * out.shape[-1], 1.0)
    logits = out.float()
    labels = batch["labels"]
    if cfg.task == "graph_class":
        mask = torch.ones(labels.shape[0], dtype=torch.float32, device=logits.device)
    else:
        mask = batch.get("train_mask", batch["node_mask"]).float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((logz - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)


# ------------------------- graphcast mesh derivation -----------------------


def mesh_sizes_for_refinement(r: int) -> tuple[int, int]:
    """(nodes, directed multimesh edges) of the icosahedral mesh at level r."""
    nodes = 10 * 4**r + 2
    undirected = 30 * (4 ** (r + 1) - 1) // 3  # Σ_{i≤r} 30·4^i (multimesh union)
    return nodes, 2 * undirected


def graphcast_mesh_plan(n_grid: int, max_refinement: int) -> dict[str, int]:
    """Cap the mesh refinement so mesh nodes ≤ grid nodes, and derive the
    g2m / m2g edge budgets (≈4 and 3 per grid node)."""
    r = 0
    while r < max_refinement and mesh_sizes_for_refinement(r + 1)[0] <= n_grid:
        r += 1
    n_mesh, e_m2m = mesh_sizes_for_refinement(r)
    return {
        "refinement": r,
        "n_mesh": n_mesh,
        "e_m2m": e_m2m,
        "e_g2m": 4 * n_grid,
        "e_m2g": 3 * n_grid,
    }
