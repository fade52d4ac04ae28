"""LLaMA-family dense transformer with GQA and RoPE: forward, prefill, decode.

The port of `repro.models.transformer` for one device.  What carries over:
  * the public layout — layer-stacked weights `(L, d_in, d_out)` used as
    `x @ w`, a KV cache `{"k", "v"}` of `(L, B, max_seq, Hkv, dh)` — so the
    JAX package's params load one for one (`repro_torch.interop`);
  * the dtype steps — params in `cfg.param_dtype`, activations in `cfg.dtype`,
    fp32 norm statistics, rope and attention softmax.
What changes:
  * `lax.scan` over layers is a Python loop over the stacked tensors, split
    once a forward with `torch.unbind` (its backward is one `stack` a leaf,
    where indexing each layer would add a leaf-sized zero tensor a layer);
    `cfg.remat` (default True, as the reference) recomputes each layer in the
    backward (`torch.utils.checkpoint`, non-reentrant) when grad is on, so the
    attention forward kernel runs twice a layer in a training step (an MoE
    layer routes twice too, and logs its routing once:
    `moe.checkpoint_contexts`).  There is no ambient mesh: `forward`,
    `loss_fn`, `prefill` and the decode steps take `mesh=`.  A dense
    model's `forward` and `loss_fn` on a mesh are Megatron TP or FSDP as
    `cfg.rules` says (`models.dense_mesh`): every leaf laid out by
    `shard_params` as `param_specs` says, (local engines…, [L,] block…), and
    whole params refused.  An MoE model with impl="ep_shardmap" runs the
    same layer with its FFN by EP over "model" on each engine's own tokens
    (`moe.moe_ep_rows`): attention, norms, embedding, lm_head, router and
    shared expert laid out by `param_specs`; under tp_sp the expert stacks
    by `moe.shard_experts` ((local engines…, L, e_l, ·, ·), the padded
    count), under "fsdp" by `param_specs` too (ZeRO-3: the real experts
    whole, d_model over ("data", "model")), gathered into EP's slab at use
    (`moe.zero3_expert_slabs`).  One with impl="local" ignores the mesh
    and takes whole params.  A
    laid-out stack's layer axis follows the local-engine prefix, and the
    split and the recompute carry it along.  `prefill` and the decode
    steps of a model laid out on a mesh serve the same way over a KV cache
    laid out as `kv_cache_specs` says (`init_kv_cache(..., mesh=)`: (local
    engines…, L, B_l, max_seq, Hkv_l, dh), stored layer-major), whole params
    or a whole cache refused; `prefill(..., slot=)` writes one prompt into
    one row of a cache of several, on a mesh only where an engine's block
    holds it.
  * `TransformerConfig.rules`, `param_specs` and `kv_cache_specs` are the
    reference's, over `models.sharding`'s `P` (a mesh, where given, is read
    for its axis sizes only).
  * Attention of prefill and forward goes through `ops.flash_attention`
    (the CUDA kernel for a CUDA tensor; with grad on, through its autograd
    Function, whose backward is the kernel `csrc/flash_attention_bwd.cu`).
    The JAX model reaches its blocked
    reference only above `BLOCKED_ATTN_THRESHOLD · 64` and `gqa_attention`
    otherwise; both compute the same function.  In `prefill` the slot is fresh
    (pos = 0), so attention over the cache restricted to `kv_valid_len = s`
    is causal attention over the s rows just written: the port attends over
    `k.to(cache.dtype).to(q.dtype)`, which are exactly the values the JAX
    code reads back from the cache.
  * Decode stays on the plain `gqa_attention` with `kv_valid_len = pos + 1`.
  * The cache is updated in place (JAX returns a new one); the functions
    return it all the same.
  * `cast_params` keeps one `cfg.dtype` copy of every weight instead of the
    `.astype(h.dtype)` at every use: bit-identical, and a decode step then
    reads half the bytes.
  * With `cfg.moe` the FFN is `models.moe.moe_block` (`impl="local"`; on a
    mesh, `"ep_shardmap"`'s `moe.moe_ep_rows`) on the normed input;
    `cast_params` keeps the router in its own type, because the router
    computes in float32 (a bf16 copy would change its logits).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import dense_mesh
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Initializer,
    apply_rope,
    gqa_attention,
    rms_norm,
    rope_table,
    softmax_cross_entropy,
)
from repro_torch.models.sharding import (P, MeshRules, axis_if_divisible, laid_out_shape, shard_tensor,
                                         unshard_tensor)

__all__ = ["TransformerConfig", "layer_shapes", "init_params", "param_specs", "kv_cache_specs", "cast_params",
           "shard_params", "unshard_params", "sharded_specs", "forward", "loss_fn", "kv_cache_shape", "init_kv_cache",
           "unshard_kv_cache", "decode_step", "decode_step_batched_pos", "prefill"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    rope_theta: float = 10000.0
    moe: moe_lib.MoEConfig | None = None
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = False
    attn_block_q: int = 512
    attn_block_k: int = 1024
    attn_skip_masked_blocks: bool = False
    attn_impl: str = "auto"  # ops.flash_attention's impl for prefill/forward
    remat: bool = True  # recompute each layer in the backward (forward with grad on)
    rules: MeshRules = dataclasses.field(default_factory=MeshRules)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def num_params(self) -> int:
        """Parameter count N for MODEL_FLOPS = 6·N·D accounting."""
        return self._count(self.moe.num_experts if self.moe is not None else 0)

    @property
    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        return self._count(self.moe.top_k if self.moe is not None else 0)

    def _count(self, experts: int) -> int:
        """Params with `experts` routed experts a layer (dense: the FFN)."""
        dh = self.head_dim
        attn = self.d_model * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * self.d_model
        if self.moe is not None:
            m = self.moe
            ffn = 3 * self.d_model * m.d_ff_expert * experts + 3 * self.d_model * m.d_ff_shared
            ffn += self.d_model * m.num_experts  # router
        else:
            ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.d_model


# ----------------------------- parameters ---------------------------------


def layer_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    d, dh = cfg.d_model, cfg.head_dim
    shapes = {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads * dh),
        "wk": (d, cfg.n_kv_heads * dh),
        "wv": (d, cfg.n_kv_heads * dh),
        "wo": (cfg.n_heads * dh, d),
        "mlp_norm": (d,),
    }
    if cfg.moe is None:
        shapes.update({"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)})
    else:
        shapes.update(moe_lib.layer_shapes(cfg.moe, d))
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0, *,
                device: str | torch.device | None = None) -> dict:
    """Random params in the JAX package's layout, drawn from a `torch.Generator`
    seeded with `seed` on `device` (None: the card).  The draws differ from
    `jax.random`'s; to compute on the JAX package's weights, carry them over
    with `repro_torch.interop.transformer_params`."""
    ini = Initializer.seeded(seed, resolve_device(device))
    n = cfg.n_layers
    layers = {}
    for name, shape in layer_shapes(cfg).items():
        full = (n, *shape)  # always layer-stacked
        layers[name] = ini.ones(full, cfg.param_dtype) if "norm" in name else ini.fan_in(full, cfg.param_dtype)
    params = {
        "embed": ini.normal((cfg.vocab, cfg.d_model), 0.02, cfg.param_dtype),
        "layers": layers,
        "final_norm": ini.ones((cfg.d_model,), cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.fan_in((cfg.d_model, cfg.vocab), cfg.param_dtype)
    return params


def param_specs(cfg: TransformerConfig, mesh=None) -> dict:
    """The spec tree parallel to `init_params`' output: the reference's
    `param_specs` (column-parallel wq/wk/wv/w_gate/w_up and lm_head,
    row-parallel wo/w_down, the embedding split by vocab; with `cfg.moe`,
    `moe.layer_specs`); `mesh` decides which dims divide."""
    r = cfg.rules
    d, dh = cfg.d_model, cfg.head_dim
    pre = 1  # params are always layer-stacked
    layers = {
        "attn_norm": r.replicated(prefix=pre + 1),
        "wq": r.col_parallel(d, cfg.n_heads * dh, prefix=pre, mesh=mesh),
        "wk": r.col_parallel(d, cfg.n_kv_heads * dh, prefix=pre, mesh=mesh),
        "wv": r.col_parallel(d, cfg.n_kv_heads * dh, prefix=pre, mesh=mesh),
        "wo": r.row_parallel(cfg.n_heads * dh, d, prefix=pre, mesh=mesh),
        "mlp_norm": r.replicated(prefix=pre + 1),
    }
    if cfg.moe is None:
        layers.update({
            "w_gate": r.col_parallel(d, cfg.d_ff, prefix=pre, mesh=mesh),
            "w_up": r.col_parallel(d, cfg.d_ff, prefix=pre, mesh=mesh),
            "w_down": r.row_parallel(cfg.d_ff, d, prefix=pre, mesh=mesh),
        })
    else:
        layers.update(moe_lib.layer_specs(cfg.moe, d, r, prefix=pre, mesh=mesh))
    specs = {"embed": r.vocab_embed(cfg.vocab, d, mesh=mesh), "layers": layers, "final_norm": P()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = r.col_parallel(d, cfg.vocab, prefix=0, mesh=mesh)
    return specs


def kv_cache_specs(cfg: TransformerConfig, mesh=None) -> dict:
    """The reference's KV cache specs: (L, B, max_seq, Hkv, dh), the batch over
    the rules' batch axes, the KV heads over "model" where they divide."""
    r = cfg.rules
    spec = P(None, r.batch, None, axis_if_divisible(cfg.n_kv_heads, r.model, mesh), None)
    return {"k": spec, "v": spec}


def cast_params(params: dict, cfg: TransformerConfig, *, device: torch.device | None = None) -> dict:
    """The same tree with every tensor in `cfg.dtype` (and on `device`, where
    given).  Every use casts a weight to the activation type first, so
    computing on this tree is bit-identical; tensors already in that type and
    place are shared, not copied.  The MoE router is the exception: it is
    used in float32, so it keeps its type."""
    return {
        k: cast_params(v, cfg, device=device) if isinstance(v, dict)
        else v.to(device=device, dtype=v.dtype if k == "router" else cfg.dtype)
        for k, v in params.items()
    }


def _laid_out(cfg: TransformerConfig, mesh) -> bool:
    """Whether the model runs on `mesh` with every leaf and the KV cache laid
    out (`models.dense_mesh`): a dense model, or an MoE model with
    impl="ep_shardmap" (its experts by EP over "model"), under either
    strategy.  An MoE model with impl="local" keeps everything whole and
    ignores the mesh, under either strategy."""
    if mesh is None:
        return False
    return cfg.moe is None or cfg.moe.impl == "ep_shardmap"


def _ep_slab_layout(cfg: TransformerConfig) -> bool:
    """Whether `shard_params` lays the expert stacks out as EP's slab
    (`moe.shard_experts`, the padded count): EP under tp_sp.  Under "fsdp"
    they stay as `param_specs` lays them (ZeRO-3, the real count)."""
    return cfg.moe is not None and cfg.rules.strategy != "fsdp"


def _layout_specs(cfg: TransformerConfig, mesh) -> dict:
    """The spec tree of the params as `shard_params` lays them out on `mesh`:
    `param_specs(cfg, mesh)`; under tp_sp with EP's expert stacks by
    `moe.ep_specs` (over the padded count), the layout EP takes."""
    specs = param_specs(cfg, mesh)
    if _ep_slab_layout(cfg):
        specs["layers"].update(moe_lib.ep_specs(cfg.moe, prefix=1))
    return specs


def _whole_shapes(cfg: TransformerConfig, mesh) -> dict:
    """{leaf path: whole shape} of the tree `shard_params` lays out, under
    tp_sp the expert stacks padded to a multiple of the EP axis (under
    "fsdp" the real count: the reference pads at use only)."""
    shapes = {("embed",): (cfg.vocab, cfg.d_model), ("final_norm",): (cfg.d_model,)}
    if not cfg.tie_embeddings:
        shapes[("lm_head",)] = (cfg.d_model, cfg.vocab)
    for k, s in layer_shapes(cfg).items():
        if _ep_slab_layout(cfg) and k in moe_lib.EXPERT_KEYS:
            s = (cfg.moe.padded_experts(mesh.shape[cfg.moe.ep_axis]), *s[1:])
        shapes[("layers", k)] = (cfg.n_layers, *s)
    return shapes


def shard_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """The tree as the model takes it on `mesh`: every leaf laid out by
    `sharding.shard_tensor` (a replicated leaf as (1…, ·)) — a dense model
    as `param_specs(cfg, mesh)` says, for Megatron TP or FSDP; an MoE model
    with impl="ep_shardmap" the same, under tp_sp its expert stacks by
    `moe.shard_experts` (padded, this process's experts only), under "fsdp"
    by `param_specs` (ZeRO-3, the real experts).  An MoE model with
    impl="local": `params`.  A laid-out stack keeps the layers
    outermost in memory, (local engines…, L, ·…) stored layer-major: one
    layer's block is then contiguous over the local engines, as the layers
    read it, and not copied every layer."""
    if not _laid_out(cfg, mesh):
        return params
    n = len(mesh.axis_names)

    def layer_major(t: torch.Tensor) -> torch.Tensor:
        return t.movedim(n, 0).contiguous().movedim(0, n)

    specs = _layout_specs(cfg, mesh)
    layers = dict(params["layers"])
    experts = moe_lib.EXPERT_KEYS if _ep_slab_layout(cfg) else ()
    if experts:  # the experts padded and laid out; the other leaves passed on whole
        layers = moe_lib.shard_experts(cfg.moe, layers, mesh, prefix=1)
    out = {k: shard_tensor(v, specs[k], mesh) for k, v in params.items() if k != "layers"}
    out["layers"] = {}
    for k in list(layers):  # one leaf's intermediate copy alive at a time
        v = layers.pop(k)
        out["layers"][k] = layer_major(v if k in experts else shard_tensor(v, specs["layers"][k], mesh))
    return out


def unshard_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """The inverse of `shard_params` (a gradient tree too): whole leaves, the
    padded experts (tp_sp) dropped."""
    if not _laid_out(cfg, mesh):
        return params
    specs = _layout_specs(cfg, mesh)
    out = {k: unshard_tensor(v, specs[k], mesh) for k, v in params.items() if k != "layers"}
    layers = {k: unshard_tensor(v, specs["layers"][k], mesh) for k, v in params["layers"].items()}
    if _ep_slab_layout(cfg):
        layers.update({k: layers[k].narrow(1, 0, cfg.moe.num_experts) for k in moe_lib.EXPERT_KEYS})
    out["layers"] = layers
    return out


def sharded_specs(cfg: TransformerConfig, mesh) -> dict:
    """{leaf path: spec} of the leaves `shard_params` lays out on `mesh` (the
    optimizer's global norm adds their squares over the engines that split
    them, and counts a replicated one once)."""
    if not _laid_out(cfg, mesh):
        return {}
    specs = _layout_specs(cfg, mesh)
    out = {(k,): spec for k, spec in specs.items() if k != "layers"}
    out.update({("layers", k): spec for k, spec in specs["layers"].items()})
    return out


def _laid_out_specs(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """`_layout_specs(cfg, mesh)`; raises unless every leaf of `params` is
    laid out on `mesh` as `shard_params` lays it."""
    specs = _layout_specs(cfg, mesh)
    for path, shape in _whole_shapes(cfg, mesh).items():
        v, spec = (params[path[0]], specs[path[0]]) if len(path) == 1 else (params["layers"][path[1]],
                                                                            specs["layers"][path[1]])
        want = laid_out_shape(shape, spec, mesh)
        if tuple(v.shape) != want:
            raise ValueError(f"a model on a mesh takes its params laid out on it (transformer.shard_params): "
                             f"{'/'.join(path)} is {tuple(v.shape)}, want {want}")
    return specs


def _whole_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """`params` where they are whole (an MoE model with impl="local" ignores
    the mesh); raises for params laid out on it."""
    if mesh is not None and params["embed"].dim() != 2:
        raise NotImplementedError(f"MoE impl={cfg.moe.impl!r} takes whole params; these are laid out on the mesh "
                                  "(transformer.shard_params lays them out for impl='ep_shardmap' only)")
    return params


def _laid_out_cache_spec(cache: dict, cfg: TransformerConfig, mesh):
    """`kv_cache_specs(cfg, mesh)`'s spec; raises unless `cache` is laid out
    on `mesh` as `init_kv_cache(..., mesh=)` lays it (of any batch and
    length)."""
    spec = kv_cache_specs(cfg, mesh)["k"]
    n = len(mesh.axis_names)
    got = tuple(cache["k"].shape)
    if len(got) == n + 5 and tuple(cache["v"].shape) == got:
        want = laid_out_shape((cfg.n_layers, got[n + 1], got[n + 2], cfg.n_kv_heads, cfg.head_dim), spec, mesh)
        if got[:n + 1] + got[n + 3:] == want[:n + 1] + want[n + 3:]:
            return spec
    raise ValueError(f"a model on a mesh takes its KV cache laid out on it (init_kv_cache(..., mesh=)): k is "
                     f"{got}, v {tuple(cache['v'].shape)}, by the spec {spec}")


# ------------------------------ forward -----------------------------------


def _qkv(cfg: TransformerConfig, lp: dict, x: torch.Tensor):
    b, s, _ = x.shape
    dh = cfg.head_dim
    h = rms_norm(x, lp["attn_norm"])
    q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, dh)
    k = (h @ lp["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, dh)
    v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def _out_proj(cfg: TransformerConfig, lp: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, s = out.shape[:2]
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["wo"].to(x.dtype)


def _ffn_block(cfg: TransformerConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"])
    if cfg.moe is not None:
        return moe_lib.moe_block(cfg.moe, lp, h)
    g = h @ lp["w_gate"].to(h.dtype)
    u = h @ lp["w_up"].to(h.dtype)
    return (F.silu(g) * u) @ lp["w_down"].to(h.dtype)


def _causal_attention(cfg: TransformerConfig, q, k, v) -> torch.Tensor:
    return flash_attention(
        q, k, v, causal=True, q_offset=0, impl=cfg.attn_impl,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        skip_masked_blocks=cfg.attn_skip_masked_blocks,
    )


def _prompt_layer(cfg: TransformerConfig, x, lp, cos, sin, cache_kv=None):
    """One layer over a whole prompt from position 0; with `cache_kv` =
    (ck, cv) of (B, max_seq, Hkv, dh) the new rows are written there."""
    q, k, v = _qkv(cfg, lp, x)
    k = apply_rope(k, cos, sin)
    q = apply_rope(q, cos, sin)
    if cache_kv is not None:
        ck, cv = cache_kv
        s = x.shape[1]
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
        # what the JAX model reads back from the cache (a no-op cast when it is q's type)
        k, v = k.to(ck.dtype).to(q.dtype), v.to(cv.dtype).to(q.dtype)
    x = x + _out_proj(cfg, lp, _causal_attention(cfg, q, k, v), x)
    return x + _ffn_block(cfg, lp, x)


def _layer_axis(key: str, v: torch.Tensor) -> int:
    """A stacked leaf's layer axis: 0, or after the local-engine prefix of a
    leaf laid out on a mesh (`shard_params`): what precedes a layer's dims (1
    a norm, 3 an expert stack, else 2)."""
    return v.dim() - 1 - (1 if "norm" in key else 3 if key in moe_lib.EXPERT_KEYS else 2)


def _layer(params: dict, i: int) -> dict:
    return {k: v.select(_layer_axis(k, v), i) for k, v in params["layers"].items()}


def _layers(params: dict, n: int) -> list[dict]:
    """Every layer's weights, each stacked leaf split once (`torch.unbind`)."""
    split = {k: torch.unbind(v, _layer_axis(k, v)) for k, v in params["layers"].items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _embed(params: dict, tokens, cfg: TransformerConfig) -> torch.Tensor:
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    return emb[tokens].to(cfg.dtype)  # = embed.astype(dtype)[tokens], without casting the table


def _head(params: dict, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(cfg.dtype)


def forward(params: dict, tokens, cfg: TransformerConfig, *, mesh=None) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V).  `mesh`: the engine mesh a dense
    model (Megatron TP / FSDP) or an MoE model with impl="ep_shardmap"
    (TP or FSDP attention, EP experts) runs on (`models.dense_mesh`: its
    params laid out by `shard_params`, the logits whole on every process);
    an MoE model with impl="local" ignores it."""
    if _laid_out(cfg, mesh):
        specs = _laid_out_specs(params, cfg, mesh)
        return dense_mesh.forward(params, _layers(params, cfg.n_layers), tokens, cfg, mesh, specs)
    x = _embed(_whole_params(params, cfg, mesh), tokens, cfg)
    cos, sin = rope_table(x.shape[1], cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layers(params, cfg.n_layers):
        if remat:
            x = checkpoint(_prompt_layer, cfg, x, lp, cos, sin, use_reentrant=False,
                           context_fn=moe_lib.checkpoint_contexts)
        else:
            x = _prompt_layer(cfg, x, lp, cos, sin)
    return _head(params, x, cfg)


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig, *, mesh=None) -> torch.Tensor:
    """The mean token cross-entropy in float32 (`valid`, where given, masks
    tokens); on a mesh the vocab-parallel one of `models.dense_mesh`, the
    same on every process."""
    if _laid_out(cfg, mesh):
        specs = _laid_out_specs(params, cfg, mesh)
        return dense_mesh.loss_fn(params, _layers(params, cfg.n_layers), batch, cfg, mesh, specs)
    logits = forward(params, batch["tokens"], cfg, mesh=mesh)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    valid = batch.get("valid")
    valid = None if valid is None else torch.as_tensor(valid, device=logits.device)
    return softmax_cross_entropy(logits, labels, valid=valid)


# ------------------------------ serving -----------------------------------


def kv_cache_shape(cfg: TransformerConfig, batch: int, max_seq: int, mesh=None) -> tuple[int, ...]:
    """The KV cache's (L, batch, max_seq, Hkv, dh); for a model laid out on
    `mesh` (dense, or MoE with impl="ep_shardmap"), as `kv_cache_specs`
    says: (local engines…, L, B_l, max_seq, Hkv_l, dh).  Raises where
    `batch` does not divide over the rules' batch axes (the spec splits it
    over them, as the reference's)."""
    whole = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if not _laid_out(cfg, mesh):
        return whole
    spec = kv_cache_specs(cfg, mesh)["k"]
    batch_axes = tuple(spec)[1]
    batch_axes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)
    if not set(batch_axes) <= set(mesh.axis_names):
        raise ValueError(f"the rules' batch axes {batch_axes} are not all in the mesh's {mesh.axis_names}")
    size = int(np.prod([mesh.shape[a] for a in batch_axes]))
    if batch % size:
        raise ValueError(f"a KV cache of {batch} rows does not divide over the rules' batch axes {batch_axes} "
                         f"({size} engines on the mesh {dict(mesh.shape)})")
    return laid_out_shape(whole, spec, mesh)


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
                  device: str | torch.device | None = None, mesh=None) -> dict:
    """A zero cache {"k", "v"} of `kv_cache_shape`; on a mesh stored
    layer-major, so that a layer's block is one contiguous tensor over the
    local engines."""
    shape = kv_cache_shape(cfg, batch, max_seq, mesh)
    dev = resolve_device(device)
    n = len(shape) - 5

    def zeros():
        return torch.zeros((shape[n], *shape[:n], *shape[n + 1:]), dtype=dtype, device=dev).movedim(0, n)

    return {"k": zeros(), "v": zeros()}


def unshard_kv_cache(cache: dict, cfg: TransformerConfig, mesh) -> dict:
    """The whole cache (L, B, max_seq, Hkv, dh) of one laid out by
    `init_kv_cache(..., mesh=)` (on "process_group" gathered from every
    rank); where the model keeps it whole (MoE with impl="local"), `cache`
    itself."""
    if not _laid_out(cfg, mesh):
        return cache
    specs = kv_cache_specs(cfg, mesh)
    return {k: unshard_tensor(v, specs[k], mesh) for k, v in cache.items()}


def prefill(params: dict, tokens, cache: dict, cfg: TransformerConfig, *, mesh=None, slot: int | None = None):
    """Prefill the cache with a full prompt from position 0 (written in
    place); returns (last_logits (B, V), cache).  `slot`: one prompt (1, P)
    written into row `slot` of a cache of several rows (the serving
    engine's admission).  A model laid out on `mesh` takes its params laid
    out by `shard_params` and its cache by `init_kv_cache(..., mesh=)`
    (`models.dense_mesh.prefill`)."""
    if _laid_out(cfg, mesh):
        specs = _laid_out_specs(params, cfg, mesh)
        spec = _laid_out_cache_spec(cache, cfg, mesh)
        return dense_mesh.prefill(params, _layers(params, cfg.n_layers), tokens, cache, cfg, mesh, specs, spec,
                                  slot), cache
    rows = cache if slot is None else {k: v[:, slot:slot + 1] for k, v in cache.items()}  # views: written in place
    x = _embed(_whole_params(params, cfg, mesh), tokens, cfg)
    s = x.shape[1]
    if s > rows["k"].shape[2]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's {rows['k'].shape[2]} positions")
    cos, sin = rope_table(s, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    for i in range(cfg.n_layers):
        x = _prompt_layer(cfg, x, _layer(params, i), cos, sin, (rows["k"][i], rows["v"][i]))
    return _head(params, x[:, -1], cfg), cache


def _mesh_decode(params: dict, cache: dict, pos, tokens, cfg: TransformerConfig, mesh):
    specs = _laid_out_specs(params, cfg, mesh)
    spec = _laid_out_cache_spec(cache, cfg, mesh)
    return dense_mesh.decode(params, _layers(params, cfg.n_layers), tokens, pos, cache, cfg, mesh, specs,
                             spec), cache


def decode_step(params: dict, cache: dict, pos, tokens, cfg: TransformerConfig, *, mesh=None):
    """One decode step: tokens (B, 1) at absolute position `pos` (an int, the
    same for every row).  Returns (logits (B, V), cache).  A model laid out
    on `mesh`: `decode_step_batched_pos` with every row at `pos`."""
    if _laid_out(cfg, mesh):
        return _mesh_decode(params, cache, torch.full((len(tokens),), int(pos), dtype=torch.long), tokens, cfg, mesh)
    x = _embed(_whole_params(params, cfg, mesh), tokens, cfg)  # (B, 1, D)
    b = x.shape[0]
    max_seq = cache["k"].shape[2]
    pos = int(pos)
    at = min(max(pos, 0), max_seq - 1)  # where dynamic_update_slice would write
    cos_t, sin_t = rope_table(max_seq, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    cos, sin = cos_t[at:at + 1], sin_t[at:at + 1]
    valid = torch.full((b,), pos + 1, dtype=torch.long, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, lp, x)
        k = apply_rope(k, cos, sin)
        q = apply_rope(q, cos, sin)
        ck[:, at] = k[:, 0].to(ck.dtype)
        cv[:, at] = v[:, 0].to(cv.dtype)
        out = gqa_attention(q, ck, cv, causal=True, q_offset=pos, kv_valid_len=valid)
        x = x + _out_proj(cfg, lp, out, x)
        x = x + _ffn_block(cfg, lp, x)
    return _head(params, x, cfg)[:, -1], cache


def decode_step_batched_pos(params: dict, cache: dict, pos, tokens, cfg: TransformerConfig, *, mesh=None):
    """Continuous-batching decode: every slot at its own position.
    pos: (B,) absolute write positions; tokens: (B, 1).  A model laid out
    on `mesh` takes its params and cache laid out (`models.dense_mesh.decode`:
    the rows split as the cache's batch, which B must divide over)."""
    if _laid_out(cfg, mesh):
        return _mesh_decode(params, cache, pos, tokens, cfg, mesh)
    x = _embed(_whole_params(params, cfg, mesh), tokens, cfg)  # (B, 1, D)
    b = x.shape[0]
    max_seq = cache["k"].shape[2]
    pos = torch.as_tensor(pos, device=x.device).long()
    at = pos.clamp(0, max_seq - 1)
    rows = torch.arange(b, device=x.device)
    cos_t, sin_t = rope_table(max_seq, cfg.head_dim, theta=cfg.rope_theta, device=x.device)
    cos_b, sin_b = cos_t[at][:, None, None, :], sin_t[at][:, None, None, :]  # (B, 1, 1, half)

    def rope_at(t):  # t: (B, 1, H, dh)
        half = t.shape[-1] // 2
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos_b - t2 * sin_b, t2 * cos_b + t1 * sin_b], -1).to(t.dtype)

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(cfg, lp, x)
        q, k = rope_at(q), rope_at(k)
        ck[rows, at] = k[:, 0].to(ck.dtype)
        cv[rows, at] = v[:, 0].to(cv.dtype)
        out = gqa_attention(q, ck, cv, causal=False, kv_valid_len=pos + 1)
        x = x + _out_proj(cfg, lp, out, x)
        x = x + _ffn_block(cfg, lp, x)
    return _head(params, x, cfg)[:, -1], cache
